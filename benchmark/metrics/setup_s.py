"""Process start to the window's first call (host clock): imports, the
CUDA context, the kernel library, the inputs made, the GFA written and
loaded, the mapper built, the warm-up."""


def read(run):
    return run.setup_s
