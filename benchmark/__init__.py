"""The benchmark of the PyTorch/CUDA port (``poasta_tpu_torch``): one cell
of ``BENCHMARK.json`` a run, ``python3 -m benchmark.run``.  It imports no
JAX and nothing of the JAX package; ``benchmark/reference/`` imports
nothing of the port either."""
