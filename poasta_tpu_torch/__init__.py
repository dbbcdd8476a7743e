"""poasta_tpu_torch — the PyTorch/CUDA port of poasta_tpu.

It carries the global one-piece gap-affine read-mapping path on PyTorch
tensors: scoring (``BatchMapper.score_batch`` -> ``BandedScorer.scores``
-> the banded fill, with the full fill as the ladder's last resort),
alignment (``BatchMapper.align_batch``: dense tables and a host backtrace
for small batches, else the device traceback) and the ``lasagna`` CLI
(``python -m poasta_tpu_torch.cli.lasagna``).  On a CUDA tensor the fills,
the trace and its decode launch hand-written CUDA kernels (``csrc/``); on
a CPU tensor they run their plain PyTorch versions.

The port imports torch and never jax.  It shares the JAX package's
jax-free modules (graphs, cost models, I/O, the native exact engine) and
re-exports the pieces a caller needs to drive it.
"""

from poasta_tpu.aligner.costs import GapAffine
from poasta_tpu.graphs import FlatGraph, POAGraph
from poasta_tpu.native import NativeAligner

from .aligner.banded import BandedScorer
from .aligner.wavefront import DeviceGraph, pack_queries
from .parallel.mapper import BatchMapper

__all__ = [
    "BandedScorer",
    "BatchMapper",
    "DeviceGraph",
    "FlatGraph",
    "GapAffine",
    "NativeAligner",
    "POAGraph",
    "pack_queries",
]
