"""poasta_tpu_torch — the PyTorch/CUDA port of poasta_tpu.

It carries the one-piece gap-affine read-mapping path on PyTorch tensors:
scoring of global and ends-free spans (``BatchMapper.score_batch`` ->
``BandedScorer.scores`` -> the banded fills on shared or drifting windows,
with the full-width fills as the ladder's last resort), alignment of
global spans (``BatchMapper.align_batch``: dense tables and a host
backtrace for small batches, else the device traceback) and the
``lasagna`` CLI (``python -m poasta_tpu_torch.cli.lasagna``).  On a CUDA
tensor the fills, the trace and its decode launch hand-written CUDA
kernels (``csrc/``); on a CPU tensor they run their plain PyTorch
versions.  Entry points use the card unless the caller names the CPU.

The port imports torch, never jax, and nothing of the JAX package: it
keeps its own copies of that package's jax-free modules (graphs, cost
models, the exact engines, I/O), byte-equal to the originals, and
re-exports the pieces a caller needs to drive it.
"""

from .aligner.banded import BandedScorer
from .aligner.costs import (
    UNBOUNDED,
    EndsFree,
    GapAffine,
    Global,
    excluded,
    included,
)
from .aligner.engine import PoastaAligner
from .aligner.wavefront import DeviceGraph, pack_queries
from .graphs import FlatGraph, POAGraph
from .native import NativeAligner
from .parallel.mapper import BatchMapper

__all__ = [
    "BandedScorer",
    "BatchMapper",
    "DeviceGraph",
    "EndsFree",
    "FlatGraph",
    "GapAffine",
    "Global",
    "NativeAligner",
    "POAGraph",
    "PoastaAligner",
    "UNBOUNDED",
    "excluded",
    "included",
    "pack_queries",
]
