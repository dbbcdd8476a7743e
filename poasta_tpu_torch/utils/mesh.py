"""The port's device mesh: a (dp, sp) grid of ``torch.device`` entries.

Counterpart of the ``jax.sharding.Mesh`` with axes ("dp", "sp") that
``poasta_tpu`` builds.  One process drives every entry, as one controller
drives every shard of the reference's ``shard_map``: the dp axis splits a
read batch into contiguous blocks, each filled by the same kernel on its
own device, and the scores are gathered afterwards (no collective runs
inside a fill).  The sp axis splits query offsets; only the demonstrator
``parallel.mapper._sp_scan_rows`` reads it, the banded and full fills
replicate over it as the reference's do.  Entries may repeat a device: the
CPU has one ``torch.device``, so eight CPU entries stand in for the
reference's eight virtual CPU devices, and two entries of one card drive
the split, the per-shard launches and the gather with the real kernels.

:func:`make_mesh` and :func:`parse_mesh_spec` build meshes
(``parallel.mapper`` exports them as the reference does).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from .device import cuda_device
from .errors import PoastaError

AXIS_NAMES = ("dp", "sp")


def normalize(device) -> torch.device:
    """``device`` as the ``torch.device`` a tensor placed there reports
    (``"cuda"`` names the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """A (dp, sp) grid of devices.  ``devices`` is the (dp, sp) object
    array of ``torch.device``; ``shape`` maps each axis name to its size,
    as the reference's ``mesh.shape`` does."""

    axis_names = AXIS_NAMES

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh needs a non-empty (dp, sp) grid of "
                             f"devices, got shape {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict:
        dp, sp = self.devices.shape
        return {"dp": dp, "sp": sp}

    @property
    def first(self) -> torch.device:
        """The mesh's first device: where the mapper keeps its graph, traces
        and decodes, as the reference does on its default device."""
        return self.devices[0, 0]

    def __repr__(self) -> str:
        dp, sp = self.devices.shape
        return (f"Mesh(dp={dp}, sp={sp}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def make_mesh(devices=None, dp: Optional[int] = None, sp: int = 1) -> Mesh:
    """A (dp, sp) mesh over ``devices`` (None: every visible card; raises
    without one).  ``dp`` defaults to ``len(devices) // sp``; dp * sp must
    equal the number of entries, which may repeat a device."""
    if devices is None:
        cuda_device()  # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [normalize(d) for d in devices]
    n = len(devices)
    if dp is None:
        dp = n // sp
    if dp < 1 or sp < 1 or dp * sp != n:
        raise ValueError(f"dp({dp}) * sp({sp}) must equal device count ({n})")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(dp, sp))


def parse_mesh_spec(spec: str, *, device=None) -> Optional[Mesh]:
    """CLI ``--mesh`` spec -> Mesh (or None for one device).

    * ``auto``: dp over every visible card, sp 1; None on one card (or
      under ``device="cpu"``).
    * ``off`` / ``1`` / ``none``: one device.
    * ``DP`` or ``DP,SP``: explicit axis sizes; DP*SP must equal the
      visible card count.  Under ``device="cpu"`` they build DP*SP CPU
      entries instead (the CPU stands in for any number of devices).
    """
    spec = spec.strip().lower()
    if spec in ("off", "1", "none"):
        return None
    on_cpu = device is not None and torch.device(device).type == "cpu"
    n = 0 if on_cpu else torch.cuda.device_count()
    if spec == "auto":
        return make_mesh(dp=n, sp=1) if n > 1 else None
    parts = spec.split(",")
    try:
        dp = int(parts[0])
        sp = int(parts[1]) if len(parts) > 1 else 1
    except ValueError:
        raise ValueError(f"bad --mesh spec {spec!r} (use auto|off|DP[,SP])")
    if dp < 1 or sp < 1:
        raise ValueError(f"bad --mesh spec {spec!r} (use auto|off|DP[,SP])")
    if on_cpu:
        n = dp * sp
    if dp * sp != n:
        raise ValueError(
            f"--mesh {spec}: dp*sp = {dp * sp} but {n} devices are visible")
    if dp == 1 and sp == 1:
        return None
    return make_mesh(devices=[torch.device("cpu")] * n if on_cpu else None,
                     dp=dp, sp=sp)


def check_mesh(mesh) -> None:
    """The reference's ``mesh=``: None runs on one device, a port
    :class:`Mesh` shards over its entries; anything else raises."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise PoastaError(f"mesh={mesh!r}: not a poasta_tpu_torch mesh "
                          "(build one with make_mesh or parse_mesh_spec)")


def dp_shards(mesh: Optional[Mesh], B: int,
              device) -> List[Tuple[torch.device, slice]]:
    """(device, rows) of each dp shard of a B-read batch: contiguous
    blocks, the first ``B % dp`` one read longer, each on the first device
    of its mesh row.  Empty blocks (B < dp) are left out; they are the last
    ones, so a shard's index is its mesh row.  Without a mesh, the whole
    batch on ``device``."""
    if mesh is None:
        return [(device, slice(0, B))]
    dp = mesh.shape["dp"]
    edges = np.cumsum([0] + [B // dp + (i < B % dp) for i in range(dp)])
    shards = [(mesh.devices[i, 0], slice(int(edges[i]), int(edges[i + 1])))
              for i in range(dp) if edges[i + 1] > edges[i]]
    return shards or [(mesh.first, slice(0, 0))]


def bound_to(device):
    """A context in which ``device`` is this thread's current card (a CPU
    device binds nothing)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def gather(parts, device):
    """The per-shard outputs (tensors, or tuples of tensors) joined along
    the batch on ``device``."""
    if isinstance(parts[0], tuple):
        return tuple(gather(list(col), device) for col in zip(*parts))
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts])
