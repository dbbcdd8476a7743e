"""Carry state built by the JAX package over to the port.

The flattened graph's device layout (symbols, predecessor ring slots,
liveness colouring, write slots) plays the role a model's weights play:
:func:`device_graph_from_reference` takes a ``poasta_tpu`` ``DeviceGraph``'s
arrays as numpy and places the same layout on a torch device.
:func:`drift_prep_from_reference` and
:func:`ends_free_params_from_reference` do the same for a drifting-window
layout and for an ends-free span's bounds, so that both packages fill the
same thing.  Everything arrives as numpy: nothing here imports the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from .aligner.wavefront import DeviceGraph
from .utils.device import resolve_device

REFERENCE_KEYS = ("symbols", "pred_slots", "pred_valid", "pred_ranks_np",
                  "write_slots", "window", "meta", "end_rank_i")


def device_graph_from_reference(arrays: dict, device=None) -> DeviceGraph:
    """``arrays`` maps each of :data:`REFERENCE_KEYS` to the reference
    ``DeviceGraph``'s field as numpy (``window`` and ``end_rank_i`` as
    ints).  ``device``: None means the card (raises without one)."""
    missing = [k for k in REFERENCE_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"reference arrays lack {missing}")
    meta = np.asarray(arrays["meta"])
    n_nodes = int(meta[0])
    if int(meta[1]) != n_nodes - 1 or int(arrays["end_rank_i"]) != n_nodes - 1:
        raise ValueError(f"inconsistent end rank: meta {meta.tolist()}, "
                         f"end_rank_i {arrays['end_rank_i']}")
    return DeviceGraph.from_arrays(
        np.asarray(arrays["symbols"]), np.asarray(arrays["pred_slots"]),
        np.asarray(arrays["pred_valid"]), np.asarray(arrays["pred_ranks_np"]),
        np.asarray(arrays["write_slots"]), int(arrays["window"]), n_nodes,
        resolve_device(device))


DRIFT_PREP_TENSORS = ("pred_wstarts", "wstarts", "s_ranks", "s_prev")


def drift_prep_from_reference(prep: dict, device=None) -> dict:
    """The reference's ``prepare_banded_drift`` dict, its arrays as numpy,
    as the port's drift fills take it: the same tables on ``device``, and
    the window bounds and 128-lane alignment the launcher checks."""
    device = resolve_device(device)
    ws = np.asarray(prep["wstarts"], dtype=np.int32)
    out = {k: int(prep[k]) for k in ("margin", "width", "mq", "S", "L",
                                     "w_end")}
    for k in DRIFT_PREP_TENSORS:
        out[k] = torch.tensor(np.asarray(prep[k], dtype=np.int32),
                              device=device)
    out["wstarts_min"], out["wstarts_max"] = int(ws.min()), int(ws.max())
    out["aligned"] = bool((ws % 128 == 0).all())
    return out


def ends_free_params_from_reference(free_start, end_ok, jlo, device=None):
    """The reference's ``ends_free_device_params`` triple (arrays as numpy)
    as the port's: ``(bool, (Np,) int32 tensor, (B,) int32 tensor)``."""
    device = resolve_device(device)
    return (bool(free_start),
            torch.tensor(np.asarray(end_ok, dtype=np.int32), device=device),
            torch.tensor(np.asarray(jlo, dtype=np.int32), device=device))
