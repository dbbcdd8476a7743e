"""Carry a graph layout built by the JAX package over to the port.

The flattened graph's device layout (symbols, predecessor ring slots,
liveness colouring, write slots) plays the role a model's weights play:
:func:`device_graph_from_reference` takes a ``poasta_tpu`` ``DeviceGraph``'s
arrays as numpy and places the same layout on a torch device.
"""

from __future__ import annotations

import numpy as np

from .aligner.wavefront import DeviceGraph

REFERENCE_KEYS = ("symbols", "pred_slots", "pred_valid", "pred_ranks_np",
                  "write_slots", "window", "meta", "end_rank_i")


def device_graph_from_reference(arrays: dict, device="cpu") -> DeviceGraph:
    """``arrays`` maps each of :data:`REFERENCE_KEYS` to the reference
    ``DeviceGraph``'s field as numpy (``window`` and ``end_rank_i`` as
    ints)."""
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
        device)
