"""ctypes binding for the native exact alignment engine.

``engine.cpp`` is compiled with ``g++ -O3`` at first use into
``build/poasta_tpu_torch/native-<hash>/`` beside the package (``build/``
is git-ignored): no binary ships with the port.  The hash covers the
source and the host, since a ``-march=native`` binary from another machine
can fault.  A missing toolchain or a failed compile raises: there is no
other engine behind it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import List

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "engine.cpp")
_BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                           "poasta_tpu_torch")
_ABI_VERSION = 3  # must match poasta_abi_version() in engine.cpp
_lock = threading.Lock()
_lib = None


def _lib_path() -> str:
    h = hashlib.sha256(f"{platform.machine()} {platform.node()}".encode())
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    return os.path.join(_BUILD_ROOT, f"native-{h.hexdigest()[:16]}",
                        "libpoasta.so")


def _build(lib_path: str) -> None:
    """Compile ``engine.cpp`` into ``lib_path``; raises on failure."""
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    # -march=native is worth ~2x on the banded fill (vectorized mins);
    # generic codegen where the flag is unsupported
    base_cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o",
                tmp]
    try:
        res = subprocess.run(base_cmd[:1] + ["-march=native"] + base_cmd[1:],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            res = subprocess.run(base_cmd, capture_output=True, text=True,
                                 timeout=300)
    except FileNotFoundError as exc:
        raise RuntimeError("g++ not found: the native engine cannot be "
                           "built") from exc
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}) on {_SRC}:\n"
                           f"{res.stderr[-2000:]}")
    os.replace(tmp, lib_path)  # atomic: no process loads half a file


def _load():
    """Build if needed, load the library and declare its C signatures.
    Thread-safe; later calls return the loaded library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        got_abi = int(lib.poasta_abi_version())
        if got_abi != _ABI_VERSION:
            raise RuntimeError(f"native library {path} has ABI {got_abi}, "
                               f"expected {_ABI_VERSION}")
        lib.poasta_engine_create.restype = ctypes.c_void_p
        lib.poasta_engine_create.argtypes = [
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.poasta_engine_destroy.argtypes = [ctypes.c_void_p]
        lib.poasta_align.restype = ctypes.c_int64
        lib.poasta_align.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.poasta_align_banded.restype = ctypes.c_int64
        lib.poasta_align_banded.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.poasta_align_anchored.restype = ctypes.c_int64
        lib.poasta_align_anchored.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.poasta_last_anchored_stats.restype = None
        lib.poasta_last_anchored_stats.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return _lib


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _pairs(rpos: np.ndarray, qpos: np.ndarray, count: int):
    """Wrap the engine's (-1 = None) arrays as a lazy ArrayAlignment.

    Serving-path alignments carry thousands of pairs per read; building
    AlignedPair tuples eagerly cost ~2.7 ms/read at pangenome scale —
    more than the corridor backtrace itself.  The wrapper defers tuple
    construction to consumers that actually iterate; vectorized
    consumers (the GAF emitter) read the arrays directly."""
    from ..aligner.alignment import ArrayAlignment

    return ArrayAlignment(rpos[:count].copy(), qpos[:count].copy())


class NativeAligner:
    """Native exact aligner over a fixed graph snapshot.

    Semantics identical to :class:`..aligner.engine.PoastaAligner` for
    global alignment with the dijkstra/mingap heuristics.
    """

    def __init__(self, graph) -> None:
        lib = self._lib = _load()
        n = graph.node_count_with_start_and_end()
        symbols = np.asarray(graph.symbols, dtype=np.uint8)

        def csr(adj_fn):
            ptr = np.zeros(n + 1, dtype=np.int32)
            idx: List[int] = []
            for v in range(n):
                lst = list(adj_fn(v))
                idx.extend(lst)
                ptr[v + 1] = len(idx)
            return ptr, np.asarray(idx, dtype=np.int32)

        # iteration order (newest edge first) to match the python engine
        succ_ptr, succ_idx = csr(graph.successors)
        pred_ptr, pred_idx = csr(graph.predecessors)
        if succ_idx.size == 0:
            succ_idx = np.zeros(1, dtype=np.int32)
        if pred_idx.size == 0:
            pred_idx = np.zeros(1, dtype=np.int32)

        self._handle = lib.poasta_engine_create(
            n,
            symbols.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            _i32ptr(succ_ptr), _i32ptr(succ_idx),
            _i32ptr(pred_ptr), _i32ptr(pred_idx),
            graph.start_node, graph.end_node,
        )
        self._n = n

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.poasta_engine_destroy(handle)
            self._handle = None

    def align(self, seq: bytes, costs, heuristic: str = "mingap",
              enable_pruning: bool = True):
        """Returns (score, alignment, (queued, visited, pruned))."""
        n = len(seq)
        cap = 4 * (n + self._n) + 16
        out_rpos = np.zeros(cap, dtype=np.int32)
        out_qpos = np.zeros(cap, dtype=np.int32)
        out_score = np.zeros(1, dtype=np.int64)
        out_stats = np.zeros(3, dtype=np.int64)
        seq_arr = np.frombuffer(bytes(seq), dtype=np.uint8) if n else np.zeros(1, dtype=np.uint8)

        two_piece = 1 if costs.is_two_piece else 0
        count = self._lib.poasta_align(
            self._handle,
            seq_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n,
            costs.mismatch, costs.gap_open, costs.gap_extend,
            costs.gap_open2 if two_piece else 0,
            costs.gap_extend2 if two_piece else 0,
            two_piece,
            0 if heuristic == "dijkstra" else 1,
            1 if enable_pruning else 0,
            _i32ptr(out_rpos), _i32ptr(out_qpos), cap,
            out_score.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out_stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if count < 0:
            raise RuntimeError(f"native alignment failed (code {count})")
        alignment = _pairs(out_rpos, out_qpos, count)
        return int(out_score[0]), alignment, tuple(int(s) for s in out_stats)

    def align_anchored(self, seq: bytes, costs, end_node: int,
                       end_offset: int, score: int,
                       free_start: bool = True):
        """End-anchored ends-free corridor alignment (one- or two-piece).

        ``(end_node, end_offset, score)`` come from the device fill
        (a bounded ends-free fill that also returns each read's end state);
        the fill covers only a corridor around the anchored diagonal, so
        per-read work scales with the read's own span and score instead
        of the whole graph.  Returns (score, alignment); raises
        RuntimeError when the corridor cannot be verified (caller falls
        back to the dense or exact path).
        """
        two_piece = getattr(costs, "is_two_piece", False)
        q = np.frombuffer(bytes(seq), dtype=np.uint8)
        cap = 4 * (len(seq) + 64) + 256
        rpos = np.empty(cap, dtype=np.int32)
        qpos = np.empty(cap, dtype=np.int32)
        out_score = np.zeros(1, dtype=np.int64)
        count = self._lib.poasta_align_anchored(
            self._handle,
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(seq), int(end_node), int(end_offset),
            costs.mismatch, costs.gap_open, costs.gap_extend,
            costs.gap_extend2 if two_piece else 0,
            1 if two_piece else 0,
            1 if free_start else 0, int(score),
            _i32ptr(rpos), _i32ptr(qpos), cap,
            out_score.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if count < 0:
            raise RuntimeError(f"anchored alignment failed ({count})")
        return int(out_score[0]), _pairs(rpos, qpos, count)

    def last_anchored_stats(self) -> dict:
        """Phase breakdown of this thread's last ``align_anchored`` call:
        corridor/fill/backtrace ns plus corridor node/cell counts and
        attempts (the serving path's host-side profiling counters)."""
        out = np.zeros(6, dtype=np.int64)
        self._lib.poasta_last_anchored_stats(
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        keys = ("corridor_ns", "fill_ns", "backtrace_ns",
                "corridor_nodes", "corridor_cells", "attempts")
        return dict(zip(keys, (int(v) for v in out)))

    def align_banded(self, seq: bytes, costs, ub=None, max_retries: int = 8):
        """Banded dense fill + backtrace: returns (score, alignment).

        Exact with verify-and-retry: a banded score <= ub is provably
        optimal (no excluded cell can lie on a <=ub path); otherwise the
        band is re-filled with the failed attempt's score as the new ub,
        which always verifies (banded scores only over-estimate).  Pass
        ``ub`` >= the known optimal score (e.g. from the device scorer)
        to make the first attempt both tight and final.
        """
        n = len(seq)
        cap = 4 * (n + self._n) + 16
        out_rpos = np.zeros(cap, dtype=np.int32)
        out_qpos = np.zeros(cap, dtype=np.int32)
        out_score = np.zeros(1, dtype=np.int64)
        seq_arr = (np.frombuffer(bytes(seq), dtype=np.uint8)
                   if n else np.zeros(1, dtype=np.uint8))

        if ub is None:
            ub = (costs.gap_open + costs.gap_extend) * 4 \
                + costs.mismatch * max(n // 16, 4)
        for _ in range(max_retries):
            count = self._lib.poasta_align_banded(
                self._handle,
                seq_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                n,
                costs.mismatch, costs.gap_open, costs.gap_extend,
                costs.gap_extend2 if costs.is_two_piece else 0,
                1 if costs.is_two_piece else 0,
                int(ub),
                _i32ptr(out_rpos), _i32ptr(out_qpos), cap,
                out_score.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
            if count == -4:
                # The failed attempt's banded score is an upper bound that
                # GUARANTEES the next attempt verifies — but a too-narrow
                # band can over-estimate wildly, making that next fill very
                # wide.  Grow geometrically, capped by the guarantee.
                # (An int16 attempt whose score saturated carries no such
                # guarantee; the dispatcher reports those as the >=2^28
                # no-bound sentinel, landing in the pure-doubling branch.)
                banded = int(out_score[0])
                grown = max(int(ub) * 2, int(ub) + 256)
                ub = min(banded, grown) if banded < (1 << 28) else grown * 2
                continue
            if count < 0:
                raise RuntimeError(f"native banded alignment failed ({count})")
            return int(out_score[0]), _pairs(out_rpos, out_qpos, count)
        raise RuntimeError("native banded alignment did not converge")
