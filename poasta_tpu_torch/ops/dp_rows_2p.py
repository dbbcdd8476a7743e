"""Two-piece (convex) affine row update on int32 PyTorch tensors.  Port of
``poasta_tpu/ops/dp_rows_2p.py`` (same recurrence, same clamps).

Five state layers (M, D1, D2, I1, I2); piece-2 states are entered from
piece-1 states at ``extend2`` and extend at ``extend2``:

    D1[j] = min_p min(M[p][j] + o1 + e1,  D1[p][j] + e1)
    D2[j] = min_p min(D1[p][j], D2[p][j]) + e2
    A[j]  = min(diag[j], D1[j], D2[j])
    I1[j] = min(A[j-1] + o1 + e1, I1[j-1] + e1, I2[j-1] + o1 + e1)
    I2[j] = min(I1[j-1], I2[j-1]) + e2
    M[j]  = min(A[j], I1[j], I2[j])

The (I1, I2) pair is a coupled linear min-plus recurrence along the offset
axis; :func:`insertion_rows_2p` evaluates it as a doubling scan over affine
min-plus maps (a 2x2 matrix and a 2-vector per lane), every entry clamped
to INF after each round.  The fills do not run this scan: only M enters a
ring, and with e1 >= e2 ``min(I1, I2)`` is the one-piece insertion with
slope e2 (``ops/cuda_fill.py``); the tests hold the two to each other.
"""

from __future__ import annotations

import torch

from .dp_rows import INF, _shift_right


def insertion_rows_2p(A: torch.Tensor, o1: int, e1: int, o2_unused: int,
                      e2: int, max_shift: int = 0):
    """Coupled (I1, I2) rows from the A = min(diag, D1, D2) row.

    A: (..., L) int32.  Returns (I1, I2) with lane 0 = INF.  ``max_shift``
    (a power of two) truncates the scan as the TPU kernels'
    ``_coupled_insertion_rows`` does: lane j then composes only the maps of
    lanes j - max_shift + 1 .. j, so runs open at most ``max_shift`` lanes
    back; 0 scans the whole row.
    """
    L = A.shape[-1]
    inf = torch.tensor(INF, dtype=A.dtype, device=A.device)
    lane1 = torch.arange(L, device=A.device) >= 1

    def step(v):
        return torch.where(lane1, torch.full_like(A, v), inf)

    # lane j >= 1 carries x_j = T (x) x_{j-1} (+) b_j; lane 0 the all-INF map
    t11, t12, t21, t22 = step(e1), step(o1 + e1), step(e2), step(e2)
    b1 = torch.where(lane1, torch.minimum(_shift_right(A) + (o1 + e1), inf),
                     inf)
    b2 = torch.full_like(A, INF)
    cap = min(L, max_shift) if max_shift else L
    k = 1
    while k < cap:
        # lanes left of 0 compose with the identity map (0 diagonal, INF
        # elsewhere, INF vector)
        s11, s12 = _shift_right(t11, k, 0), _shift_right(t12, k)
        s21, s22 = _shift_right(t21, k), _shift_right(t22, k, 0)
        c1, c2 = _shift_right(b1, k), _shift_right(b2, k)
        # F_j <- F_j o F_{j-k}: T' = T (x) S, b' = min(T (x) c, b)
        n11 = torch.minimum(torch.minimum(t11 + s11, t12 + s21), inf)
        n12 = torch.minimum(torch.minimum(t11 + s12, t12 + s22), inf)
        n21 = torch.minimum(torch.minimum(t21 + s11, t22 + s21), inf)
        n22 = torch.minimum(torch.minimum(t21 + s12, t22 + s22), inf)
        b1, b2 = (
            torch.minimum(torch.minimum(torch.minimum(t11 + c1, t12 + c2), b1),
                          inf),
            torch.minimum(torch.minimum(torch.minimum(t21 + c1, t22 + c2), b2),
                          inf))
        t11, t12, t21, t22 = n11, n12, n21, n22
        k <<= 1
    return b1, b2


def row_update_2p(pred_M: torch.Tensor, pred_D1: torch.Tensor,
                  pred_D2: torch.Tensor, pred_mask: torch.Tensor,
                  match_cost: torch.Tensor, o1: int, e1: int, e2: int,
                  is_start_row: bool, free_start: bool):
    """One rank-row update for the two-piece model.

    pred_*: (..., P, L) gathered predecessor rows; pred_mask: (P,) bool.
    Returns (M, I1, I2, D1, D2) rows of shape (..., L).
    """
    mask = pred_mask.reshape((1,) * (pred_M.ndim - 2) + (-1, 1))
    min_pm = torch.where(mask, pred_M, INF).min(dim=-2).values
    min_pd1 = torch.where(mask, pred_D1, INF).min(dim=-2).values
    min_pd2 = torch.where(mask, pred_D2, INF).min(dim=-2).values
    D1 = torch.clamp(torch.minimum(min_pm + (o1 + e1), min_pd1 + e1),
                     max=INF)
    D2 = torch.clamp(torch.minimum(min_pd1, min_pd2) + e2, max=INF)
    diag = torch.clamp(_shift_right(min_pm) + match_cost, max=INF)
    A = torch.minimum(diag, torch.minimum(D1, D2))
    if is_start_row or free_start:
        A[..., 0] = torch.clamp(A[..., 0], max=0)
    I1, I2 = insertion_rows_2p(A, o1, e1, 0, e2)
    M = torch.minimum(A, torch.minimum(I1, I2))
    return M, I1, I2, D1, D2
