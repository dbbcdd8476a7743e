"""Row-update primitives of the gap-affine POA wavefront fill, on int32
PyTorch tensors.  Port of ``poasta_tpu/ops/dp_rows.py`` (same recurrence,
same clamps; see that module for the derivation):

    D[r, j] = min_p min(M[p, j] + o + e,  D[p, j] + e)
    diag[r, j] = min_p M[p, j-1] + (0 if sym(r) == q[j-1] else x)
    A[r, j] = min(diag[r, j], D[r, j])
    I[r, j] = min_{k < j} A[r, k] + o + e * (j - k)
    M[r, j] = min(A[r, j], I[r, j])
"""

from __future__ import annotations

import torch

INF = 1 << 28


def _shift_right(t: torch.Tensor, k: int = 1) -> torch.Tensor:
    """t[..., j-k] at lane j, INF at lanes < k."""
    pad = torch.full(t.shape[:-1] + (k,), INF, dtype=t.dtype, device=t.device)
    return torch.cat([pad, t[..., :-k]], dim=-1)


def insertion_row(A: torch.Tensor, gap_open: int,
                  gap_extend: int) -> torch.Tensor:
    """Closed-form affine insertion row from the A = min(diag, D) row.

    A: (..., L) int32.  Returns I with I[..., 0] = INF.
    """
    L = A.shape[-1]
    j = torch.arange(L, dtype=torch.int32, device=A.device)
    p = torch.cummin(A - gap_extend * j, dim=-1).values
    I = _shift_right(p) + gap_open + gap_extend * j
    return torch.clamp(I, max=INF)


def row_update(pred_M: torch.Tensor, pred_D: torch.Tensor,
               pred_mask: torch.Tensor, match_cost: torch.Tensor,
               gap_open: int, gap_extend: int, is_start_row: bool,
               free_start: bool):
    """One rank-row update.

    pred_M, pred_D: (..., P, L) gathered predecessor rows.  pred_mask:
    (P,) bool, the valid predecessors.  match_cost: (..., L).  Returns
    (M, I, D) rows of shape (..., L).
    """
    mask = pred_mask.reshape((1,) * (pred_M.ndim - 2) + (-1, 1))
    pm = torch.where(mask, pred_M, INF)
    pd = torch.where(mask, pred_D, INF)
    min_pm = pm.min(dim=-2).values
    min_pd = pd.min(dim=-2).values
    D = torch.clamp(torch.minimum(min_pm + gap_open + gap_extend,
                                  min_pd + gap_extend), max=INF)
    diag = torch.clamp(_shift_right(min_pm) + match_cost, max=INF)
    A = torch.minimum(diag, D)
    if is_start_row or free_start:
        A[..., 0] = torch.clamp(A[..., 0], max=0)
    I = insertion_row(A, gap_open, gap_extend)
    M = torch.minimum(A, I)
    return M, I, D
