"""The parallel partition method for tridiagonal systems, in plain PyTorch.

The counterpart of ``repro.core.tridiag.partition`` and the port's reference
backend. With blocks of m rows, the interface unknowns are the *last*
unknown of every block, s_p = x[(p+1)m - 1]. Each block's (m-1)-row interior
couples only to s_{p-1} (through its first row) and s_p (through its last
interior row), so one Thomas factorization per block with three right-hand
sides expresses the interior as

    x_interior = y - v * s_{p-1} - w * s_p                       (spikes)

Substituting the neighbouring interiors into each block's *last* row yields
one equation per block in (s_{p-1}, s_p, s_{p+1}): the reduced tridiagonal
system of size P solved in Stage 2.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.tridiag.thomas import thomas, thomas_factor, thomas_solve_factored

Tensor = torch.Tensor


class PartitionCoeffs(NamedTuple):
    """Stage-1 output: per-block spike solutions + reduced-system rows."""

    y: Tensor  # (..., P, m-1) particular solution of interior
    v: Tensor  # (..., P, m-1) left spike  (coefficient of s_{p-1})
    w: Tensor  # (..., P, m-1) right spike (coefficient of s_p)
    red_dl: Tensor  # (..., P) reduced sub-diagonal
    red_d: Tensor  # (..., P) reduced diagonal
    red_du: Tensor  # (..., P) reduced super-diagonal
    red_b: Tensor  # (..., P) reduced RHS


def blockify(a: Tensor, m: int) -> Tensor:
    *lead, n = a.shape
    if n % m:
        raise ValueError(f"system size {n} not divisible by sub-system size {m}")
    return a.reshape(*lead, n // m, m)


def next_first_row(a: Tensor) -> Tensor:
    """Each block's next-block first spike row, zero past the last block.

    ``a`` is (..., P, m-1); the shift runs along the block axis only, so it
    never crosses from one system (leading index) into the next.
    """
    out = torch.zeros_like(a[..., :, 0])
    out[..., :-1] = a[..., 1:, 0]
    return out


def partition_stage1(dl: Tensor, d: Tensor, du: Tensor, b: Tensor, m: int) -> PartitionCoeffs:
    """Parallel intra-block elimination (GPU Stage 1 in the paper)."""
    if m < 2:
        raise ValueError("sub-system size m must be >= 2")
    dlb, db, dub, bb = (blockify(a, m) for a in (dl, d, du, b))
    # Interior rows are local indices 0..m-2 of each block.
    int_dl = dlb[..., :, : m - 1].clone()
    int_dl[..., :, 0] = 0.0
    int_d = db[..., :, : m - 1]
    int_du = dub[..., :, : m - 1].clone()
    int_du[..., :, m - 2] = 0.0

    factors = thomas_factor(int_dl, int_d, int_du)
    # Three RHS: particular (b), left spike (a_first e_0), right spike
    # (c_last_interior e_{m-2}).
    rhs = torch.zeros(int_d.shape + (3,), dtype=int_d.dtype, device=int_d.device)
    rhs[..., 0] = bb[..., :, : m - 1]
    rhs[..., :, 0, 1] = dlb[..., :, 0]
    rhs[..., :, m - 2, 2] = dub[..., :, m - 2]
    sol = thomas_solve_factored(factors, rhs)
    y, v, w = sol[..., 0], sol[..., 1], sol[..., 2]

    return assemble_reduced(dlb, db, dub, bb, y, v, w)


def assemble_reduced(
    dlb: Tensor, db: Tensor, dub: Tensor, bb: Tensor, y: Tensor, v: Tensor, w: Tensor
) -> PartitionCoeffs:
    """Reduced rows from each block's last row and the spikes.

    Operands are blocked (..., P, m), spikes (..., P, m-1). The last row of
    block p reads aL x[last interior] + bL s_p + cL x[first of next] = dL;
    substituting the spikes gives one equation in (s_{p-1}, s_p, s_{p+1}).
    """
    m = db.shape[-1]
    aL = dlb[..., :, m - 1]
    bL = db[..., :, m - 1]
    cL = dub[..., :, m - 1]  # 0 for the final block by convention
    dL = bb[..., :, m - 1]

    y_last, v_last, w_last = y[..., :, m - 2], v[..., :, m - 2], w[..., :, m - 2]
    y_nf, v_nf, w_nf = next_first_row(y), next_first_row(v), next_first_row(w)

    red_dl = -aL * v_last
    red_d = bL - aL * w_last - cL * v_nf
    red_du = -cL * w_nf
    red_b = dL - aL * y_last - cL * y_nf
    return PartitionCoeffs(y, v, w, red_dl, red_d, red_du, red_b)


def partition_stage2(coeffs: PartitionCoeffs) -> Tensor:
    """Serial reduced solve of size P (CPU Stage 2 in the paper)."""
    return thomas(coeffs.red_dl, coeffs.red_d, coeffs.red_du, coeffs.red_b)


def shift_right(s: Tensor, left: Optional[Tensor] = None) -> Tensor:
    """``s_{p-1}`` for every block: ``s`` shifted right by one along the
    block axis, with ``left`` (default 0) at each system's first block."""
    s_left = torch.empty_like(s)
    s_left[..., 1:] = s[..., :-1]
    s_left[..., 0] = 0.0 if left is None else left
    return s_left


def partition_stage3(
    coeffs: PartitionCoeffs, s: Tensor, left: Optional[Tensor] = None
) -> Tensor:
    """Parallel back-substitution: x_interior = y - v s_{p-1} - w s_p.

    ``left`` (shape ``s.shape[:-1]``) is s_{p-1} of each system's first block:
    zero for a whole system, the neighbouring chunk's last interface value
    when the blocks are one chunk of a longer fused system.
    """
    s_left = shift_right(s, left)
    x_int = coeffs.y - coeffs.v * s_left[..., :, None] - coeffs.w * s[..., :, None]
    x_blocks = torch.cat([x_int, s[..., :, None]], dim=-1)
    *lead, p, m = x_blocks.shape
    return x_blocks.reshape(*lead, p * m)


def partition_solve(dl: Tensor, d: Tensor, du: Tensor, b: Tensor, m: int = 10) -> Tensor:
    """Full three-stage partition solve. Batched over leading dims of inputs."""
    coeffs = partition_stage1(dl, d, du, b, m)
    s = partition_stage2(coeffs)
    return partition_stage3(coeffs, s)
