"""Parallel-in-time LQR: the backward pass as one associative scan of depth
O(log N).  Port of `kissmpc_tpu/ops/lqr_pt.py`, batch-major.

The sequential Riccati sweep (`ops/lqr.py`, and the CUDA kernel behind
`ops/riccati.py`) has O(N) depth.  The LQR value functions form a monoid
under composition (Sarkka & Garcia-Fernandez, "Temporal Parallelization of
Dynamic Programming and Linear Quadratic Tracking", 2021), so the backward
pass is one associative scan, and the forward state recovery reuses its
suffix elements.

Element of the conditional value function between two times: (A, b, C,
eta, J), x_j reachable as A x_i + b + C-weighted freedom, tail cost
1/2 x'Jx - eta'x.  Composition (only (I + C_i J_j)^-1 appears; C may be
singular):

    D    = (I + C_i J_j)^-1
    A_ij = A_j D A_i
    b_ij = A_j D (b_i + C_i eta_j) + b_j
    C_ij = A_j D C_i A_j' + C_j
    E    = (I + J_j C_i)^-1
    eta  = A_i' E (eta_j - J_j b_i) + eta_i
    J_ij = A_i' E J_j A_i + J_i

Stage init folds the linear control cost into the defect by completing the
square (u~ = u + Quu^-1 qu):

    A_k = A_t,  b_k = d_t - B Quu^-1 qu,  C_k = B Quu^-1 B',
    eta_k = -qx_t,  J_k = Qxx_t;    terminal: (0, 0, 0, -qx_N, Qxx_N).

torch has no public associative scan, so `associative_scan` follows
`jax.lax.associative_scan`'s odd/even recursion: the same elements are
combined in the same order as in the reference.  Plain PyTorch: there is no
TPU kernel behind the reference, and on the card the Riccati kernel is the
yardstick it is held against.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from .lqr import LQRData, LQRSolution


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _combine(ei, ej):
    """Associative combination of value-function elements (batched over
    leading axes)."""
    Ai, bi, Ci, etai, Ji = ei
    Aj, bj, Cj, etaj, Jj = ej
    I = torch.eye(Ai.shape[-1], dtype=Ai.dtype, device=Ai.device)
    D = torch.linalg.inv(I + Ci @ Jj)
    E = torch.linalg.inv(I + Jj @ Ci)
    AjD = Aj @ D
    A = AjD @ Ai
    b = _mv(AjD, bi + _mv(Ci, etaj)) + bj
    C = AjD @ Ci @ Aj.transpose(-1, -2) + Cj
    AiT = Ai.transpose(-1, -2)
    eta = _mv(AiT @ E, etaj - _mv(Jj, bi)) + etai
    J = AiT @ E @ Jj @ Ai + Ji
    return (A, b, C, eta, J)


def associative_scan(fn: Callable, elems: List[torch.Tensor], reverse: bool = False,
                     dim: int = 1) -> List[torch.Tensor]:
    """Inclusive scan of ``fn`` over ``dim`` of every tensor in ``elems``,
    by `jax.lax.associative_scan`'s recursion: combine adjacent pairs, scan
    the half-length sequence, then fill in the even positions.  ``fn``
    takes and returns lists of tensors shaped like ``elems``."""
    if reverse:
        elems = [e.flip(dim) for e in elems]

    def sl(e, start, stop=None, step=1):
        index = [slice(None)] * e.dim()
        index[dim] = slice(start, stop, step)
        return e[tuple(index)]

    def interleave(even, odd):
        shape = list(even.shape)
        shape[dim] += odd.shape[dim]
        out = even.new_empty(shape)
        index = [slice(None)] * even.dim()
        index[dim] = slice(0, None, 2)
        out[tuple(index)] = even
        index[dim] = slice(1, None, 2)
        out[tuple(index)] = odd
        return out

    def scan(elems):
        n = elems[0].shape[dim]
        if n < 2:
            return elems
        reduced = fn([sl(e, 0, -1, 2) for e in elems], [sl(e, 1, None, 2) for e in elems])
        odd = scan(list(reduced))
        if n % 2 == 0:
            even = fn([sl(e, 0, -1) for e in odd], [sl(e, 2, None, 2) for e in elems])
        else:
            even = fn(odd, [sl(e, 2, None, 2) for e in elems])
        even = [torch.cat([sl(e, 0, 1), r], dim=dim) for e, r in zip(elems, even)]
        return [interleave(e, o) for e, o in zip(even, odd)]

    out = scan(list(elems))
    return [e.flip(dim) for e in out] if reverse else out


def backward_pass(data: LQRData, reg: float = 0.0):
    """The associative scan: (Quu + reg I, eta_tail, J_tail), the tail
    value function V_t(x) = 1/2 x'J_tail[t] x - eta_tail[t]'x at every time
    t = 0..N ([B, N+1, ...])."""
    Bsz, N, nx = data.d.shape
    nu = data.qu.shape[-1]
    dtype, device = data.A.dtype, data.A.device
    I_u = torch.eye(nu, dtype=dtype, device=device)

    Quu_r = data.Quu + reg * I_u
    Quu_inv = torch.linalg.inv(Quu_r)  # [B, N, nu, nu]
    # complete the square on the linear control cost
    u_shift = torch.einsum("btij,btj->bti", Quu_inv, data.qu)  # Quu^-1 qu
    b_stage = data.d - torch.einsum("btij,btj->bti", data.B, u_shift)
    C_stage = torch.einsum("btik,btkl,btjl->btij", data.B, Quu_inv, data.B)  # B Quu^-1 B'

    # elements 0..N-1 are stages, element N is terminal
    zeros = lambda *shape: torch.zeros((Bsz, 1) + shape, dtype=dtype, device=device)  # noqa: E731
    A_el = torch.cat([data.A, zeros(nx, nx)], dim=1)
    b_el = torch.cat([b_stage, zeros(nx)], dim=1)
    C_el = torch.cat([C_stage, zeros(nx, nx)], dim=1)
    eta_el = -data.qx  # [B, N+1, nx]
    J_el = data.Qxx  # [B, N+1, nx, nx]

    # Backward pass: suffix combinations give the tail value function at
    # each time: V_t(x) = 1/2 x'J x - eta'x.  A reverse scan hands the
    # operator (accumulated-later, new-earlier); _combine takes (earlier,
    # later), so swap.
    suffix = associative_scan(lambda a, b: _combine(b, a),
                              [A_el, b_el, C_el, eta_el, J_el], reverse=True)
    return Quu_r, suffix[3], suffix[4]


def solve_lqr_associative(data: LQRData, reg: float = 0.0) -> LQRSolution:
    """LQR solve of a batch (leaves [B, N, ...]) with an associative-scan
    backward pass (same contract as `ops/lqr.py::solve_lqr`).

    K/k feedback gains are not produced (zeros returned), as in the
    reference.
    """
    Bsz, N, nx = data.d.shape
    nu = data.qu.shape[-1]
    dtype, device = data.A.dtype, data.A.device
    Quu_r, eta_tail, J_tail = backward_pass(data, reg)

    # Forward pass: sequential state recovery from the tail value functions.
    dx = [data.d0]
    du = []
    for t in range(N):
        A_t, B_t = data.A[:, t], data.B[:, t]
        Jn, en = J_tail[:, t + 1], eta_tail[:, t + 1]
        BT = B_t.transpose(-1, -2)
        M = Quu_r[:, t] + BT @ Jn @ B_t
        rhs = data.qu[:, t] + _mv(BT, _mv(Jn, _mv(A_t, dx[-1]) + data.d[:, t]) - en)
        du_t = -torch.linalg.solve(M, rhs)
        du.append(du_t)
        dx.append(_mv(A_t, dx[-1]) + _mv(B_t, du_t) + data.d[:, t])
    return LQRSolution(
        dx=torch.stack(dx, dim=1),
        du=torch.stack(du, dim=1),
        K=torch.zeros((Bsz, N, nu, nx), dtype=dtype, device=device),
        k=torch.zeros((Bsz, N, nu), dtype=dtype, device=device),
    )


# Batch-major already: the batched name is the same function.
solve_lqr_associative_batched = solve_lqr_associative
