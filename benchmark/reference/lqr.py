"""Frozen copy of `kissmpc_tpu_torch/ops/lqr.py` at commit d587314.

Part of the benchmark's plain reference: it imports nothing of the port,
of the JAX package or of JAX, so later changes to the port leave the
yardstick where it is.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LQRData(NamedTuple):
    A: torch.Tensor  # [B, N, 3, 3]
    B: torch.Tensor  # [B, N, 3, 2]
    d: torch.Tensor  # [B, N, 3]   defect: f(x_t, u_t) - x_{t+1}
    d0: torch.Tensor  # [B, 3]      initial pin residual: x_init - x_0
    Qxx: torch.Tensor  # [B, N+1, 3, 3]
    qx: torch.Tensor  # [B, N+1, 3]
    Quu: torch.Tensor  # [B, N, 2, 2]
    qu: torch.Tensor  # [B, N, 2]


class LQRSolution(NamedTuple):
    dx: torch.Tensor  # [B, N+1, 3]
    du: torch.Tensor  # [B, N, 2]
    K: torch.Tensor  # [B, N, 2, 3] feedback gains
    k: torch.Tensor  # [B, N, 2]


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _inv2x2(M: torch.Tensor, reg) -> torch.Tensor:
    """Closed-form inverse of a batched 2x2 with diagonal regularization."""
    a = M[..., 0, 0] + reg
    b = M[..., 0, 1]
    c = M[..., 1, 0]
    d = M[..., 1, 1] + reg
    inv_det = 1.0 / (a * d - b * c)
    return torch.stack(
        [
            torch.stack([d * inv_det, -b * inv_det], dim=-1),
            torch.stack([-c * inv_det, a * inv_det], dim=-1),
        ],
        dim=-2,
    )


def solve_lqr(data: LQRData, reg: float = 0.0) -> LQRSolution:
    """Riccati backward sweep + forward rollout over a batch of scenarios."""
    N = data.A.shape[1]
    P, p = data.Qxx[:, N], data.qx[:, N]
    Ks = [None] * N
    ks = [None] * N
    for t in range(N - 1, -1, -1):
        A, Bm, d = data.A[:, t], data.B[:, t], data.d[:, t]
        BT = Bm.transpose(-1, -2)
        AT = A.transpose(-1, -2)
        Pd_p = _mv(P, d) + p
        PA = P @ A
        PB = P @ Bm
        Quu_hat = data.Quu[:, t] + BT @ PB
        Qux_hat = BT @ PA
        qu_hat = data.qu[:, t] + _mv(BT, Pd_p)
        Quu_inv = _inv2x2(Quu_hat, reg)
        K = -(Quu_inv @ Qux_hat)
        k = -_mv(Quu_inv, qu_hat)
        QuxT = Qux_hat.transpose(-1, -2)
        P_new = data.Qxx[:, t] + AT @ PA + QuxT @ K
        P = 0.5 * (P_new + P_new.transpose(-1, -2))
        p = data.qx[:, t] + _mv(AT, Pd_p) + _mv(QuxT, k)
        Ks[t], ks[t] = K, k

    dx = [data.d0]
    du = []
    for t in range(N):
        u = _mv(Ks[t], dx[-1]) + ks[t]
        du.append(u)
        dx.append(_mv(data.A[:, t], dx[-1]) + _mv(data.B[:, t], u) + data.d[:, t])
    return LQRSolution(
        dx=torch.stack(dx, dim=1),
        du=torch.stack(du, dim=1),
        K=torch.stack(Ks, dim=1),
        k=torch.stack(ks, dim=1),
    )


# The reference's `jax.vmap(solve_lqr, in_axes=(0, None))`
# (`kissmpc_tpu/ops/lqr.py:119`): this `solve_lqr` is batched already.
solve_lqr_batched = solve_lqr


def kkt_residual(data: LQRData, sol: LQRSolution) -> torch.Tensor:
    """Per-scenario inf-norm KKT residual of an LQR solution ([B]).

    Adjoint recursion lambda_N = Qxx_N dx_N + qx_N,
    lambda_t = Qxx_t dx_t + qx_t + A_t' lambda_{t+1}; checks control
    stationarity, dynamics feasibility and the initial pin.
    """
    dx, du = sol.dx, sol.du
    N = data.A.shape[1]
    lam = _mv(data.Qxx[:, N], dx[:, N]) + data.qx[:, N]
    lam_next = [None] * N
    for t in range(N - 1, -1, -1):
        lam_next[t] = lam
        lam = (
            _mv(data.Qxx[:, t], dx[:, t])
            + data.qx[:, t]
            + _mv(data.A[:, t].transpose(-1, -2), lam)
        )
    lam_next = torch.stack(lam_next, dim=1)  # [B, N, 3]
    stat = (
        torch.einsum("btij,btj->bti", data.Quu, du)
        + data.qu
        + torch.einsum("btji,btj->bti", data.B, lam_next)
    )
    dyn = (
        torch.einsum("btij,btj->bti", data.A, dx[:, :-1])
        + torch.einsum("btij,btj->bti", data.B, du)
        + data.d
        - dx[:, 1:]
    )
    pin = data.d0 - dx[:, 0]
    return torch.stack(
        [
            torch.amax(torch.abs(stat), dim=(1, 2)),
            torch.amax(torch.abs(dyn), dim=(1, 2)),
            torch.amax(torch.abs(pin), dim=1),
        ]
    ).amax(dim=0)
