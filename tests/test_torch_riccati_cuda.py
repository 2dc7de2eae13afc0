"""The CUDA Riccati kernel against its plain PyTorch version, on the card.

Marked ``cuda``: it skips without an NVIDIA GPU (the kernel has no CPU
mode).  It imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_riccati_cuda.py
"""

import numpy as np
import pytest
import torch

from kissmpc_tpu_torch.ops.lqr import LQRData, solve_lqr
from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda


def _random_batch(B, N, seed=0):
    """Random well-posed LQR data: near-identity dynamics, SPD costs."""
    rng = np.random.default_rng(seed)

    def spd(n, count):
        m = rng.normal(size=(B, count, n, n))
        return m @ np.swapaxes(m, -1, -2) * 0.3 + np.eye(n) * 0.5

    return dict(
        A=rng.normal(size=(B, N, 3, 3)) * 0.1 + np.eye(3),
        B=rng.normal(size=(B, N, 3, 2)) * 0.5,
        d=rng.normal(size=(B, N, 3)) * 0.1,
        d0=rng.normal(size=(B, 3)) * 0.1,
        Qxx=spd(3, N + 1),
        qx=rng.normal(size=(B, N + 1, 3)),
        Quu=spd(2, N),
        qu=rng.normal(size=(B, N, 2)),
    )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 37, 300])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("float64", 1e-9)])
def test_cuda_kernel_matches_plain(cuda, B, dtype, tol):
    arrays = _random_batch(B, 20)
    td = LQRData(**{k: torch.tensor(v, dtype=getattr(torch, dtype)) for k, v in arrays.items()})
    ref = solve_lqr(td, 1e-8)
    before = solve_lqr_cuda.launches
    got = solve_lqr_cuda(LQRData(*(x.cuda() for x in td)), 1e-8)
    torch.cuda.synchronize()
    assert solve_lqr_cuda.launches == before + 1
    for a, b in ((got.dx, ref.dx), (got.du, ref.du), (got.K, ref.K), (got.k, ref.k)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_kernel_rejects_mixed_devices(cuda):
    td = LQRData(**{k: torch.tensor(v, dtype=torch.float32)
                    for k, v in _random_batch(4, 5).items()})
    mixed = LQRData(*(x.cuda() for x in td))._replace(qu=td.qu)
    with pytest.raises(TypeError):
        solve_lqr_cuda(mixed, 0.0)
