"""The CUDA Riccati kernel against its plain PyTorch version, on the card.

Marked ``cuda``: it skips without an NVIDIA GPU (the kernel has no CPU
mode).  It imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_riccati_cuda.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from kissmpc_tpu_torch.ops import riccati
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


def _check_gate(B, N, dtype, seed):
    """The kernel on B random scenarios of horizon N against the plain
    version, by chip_smoke.py's phase-2 gate: each output (dx, du, K, k) of
    each scenario within its own tolerance (f32: 1e-4 of its scale plus
    four times the plain version's own f32-vs-f64 gap there; f64: 1e-9 of its
    scale)."""
    td = LQRData(**{k: torch.tensor(v, dtype=dtype) for k, v in _random_batch(B, N, seed).items()})
    got = solve_lqr_cuda(LQRData(*(x.cuda() for x in td)), 1e-8)
    torch.cuda.synchronize()
    gate = chip_smoke.riccati_gate(tuple(x.cpu() for x in got), td, 1e-8)
    assert gate["ok"], gate["outputs"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("N", [1, 12, 50, 120])
@pytest.mark.parametrize("batch", ["S-1", "S", "S+1", "2S+3", "4096+3"])
def test_cuda_kernel_ragged_batches(cuda, dtype, N, batch):
    """dx, du, K, k at batches around the block's scenario count S and at
    one above the batch where the launcher changes its chunk length."""
    S = riccati.occupancy(1, N, dtype)["scenarios_per_block"]
    B = {"S-1": S - 1, "S": S, "S+1": S + 1, "2S+3": 2 * S + 3, "4096+3": 4099}[batch]
    _check_gate(B, N, dtype, seed=N)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("B", [9, 1024, 1025])
def test_cuda_kernel_long_horizon(cuda, dtype, B):
    """N=200, where in f64 the ring of 32 steps does not fit beside the
    gains at B <= 1024 and the launcher takes chunks of 16 as above it; the
    same horizon is taken at every batch."""
    assert riccati.max_horizon(dtype) >= 200
    occ = riccati.occupancy(B, 200, dtype)
    assert occ["blocks_per_sm"] >= 1
    _check_gate(B, 200, dtype, seed=B)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("B", [9, 1025])
def test_cuda_kernel_refusal_raises(cuda, dtype, B):
    """N=2000, whose gains do not fit in shared memory, is no longer
    refused: the launcher takes the instance that keeps the gains in the
    output, with the ring alone in shared memory, and the solve passes the
    phase-2 gate with one launch."""
    N = 2000
    assert N > riccati.max_horizon(dtype)
    occ = riccati.occupancy(B, N, dtype)
    assert occ["blocks_per_sm"] >= 1
    size = 4 if dtype == torch.float32 else 8
    ring = riccati._library().kissmpc_riccati_smem_bytes(B, 0, size)  # no gains kept
    assert occ["smem_bytes_per_block"] == ring
    before = solve_lqr_cuda.launches
    _check_gate(B, N, dtype, seed=B)
    assert solve_lqr_cuda.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cuda_kernel_just_above_max_horizon(cuda, dtype):
    """One step above the longest horizon whose gains stay on chip (N=757
    in f32, 307 in f64), at B=9: the global-gains instance's first horizon."""
    N = riccati.max_horizon(dtype) + 1
    _check_gate(9, N, dtype, seed=N)
