"""Port parity: the plain batched Riccati solve (the CUDA kernel's plain
version) against the JAX oracle and the Pallas kernel in interpret mode,
and the kernel wrapper's CPU route and input checks.

The CUDA kernel itself needs the card: tests/test_torch_riccati_cuda.py
holds it against this plain version there, and `python3 chip_smoke.py` does
so at the main path's shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kissmpc_tpu.ops.lqr import kkt_residual as j_kkt_residual
from kissmpc_tpu.ops.lqr import solve_lqr_batched
from kissmpc_tpu.ops.pallas.riccati import solve_lqr_pallas
from kissmpc_tpu_torch.ops.lqr import LQRData, kkt_residual, solve_lqr
from kissmpc_tpu_torch.ops.lqr import solve_lqr_batched as t_solve_lqr_batched
from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda

from .test_lqr import _random_lqr


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: small tensors, beside other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batch(n, N):
    """The same random LQR batch as numpy arrays (per-scenario seeds)."""
    datas = [_random_lqr(seed, N=N) for seed in range(n)]
    return {f: np.stack([np.asarray(getattr(d, f)) for d in datas])
            for f in datas[0]._fields}


def _torch(arrays, dtype):
    return LQRData(**{k: torch.tensor(v, dtype=dtype) for k, v in arrays.items()})


def _jax(arrays, dtype):
    from kissmpc_tpu.ops.lqr import LQRData as JData

    return JData(**{k: jnp.asarray(v, dtype) for k, v in arrays.items()})


@pytest.mark.parametrize(
    "n,N,dtype,tol",
    [
        (4, 6, "float32", 2e-4),
        (3, 5, "float64", 1e-9),
        (5, 4, "float64", 1e-9),  # a batch that is not a multiple of the tile
    ],
)
def test_plain_riccati_matches_oracle_and_pallas(n, N, dtype, tol):
    arrays = _batch(n, N)
    reg = 1e-8 if dtype == "float32" else 0.0
    ours = solve_lqr(_torch(arrays, getattr(torch, dtype)), reg)
    jd = _jax(arrays, getattr(jnp, dtype))
    oracle = solve_lqr_batched(jd, reg)
    pallas = solve_lqr_pallas(jd, reg=reg, interpret=True, bt=8)
    for ref in (oracle, pallas):
        np.testing.assert_allclose(ours.dx.numpy(), np.asarray(ref.dx), rtol=tol, atol=tol)
        np.testing.assert_allclose(ours.du.numpy(), np.asarray(ref.du), rtol=tol, atol=tol)
    np.testing.assert_allclose(ours.K.numpy(), np.asarray(oracle.K), rtol=tol, atol=tol)
    np.testing.assert_allclose(ours.k.numpy(), np.asarray(oracle.k), rtol=tol, atol=tol)


def test_solve_lqr_batched_matches_jax():
    """The port's `solve_lqr_batched` (its batched `solve_lqr`) against the
    JAX package's vmapped `solve_lqr_batched` on a B=4 batch in float64,
    within 1e-9 as the plain solve above."""
    arrays = _batch(4, 6)
    ours = t_solve_lqr_batched(_torch(arrays, torch.float64), 0.0)
    ref = solve_lqr_batched(_jax(arrays, jnp.float64), 0.0)
    for name in ours._fields:
        np.testing.assert_allclose(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-9, err_msg=name)


def test_kkt_residual_matches():
    arrays = _batch(3, 7)
    td = _torch(arrays, torch.float64)
    sol = solve_lqr(td, 0.0)
    # A perturbed solution has a residual well above round-off.
    bumped = sol._replace(du=sol.du + 1e-3)
    jd = _jax(arrays, jnp.float64)
    for s in (sol, bumped):
        from kissmpc_tpu.ops.lqr import LQRSolution as JSol

        js = JSol(dx=jnp.asarray(s.dx.numpy()), du=jnp.asarray(s.du.numpy()),
                  K=jnp.asarray(s.K.numpy()), k=jnp.asarray(s.k.numpy()))
        ref = np.asarray(jax.vmap(j_kkt_residual)(jd, js))
        np.testing.assert_allclose(kkt_residual(td, s).numpy(), ref, rtol=1e-9, atol=1e-12)
    assert float(kkt_residual(td, sol).max()) < 1e-9


def test_wrapper_cpu_route_is_plain_and_uncounted():
    td = _torch(_batch(2, 5), torch.float64)
    before = solve_lqr_cuda.launches
    got = solve_lqr_cuda(td, 0.0)
    ref = solve_lqr(td, 0.0)
    assert solve_lqr_cuda.launches == before
    np.testing.assert_array_equal(got.dx.numpy(), ref.dx.numpy())
    np.testing.assert_array_equal(got.du.numpy(), ref.du.numpy())


@pytest.mark.parametrize("fault", ["shape", "dtype", "contiguity", "int"])
def test_wrapper_rejects_bad_input(fault):
    td = _torch(_batch(2, 5), torch.float64)
    if fault == "shape":
        bad, err = td._replace(qx=td.qx[:, :-1]), ValueError
    elif fault == "dtype":
        bad, err = td._replace(qu=td.qu.float()), TypeError
    elif fault == "contiguity":
        bad, err = td._replace(A=td.A.transpose(-1, -2)), ValueError
    else:
        bad, err = LQRData(*(x.to(torch.int32) for x in td)), TypeError
    with pytest.raises(err):
        solve_lqr_cuda(bad, 0.0)
