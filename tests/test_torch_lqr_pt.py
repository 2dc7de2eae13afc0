"""The port's associative-scan LQR (`kissmpc_tpu_torch/ops/lqr_pt.py`)
against the JAX package's and against the port's sequential Riccati solve,
on `tests/test_lqr.py`'s random LQR data, in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kissmpc_tpu.ops.lqr_pt import solve_lqr_associative as j_solve_associative
from kissmpc_tpu_torch.ops.lqr import LQRData, solve_lqr
from kissmpc_tpu_torch.ops.lqr_pt import (
    associative_scan,
    solve_lqr_associative,
    solve_lqr_associative_batched,
)

from .test_lqr import _random_lqr

# (seed, N, reg, tolerance against JAX, tolerance against solve_lqr): the
# cases of tests/test_lqr_pt.py.
CASES = [(0, 16, 0.0, 1e-9, 1e-7), (1, 16, 0.0, 1e-9, 1e-7), (2, 16, 0.0, 1e-9, 1e-7),
         (42, 256, 1e-9, 1e-7, 1e-5)]


def _port(data) -> LQRData:
    """A JAX LQRData of one scenario as the port's batch of one."""
    return LQRData(*(torch.tensor(np.asarray(x))[None] for x in data))


@pytest.mark.parametrize("seed,N,reg,tol_jax,tol_seq", CASES)
def test_associative_matches_jax(seed, N, reg, tol_jax, tol_seq):
    data = _random_lqr(seed, N=N)
    ref = jax.jit(j_solve_associative, static_argnums=1)(data, reg)
    got = solve_lqr_associative(_port(data), reg)
    np.testing.assert_allclose(got.dx[0].numpy(), np.asarray(ref.dx), atol=tol_jax, rtol=0)
    np.testing.assert_allclose(got.du[0].numpy(), np.asarray(ref.du), atol=tol_jax, rtol=0)
    assert not got.K.any() and not got.k.any()
    assert got.K.shape == (1, N, 2, 3) and got.k.shape == (1, N, 2)


@pytest.mark.parametrize("seed,N,reg,tol_jax,tol_seq", CASES)
def test_associative_matches_riccati(seed, N, reg, tol_jax, tol_seq):
    data = _port(_random_lqr(seed, N=N))
    seq = solve_lqr(data, reg)
    par = solve_lqr_associative(data, reg)
    np.testing.assert_allclose(par.dx.numpy(), seq.dx.numpy(), atol=tol_seq, rtol=0)
    np.testing.assert_allclose(par.du.numpy(), seq.du.numpy(), atol=tol_seq, rtol=0)


def test_associative_batched():
    """Three scenarios as one batch: each equal to its own solve, and within
    1e-7 of the sequential solve (tests/test_lqr_pt.py's batched case)."""
    datas = [_random_lqr(100 + i, N=12) for i in range(3)]
    batch = LQRData(*(torch.cat(xs) for xs in zip(*(_port(d) for d in datas))))
    par = solve_lqr_associative_batched(batch, 0.0)
    for i, d in enumerate(datas):
        alone = solve_lqr_associative(_port(d), 0.0)
        np.testing.assert_array_equal(par.du[i].numpy(), alone.du[0].numpy())
        seq = solve_lqr(_port(d), 0.0)
        np.testing.assert_allclose(par.du[i].numpy(), seq.du[0].numpy(), atol=1e-7, rtol=0)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_matches_jax_order(n, reverse):
    """The scan combines in `jax.lax.associative_scan`'s order: with a
    non-associative operator on integers (exact, so only the order of
    combination can differ) the results are equal."""
    x = np.random.default_rng(n).integers(-9, 10, size=(n, 3))
    ref = jax.lax.associative_scan(lambda a, b: 2 * a - b, jnp.asarray(x), reverse=reverse)
    got = associative_scan(lambda a, b: [2 * a[0] - b[0]], [torch.tensor(x)[None]],
                           reverse=reverse)[0][0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
