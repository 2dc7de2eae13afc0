"""The CUDA Riccati kernel's own source, rehearsed on the CPU.

`scripts/riccati_cpu_shim.py` compiles `kissmpc_tpu_torch/csrc/riccati.cu`
with g++ behind a header that stands in for the CUDA runtime (a
`std::thread` per CUDA thread, a `std::barrier` per block for
`__syncthreads`, the staging's asynchronous copy as a plain copy, shared
memory a 0xff-filled vector of the launch's exact size).  Here that build
is held against the plain version `ops/lqr.py::solve_lqr` by chip_smoke.py's
phase-2 gate (each output dx, du, K, k of each scenario within its own
tolerance), at ragged batches around the block's scenario count, and
against the JAX Pallas kernel in interpret mode; the build's host
functions give the longest horizon whose gains stay on chip, and one step
above it the global-gains instance is held to the same gate.  The tests skip where g++ is missing;
they cannot see what only the card shows (ptxas, the real bulk copies,
speed).
"""

import importlib.util
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kissmpc_tpu.ops.lqr import LQRData as JData
from kissmpc_tpu.ops.pallas.riccati import solve_lqr_pallas
from kissmpc_tpu_torch.ops.lqr import LQRData, solve_lqr

from .test_lqr import _random_lqr

ROOT = Path(__file__).resolve().parents[1]
REG = 1e-8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tests run beside others in parallel
    workers, where many threads per worker only contend for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _shim_module():
    spec = importlib.util.spec_from_file_location(
        "riccati_cpu_shim", ROOT / "scripts" / "riccati_cpu_shim.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (C++20) to compile the kernel's source for the CPU")
    module = _shim_module()
    return module, module.build(tmp_path_factory.mktemp("riccati_shim"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("N", [1, 12, 50, 100, 200])
@pytest.mark.parametrize("batch", ["S-1", "S", "S+1", "2S+3"])
def test_shim_matches_plain(shim, dtype, N, batch):
    """Ragged batches around the block's scenario count S; at N=100 both
    sweeps reuse a chunk buffer; at N=200 in f64 the ring of 32 steps does
    not fit beside the gains, so these small batches take chunks of 16."""
    module, lib = shim
    S = module.scenarios_per_block(lib, N)
    B = {"S-1": S - 1, "S": S, "S+1": S + 1, "2S+3": 2 * S + 3}[batch]
    data = module.random_data(B, N, seed=B + N, dtype=dtype)
    if batch == "2S+3":  # no tensor starting on 16 bytes: the staging's head peel
        data = module.shifted(data)
    gate = module.compare(module.run(lib, data, REG), data, REG)
    assert gate["ok"], module.describe(gate)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_shim_matches_plain_large_batch(shim, dtype):
    """B=1025, just above the batch where the launcher takes its shorter
    chunks (the kernel's other instance), at N=12."""
    module, lib = shim
    data = module.random_data(1025, 12, seed=7, dtype=dtype)
    gate = module.compare(module.run(lib, data, REG), data, REG)
    assert gate["ok"], module.describe(gate)


@pytest.mark.parametrize("dtype,N", [(torch.float32, 757), (torch.float64, 307)],
                         ids=["f32", "f64"])
def test_shim_global_gains_above_max_horizon(shim, dtype, N):
    """One step above the longest horizon whose gains stay on chip, the
    launcher takes the instance that keeps them in the gains output (the
    sweep writes them there, the rollout reads them back); B=9 leaves a
    ragged second block whose idle lanes must write no gains."""
    module, lib = shim
    assert lib.kissmpc_riccati_max_horizon(4 if dtype == torch.float32 else 8) == N - 1
    data = module.random_data(9, N, seed=N, dtype=dtype)
    gate = module.compare(module.run(lib, data, REG), data, REG)
    assert gate["ok"], module.describe(gate)


SMEM_OPTIN = 227 * 1024  # dynamic shared memory a block may take on sm_90


@pytest.mark.parametrize("size,most", [(4, 756), (8, 306)], ids=["f32", "f64"])
def test_shim_horizon_limit_is_the_same_at_every_batch(shim, size, most):
    """The longest horizon fits at every batch and one step more fits at
    none, so a solve is refused before any work or not at all; a batch at
    or below 1024 whose ring of 32 steps does not fit takes the ring of 16,
    as one above 1024 does."""
    _, lib = shim
    assert lib.kissmpc_riccati_max_horizon(size) == most
    for B in (1, 9, 164, 1024, 1025, 8192):
        assert lib.kissmpc_riccati_smem_bytes(B, most, size) <= SMEM_OPTIN
        assert lib.kissmpc_riccati_smem_bytes(B, most + 1, size) > SMEM_OPTIN
    for N in (50, 162, 163, 200, most):
        small, large = (lib.kissmpc_riccati_smem_bytes(B, N, size) for B in (1024, 1025))
        assert large <= small <= SMEM_OPTIN
    assert lib.kissmpc_riccati_smem_bytes(1024, 163, 8) == lib.kissmpc_riccati_smem_bytes(
        1025, 163, 8)


@pytest.fixture(scope="module")
def pallas_f64():
    """Nine scenarios at N=12 as numpy arrays, and the JAX Pallas kernel's
    float64 dx, du for them (interpret mode, bt=8, as
    tests/test_pallas_riccati.py runs it; one call, ~30 s on the CPU)."""
    datas = [_random_lqr(seed, N=12) for seed in range(9)]
    arrays = {f: np.stack([np.asarray(getattr(d, f)) for d in datas]) for f in datas[0]._fields}
    ref = solve_lqr_pallas(JData(**{k: jnp.asarray(v, jnp.float64) for k, v in arrays.items()}),
                           reg=REG, interpret=True, bt=8)
    return arrays, np.asarray(ref.dx), np.asarray(ref.du)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_shim_matches_jax_pallas(shim, pallas_f64, dtype):
    """dx and du at N=12 against the JAX Pallas kernel in float64: within
    1e-9 of the scale in f64; in f32 within phase 2's 1e-4 of the scale
    plus twice the plain version's own f32 gap to that f64 solution."""
    module, lib = shim
    arrays, ref_dx, ref_du = pallas_f64
    data = LQRData(**{k: torch.tensor(v, dtype=dtype) for k, v in arrays.items()})
    got = module.run(lib, data, REG)
    scale = max(1.0, np.abs(ref_dx).max(), np.abs(ref_du).max())

    def gap(sol):
        return max(np.abs(sol.dx.double().numpy() - ref_dx).max(),
                   np.abs(sol.du.double().numpy() - ref_du).max())

    if dtype == torch.float64:
        tol = 1e-9 * scale
    else:
        tol = 1e-4 * scale + 2.0 * gap(solve_lqr(data, REG))
    assert gap(got) <= tol, (gap(got), tol)
