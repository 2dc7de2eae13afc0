"""The fused kernel's own source, rehearsed on the CPU: its warps per block
and horizon limit.

`scripts/fused_cpu_shim.py` compiles `kissmpc_tpu_torch/csrc/ipm_fused.cu`
with g++ behind a header that stands in for the CUDA runtime (a
`std::thread` per lane, a `std::barrier` per warp for `__syncwarp`, shared
memory a NaN-filled vector of the launch's exact size, `blockDim` set, and
sm_90's 227 KB of opt-in shared memory per block).  Here the build's host
function gives the longest horizon the kernel takes, for each obstacle
form, and the launcher's warps per block are held at 4 at N=50 and at 2
and 1 at longer horizons, where the build is held against the plain
version `solve_batch_fused_plain` by chip_smoke.py's phase-4 gate at a few
iterations (within 1e-4 of the solution's scale plus twice the plain
version's own f32-vs-f64 gap).  The tests skip where g++ is missing; they
cannot see what only the card shows (ptxas, a refused launch, speed).
"""

import ctypes
import importlib.util
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SMEM_OPTIN = 227 * 1024  # dynamic shared memory a block may take on sm_90


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
        "fused_cpu_shim", ROOT / "scripts" / "fused_cpu_shim.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (C++20) to compile the kernel's source for the CPU")
    module = _shim_module()
    return module, module.build(tmp_path_factory.mktemp("fused_shim"), None, False)


def _occupancy(lib, N, K, elastic, affine):
    out = (ctypes.c_int * 5)()
    assert lib.kissmpc_ipm_fused_occupancy(N, K, int(elastic), int(affine), out) == 0
    return {"warps": out[0], "smem": out[1]}


# (K, elastic, affine tracks): the longest horizon at one warp per block,
# by the layout's arithmetic.
LIMITS = [((0, False, False), 1036), ((8, False, True), 805), ((8, False, False), 659),
          ((8, True, True), 725), ((8, True, False), 604)]


@pytest.mark.parametrize("form,most", LIMITS,
                         ids=["free", "k8_affine", "k8", "k8_elastic_affine", "k8_elastic"])
def test_shim_horizon_limit_at_one_warp(shim, form, most):
    """The longest horizon fits in a block of one warp and one step more
    does not; at N=50, as on the main path, a block takes 4 warps."""
    _, lib = shim
    K, elastic, affine = form
    assert lib.kissmpc_ipm_fused_max_horizon(K, int(elastic), int(affine)) == most
    at = _occupancy(lib, most, K, elastic, affine)
    above = _occupancy(lib, most + 1, K, elastic, affine)
    assert at["warps"] == 1 and at["smem"] <= SMEM_OPTIN
    assert above["smem"] > SMEM_OPTIN
    assert _occupancy(lib, 50, K, elastic, affine)["warps"] == 4


def _case_id(case):
    n, K, elastic, affine, batch, _, warps = case
    return f"N{n}-K{K}{'-el' if elastic else ''}{'-aff' if affine else ''}-B{batch}-W{warps}"


@pytest.mark.parametrize("case", _shim_module().CASES, ids=_case_id)
def test_shim_matches_plain(shim, case):
    """Ragged batches at 4 warps per block (one iteration), and B=3 at
    horizons that take 2 and 1 warps per block (three iterations)."""
    module, lib = shim
    ok, line = module.check(lib, *case, report_full=False)
    assert ok, line
