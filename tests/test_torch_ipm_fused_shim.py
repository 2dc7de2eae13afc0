"""The fused kernel's own source, rehearsed on the CPU: its warps per block,
its width rule and horizon limit.

`scripts/fused_cpu_shim.py` compiles `kissmpc_tpu_torch/csrc/ipm_fused.cu`
with g++ behind a header that stands in for the CUDA runtime (a
`std::thread` per thread of a block, a `std::barrier` per warp for
`__syncwarp` and one per block for `__syncthreads`, shared memory a
NaN-filled vector of the launch's exact size, `blockDim` set, sm_90's
227 KB of opt-in shared memory per block, and a stand-in SM of 4 warps
whose count the tests set).  Here the build's host function gives the
longest horizon the kernel takes, for each obstacle form, and the
launcher's warps per block are held at 4 at N=50 and at 2 and 1 at longer
horizons, where the build is held against the plain version
`solve_batch_fused_plain` by chip_smoke.py's phase-4 gate at a few
iterations (within 1e-4 of the solution's scale plus twice the plain
version's own f32-vs-f64 gap).  The wide instance (4 warps per scenario,
picked where the SMs hold the whole batch at once) is held to the same
gate, and to the same bits as one warp per scenario; the base batches of
the fleet keep one warp per scenario and 4 scenarios a block.
The tests skip where g++ is missing; they cannot see what only the card
shows (ptxas, a refused launch, speed, the card's own residency).
"""

import contextlib
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


def _occupancy(lib, N, K, elastic, affine, batch=8192):
    out = (ctypes.c_int * 7)()
    assert lib.kissmpc_ipm_fused_occupancy(batch, N, K, int(elastic), int(affine), out) == 0
    return {"width": out[0], "warps": out[1], "per_block": out[2], "smem": out[3]}


@contextlib.contextmanager
def _sms(lib, count):
    """The shim build's stand-in card with ``count`` SMs."""
    lib.shim_set_sm_count(count)
    try:
        yield
    finally:
        lib.shim_set_sm_count(1)


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
    n, K, elastic, affine, batch, _, warps, _, width = case
    wide = f"-width{width}" if width > 1 else ""
    return f"N{n}-K{K}{'-el' if elastic else ''}{'-aff' if affine else ''}-B{batch}-W{warps}{wide}"


@pytest.mark.parametrize("case", _shim_module().CASES, ids=_case_id)
def test_shim_matches_plain(shim, case):
    """Ragged batches at 4 warps per block (one iteration), B=3 at horizons
    that take 2 and 1 warps per block (three iterations), and B=3 at 4
    warps per scenario."""
    module, lib = shim
    ok, line = module.check(lib, *case, report_full=False)
    assert ok, line


@pytest.mark.parametrize("K", [2, 8])
@pytest.mark.parametrize("elastic", [False, True], ids=["hard", "elastic"])
def test_shim_wide_instance_returns_the_bits_of_one_warp(shim, elastic, K):
    """K obstacles, N=12, B=3, 3 iterations: the same scenarios solved at 4
    warps per scenario (3 SMs hold the batch at once) and at one warp per
    scenario (1 SM): every output bitwise equal."""
    module, lib = shim
    cfg = module.config(12, K, elastic, True)
    pr = module.problems(cfg, 3)
    with _sms(lib, 3):
        wide, got_width = module.run(lib, cfg, pr, 3)
    one, one_width = module.run(lib, cfg, pr, 3)
    assert (got_width, one_width) == (4, 1)
    for a, b in zip((wide.states, wide.controls, *wide.diagnostics),
                    (one.states, one.controls, *one.diagnostics)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("batch", [8192, 4096, 2048])
def test_shim_base_batches_keep_one_warp_per_scenario(shim, batch):
    """On 132 SMs the fleet's base batches (N=50, K=8, affine tracks) take
    width 1 and the one-warp launch shape: 4 scenarios (warps) a block, each
    with its 3,701 floats of shared memory."""
    _, lib = shim
    with _sms(lib, 132):
        assert _occupancy(lib, 50, 8, False, True, batch) == {
            "width": 1, "warps": 4, "per_block": 4, "smem": 4 * 3701 * 4}
