"""The split iteration's kernels, rehearsed on the CPU from their own source.

`scripts/ipm_split_cpu_shim.py` compiles `kissmpc_tpu_torch/csrc/ipm_split.cu`
with g++ behind a header that stands in for the CUDA runtime (a
`std::thread` per CUDA thread, a `std::barrier` per warp around each
shuffle, the blocks of a launch one after another).  Here the wrapper's own
card path (`ops/ipm_split.py::_condense`, `_step`) drives that build on CPU
tensors, and both kernels are held against the plain halves
(`ipm.condense_plain`, `ipm.step_plain`) by chip_smoke.py's gates: hard and
elastic, K=0 and K=4, with and without the curvature term, both cost
modes, Mehrotra "pc" and "soc", float32 and float64 (each LQRData field and
each field of the new iterate of each scenario within 1e-4 of its scale
plus twice the plain version's own f32-vs-f64 gap in float32, 1e-9 of its
scale in float64; the accepted line-search candidate differs on at most
max(1, twice the plain version's own f32-vs-f64 flips) scenarios); and a
whole float64 solve through the shim kernels is `ipm.solve_plain` within
1e-7.  The step runs in the wrapper's layout for these small batches (a
block of several warps per scenario), and each layout is also forced at
the node's N=7: one warp per scenario and a block of 2 warps, hard and
elastic, K=0 and K=4, float32 and float64; the merits at every candidate
and rho are held by the same gate.  The tests skip where g++ is missing; they cannot see what only the
card shows (ptxas, a refused launch, speed).
"""

import importlib.util
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


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
        "ipm_split_cpu_shim", ROOT / "scripts" / "ipm_split_cpu_shim.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (C++20) to compile the kernels' source for the CPU")
    module = _shim_module()
    return module, module.build(tmp_path_factory.mktemp("ipm_split_shim"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", _shim_module().CASES, ids=lambda c: c[0])
def test_shim_kernels_match_plain_halves(shim, case, dtype):
    module, lib = shim
    [(ok, line)] = module.run_cases(lib, cases=(case,), dtypes=(dtype,))
    assert ok, line


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("warps", _shim_module().LAYOUTS, ids=lambda w: f"warps{w}")
@pytest.mark.parametrize("case", _shim_module().LAYOUT_CASES, ids=lambda c: c[0])
def test_shim_layouts_match_plain_halves(shim, case, warps, dtype):
    module, lib = shim
    [(ok, line)] = module.run_cases(lib, cases=(case,), dtypes=(dtype,), warps=warps)
    assert ok, line


def test_shim_solve_matches_solve_plain(shim):
    module, lib = shim
    ok, line = module.check_solve(lib)
    assert ok, line
