"""The problem build, init and diagnostics kernels, rehearsed on the CPU from
their own sources.

`scripts/ipm_split_cpu_shim.py` compiles `kissmpc_tpu_torch/csrc/ipm_split.cu`
and `csrc/problem_build.cu` with g++ behind a header that stands in for the
CUDA runtime (a fiber per CUDA thread, a barrier per warp around each
shuffle and `__syncwarp` and one per block, the blocks of a launch one
after another).  Here the wrappers' own card paths (`ops/ipm_split.py::_init`,
`_diagnostics`, `ops/problem_build.py::_launch`) drive those builds on CPU
tensors, held against the plain versions by chip_smoke.py's gates:

- the init in its layouts (`init_gate`): at a refine stage's batch
  (B=164), hard, elastic and "pc", and where each thread takes several
  entries of a family (K=100; N=200);
- the diagnostics in their layouts (`once_kernels_check`, and a second
  launch with the same bits): a block per scenario at a refine stage's
  batch (K=8, N=50, B=164), the node (N=7, B=1), and stages in several
  chunks (K=100: chunks of 4 stages; N=200 and N=400 at K=8: the suffix
  scans' carry across 4 and 7 chunks);
- init and diagnostics (`once_kernels_check`): hard and elastic, K=0 and
  K=4, "pc", both cost modes; every field of each scenario within 1e-4 of
  its scale plus twice the plain version's own f32-vs-f64 gap in float32,
  1e-9 of its scale in float64; ``converged`` differs on at most
  `chip_smoke.allowed_flips` scenarios: twice the plain version's own
  flips an ulp away (with the initial state moved one ulp either way; on
  these CPU tensors its CPU evaluation is the one held to), at most a
  quarter of the batch;
- the build (`build_kernel_check`): repair and completion on and off, a
  zero completion threshold, K=0 and K=4, K_all > K and K_all > 32, one
  set shared by every scenario at stride 0, the start tiled with the
  default prediction dt, horizons past a warp's lanes (N=33, 64), tied
  sensor keys and tied speed caps; every Problem field by the same gate, a scenario outside it counted
  as a discrete flip, at most `chip_smoke.allowed_flips` by the same
  witness (the start moved one ulp); and rows past 227 KB per scenario
  (K=16, N=1500), which must take the global scratch;
- a whole float64 split solve through the shim kernels (init, the
  iterations' condensation and step around the plain Riccati solve,
  diagnostics) within 1e-7 of `ipm.solve_plain`, elastic and "pc".

The tests skip where g++ is missing; they cannot see what only the card
shows (ptxas, a refused launch, speed).
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
        pytest.skip("needs g++ (C++20) to compile the kernels' sources for the CPU")
    module = _shim_module()
    tmp = tmp_path_factory.mktemp("build_once_shim")
    return module, module.build(tmp), module.build_problem(tmp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", _shim_module().ONCE_CASES, ids=lambda c: c[0])
def test_shim_init_and_diagnostics_match_plain(shim, case, dtype):
    module, lib, _ = shim
    [(ok, line)] = module.run_once_cases(lib, cases=(case,), dtypes=(dtype,))
    assert ok, line


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", _shim_module().INIT_LAYOUT_CASES, ids=lambda c: c[0])
def test_shim_init_layouts_match_plain(shim, case, dtype):
    module, lib, _ = shim
    [(ok, line)] = module.run_init_layouts(lib, cases=(case,), dtypes=(dtype,))
    assert ok, line


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", _shim_module().DIAG_LAYOUT_CASES, ids=lambda c: c[0])
def test_shim_diagnostics_layouts_match_plain(shim, case, dtype):
    module, lib, _ = shim
    [(ok, line)] = module.run_diag_layouts(lib, cases=(case,), dtypes=(dtype,))
    assert ok, line


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", _shim_module().BUILD_CASES, ids=lambda c: c[0])
def test_shim_build_matches_plain(shim, case, dtype):
    module, _, lib = shim
    [(ok, line)] = module.run_build_cases(lib, cases=(case,), dtypes=(dtype,))
    assert ok, line


@pytest.mark.parametrize("name", ["k4_elastic", "k4_pc"])
def test_shim_solve_matches_solve_plain(shim, name):
    module, lib, _ = shim
    ok, line = module.check_solve(lib, name)
    assert ok, line
