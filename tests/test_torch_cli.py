"""The port's command line (`kissmpc_tpu_torch/cli.py`) against the JAX
package's (`kissmpc_tpu/cli.py`): `demo` positions, `map` output, and
`lab` on a synthetic map (the JAX test of `lab` skips for want of one)."""

import re

import numpy as np
import pytest
import torch

import chip_smoke
from kissmpc_tpu.cli import main as j_main
from kissmpc_tpu_torch.cli import main

POS = re.compile(r"tick\s+(\d+) pos=\(([-+.\d]+),([-+.\d]+)\)")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _positions(out):
    return {int(t): (float(x), float(y)) for t, x, y in POS.findall(out)}


def test_demo_matches_jax(capsys):
    args = ["demo", "--horizon", "10", "--dt", "0.1", "--ticks", "5"]
    assert main(args + ["--device", "cpu"]) == 0
    got = _positions(capsys.readouterr().out)
    assert j_main(args) == 0
    want = _positions(capsys.readouterr().out)
    assert sorted(got) == sorted(want) == list(range(5))
    # Printed with two decimals: one step of the last digit apart at most.
    np.testing.assert_allclose([got[t] for t in want], [want[t] for t in want], atol=0.011,
                               rtol=0)


def test_map_matches_jax(tmp_path):
    # binary P5 occupancy map: free field with one dark blob (tests/test_cli.py)
    H, W = 40, 60
    img = np.full((H, W), 254, np.uint8)
    img[10:20, 20:35] = 0
    p = tmp_path / "m.pgm"
    with open(p, "wb") as f:
        f.write(f"P5\n{W} {H}\n255\n".encode())
        f.write(img.tobytes())
    out, ref = tmp_path / "c.npz", tmp_path / "ref.npz"
    assert main(["map", str(p), "-o", str(out), "--min-radius", "2.0"]) == 0
    assert j_main(["map", str(p), "-o", str(ref), "--min-radius", "2.0"]) == 0
    got, want = np.load(out), np.load(ref)
    assert sorted(got.files) == sorted(want.files)
    assert len(got["radii"]) >= 1
    for name in want.files:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_lab_runs_on_a_synthetic_map(tmp_path, capsys):
    path = tmp_path / "lab.pgm"
    chip_smoke.write_synthetic_map(path, shape=(160, 240), seed=4)
    rc = main(["lab", "--map", str(path), "--batch", "4", "--ticks", "3", "--horizon", "10",
               "--dt", "0.1", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "circles" in out and "tick" in out


def test_lab_needs_a_map():
    with pytest.raises(SystemExit):
        main(["lab", "--batch", "4"])


@pytest.mark.parametrize("command", ["demo", "lab"])
def test_runs_on_the_card_unless_cpu_is_asked(command, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the refusal is for machines without CUDA")
    path = tmp_path / "lab.pgm"
    chip_smoke.write_synthetic_map(path, shape=(160, 240), seed=4)
    args = {"demo": ["demo", "--ticks", "1"], "lab": ["lab", "--map", str(path), "--ticks", "1"]}
    with pytest.raises(RuntimeError, match="CUDA"):
        main(args[command])
