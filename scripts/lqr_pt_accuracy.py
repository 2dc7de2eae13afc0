#!/usr/bin/env python3
"""How accurate the associative-scan LQR (`ops/lqr_pt.py`) is beside the
sequential Riccati solve, on the LQR data of a real IPM iterate.

    python3 scripts/lqr_pt_accuracy.py [--batch 1024] [--device cpu|cuda] [--faults]

The data is `chip_smoke.py` phase 2's: the K=8 benchmark scenarios (seed 0)
after 8 split IPM iterations, N=50.  For float32 and float64 it prints,
over the batch: `chip_smoke.py::riccati_gate`'s dx/du ratios of the
associative solve against the sequential one (the ratio of each output's
error to its per-scenario limit, at the worst scenario), each solve's
largest error against the float64 sequential solve, and each solve's
largest KKT residual relative to its scenario's data scale, on the system
both solve (Quu + reg I).  On the CPU the sequential solve is
`ops/lqr.py::solve_lqr`; on the card, the Riccati kernel.

With ``--faults`` it also plants four faults in a copy of
`ops/lqr_pt.py`'s source (built as a module in memory; the file is not
touched) and prints each one's largest relative KKT residual, the quantity
`chip_smoke.py` phase 14 gates at LQR_PT_KKT_REL.
"""

import argparse
import inspect
import json
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from kissmpc_tpu_torch.ops import lqr_pt  # noqa: E402
from kissmpc_tpu_torch.ops.lqr import LQRData, kkt_residual, solve_lqr  # noqa: E402
from kissmpc_tpu_torch.ops.riccati import solve_lqr_cuda  # noqa: E402
from kissmpc_tpu_torch.scenarios import obstacle_problems  # noqa: E402


# (what the source says, what the faulted copy says)
FAULTS = {
    "operands not swapped in the reverse scan": (
        "lambda a, b: _combine(b, a)", "lambda a, b: _combine(a, b)"),
    "eta's sign in the recovery": (
        "_mv(A_t, dx[-1]) + data.d[:, t]) - en)", "_mv(A_t, dx[-1]) + data.d[:, t]) + en)"),
    "A_j not transposed in C": (
        "C = AjD @ Ci @ Aj.transpose(-1, -2) + Cj", "C = AjD @ Ci @ Aj + Cj"),
    "E computed as D": (
        "E = torch.linalg.inv(I + Jj @ Ci)", "E = torch.linalg.inv(I + Ci @ Jj)"),
}


def faulted(edit) -> types.ModuleType:
    """`ops/lqr_pt.py` with one edit, as a module built from its source."""
    source = inspect.getsource(lqr_pt)
    old, new = edit
    if source.count(old) != 1:
        raise SystemExit(f"fault site not found once in ops/lqr_pt.py: {old!r}")
    module = types.ModuleType("lqr_pt_faulted")
    module.__package__ = "kissmpc_tpu_torch.ops"
    exec(compile(source.replace(old, new), "lqr_pt_faulted", "exec"), module.__dict__)
    return module


def kkt_rel(solve, data, reg, scale) -> float:
    d = data._replace(Quu=data.Quu + reg * torch.eye(2, dtype=data.Quu.dtype,
                                                     device=data.Quu.device))
    return float((kkt_residual(d, solve(data, reg)).double() / scale).max())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args()
    cfg = chip_smoke.configs("split")["k8_dyn2"]
    reg = cfg.solver.reg
    problems = obstacle_problems(cfg, args.batch, seed=0, n_dynamic=2, device=args.device)
    data = chip_smoke.lqr_from_iterate(cfg, problems)
    data64 = LQRData(*(x.double() for x in data))
    truth = solve_lqr(data64, reg)
    B = args.batch
    scale = torch.stack([x.reshape(B, -1).abs().amax(1).double() for x in data]).amax(0)
    out = {"batch": B, "device": args.device}
    for dtype in (torch.float32, torch.float64):
        d = LQRData(*(x.to(dtype) for x in data))
        par = lqr_pt.solve_lqr_associative(d, reg)
        gate = chip_smoke.riccati_gate(par, d, reg, ref=solve_lqr_cuda(d, reg),
                                       outputs=("dx", "du"))
        row = {"gate_ratio": {k: o["ratio"] for k, o in gate["outputs"].items()}}
        for name, solve in (("sequential", solve_lqr_cuda),
                            ("associative", lqr_pt.solve_lqr_associative)):
            row[name] = {
                "du_err_vs_f64_max": float((solve(d, reg).du.double() - truth.du).abs().max()),
                "kkt_rel_max": kkt_rel(solve, d, reg, scale),
            }
        if args.faults:
            row["faults_kkt_rel_max"] = {
                name: kkt_rel(faulted(edit).solve_lqr_associative, d, reg, scale)
                for name, edit in FAULTS.items()}
        out[str(dtype)[6:]] = row
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
