"""Batched-solve traffic: `make_batch_solver` replayed back to back.

Set-up draws a pool of raw scenarios from the seed (`scenarios.pool`),
builds their problems with the port's build (`problem_with_obstacles`, one
launch of the build kernel), draws a table of distinct batches of the
pool on the device, and warms the solver's one shape (its first call
captures the CUDA graph, the second replays it).  Each timed call solves a
fresh batch and ends in `synchronize`.  The converged and unusable solves
of every call are summed on the device; one call's answers, drawn from
the seed by a reservoir over all calls, are kept for the check.

Cell parameters (`params` in the cell's file): ``batch``, ``pool``,
``batches`` (rows of the batch table, cycled).  Check parameters
(`check`): ``tolerance`` on the controls of answers both sides report
converged, and ``limits`` of the compared numbers.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import compare, counts, scenarios
from ..harness import percentile
from ..reference import api as ref_api
from ..reference import config as ref_config
from ..reference import obstacles as ref_obstacles
from ..reference import problem as ref_problem
from .common import DTYPES, UNUSABLE_FEASIBILITY, mpc_config, sync, torch_seed


def _obstacles(cls, raw, dtype, device):
    _, _, centers, radii, orientation, v = raw
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    zeros = torch.zeros(radii.shape, dtype=dtype, device=device)
    return cls(position=t(centers), radius=t(radii), orientation=t(orientation),
               linear_velocity=t(v), angular_velocity=zeros, active=torch.ones_like(zeros))


def build_kwargs(config: dict, dtype, device) -> dict:
    """`problem_with_obstacles`' keywords for a configuration."""
    (vl, vu), (wl, wu) = config["control_bounds"]
    return dict(sensor_radius=float(config["sensor_radius"]),
                prediction_dt=float(config["time_step"]),
                inflation_radius=float(config["inflation_radius"]),
                control_bounds=((float(vl), float(vu)), (float(wl), float(wu))),
                state_bounds=tuple(float(b) for b in config["state_bounds"]),
                dtype=dtype, device=device)


def reference_problems(config: dict, raw, idx: np.ndarray, dtype, device):
    """The reference's problems of pool rows ``idx``, rebuilt from the raw
    scenarios (the build is per scenario, so rows of the pool are the
    build of those rows)."""
    cfg = mpc_config(ref_config, config)
    rows = tuple(x[idx] for x in raw)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    obs = _obstacles(ref_obstacles.ObstacleSet, rows, dtype, device)
    return cfg, ref_problem.problem_with_obstacles(cfg, t(rows[0]), t(rows[1]), obs,
                                                   **build_kwargs(config, dtype, device))


class Driver:
    def __init__(self, ctx):
        from kissmpc_tpu_torch import config as port_config
        from kissmpc_tpu_torch import make_batch_solver, problem_with_obstacles
        from kissmpc_tpu_torch.obstacles import ObstacleSet
        from kissmpc_tpu_torch.solver.problem import gather

        self.ctx, self.gather = ctx, gather
        c, p = ctx.config, ctx.cell["params"]
        self.batch, self.dtype = int(p["batch"]), DTYPES[c["dtype"]]
        self.cfg = mpc_config(port_config, c)
        dev = ctx.device
        self.raw = scenarios.pool(c["horizon"], c["time_step"], int(p["pool"]),
                                  c["max_obstacles"], int(c["dynamic_obstacles"]),
                                  float(c["inflation_radius"]), ctx.seed)
        t = lambda x: torch.as_tensor(x, dtype=self.dtype, device=dev)  # noqa: E731
        self.problems = problem_with_obstacles(
            self.cfg, t(self.raw[0]), t(self.raw[1]),
            _obstacles(ObstacleSet, self.raw, self.dtype, dev),
            **build_kwargs(c, self.dtype, dev))
        gen = torch.Generator(device=dev)
        gen.manual_seed(torch_seed(ctx.seed))
        self.index = torch.rand((int(p["batches"]), int(p["pool"])), generator=gen,
                                device=dev).argsort(dim=1)[:, :self.batch]
        self.solver = make_batch_solver(self.cfg, device=dev)
        for i in range(2):  # the capture, then a replay
            self.solver(gather(self.problems, self.index[i]))
        sync(dev)
        self.converged = torch.zeros((), dtype=torch.int64, device=dev)
        self.unusable = torch.zeros((), dtype=torch.int64, device=dev)
        self.calls = 0
        self.pick = np.random.default_rng([ctx.seed, 1])
        self.kept = None
        self.trace_calls = 20

    def step(self, i: int) -> float:
        batch = self.gather(self.problems, self.index[i % self.index.shape[0]])
        sync(self.ctx.device)
        t0 = time.perf_counter()
        sol = self.solver(batch)
        sync(self.ctx.device)
        seconds = time.perf_counter() - t0
        d = sol.diagnostics
        self.converged += d.converged.sum()
        self.unusable += (d.kkt_feasibility > UNUSABLE_FEASIBILITY).sum()
        self.calls += 1
        if self.pick.random() * self.calls < 1.0:  # a reservoir of one call
            self.kept = (i, sol)
        return seconds

    def result(self, window) -> tuple[int, int, dict]:
        attempted = self.calls * self.batch
        converged = int(self.converged)
        return attempted, int(self.unusable), {
            "solves_per_s": converged / window.seconds,
            "step_ms_p95": percentile(window.times, 95) * 1e3,
        }

    def stage_shapes(self):
        sc = self.cfg.solver
        return counts.stage_shapes(self.batch, sc.iterations, sc.refine_stages)

    def check(self) -> list:
        """The kept call's answers against the reference's staged solve of
        the same batch, rebuilt from its raw scenarios."""
        i, sol = self.kept
        idx = self.index[i % self.index.shape[0]].cpu().numpy()
        chk = self.ctx.cell["check"]
        del self.problems, self.solver
        cfg, problems = reference_problems(self.ctx.config, self.raw, idx, self.dtype,
                                           self.ctx.device)
        t0 = time.perf_counter()
        ref = ref_api.solve_batch(cfg, problems)
        sync(self.ctx.device)
        self.ctx.log(f"reference: call {i} of {self.calls}, {self.batch} answers, "
                     f"{time.perf_counter() - t0:.3f} s")
        return numbers(cfg, problems, sol, ref, chk)


def numbers(cfg, problems, sol, ref, chk) -> list:
    """The compared numbers of answers ``sol`` against the reference's
    ``ref`` on the reference's ``problems``: [(name, value, limit)]."""
    conv, ref_conv = sol.diagnostics.converged.cpu(), ref.diagnostics.converged.cpu()
    share = float(compare.disagreeing(conv, ref_conv, sol.controls.cpu(), ref.controls.cpu(),
                                      float(chk["tolerance"])).double().mean())
    gap = compare.claim_gap(cfg, type(problems)(*(x.cpu() for x in problems)),
                            sol.diagnostics.kkt_feasibility.cpu(), sol.states.cpu(),
                            sol.controls.cpu())
    limits = chk["limits"]
    return [("disagree_share", share, float(limits["disagree_share"])),
            ("claim_gap", gap, float(limits["claim_gap"]))]


def setup(ctx) -> Driver:
    return Driver(ctx)


def control(ctx, lower: str) -> list:
    """The compared numbers of the reference in ``lower`` precision put in
    the program's place, on the batch a run's first call solves."""
    c, p = ctx.config, ctx.cell["params"]
    raw = scenarios.pool(c["horizon"], c["time_step"], int(p["pool"]), c["max_obstacles"],
                         int(c["dynamic_obstacles"]), float(c["inflation_radius"]), ctx.seed)
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(torch_seed(ctx.seed))
    idx = torch.rand((1, int(p["pool"])), generator=gen, device=ctx.device).argsort(
        dim=1)[0, :int(p["batch"])].cpu().numpy()
    cfg, problems = reference_problems(c, raw, idx, DTYPES[c["dtype"]], ctx.device)
    ref = ref_api.solve_batch(cfg, problems)
    _, low = reference_problems(c, raw, idx, DTYPES[lower], ctx.device)
    return numbers(cfg, problems, ref_api.solve_batch(cfg, low), ref, ctx.cell["check"])
