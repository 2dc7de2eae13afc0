"""Command-line entry points of the port.  Port of `kissmpc_tpu/cli.py`.

  python -m kissmpc_tpu_torch.cli demo   — simulated receding-horizon episode
  python -m kissmpc_tpu_torch.cli map    — occupancy map -> circle set npz
  python -m kissmpc_tpu_torch.cli lab    — fleet episodes on an occupancy map

(or the ``kissmpc-torch`` script).  ``demo`` and ``lab`` run on the card;
``--device cpu`` runs them on the CPU.  ``map`` is host code (numpy and
the g++-built native library).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _cmd_demo(args) -> int:
    import torch

    from . import MPCConfig
    from . import agent as agent_mod
    from . import environment as env_mod
    from ._device import resolve_device
    from .agent import AgentParams
    from .obstacles import static_set
    from .utils.metrics import MetricsAggregator
    from .utils.profiling import block_until_ready

    dev = resolve_device(args.device)
    cfg = MPCConfig(
        horizon=args.horizon, time_step=args.dt,
        max_obstacles=2 if args.obstacles else 0,
    )
    params = AgentParams(radius=0.15)
    waypoints = torch.tensor([[1.2, 0.4, 0.0], [2.4, 0.0, 0.0]])
    env = env_mod.init_env(
        cfg, torch.tensor([0.0, 0.0, 0.0]), waypoints, dtype=torch.float32, device=dev
    )
    obstacles = (
        static_set([[1.0, 0.75], [2.0, -0.7]], [0.2, 0.2], dtype=torch.float32, device=dev)
        if args.obstacles
        else None
    )

    agg = MetricsAggregator()
    for tick in range(args.ticks):
        t0 = time.perf_counter()
        env, info = env_mod.step(cfg, params, env, obstacles, device=dev)
        block_until_ready(env)
        agg.record_tick(time.perf_counter() - t0, info.diagnostics)
        pos = agent_mod.position(env.agent)[0].tolist()
        if tick % max(1, args.ticks // 10) == 0:
            print(
                f"tick {tick:4d} pos=({pos[0]:+.2f},{pos[1]:+.2f}) "
                f"wp={int(env.waypoint_index[0])} "
                f"v={float(env.agent.linear_velocity[0]):+.3f} "
                f"w={float(env.agent.angular_velocity[0]):+.3f}"
            )
        if bool(env_mod.final_goal_reached(params, env)[0]):
            print(f"final goal reached at tick {tick}")
            break
    print(json.dumps(agg.summary(), indent=2))
    return 0


def _cmd_map(args) -> int:
    import numpy as np

    from .obstacles.mapping import circles_to_world, pack_circles, read_pgm

    img = read_pgm(args.input)
    t0 = time.time()
    centers, radii = pack_circles(
        img, min_radius=args.min_radius, max_circles=args.max_circles
    )
    centers_w, radii_w = circles_to_world(
        centers, radii, resolution=args.resolution,
        map_height_px=img.shape[0],
    )
    np.savez(args.output, centers=centers_w, radii=radii_w,
             centers_px=centers, radii_px=radii)
    print(
        f"{args.input}: {img.shape[1]}x{img.shape[0]} -> {len(radii)} "
        f"circles in {time.time() - t0:.2f}s -> {args.output}"
    )
    return 0


def _cmd_lab(args) -> int:
    """Batched episodes on an occupancy map (config 3 at fleet scale)."""
    import dataclasses

    from . import environment as env_mod
    from ._device import resolve_device
    from .agent import AgentParams
    from .config import MPCConfig
    from .scenarios import lab_worlds

    dev = resolve_device(args.device)
    cfg = MPCConfig(horizon=args.horizon, time_step=args.dt,
                    max_obstacles=8)
    cfg = cfg.replace(solver=dataclasses.replace(
        cfg.solver, iterations=32,
        refine_stages=((0.125, 64, 0.2), (0.02, 96, 0.7)),
        mu_sigma_max=0.7, fused_affine_tracks=True,
    ))
    env, obstacles, winfo = lab_worlds(
        cfg, args.batch, map_path=args.map, resolution=args.resolution, device=dev,
    )
    params = AgentParams(
        prediction_dt=cfg.time_step, complete_warm_starts=False,
        stall_skip_ticks=50,
        state_bounds=(-10.0, float(winfo["extent"].max()) + 10.0),
    )
    print(f"{winfo['n_circles']} circles, {args.batch} episodes, "
          f"extent {winfo['extent'].round(1)} m")
    for t in range(args.ticks):
        env, info = env_mod.fleet_step(cfg, params, env, obstacles, device=dev)
        if t % 25 == 0 or t == args.ticks - 1:
            done = float(info.final_goal_reached.float().mean())
            conv = float(info.diagnostics.converged.float().mean())
            print(f"tick {t:4d}  done={done:.3f}  converged={conv:.3f}",
                  flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="kissmpc_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    demo = sub.add_parser("demo", help="simulated receding-horizon episode")
    demo.add_argument("--horizon", type=int, default=20)
    demo.add_argument("--dt", type=float, default=0.1)
    demo.add_argument("--ticks", type=int, default=60)
    demo.add_argument("--obstacles", action="store_true")
    demo.add_argument("--device", default="cuda")
    demo.set_defaults(func=_cmd_demo)

    mp = sub.add_parser("map", help="occupancy map -> circle set")
    mp.add_argument("input", help="PGM occupancy map path")
    mp.add_argument("-o", "--output", default="circles.npz")
    mp.add_argument("--min-radius", type=float, default=2.0)
    mp.add_argument("--max-circles", type=int, default=500)
    mp.add_argument("--resolution", type=float, default=0.05,
                    help="meters per pixel")
    mp.set_defaults(func=_cmd_map)

    lab = sub.add_parser(
        "lab", help="fleet episodes on an occupancy map"
    )
    lab.add_argument("--map", required=True, help="PGM occupancy map path")
    lab.add_argument("--resolution", type=float, default=0.05)
    lab.add_argument("--batch", type=int, default=256)
    lab.add_argument("--ticks", type=int, default=200)
    lab.add_argument("--horizon", type=int, default=50)
    lab.add_argument("--dt", type=float, default=0.041)
    lab.add_argument("--device", default="cuda")
    lab.set_defaults(func=_cmd_lab)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
