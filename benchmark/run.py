#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card, and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (imports, the CUDA context, the
cell's inputs from the seed, the kernels' libraries, every shape warmed)
runs from the process's start to the first timed call; then the window
runs closed-loop for ``--seconds``; then the device's peak memory is read
and what the timed path produced is compared with the plain reference.
With ``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled stretch of the
window.  The last lines on standard error are the compared numbers, each
beside its limit; the last line on standard output is one JSON object.
Without a card, with fewer cards than the cell asks for, with JAX or the
JAX package loaded, or without the port beside it, the run exits non-zero
and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every cache a library may keep lies at a fixed path inside the checkout;
# the port builds its kernels into build/kissmpc_tpu_torch/ there itself.
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(ROOT / "build" / "bench_cache" / _sub)
sys.path.insert(0, str(ROOT))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def applies(entry: dict, cell: str) -> bool:
    return cell in entry["workloads"] if "workloads" in entry else True


def execute(args) -> tuple[dict, list]:
    from benchmark import harness, traces
    from benchmark.traffic.common import Context

    bad = harness.reference_imports_ok()
    if bad:
        raise harness.BenchError(f"the plain reference imports what it may not: {bad}")
    cell, config = harness.load_cell(args.workload)
    spec = harness.read_json(ROOT / "BENCHMARK.json")
    end_to_end = [m for m in spec["end_to_end"] if applies(m, cell["name"])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in spec["per_layer"]
                 if (cell["name"] in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]

    try:
        import kissmpc_tpu_torch  # noqa: F401
    except ModuleNotFoundError as exc:
        raise harness.BenchError(f"the port is not beside the benchmark ({exc})") from exc
    import torch

    if not torch.cuda.is_available():
        raise harness.BenchError("no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < int(cell["chips"]):
        raise harness.BenchError(f"{cell['name']} needs {cell['chips']} cards, "
                                 f"{torch.cuda.device_count()} present")
    torch.set_num_threads(1)
    card = harness.power_limit()
    harness.log(f"card: {card}")

    driver_module = harness.load_module("traffic", cell["driver"])
    # Any whole number is a seed; numpy's seeding takes it modulo 2**64.
    ctx = Context(cell, config, args.seed % 2 ** 64, "cuda", harness.log)
    driver = driver_module.setup(ctx)
    if args.trace:
        traces.warm()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    torch.cuda.reset_peak_memory_stats()
    window = harness.run_window(driver.step, args.seconds, trace=bool(args.trace),
                                trace_calls=driver.trace_calls)
    memory_peak = torch.cuda.max_memory_allocated()
    attempted, failed, e2e = driver.result(window)
    harness.log(f"window: {len(window.times)} calls in {window.seconds:.3f} s, setup "
                f"{setup_s:.3f} s")
    compared = driver.check()

    metrics = {}
    if args.trace:
        run = harness.Run(cell, config, driver, window)
        for m in per_layer:
            value = harness.load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for m in end_to_end:
            if m["name"] not in e2e:
                raise harness.BenchError(f"{cell['driver']} gave no {m['name']}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]), "memory_peak_bytes": int(memory_peak),
              "power": card}
    result = {"correct": None, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if args.trace:
        trace = window.trace
        device["busy_s"] = traces.busy_seconds(trace.device)
        device["window_s"] = trace.end - trace.start
        result["breakdown"] = {"device_ops": traces.device_ops(trace),
                               "idle_gaps": traces.idle_gaps(trace)}
    ok = all(math.isfinite(v) and v <= limit for _, v, limit in compared)
    result["correct"] = ok
    result["compared"] = {name: {"value": v, "limit": limit} for name, v, limit in compared}
    return result, compared


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import harness

    try:
        result, compared = execute(args)
    except harness.BenchError as exc:
        harness.log(f"benchmark: no result: {exc}")
        return 2
    found = harness.forbidden_modules()
    if found:
        harness.log(f"benchmark: no result: the run loaded {found}")
        return 3
    for name, value, limit in compared:
        harness.log(f"compared {name} = {value!r} (limit {limit!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
