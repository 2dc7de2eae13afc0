"""Structured metrics: per-tick records with percentile summaries, as the
CLI's `demo` prints them.  A port-owned copy of the aggregator of
`kissmpc_tpu/utils/metrics.py`.

A host-side aggregator of per-tick records, fed off the critical path:
diagnostics are copied to the host only when recorded, one copy per field,
so a `Diagnostics` of tensors on the card is recorded as one on the CPU.
The summary keys and the JSONL keys are the reference's.  Spans inside a
tick are the profiler's (`utils/profiling.py::annotate`).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclass
class TickRecord:
    wall_time_s: float
    latency_s: float
    converged_fraction: float
    kkt_stationarity_max: float
    kkt_feasibility_max: float
    cost_mean: float
    extra: Dict[str, float] = field(default_factory=dict)


class MetricsAggregator:
    """Accumulates per-tick records; summarizes latency p50/p99 and solver
    health.  All numpy/python on the host."""

    def __init__(self, capacity: int = 100_000):
        self.capacity = capacity
        self.records: List[TickRecord] = []

    def record_tick(
        self,
        latency_s: float,
        diagnostics=None,
        *,
        converged_fraction: Optional[float] = None,
        **extra,
    ) -> None:
        if diagnostics is not None:
            conv = _host(diagnostics.converged)
            converged_fraction = float(np.mean(conv.astype(np.float64)))
            stat = float(np.max(_host(diagnostics.kkt_stationarity)))
            feas = float(np.max(_host(diagnostics.kkt_feasibility)))
            cost = float(np.mean(_host(diagnostics.final_cost)))
        else:
            stat = feas = cost = float("nan")
            converged_fraction = (
                converged_fraction if converged_fraction is not None else float("nan")
            )
        rec = TickRecord(
            wall_time_s=time.time(),
            latency_s=latency_s,
            converged_fraction=converged_fraction,
            kkt_stationarity_max=stat,
            kkt_feasibility_max=feas,
            cost_mean=cost,
            extra={k: float(v) for k, v in extra.items()},
        )
        self.records.append(rec)
        if len(self.records) > self.capacity:
            del self.records[: len(self.records) - self.capacity]

    def summary(self) -> Dict[str, float]:
        if not self.records:
            return {}
        lat = np.array([r.latency_s for r in self.records])
        conv = np.array([r.converged_fraction for r in self.records])
        stats = np.array([r.kkt_stationarity_max for r in self.records])
        feas = np.array([r.kkt_feasibility_max for r in self.records])
        nanmax = lambda a: (  # noqa: E731
            float(np.nanmax(a)) if np.any(np.isfinite(a)) else float("nan")
        )
        return {
            "ticks": len(self.records),
            "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
            "latency_p99_ms": float(np.percentile(lat, 99) * 1e3),
            "latency_mean_ms": float(lat.mean() * 1e3),
            "converged_fraction_mean": float(np.nanmean(conv)),
            "kkt_stationarity_worst": nanmax(stats),
            "kkt_feasibility_worst": nanmax(feas),
        }

    def to_jsonl(self) -> str:
        return "\n".join(
            json.dumps(
                {
                    "t": r.wall_time_s,
                    "latency_s": r.latency_s,
                    "converged_fraction": r.converged_fraction,
                    "kkt_stat": r.kkt_stationarity_max,
                    "kkt_feas": r.kkt_feasibility_max,
                    "cost": r.cost_mean,
                    **r.extra,
                }
            )
            for r in self.records
        )
