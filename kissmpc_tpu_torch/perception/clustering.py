"""Fixed-shape density clustering, the DBSCAN of the perception stack: a
port of `kissmpc_tpu/perception/clustering.py`.

The reference clusters each track's LiDAR points with sklearn DBSCAN
(eps 0.08, min_samples 10, `obstacle_handling/human_tracking.py:126-127,273`)
and takes the largest cluster's mean as the human centre (`:276-283`).  This
is the batched equivalent: a dense eps-radius graph and iterated min-label
propagation (connected components of the core-point graph), with static
shapes and any leading batch axes.  Cluster membership matches DBSCAN;
cluster ids are the smallest member index; noise is -1.

The adjacency stays bool and the labels int32.  The squared distances are
summed per component (dx*dx + dy*dy, ...) in index order, never through a
[..., P, P, D] difference tensor, and each sweep is one masked min over a
[..., P, P] int32 tensor, with no early exit, so no sweep reads a value back
to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ClusterResult(NamedTuple):
    labels: torch.Tensor  # [..., P] int32: cluster id (= min point index) or -1
    num_clusters: torch.Tensor  # [...] int32


def dbscan(points: torch.Tensor, mask: torch.Tensor, eps: float, min_samples: int,
           max_iters: int | None = None) -> ClusterResult:
    """Density clustering via label propagation on the eps-radius graph.

    points [..., P, D], mask [..., P] bool validity (padding).

    * core point: >= min_samples neighbours within eps (self included, as in
      sklearn);
    * clusters: connected components of core points under the eps graph;
    * border points adopt the smallest label of their core neighbours;
      others are noise.

    ``max_iters`` sweeps of label propagation, min(32, P) by default (as in
    the reference), whatever the labels do.
    """
    P = points.shape[-2]
    if max_iters is None:
        max_iters = min(32, P)
    dev = points.device

    d2 = None
    for k in range(points.shape[-1]):
        c = points[..., k]
        diff = c[..., :, None] - c[..., None, :]
        sq = diff * diff
        d2 = sq if d2 is None else d2 + sq
    valid_pair = mask[..., :, None] & mask[..., None, :]
    adj = valid_pair & (d2 <= eps * eps)  # includes self (d2 = 0)
    degree = adj.sum(-1)
    core = mask & (degree >= min_samples)

    # Core-core propagation: label = min reachable core index.
    core_adj = adj & core[..., :, None] & core[..., None, :]
    idx = torch.arange(P, dtype=torch.int32, device=dev)
    big = P
    labels = torch.where(core, idx, big)
    for _ in range(max_iters):
        neigh = torch.where(core_adj, labels[..., None, :], big)
        new = torch.minimum(labels, neigh.amin(-1))
        labels = torch.where(core, new, big)

    # Border points: adopt the min core neighbour's label.
    border = torch.where(adj & core[..., None, :], labels[..., None, :], big).amin(-1)
    labels = torch.where(core, labels, border)
    labels = torch.where(mask & (labels < big), labels, -1)

    is_root = mask & (labels == idx) & (labels >= 0)
    return ClusterResult(labels=labels.to(torch.int32),
                         num_clusters=is_root.sum(-1).to(torch.int32))


def largest_cluster_mean(points: torch.Tensor,
                         result: ClusterResult) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean of the most populous cluster (`human_tracking.py:276-283`).

    points [..., P, D].  Returns (centre [..., D], found [...] bool): with no
    cluster the centre is zeros and found is False.  Ties go to the lowest
    root index, as the reference's argmax gives them.
    """
    P = points.shape[-2]
    labels = result.labels
    # Members per root label; noise counts into a dropped last slot.
    slot = torch.where(labels >= 0, labels, P).to(torch.int64)
    counts = torch.zeros(labels.shape[:-1] + (P + 1,), dtype=torch.int32, device=labels.device)
    counts = counts.scatter_add(-1, slot, torch.ones_like(labels))[..., :P]
    best_root = counts.argmax(-1, keepdim=True)
    found = counts.gather(-1, best_root)[..., 0] > 0
    member = labels == best_root
    denom = torch.clamp(member.sum(-1, keepdim=True), min=1)
    zero = torch.zeros((), dtype=points.dtype, device=points.device)
    centre = _xla_sum(torch.where(member[..., None], points, zero)) / denom
    return centre, found


def _xla_sum(x: torch.Tensor, chunk: int = 32) -> torch.Tensor:
    """Sum over axis -2 in the order XLA's CPU backend sums a long axis:
    each run of ``chunk`` rows from the first to the last, then the runs'
    partial sums in order (the last run padded with zeros).  One rounding
    of a centre decides whether a later track falls inside its gate, so
    the port sums as the reference does; elementwise adds also make the
    card's sum equal to the CPU's."""
    P = x.shape[-2]
    n = -(-P // chunk)
    if n > 1 and P % chunk:
        pad = x.new_zeros(x.shape[:-2] + (n * chunk - P,) + x.shape[-1:])
        x = torch.cat([x, pad], dim=-2)
    width = chunk if n > 1 else P
    runs = x.reshape(x.shape[:-2] + (n, width) + x.shape[-1:])
    part = runs[..., 0, :]
    for i in range(1, width):
        part = part + runs[..., i, :]
    total = part[..., 0, :]
    for j in range(1, n):
        total = total + part[..., j, :]
    return total
