"""The comparison that decides `correct`: what the timed path produced,
judged against the plain reference and by what it claims.

Two kinds of number, each held to a limit from the cell's file:

- agreement with the reference: the share of compared answers that the
  reference contradicts (another converged flag, or, both converged,
  controls apart by more than the cell's tolerance), or the share of the
  answers the reference converged on whose controls are that far apart;
- what an answer claims: the largest gap between the constraint violation
  that the program reports for an answer (its ``kkt_feasibility``) and
  the violation of the returned trajectory, recomputed in float64 by the
  reference from the problem it rebuilt from the raw scenario (dynamics
  defects, the pinned start, the control and state boxes, the inflated
  obstacles), as a share of 1 + the reported value.  A sound answer's gap
  is rounding; an answer altered after it was computed, or one returned
  for another scenario, claims what it does not hold.
"""

from __future__ import annotations

import torch

from .reference import ipm, unicycle


def violation(cfg, problem, states, controls) -> torch.Tensor:
    """[B] largest violation of the trajectories (states [B, N+1, 3],
    controls [B, N, 2]) for ``problem`` (the reference's), in float64."""
    p = type(problem)(*(x.double() for x in problem))
    states, controls = states.double(), controls.double()
    d = unicycle.defects(states, controls, cfg.time_step).abs().flatten(1).amax(dim=1)
    pin = (p.initial_state - states[:, 0]).abs().amax(dim=1)
    vals, _, _, masks = ipm._constraint_values(cfg, p, states, controls)
    worst = torch.maximum(d, pin)
    for c, m in zip(vals, masks):
        if c.numel():
            worst = torch.maximum(worst, (m * torch.clamp(-c, min=0.0)).flatten(1).amax(dim=1))
    return worst


def disagreeing(conv, ref_conv, controls, ref_controls, tol: float) -> torch.Tensor:
    """[B] answers whose converged flag differs from the reference's, or
    which both report converged with controls apart by more than ``tol``,
    or which are not finite."""
    gap = (controls.double() - ref_controls.double()).abs().flatten(1).amax(dim=1)
    finite = torch.isfinite(controls.double()).flatten(1).all(dim=1)
    return (conv != ref_conv) | (conv & ref_conv & ~(gap <= tol)) | ~finite


def missed_share(ref_conv, controls, ref_controls, tol: float) -> float:
    """The share of the answers that the reference reports converged whose
    controls are apart from the reference's by more than ``tol`` or not
    finite, whatever the program reports of them (0 where the reference
    converged on none): a program that returns a plan it did not solve,
    and says so, misses them as one that claims it did."""
    gap = (controls.double() - ref_controls.double()).abs().flatten(1).amax(dim=1)
    bad = ref_conv & ~(gap <= tol)
    n = int(ref_conv.sum())
    return float(bad.sum()) / n if n else 0.0


def off_share(ref_usable, controls, ref_controls, tol: float) -> float:
    """The share of the answers whose reference plan is usable whose first
    control is apart from the reference's by more than ``tol`` or not
    finite (0 where no reference plan is usable): where the reference does
    not converge, a program that returns a plan it did not solve still
    gives a command far from the reference's."""
    gap = (controls[:, 0].double() - ref_controls[:, 0].double()).abs().amax(dim=1)
    bad = ref_usable & ~(gap <= tol)
    n = int(ref_usable.sum())
    return float(bad.sum()) / n if n else 0.0


def claim_gap(cfg, problem, feasibility, states, controls) -> float:
    """The largest |recomputed violation - reported feasibility| / (1 +
    |reported|) over the finite answers (one that is not finite counts in
    `disagreement`)."""
    v = violation(cfg, problem, states, controls)
    f = feasibility.double()
    gap = (v - f).abs() / (1.0 + f.abs())
    gap = gap[torch.isfinite(gap)]
    return float(gap.max()) if gap.numel() else 0.0
