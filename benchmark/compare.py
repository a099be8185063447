"""The numbers that decide `correct`: gaps between what the program's timed
path produced and what the plain reference makes of the same inputs.

Training: each update's losses, the first update's gradients as the
optimizer got them, the leaves' change over the compared updates, each
step's mean reward, and the fields. Gradients and changes are compared leaf
by leaf as gaps of norms, |‖program‖ - ‖reference‖|, over the reference's
norm of that leaf or of the median leaf, whichever is larger, and the worst
leaf counts. A leaf whose reference gradient is under a thousandth of the
median leaf's moves by round-off alone under Adam, and its change is not
compared. Control: each sampled step's action, reward and next field from
the program's own state before it, and the first steps from the reset.
"""

from __future__ import annotations

import statistics

import torch

FLAT_LEAF = 1e-3  # a leaf whose reference gradient is below this share of the median's


def _norms(ts) -> list[float]:
    return [float(torch.linalg.vector_norm(t.double())) for t in ts]


def leaf_gap(prog, ref, keep=None) -> float:
    """Worst leaf of |‖p‖ - ‖r‖| / max(‖r‖, median leaf ‖r‖)."""
    np_, nr = _norms(prog), _norms(ref)
    med = statistics.median(nr)
    gaps = [abs(p - r) / max(r, med, 1e-30) for i, (p, r) in enumerate(zip(np_, nr))
            if keep is None or keep[i]]
    return max(gaps) if gaps else 0.0


def moving_leaves(ref_grads) -> list[bool]:
    nr = _norms(ref_grads)
    med = statistics.median(nr)
    return [r >= FLAT_LEAF * med for r in nr]


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().to(b.device), b.double()
    return float(torch.linalg.vector_norm(a - b) / max(float(torch.linalg.vector_norm(b)), 1e-30))


def train_gaps(prog: dict, ref: dict) -> dict:
    """Gaps of a train cell. `prog` and `ref` hold `losses` [(critic,
    actor)] per update, `grads` (first update, leaves), `before` and
    `after` leaves, `mean_reward` per step, `fields` [(program, reference)
    pairs are formed from `field` and, where present, `init_field`]."""
    n = min(len(prog["losses"]), len(ref["losses"]))
    if n == 0 or len(prog["losses"]) != len(ref["losses"]):
        raise RuntimeError(f"updates: program {len(prog['losses'])}, reference {len(ref['losses'])}")
    loss = max(rel(p, r) for pl, rl in zip(prog["losses"], ref["losses"]) for p, r in zip(pl, rl))
    grad = leaf_gap(prog["grads"], ref["grads"])
    keep = moving_leaves(ref["grads"])
    d_prog = [a.double().cpu() - b.double().cpu() for a, b in zip(prog["after"], prog["before"])]
    d_ref = [a.double().cpu() - b.double().cpu() for a, b in zip(ref["after"], ref["before"])]
    change = leaf_gap(d_prog, d_ref, keep)
    reward = max(rel(p, r) for p, r in zip(prog["mean_reward"], ref["mean_reward"]))
    field = rel_l2(prog["field"], ref["field"])
    if "init_field" in ref:
        field = max(field, rel_l2(prog["init_field"], ref["init_field"]))
    return {"loss": loss, "grad": grad, "change": change, "reward": reward, "field": field}


def control_gaps(prog_steps: list, ref_steps: list, prog_start: dict, ref_start: dict) -> dict:
    """Gaps of the control cell: over the sampled steps, the largest action
    gap, the largest reward gap relative to the step's largest reward, the
    largest relative gap of the next field; and over the first steps from
    the reset, the largest action gap or relative field gap."""
    action = max(float((p["action"].to(r["action"].device) - r["action"]).abs().max())
                 for p, r in zip(prog_steps, ref_steps))
    reward = max(float((p["reward"].to(r["reward"].device) - r["reward"]).abs().max()
                       / r["reward"].abs().max().clamp_min(1e-30))
                 for p, r in zip(prog_steps, ref_steps))
    field = max(rel_l2(p["y"], r["y"]) for p, r in zip(prog_steps, ref_steps))
    n = len(prog_start["action"])
    start = max(max(float((prog_start["action"][i].to(ref_start["action"][i].device)
                           - ref_start["action"][i]).abs().max()),
                    rel_l2(prog_start["y"][i], ref_start["y"][i])) for i in range(n))
    return {"action": action, "reward": reward, "field": field, "start": start}
