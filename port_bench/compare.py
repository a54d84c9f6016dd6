"""The numbers that decide ``correct``: what the timed path produced
against the plain reference, each a gap that its limit (in the cell's
``workloads/<cell>.json``) bounds from above."""

from __future__ import annotations

import statistics

import numpy as np
import torch

# Leaves whose reference gradient is under this share of the median
# leaf's move under Adam by round-off alone; their change is not compared.
MOVED = 1e-3


def _norms(tree):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def worst(values) -> float:
    """The largest of ``values``; infinite if any is not finite."""
    values = list(values)
    return max(values) if all(np.isfinite(values)) else float("inf")


def leaf_gaps(got: dict, want: dict, keys=None) -> dict:
    """Per leaf, |norm(got) - norm(want)| over the larger of norm(want) and
    the median leaf's norm(want)."""
    g, w = _norms(got), _norms(want)
    floor = statistics.median(w.values())
    return {k: abs(g[k] - w[k]) / max(w[k], floor) for k in (keys or w)}


def train_numbers(got_losses, got_grad1, got_change, want_losses, want_grad1,
                  want_change) -> dict:
    """``loss1_gap``: the first step's loss, relative gap (the later
    steps' losses move with Adam's first, sign-like updates of entries
    whose gradient is zero to rounding, and are not compared);
    ``grad_gap``: the worst leaf's gap of the first gradient's norms;
    ``change_gap``: the worst leaf's gap of the norms of the weights' change
    over the three steps, among the leaves the reference moves."""
    gl = torch.as_tensor(got_losses, dtype=torch.float64).cpu()
    wl = torch.as_tensor(want_losses, dtype=torch.float64).cpu()
    loss1 = float((gl[0] - wl[0]).abs() / wl[0].abs())
    w1 = _norms(want_grad1)
    floor = statistics.median(w1.values())
    moved = [k for k, v in w1.items() if v >= MOVED * floor]
    return {
        "loss1_gap": worst([loss1]),
        "grad_gap": worst(leaf_gaps(got_grad1, want_grad1).values()),
        "change_gap": worst(leaf_gaps(got_change, want_change, moved).values()),
    }


def score_gap(answers, want: np.ndarray) -> float:
    """The widest gap of any served score from the reference's at its tick,
    over the root mean square of the reference's scores.  ``answers`` is a
    list of cycles, each a list of (streams, 1) host arrays from tick 1 on;
    ``want`` is (ticks, streams)."""
    scale = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    gaps = [0.0]
    for cycle in answers:
        got = np.stack([a[:, 0] for a in cycle])
        gaps.append(float(np.abs(got - want[:len(cycle)]).max()))
    return worst(gaps) / scale
