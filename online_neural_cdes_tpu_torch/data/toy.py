"""Brownian-motion sign-prediction toy problem.

PyTorch counterpart of the JAX package's ``data/toy.py``: standard Brownian
paths on [start, end] with ``n_points`` knots, channels (time, value), and
the binary label "is the terminal value positive" repeated over time.  The
increments are drawn on the CPU from the caller's ``torch.Generator`` and
then moved to ``device`` (the card unless ``device="cpu"`` is asked for),
so one seed gives the same data on every device (not the JAX PRNG's
numbers).
"""

from __future__ import annotations

import math

import torch

from online_neural_cdes_tpu_torch.utils.device import resolve_device

__all__ = ["brownian_motion_data"]


def brownian_motion_data(
    generator: torch.Generator,
    num_paths: int,
    n_points: int = 3,
    start: float = 0.0,
    end: float = 1.0,
    dtype=torch.float32,
    device=None,
):
    """Returns (x, y): x (num_paths, n_points, 2) with channels (t, W_t);
    y (num_paths, n_points) repeated binary labels."""
    times = torch.linspace(start, end, n_points, dtype=dtype)
    dt = (end - start) / (n_points - 1)
    increments = torch.randn((num_paths, n_points - 1), generator=generator,
                             dtype=dtype) * math.sqrt(dt)
    bm = torch.cat([torch.zeros((num_paths, 1), dtype=dtype),
                    torch.cumsum(increments, dim=1)], dim=1)
    x = torch.stack([times.expand(bm.shape), bm], dim=-1)
    labels = (bm[:, -1] > 0).to(dtype)
    y = labels[:, None].expand(bm.shape).contiguous()
    device = resolve_device(device)
    return x.to(device), y.to(device)
