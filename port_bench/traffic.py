"""The general traffic generator: irregular, partly missing series from a
seed.

A traffic mix is a data file, ``traffic/<mix>.json``, of parameters:

- ``series``: series (or streams) in a batch;
- ``length``: observations a series;
- ``pool``: batches made (a training cell cycles through them);
- ``gap_mean``: the mean of the exponential gaps between observations, in
  hours (the time channel, channel 0, is their running sum from 0);
- ``nan_share``: the share of value entries (never the time channel) that
  are missing (NaN);
- ``label_share``: the share of 0/1 labels, one an observation, that are 1.

Values and static features are N(0, 1).  The pattern follows the smoke
run's (``chip_smoke.py::make_requests`` and ``train_batch``: N(0, 1)
values, the time in channel 0, 30% of the values missing, 0/1 labels an
observation), with exponential gaps where those step the time by 1.
Everything is drawn on ``device`` from one ``torch.Generator`` seeded with
the run's seed, in a few large calls, so the same seed gives the same
batches on one device.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import torch

KEYS = ("series", "length", "pool", "gap_mean", "nan_share", "label_share")


@dataclass
class Batches:
    """``pool`` batches: ``x`` (pool, series, length, channels) with the
    time in channel 0 and NaN for a missing value, ``static`` (pool,
    series, static_dim), ``labels`` (pool, series, length)."""

    x: torch.Tensor
    static: torch.Tensor
    labels: torch.Tensor


def load(root: Path, mix: str) -> dict:
    """The parameters of the traffic mix ``mix`` under ``root``
    (``port_bench/traffic/<mix>.json``); raises on a missing or unknown
    key."""
    params = json.loads((root / "port_bench" / "traffic" / f"{mix}.json").read_text())
    missing = [k for k in KEYS if k not in params]
    if missing:
        raise ValueError(f"traffic {mix!r} lacks {missing}")
    return params


def generate(params: dict, channels: int, static_dim: int, gen: torch.Generator,
             device) -> Batches:
    """The mix's batches, drawn from ``gen`` on ``device``."""
    p, n, length = params["pool"], params["series"], params["length"]
    shape = (p, n, length, channels)
    u = torch.rand((p, n, length), generator=gen, device=device)
    gaps = -params["gap_mean"] * torch.log1p(-u)      # exponential, finite for u in [0, 1)
    gaps[..., 0] = 0.0
    x = torch.randn(shape, generator=gen, device=device)
    x[..., 0] = torch.cumsum(gaps, dim=-1)
    holes = torch.rand(shape, generator=gen, device=device) < params["nan_share"]
    holes[..., 0] = False
    x[holes] = float("nan")
    static = torch.randn((p, n, static_dim), generator=gen, device=device)
    labels = (torch.rand((p, n, length), generator=gen, device=device)
              < params["label_share"]).to(torch.float32)
    return Batches(x=x, static=static, labels=labels)
