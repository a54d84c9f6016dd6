"""Interval cost: the per-stage path against the whole-interval kernel.

The counterpart of the JAX package's ``scripts/pair_probe.py``.  At the
flagship field (B=512, H=HH=128, two trunk layers, I=21) it times chains
of N dependent intervals of three kinds:

- *even*: a rectilinear time-advance interval, contracting the time
  channel's head slice (``head_w[:, 0:H]``, I=1) only;
- *odd*: a value-update interval over all I channels;
- *pair*: an even interval, then an odd one.

each two ways:

- ``*_stages``: the path ``NeuralCDE`` runs -- the RK4 (3/8) stepper's four
  ``fused_matmul_field`` launches and its updates per interval (the JAX
  script's "xla" chains);
- ``*_interval``: one launch of ``fused_rk4_interval`` per interval.

It prints one JSON object: per variant the time per interval (per pair for
the pair variants) as ``chain_times`` gives it -- device time from a queued
segment of the chain, the chain's event span and its host wall clock --
and the launches of each kernel over the whole chain.  It writes no file.

Usage::

    python -m online_neural_cdes_tpu_torch.experiments.pair_probe \\
        [--device cpu] [--n 1000] [--batch 512] [--hidden 128] [--width 128] \\
        [--channels 21]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from online_neural_cdes_tpu_torch.models.vector_fields import VectorField
from online_neural_cdes_tpu_torch.ops import kernels, solvers
from online_neural_cdes_tpu_torch.utils.device import resolve_device
from online_neural_cdes_tpu_torch.utils.timing import chain_times

__all__ = ["COUNTERS", "variants", "run", "main"]

B, H, HH, I, N = 512, 128, 128, 21, 1000
COUNTERS = {"fused_field": kernels.fused_field_kernel,
            "fused_rk4": kernels.fused_rk4_kernel}
# Launches per interval of a per-stage chain: four field kernels and ten
# RK updates (1 + 2 + 3 + 4 multiply-adds).
STAGE_LAUNCHES = 14


def variants(batch, hidden, hh, channels, device, seed=0):
    """{name: (body, launches per iteration)}: ``body(z)`` advances the
    state by one interval (two for the pair variants)."""
    field = VectorField(input_dim=channels, hidden_dim=hidden, hidden_hidden_dim=hh,
                        num_layers=2, generator=torch.Generator().manual_seed(seed),
                        device=device)
    p = kernels.pack_fused_params(field.params, hidden, channels)
    trunk = [{k: v.detach() for k, v in layer.items()} for layer in p["trunk"]]
    head_w, head_b = p["head_w"].detach(), p["head_b"].detach()
    head_w_t = head_w[:, 0:hidden].contiguous()    # the time channel's slice
    head_b_t = head_b[0:hidden].contiguous()
    rng = np.random.default_rng(seed)
    dx_t = torch.from_numpy(rng.normal(size=(batch, 1)).astype(np.float32)).to(device)
    dx = torch.from_numpy(rng.normal(size=(batch, channels)).astype(np.float32)).to(device)
    step = solvers.tree_fixed_step("rk4")

    def stages(w, b, d, n_in):
        def body(z):
            return step(lambda t, zz: kernels.fused_matmul_field(trunk, w, b, zz, d,
                                                                 hidden, n_in),
                        0.0, 1.0, z)
        return body

    def interval(w, b, d, n_in):
        def body(z):
            return kernels.fused_rk4_interval(trunk, w, b, z, d, hidden, n_in)
        return body

    out = {}
    for kind, make, per in (("stages", stages, STAGE_LAUNCHES), ("interval", interval, 1)):
        even = make(head_w_t, head_b_t, dx_t, 1)
        odd = make(head_w, head_b, dx, channels)
        out[f"even_{kind}"] = (even, per)
        out[f"odd_{kind}"] = (odd, per)
        out[f"pair_{kind}"] = (lambda z, e=even, o=odd: o(e(z)), 2 * per)
    return out


def run(n=N, batch=B, hidden=H, hh=HH, channels=I, device=None) -> dict:
    device = resolve_device(device)
    z0 = torch.from_numpy(np.random.default_rng(1).normal(size=(batch, hidden))
                          .astype(np.float32)).to(device)
    rows = {}
    with torch.inference_mode():
        for name, (body, per) in variants(batch, hidden, hh, channels, device).items():
            def run_chain(k, body=body):
                z = z0
                for _ in range(k):
                    z = body(z)
                return z

            rows[name] = chain_times(run_chain, n, per, COUNTERS, device.type)
            rows[name]["unit"] = "pair" if name.startswith("pair") else "interval"
            rows[name]["finite"] = bool(torch.isfinite(run_chain(2)).all())
    return {"experiment": "pair_probe", "device": device.type,
            "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                     else "cpu"),
            "shape": {"B": batch, "H": hidden, "HH": hh, "I": channels, "N": n},
            "variants": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--hidden", type=int, default=H)
    ap.add_argument("--width", type=int, default=HH)
    ap.add_argument("--channels", type=int, default=I)
    a = ap.parse_args(argv)
    out = run(a.n, a.batch, a.hidden, a.width, a.channels, a.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
