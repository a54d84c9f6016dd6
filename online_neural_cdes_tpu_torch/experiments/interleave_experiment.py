"""K replicas' interval chains: one launch for all of them, or one each.

The counterpart of the JAX package's ``scripts/interleave_experiment.py``.
At the flagship field (B=512, H=HH=128, two trunk layers, C=21) with the
weights of replica r from seed r, it times forward chains of N=396 unit
RK4 (3/8) intervals:

- ``single``: replica 0 alone, one ``fused_rk4_interval`` launch per
  interval;
- ``k{K}_seq``: K replicas one after another, K x ``single`` by arithmetic;
- ``k{K}_launches``: each interval launches the K replicas' single-interval
  kernels one after another on one stream (the JAX script's
  ``k{K}_xla_ops``);
- ``k{K}_interleave``: one ``fused_rk4_interval_multi`` launch per interval
  for all K replicas;

for K in (2, 4).  Before timing it checks that the K-replica kernel gives
exactly what K single launches give.  Win condition of the JAX script,
reported and not enforced: ``k2_interleave`` under 1.6 x ``single``.  It
prints one JSON object and writes no file.

Usage::

    python -m online_neural_cdes_tpu_torch.experiments.interleave_experiment \\
        [--device cpu] [--n 396] [--batch 512] [--hidden 128] [--channels 21]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from online_neural_cdes_tpu_torch.models.vector_fields import VectorField
from online_neural_cdes_tpu_torch.ops import kernels
from online_neural_cdes_tpu_torch.utils.device import resolve_device
from online_neural_cdes_tpu_torch.utils.timing import chain_times

__all__ = ["COUNTERS", "replica_fields", "stack_fields", "run", "main"]

B, H, C, N = 512, 128, 21, 396
KS = (2, 4)
WIN_RATIO = 1.6
COUNTERS = {"fused_rk4": kernels.fused_rk4_kernel,
            "fused_rk4_multi": kernels.fused_rk4_multi_kernel}


def replica_fields(k, hidden, channels, device):
    """Packed fields of replicas 0..k-1, replica r from seed r."""
    packs = []
    for r in range(k):
        field = VectorField(input_dim=channels, hidden_dim=hidden,
                            hidden_hidden_dim=hidden, num_layers=2,
                            generator=torch.Generator().manual_seed(r), device=device)
        p = kernels.pack_fused_params(field.params, hidden, channels)
        packs.append({"trunk": [{k_: v.detach() for k_, v in layer.items()}
                                for layer in p["trunk"]],
                      "head_w": p["head_w"].detach(), "head_b": p["head_b"].detach()})
    return packs


def stack_fields(packs):
    """The K-replica op's stacked layouts of ``packs``."""
    trunk = [{"w": torch.stack([p["trunk"][i]["w"] for p in packs]),
              "b": torch.stack([p["trunk"][i]["b"] for p in packs])}
             for i in range(len(packs[0]["trunk"]))]
    return (trunk, torch.stack([p["head_w"] for p in packs]),
            torch.stack([p["head_b"] for p in packs]))


def run(n=N, batch=B, hidden=H, channels=C, device=None) -> dict:
    device = resolve_device(device)
    k_max = max(KS)
    rng = np.random.default_rng(0)
    z0 = torch.from_numpy(rng.normal(size=(k_max, batch, hidden))
                          .astype(np.float32)).to(device)
    dxs = torch.from_numpy((rng.normal(size=(n, k_max, batch, channels)) * 0.05)
                           .astype(np.float32)).to(device)
    rows = {}
    with torch.inference_mode():
        packs = replica_fields(k_max, hidden, channels, device)
        stacks = {k: stack_fields(packs[:k]) for k in KS}

        def single(r, z, dx):
            p = packs[r]
            return kernels.fused_rk4_interval(p["trunk"], p["head_w"], p["head_b"], z,
                                              dx, hidden, channels)

        # Parity: the K-replica kernel against K single launches, exactly.
        parity = {}
        for k in KS:
            got = kernels.fused_rk4_interval_multi(*stacks[k], z0[:k].contiguous(),
                                                   dxs[0, :k].contiguous(), hidden,
                                                   channels)
            want = torch.stack([single(r, z0[r], dxs[0, r]) for r in range(k)])
            if not torch.equal(got, want):
                raise AssertionError(
                    f"K={k}: the K-replica kernel differs from K single launches by "
                    f"{float((got - want).abs().max())}")
            parity[f"k{k}"] = "bit-identical"

        def chain_single(m):
            z = z0[0]
            for i in range(m):
                z = single(0, z, dxs[i % n, 0])
            return z

        rows["single"] = chain_times(chain_single, n, 1, COUNTERS, device.type)
        for k in KS:
            def chain_launches(m, k=k):
                zs = [z0[r] for r in range(k)]
                for i in range(m):
                    zs = [single(r, zs[r], dxs[i % n, r]) for r in range(k)]
                return zs[-1]

            def chain_interleave(m, k=k):
                z = z0[:k].contiguous()
                for i in range(m):
                    z = kernels.fused_rk4_interval_multi(*stacks[k], z,
                                                         dxs[i % n, :k].contiguous(),
                                                         hidden, channels)
                return z

            rows[f"k{k}_launches"] = chain_times(chain_launches, n, k, COUNTERS,
                                                 device.type)
            rows[f"k{k}_interleave"] = chain_times(chain_interleave, n, 1, COUNTERS,
                                                   device.type)
    _derive(rows)
    return {"experiment": "interleave_experiment", "device": device.type,
            "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                     else "cpu"),
            "shape": {"B": batch, "H": hidden, "HH": hidden, "C": channels, "N": n},
            "parity": parity, "variants": rows}


def _derive(rows):
    """k{K}_seq by arithmetic, each variant's time per replica and its
    aggregate speed-up over K x single, and the win condition -- on the
    card's device time, or on the wall clock where that is all there is."""
    key = "device_us" if isinstance(rows["single"].get("device_us"), float) else "wall_us"
    t1 = rows["single"][key]
    rows["single"].update(K=1, per_replica_us=t1, aggregate_speedup=1.0)
    for k in KS:
        rows[f"k{k}_seq"] = {key: k * t1, "K": k, "per_replica_us": t1,
                             "aggregate_speedup": 1.0, "by": "arithmetic"}
        for name in (f"k{k}_launches", f"k{k}_interleave"):
            t = rows[name][key]
            rows[name].update(K=k, per_replica_us=None if t is None else t / k,
                              aggregate_speedup=None if t is None else k * t1 / t)
    t2 = rows["k2_interleave"][key]
    rows["win"] = {"on": key, "ratio_k2_interleave_to_single": t2 / t1,
                   "limit": WIN_RATIO, "met": t2 < WIN_RATIO * t1}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--hidden", type=int, default=H)
    ap.add_argument("--channels", type=int, default=C)
    a = ap.parse_args(argv)
    out = run(a.n, a.batch, a.hidden, a.channels, a.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
