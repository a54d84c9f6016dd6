"""Relu decisions that the field kernels' arithmetic takes the other way.

The stacked NCDE (``ncde-stacked`` at the flagship widths: C=21, static 10,
``hidden_dims=(128, 128)``, HH=128, three trunk layers) on 16 rows of the
flagship training batch (L=100, linear coefficients), with the adjoint off
so that every field call's backward recomputes the trunk from the state the
forward saved.  Three arms compute the parameter gradients of the
per-observation BCE:

- ``kernels``: the fused field's forward kernel (3xTF32 products), its VJP
  by the plain version (f32 products);
- ``plain``: the plain version forward and backward (f32 products);
- ``emulated``: the plain version with every product split as the kernels
  split it (``csrc/mma_tf32.cuh``: each f32 operand as a TF32 big part and
  a TF32 small part, a_small b_big + a_big b_small + a_big b_big in f32).

For each pair of arms it counts the relu inputs of the backward's trunk
recompute that fall on the other side of 0 and prints them with their
row's scale, beside the largest gradient gap (per tensor max) and each
batch row's share of the train gate on its input cotangents.  Beside them,
each forward call of the ``kernels`` arm against the emulated product on
the same inputs, as against the f32 plain version: the kernel rounds as
its model does.  It prints one JSON object and writes no file.

Usage (``--device cpu`` runs every arm on the plain version, at any size)::

    python -m online_neural_cdes_tpu_torch.experiments.relu_flips \\
        [--device cpu] [--rows 16] [--length 100] [--hidden 128]
"""

from __future__ import annotations

import argparse
import json
import subprocess
from contextlib import contextmanager

import numpy as np
import torch

from online_neural_cdes_tpu_torch.models.stacked import StackedNeuralCDE
from online_neural_cdes_tpu_torch.ops import kernels
from online_neural_cdes_tpu_torch.ops.interpolation import linear_interpolation_coeffs
from online_neural_cdes_tpu_torch.training.metrics import make_loss, masked_temporal_loss

GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-3   # chip_smoke.py's train gate


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 as the kernels round it (nearest, ties away
    from zero): add half a TF32 ulp to the bits, clear the 13 low ones."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32: the small x small term dropped, the big product
    and the two cross terms summed apart, as ``mma_3xtf32``."""
    a_big, b_big = tf32_round(a), tf32_round(b)
    a_small, b_small = tf32_round(a - a_big), tf32_round(b - b_big)
    return a_big @ b_big + (a_small @ b_big + a_big @ b_small)


class _SplitProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return split_product(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return (split_product(g, b.mT),
                split_product(a.reshape(-1, a.shape[-1]).mT, g.reshape(-1, g.shape[-1])))


@contextmanager
def arm(name, record=None):
    """Route the fused field as arm ``name``; with ``record`` (a list), each
    backward call appends its trunk's relu inputs."""
    mm, fwd, bwd = kernels._mm, kernels._forward, kernels._backward

    def split_mm(a, b, precision):
        if precision != "float32" or a.dtype != torch.float32:
            return mm(a, b, precision)
        return _SplitProduct.apply(a, b)

    def backward(trunk, head_w, head_b, z, dx, g, *rest):
        if record is not None:
            u, pres = z, []
            for layer in trunk:
                pre = kernels._mm(u, layer["w"], "float32") + layer["b"]
                pres.append(pre.detach().clone())
                u = torch.relu(pre)
            record.append(pres)
        return kernels._backward_reference(trunk, head_w, head_b, z, dx, g, *rest)

    if name != "kernels":
        kernels._forward = kernels._forward_reference
    if name == "emulated":
        kernels._mm = split_mm
    kernels._backward = backward
    try:
        yield
    finally:
        kernels._mm, kernels._forward, kernels._backward = mm, fwd, bwd


def flagship_batch(device, rows, length, seed=7):
    """The first ``rows`` rows of ``chip_smoke.py``'s flagship training
    batch (B=512, 100 observations, time in channel 0, static features,
    0/1 labels), its first ``length`` observations, linear coefficients."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(512, 100, 21)).astype(np.float32)
    x[:, :, 0] = np.arange(100)
    static = rng.normal(size=(512, 10)).astype(np.float32)
    labels = rng.integers(0, 2, size=(512, 100)).astype(np.float32)
    coeffs = linear_interpolation_coeffs(torch.from_numpy(x[:rows, :length]).to(device))
    return ((torch.from_numpy(static[:rows]).to(device), coeffs),
            torch.from_numpy(labels[:rows, :length]).to(device))


def gradients(model, inputs, labels):
    """(parameter gradients, the coefficients' cotangent) of the BCE."""
    model.zero_grad(set_to_none=True)
    static, coeffs = (t.detach().clone().requires_grad_() for t in inputs)
    masked_temporal_loss(make_loss("bce"), model((static, coeffs)), labels).backward()
    return ({n: p.grad.detach().clone() for n, p in model.named_parameters()},
            coeffs.grad.detach())


def differing_decisions(a, b, examples=8):
    """Relu inputs on opposite sides of 0 in two arms' recorded calls."""
    count, found = 0, []
    for call, (pa, pb) in enumerate(zip(a, b)):
        for layer, (x, y) in enumerate(zip(pa, pb)):
            idx = ((x > 0) != (y > 0)).nonzero().tolist()
            count += len(idx)
            found += [{"call": call, "layer": layer, "row": r, "unit": c,
                       "pre": [float(x[r, c]), float(y[r, c])],
                       "row_scale": float(x[r].abs().max())} for r, c in idx]
    return count, found[:examples]


def row_shares(got, want):
    """Each row's share of the train gate on its input cotangents."""
    got, want = (t.cpu().double().reshape(len(t), -1) for t in (got, want))
    err = (got - want).abs()
    gate = GRAD_RTOL * want.abs() + GRAD_ATOL_REL * want.abs().amax(dim=1, keepdim=True)
    return torch.where(err == 0, torch.zeros_like(err), err / gate).amax(dim=1).tolist()


def forward_accuracy(calls):
    """Per forward call of the kernels arm: max |kernel - emulated| and
    max |f32 plain - emulated| per max |emulated|, the worst over calls."""
    worst = {"kernel_vs_emulated": 0.0, "plain_vs_emulated": 0.0}
    for args, got in calls:
        want = kernels._forward_reference(*args)
        with arm("emulated"):
            emulated = kernels._forward_reference(*args)
        scale = float(emulated.abs().max()) or 1.0
        worst["kernel_vs_emulated"] = max(worst["kernel_vs_emulated"],
                                          float((got - emulated).abs().max()) / scale)
        worst["plain_vs_emulated"] = max(worst["plain_vs_emulated"],
                                         float((want - emulated).abs().max()) / scale)
    return worst


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=16)
    ap.add_argument("--length", type=int, default=100)
    ap.add_argument("--hidden", type=int, default=128)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs, labels = flagship_batch(args.device, args.rows, args.length)
    model = StackedNeuralCDE(
        input_dim=21, hidden_dims=(args.hidden, args.hidden), output_dim=1,
        hidden_hidden_dim=args.hidden, static_dim=10, adjoint=False, return_sequences=True,
        device=args.device, generator=torch.Generator().manual_seed(0))
    records, grads, forwards = {}, {}, []
    forward = kernels._forward

    def recording_forward(*call):
        out = forward(*call)
        forwards.append(([t.detach().clone() if torch.is_tensor(t) else
                          [{k: v.detach().clone() for k, v in d.items()} for d in t]
                          if isinstance(t, list) else t for t in call], out.detach().clone()))
        return out

    for name in ("kernels", "plain", "emulated"):
        records[name] = []
        with arm(name, records[name]):
            if name == "kernels":
                kernels._forward = recording_forward
            grads[name] = gradients(model, inputs, labels)
    pairs = []
    for a, b in (("kernels", "plain"), ("emulated", "plain"), ("kernels", "emulated")):
        count, examples = differing_decisions(records[a], records[b])
        (ga, ca), (gb, cb) = grads[a], grads[b]
        gaps = {n: float((ga[n] - w).abs().max() / w.abs().max()) for n, w in gb.items()}
        worst = max(gaps, key=gaps.get)
        shares = row_shares(ca, cb)
        pairs.append({"arms": [a, b], "differing_relu_decisions": count,
                      "examples": examples, "largest_gradient_gap": [worst, gaps[worst]],
                      "rows_past_their_gate": {r: s for r, s in enumerate(shares) if s > 1.0},
                      "largest_share_of_the_other_rows": max((s for s in shares if s <= 1.0),
                                                                default=None)})
    result = {"experiment": "relu_flips", "device": args.device, "rows": args.rows,
              "length": args.length, "hidden": args.hidden,
              "backward_calls": len(records["plain"]),
              "relu_decisions": sum(p.numel() for call in records["plain"] for p in call),
              "pairs": pairs, "forward_calls": forward_accuracy(forwards)}
    if args.device != "cpu":
        result["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
