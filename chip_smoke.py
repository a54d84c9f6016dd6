#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's serving and training paths at the width of the
repository's flagship online NCDE (C=21 with time in channel 0, H=HH=128,
two trunk layers, static_dim=10, rectilinear, RK4 one step per knot,
return_sequences) with random weights from a seed, the interval-chain
experiments at the same field width, and the flagship under Hermite
controls, and prints one JSON line per phase:

1. env       -- torch, CUDA, nvcc, triton, CUTLASS headers, the card.
2. build     -- builds every kernel from ``online_neural_cdes_tpu_torch/csrc``,
                one ``nvcc`` per source, all started together.
3. kernel    -- the fused field's forward kernel against its plain PyTorch
                version on the card over the sweep and a width above 256
                (its CUDA-core path), identical bits on a repeat call, and
                its time (CUDA events) beside its bounds and the plain
                version's time, with each of its launches' device time.
4. kernel_bwd -- the same for the backward kernel: all six cotangent
                groups over the sweep, identical bits on a repeat call, a
                width its tiles cannot hold refused without a launch, and
                each of its launches' device time at the training shapes.
                Both field kernels also run the sweep in bf16 storage and
                under precision "bfloat16" (each held to one bf16 ulp of
                the plain version in the same mode, and in the rounded
                modes that gate shown to refuse the kernel's "float32"
                instantiation), are timed in bf16, and print a sha256
                digest of their f32 outputs at a fixed seed.
5. kernel_rk4 -- the whole-interval RK4 kernel against its plain version
                over the sweep, its K-replica form (K = 1..4) bit for bit
                against K single launches, a width beyond its limit refused
                without a launch, and its times.
6. predictor -- ``Predictor`` serving 64 ragged, NaN-holding requests: the
                kernels' launch counts for one forward, the outputs against
                the same predictor on the CPU, and request latencies.
   profile   -- one ``predict`` under torch.profiler: device time by kernel
                and the device's busy share of the call.
7. stepper   -- ``OnlineNCDEStepper`` over 64 streams x 99 ticks against
                the predictor's rows, and tick latencies.
8. train     -- ``make_train_step`` (Adam, BCE, lr 5e-4, interval adjoint)
                on a B=512 flagship batch: the kernels' launch counts for
                one step, the card's gradients against the CPU port's on a
                16-row slice, falling losses, step times, the profile of a
                step and the peak device memory.
9. chains    -- the ``pair_probe`` and ``interleave_experiment`` modules'
                chains (per-stage path against the interval kernel; K
                replicas in one launch against one launch each) with their
                launch counts, and the interval kernel chained over the
                flagship batch against ``cdeint``'s per-stage solve.
10. splines  -- every spline coefficient builder on the card against the
                CPU, a Hermite flagship ``Predictor`` and one Hermite
                training step: launch counts, card against CPU, times.
11. toy      -- the Brownian-motion toy under the rectilinear, Hermite and
                natural cubic schemes, trained on the card and on the CPU
                from the same weights and data: the loss curves agree and
                the last-time train accuracy rises.
12. train_bf16 -- one flagship step with ``compute_dtype="bfloat16"``: launch
                counts, the card's bf16 gradients against the CPU's on 16
                rows (on their first 10 observations, each parameter's
                held to half the CPU's own bf16-vs-f32 distance), the
                first loss against the f32 one, 10 more
                steps with a falling loss, step times, profile and peak
                memory beside the f32 step's.
13. predict_bf16 -- one ``predict`` of a bf16 flagship model: launch counts,
                and the card's outputs against the CPU's, held to the CPU's
                own bf16-vs-f32 distance.
14. bench_bf16_leg -- the JAX package's bf16 parity leg (bench.py): the
                flagship field in bf16 storage under precision "bfloat16",
                forward and gradient, the card against the CPU.

Then a line with every kernel's numbers, a line with the run's seconds, a
line with the card's name and power limit as ``nvidia-smi`` gives them,
and, as the last line, ``{"ok": true, "device": {...}}``.  Any failure
raises: the run then exits non-zero without that last line.  It needs a
CUDA card, and it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import numpy as np
import torch

from online_neural_cdes_tpu_torch.utils.timing import device_us

# Flagship online NCDE (the repository's MIMIC-scale configuration).
C, H, HH, N_LAYERS, STATIC = 21, 128, 128, 2, 10
N_REQUESTS, MIN_LEN, MAX_LEN = 64, 60, 100
LENGTH_MULTIPLE = 16
# (B, H, HH, I, n_trunk): the serving shapes (I=21 value pieces, I=1 time
# pieces, B=1 and 64 buckets), the flagship training batch's two shapes,
# and odd widths (H = HH = 256 with four layers fills the backward kernel's
# shared memory; the last one's H and HH are not multiples of 8, the
# tensor-core tiles' edge).
SWEEP = [(64, 128, 128, 21, 2), (64, 128, 128, 1, 2), (1, 128, 128, 21, 2),
         (512, 128, 128, 21, 2), (512, 128, 128, 1, 2), (5, 96, 196, 21, 3),
         (33, 256, 64, 21, 4), (9, 256, 256, 3, 4), (17, 42, 37, 5, 1)]
# The training step's dominant shape: the kernels line reports each
# kernel's times here, where most of its counted launches run.
TRAIN_SHAPE = (512, 128, 128, 21, 2)
TIMED = [(64, 128, 128, 21, 2), (64, 128, 128, 1, 2),
         (512, 128, 128, 21, 2), (512, 128, 128, 1, 2)]
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5   # the sums run in another order
# Forward-only: a width above the tensor-core tiles' 256, which takes the
# forward kernel's CUDA-core path for wide models (the backward and the
# interval kernel refuse it).
FWD_WIDE = [(3, 320, 264, 2, 1)]
# The whole-interval RK4 kernel: the forward sweep plus bench.py's parity
# shape; timed at the training step's two shapes and the serving batch;
# its K-replica form at K = 1..4 on the training shape and K = 3 on a
# ragged one, and timed at K = 2 and 4.
RK4_SWEEP = SWEEP + [(256, 128, 64, 21, 2)]
RK4_TIMED = [(512, 128, 128, 21, 2), (512, 128, 128, 1, 2), (64, 128, 128, 21, 2)]
RK4_MULTI = [(TRAIN_SHAPE, (1, 2, 3, 4)), ((5, 96, 196, 21, 3), (3,))]
RK4_MULTI_TIMED = (2, 4)
# Backward kernel vs its plain version, each of the six groups: |err| <=
# BWD_RTOL |want| + BWD_ATOL_REL max|want|.  Weight grads sum B rows (and
# dz, ddx sum I*H columns) in another order than cuBLAS; f32 round-off of
# such a sum grows with its largest terms, so the absolute part scales with
# the group's largest magnitude.
BWD_RTOL, BWD_ATOL_REL = 1e-4, 1e-5
SERVE_RTOL, SERVE_ATOL = 1e-3, 1e-4     # card vs CPU over 222 RK intervals
# Stepper vs predictor on one card: the same kernel arithmetic, but the
# readout sums over H=128 in other orders (a 64x128 product per tick
# against one (64*223)x128 product), and f32 round-off grows over 198 RK
# intervals.
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
# The interval kernel chained over the flagship batch's 198 intervals
# against cdeint's per-stage solve: the same field arithmetic, the RK
# updates rounded in another order.  Hidden states reach |z| ~ 100, where
# f32's spacing is ~8e-6, and the trunk mixes every hidden unit into every
# other, so a round-off at the largest unit reaches units near zero: per
# tensor |err| <= CHAIN_RTOL |want| + CHAIN_ATOL_REL max|want|.  Two runs
# on the same inputs read 3.8e-6 and 5.3e-6 of max|want|, so the bound
# leaves a margin of about 5 over the larger.
CHAIN_RTOL, CHAIN_ATOL_REL = 1e-4, 3e-5
# Training: B=512 flagship batch, 100 observations -> 199 knots.
TRAIN_B, TRAIN_L, TRAIN_LR, TRAIN_STEPS = 512, 100, 5e-4, 10
GRAD_ROWS = 16
# Card vs CPU parameter gradients over 198 RK4 intervals forward and 198
# reverse (adjoint) in f32, summed in other orders on the two devices: per
# tensor, |err| <= GRAD_RTOL |want| + GRAD_ATOL_REL max|want|.
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-3
# Spline coefficients of the padded serving batch, card vs CPU: the same
# f32 formulas, but the natural cubic's tridiagonal solve carries round-off
# through 112 knots, so per tensor |err| <= SPLINE_RTOL |want| +
# SPLINE_ATOL_REL max|want|.
SPLINE_RTOL, SPLINE_ATOL_REL = 1e-4, 1e-5
SMOOTH_EPS = 0.5
# Toy: 4096 paths of 3 points, batches of 1024, 20 epochs; card vs CPU
# loss curves after 80 Adam steps in f32 (Adam divides by the root of the
# second moment, which amplifies round-off where gradients are small).
TOY_PATHS, TOY_BATCH, TOY_EPOCHS = 4096, 1024, 20
TOY_RTOL, TOY_ATOL = 1e-3, 1e-4
TOY_SCHEMES = ("rectilinear", "cubic_hermite", "cubic")
# bf16 operands, each (storage dtype, precision) held against the plain
# version run on the card in the same mode: bf16 storage with products of
# the operands as stored (the compute_dtype="bfloat16" path) or rounded to
# bf16 (the JAX op's precision="bfloat16"), and f32 storage rounded.  The
# first two are timed.
BF16_MODES = ((torch.bfloat16, "float32"), (torch.bfloat16, "bfloat16"),
              (torch.float32, "bfloat16"))
BF16_TIMED = BF16_MODES[:2]
# One bf16 ulp: the card and the plain version sum in other orders, so a
# result near a rounding boundary may land on the neighbouring bf16 value;
# |err| <= 2^-7 |want| + 1e-5 max|want| admits that and nothing larger.
# Under precision "bfloat16" every product's operands are rounded too, and
# an operand that lands on its neighbour moves every sum downstream by an
# ulp of its terms, which cancellation can leave large against the sum: the
# absolute part is then one ulp of the group's largest value, 2^-8
# max|want|.  In f32 storage under "bfloat16" the forward's output is not
# rounded at all: it is an f32 sum of products of rounded operands, and its
# gate is 8x tighter, 2^-10 |want| + 2^-11 max|want|.  In that mode the
# backward's dz and weight grads are cotangents of rounded operands, bf16
# values stored in f32, and must be bf16 values to the bit.  In bf16
# storage, of every group of at least 1,000 elements, 99% are equal to the
# bit; under "bfloat16", where such neighbours reach every sum downstream
# (a weight grad sums 512 rows, most columns hold one), 80% of every group
# of at least 100.  Each rounded mode's gate must refuse the kernel's
# "float32" instantiation (the operands left unrounded) at every sweep
# shape; the tight gate and the 80% lie between that control's readings and
# the kernel's (PERF.md).
BF16_RTOL, BF16_ATOL_REL, BF16_ROUNDED_ATOL_REL = 2.0 ** -7, 1e-5, 2.0 ** -8
BF16_F32_OUT_RTOL, BF16_F32_OUT_ATOL_REL = 2.0 ** -10, 2.0 ** -11
BF16_MIN_EQUAL, BF16_EQUAL_MIN_SIZE = 0.99, 1000
BF16_MIN_EQUAL_ROUNDED, BF16_EQUAL_MIN_SIZE_ROUNDED = 0.80, 100
BF16_TOLERANCE = {"rtol": BF16_RTOL, "atol_per_max": BF16_ATOL_REL,
                  "atol_per_max_rounded": BF16_ROUNDED_ATOL_REL,
                  "f32_storage_rounded_output": {"rtol": BF16_F32_OUT_RTOL,
                                                 "atol_per_max": BF16_F32_OUT_ATOL_REL},
                  "min_bit_equal": BF16_MIN_EQUAL, "min_size": BF16_EQUAL_MIN_SIZE,
                  "min_bit_equal_rounded": BF16_MIN_EQUAL_ROUNDED,
                  "min_size_rounded": BF16_EQUAL_MIN_SIZE_ROUNDED}
# The training step's two shapes: the bf16 times and the f32 digests.
TRAIN_SHAPES = [(512, 128, 128, 21, 2), (512, 128, 128, 1, 2)]
# bench.py's bf16 parity leg: B=512, H=128, I=21, two trunk layers, bf16
# storage under precision "bfloat16"; max|card - cpu| <= tol max|cpu| + 1e-5.
LEG_B, LEG_H, LEG_I, LEG_TOL = 512, 128, 21, 3e-2
# A bf16 step, card against CPU on GRAD_ROWS rows.  A bf16 rounding that
# the card and the CPU settle the other way (their f32 sums differ in the
# last bits) changes one element by a whole bf16 ulp, and the solve carries
# it on, so a kernel that is right moves single gradient entries by a large
# share of the CPU's own bf16-vs-f32 distance, more the longer the series.
# So the gate is on the first GRAD_BF16_L observations and, for each
# parameter tensor, on ||card - cpu_bf16|| / ||cpu_bf16 - cpu_f32||
# (Frobenius): a kernel that rounds where the plain version does not moves
# every entry of the tensors it reaches and reads near 1.  Beside it, the
# same shares of the CPU's plain version with every product jittered by
# BF16_JITTER (relative; about the f32 round-off that separates the card's
# products from the CPU's) in place of the card: the yardstick the limit
# was set against (PERF.md).
GRAD_BF16_RATIO, GRAD_BF16_L, BF16_JITTER = 0.5, 10, 1e-7
# The first bf16 loss against the f32 one (the JAX package's bound,
# tests/test_cdeint.py).
LOSS_BF16_TOL = 0.06
# A bf16 predict, card against CPU over 222 intervals: at most this share of
# the CPU's own bf16-vs-f32 distance (same weights), for the same reason.
PREDICT_BF16_RATIO = 1.0


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def peaks(name: str):
    """(f32 CUDA-core FLOP/s, dense TF32 tensor-core FLOP/s, HBM bytes/s,
    dense bf16 tensor-core FLOP/s) from NVIDIA's data sheets."""
    if "PCIe" in name:
        return 51e12, 378e12, 2.0e12, 756e12
    return 67e12, 495e12, 3.35e12, 989e12  # SXM


def field_cost(B, Hd, HHd, I, n, elem=4):
    """Operations and the least bytes moved (each input read once, the
    output written once) of one fused-field call, ``elem`` bytes an
    element (4: f32)."""
    weights = Hd * HHd + (n - 1) * HHd * HHd + n * HHd + HHd * I * Hd + I * Hd
    flops = 2 * B * (Hd * HHd + (n - 1) * HHd * HHd + HHd * I * Hd + I * Hd)
    nbytes = elem * (B * Hd + B * I + weights + B * Hd)
    return flops, nbytes


def field_bwd_cost(B, Hd, HHd, I, n, elem=4):
    """Operations (forward recompute, weight grads and input grads of every
    product) and the least bytes (inputs z, dX, g and the weights read
    once; dz, ddX and the weight grads written once) of one backward call,
    ``elem`` bytes an element (4: f32)."""
    weights = Hd * HHd + (n - 1) * HHd * HHd + n * HHd + HHd * I * Hd + I * Hd
    flops = 3 * 2 * B * (Hd * HHd + (n - 1) * HHd * HHd + HHd * I * Hd)
    nbytes = elem * (2 * B * Hd + B * I + weights + B * Hd + B * I + weights)
    return flops, nbytes


def mode_products(kind, B, Hd, HHd, I, n, dtype, precision):
    """(operations, a is bf16, b is bf16) of each product group of one call
    of the forward or backward kernel in a (storage, precision) mode, an
    operand being bf16 where the reference holds it in bf16: z, dX and the
    weights in bf16 storage; every product's operands under "bfloat16"
    (in the backward, the cotangents of rounded operands too); the
    activations, dpre and the dX sum's tanh stay f32 otherwise."""
    rnd, stored = precision == "bfloat16", dtype == torch.bfloat16
    w16 = rnd or stored
    first = 2 * B * Hd * HHd                     # layer 1: z W_1
    rest = 2 * B * (n - 1) * HHd * HHd           # later layers: u W_l
    head = 2 * B * HHd * I * Hd                  # u_n W_o
    fwd = [(first, w16, w16), (rest, rnd, w16), (head, rnd, w16)]
    if kind == "forward":
        return fwd + [(2 * B * I * Hd, False, stored)]   # the dX sum
    return fwd + [(head, False, w16),                   # du_n = dpre W_o^T
                  (first + rest, rnd, w16),             # du_{l-1} = dv_l W_l^T
                  (first, w16, False),                  # dW_1 = z^T dpre_1
                  (rest + head, rnd, False)]            # dW_l = u^T dpre_l, dW_o


def mode_bounds(products, nbytes, pk):
    """``bounds`` for a mode: a product of two bf16 operands at the dense
    bf16 tensor-core rate in both; any other on the f32 CUDA cores in
    ``bound_us`` and, in ``bound_tc_us``, in the TF32 passes that its
    operand types need on the tensor cores (three, two with one bf16
    operand); bytes at the HBM rate in both."""
    peak_f32, peak_tf32, peak_bytes, peak_bf16 = pk
    pair = sum(f for f, a, b in products if a and b) / peak_bf16
    rest = [(f, 3 - int(a) - int(b)) for f, a, b in products if not (a and b)]
    t_ops = pair + sum(f for f, _ in rest) / peak_f32
    t_tc = pair + sum(f * p for f, p in rest) / peak_tf32
    t_bytes = nbytes / peak_bytes
    return {"bound_us": max(t_ops, t_bytes) * 1e6,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "bound_tc_us": max(t_tc, t_bytes) * 1e6}


def rk4_cost(B, Hd, HHd, I, n, K=1):
    """One RK4 interval: four field evaluations' operations; the bytes of
    one (z, dX and the weights read once, the state written once); K
    replicas K times both."""
    flops, nbytes = field_cost(B, Hd, HHd, I, n)
    return K * 4 * flops, K * nbytes


def bound(flops, nbytes, peak_flops, peak_bytes):
    """(bound in us, what bounds it)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bytes
    return max(t_ops, t_bytes) * 1e6, "operations" if t_ops > t_bytes else "bytes"


def bounds(flops, nbytes, pk):
    """A timed entry's bounds from ``pk = peaks(...)``: ``bound_us`` on the
    f32 CUDA cores and ``bound_tc_us`` on the tensor cores in 3xTF32 (three
    TF32 passes per f32 product), each the larger of operations and bytes."""
    peak_f32, peak_tf32, peak_bytes, _ = pk
    bound_us, bound_by = bound(flops, nbytes, peak_f32, peak_bytes)
    return {"bound_us": bound_us, "bound_by": bound_by,
            "bound_tc_us": bound(flops, nbytes, peak_tf32 / 3, peak_bytes)[0]}


# Each kernel's launch counter, under the key the phases report it by.
COUNTED = (("forward", "fused_field_kernel"), ("backward", "fused_field_bwd_kernel"),
           ("rk4", "fused_rk4_kernel"), ("rk4_multi", "fused_rk4_multi_kernel"))


def counted(fn):
    """Runs ``fn`` with every kernel's launch count set to 0 just before
    and read just after; returns (fn's result, the counts)."""
    from online_neural_cdes_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    for _, attr in COUNTED:
        getattr(kernels, attr).launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {key: getattr(kernels, attr).launches for key, attr in COUNTED}


def expect_launches(what, got, **want):
    """Raise unless ``got`` has the counts ``want`` and 0 for every other
    kernel."""
    full = {key: want.get(key, 0) for key, _ in COUNTED}
    if got != full:
        raise AssertionError(f"{what} launched {got}, expected {full}")


def gate_share(got, want, rtol, atol):
    """max |got - want| / (atol + rtol |want|): the share of its gate a
    comparison uses (below 1 passes)."""
    got, want = (np.asarray(a, dtype=np.float64) for a in (got, want))
    return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())


def percentiles(samples_ms):
    a = np.asarray(samples_ms)
    return {"p50": float(np.percentile(a, 50)), "p99": float(np.percentile(a, 99)),
            "n": int(a.size)}


def random_field(gen, B, Hd, HHd, I, n, device):
    def u(shape, fan_in):
        b = 1.0 / fan_in ** 0.5
        return (torch.rand(shape, generator=gen) * 2 * b - b).to(device)

    trunk, d_in = [], Hd
    for _ in range(n):
        trunk.append({"w": u((d_in, HHd), d_in), "b": u((HHd,), d_in)})
        d_in = HHd
    head_w, head_b = u((HHd, I * Hd), HHd), u((I * Hd,), HHd)
    z = torch.randn((B, Hd), generator=gen).to(device)
    dx = torch.randn((B, I), generator=gen).to(device)
    return trunk, head_w, head_b, z, dx


def per_launch(fn, calls=20):
    """Each kernel's device time per launch over ``calls`` calls of ``fn``
    under torch.profiler, averaged over the launches whose events the
    profiler kept (``per_call``: those launches per call; it may keep fewer
    than all)."""
    top = profile_call(lambda: [fn() for _ in range(calls)])["top"]
    return [{"name": t["name"], "per_call": t["count"] / calls,
             "us_per_launch": t["ms"] * 1e3 / t["count"]} for t in top]


def mode_name(dtype, precision):
    return f"{str(dtype).removeprefix('torch.')}/{precision}"


def cast_field(field, dtype):
    trunk, head_w, head_b, z, dx = field
    return ([{k: v.to(dtype) for k, v in layer.items()} for layer in trunk],
            head_w.to(dtype), head_b.to(dtype), z.to(dtype), dx.to(dtype))


def rounded_group(name):
    """Whether a backward group is the cotangent of a rounded operand under
    precision "bfloat16": dz, dW_o and every trunk dW."""
    return name in ("dz", "dhead_w") or name.endswith(".w")


def bf16_readings(got, want, precision, f32_out=False, exact=False):
    """One result against the plain version in a bf16 mode: the largest
    error, the share of its gate it uses, the share of the elements within
    one ulp of their own value (BF16_ATOL_REL), the share equal to the bit,
    and ``failed``, what of the gate it fails.  The gate: |got - want| <=
    BF16_RTOL |want| + atol max|want| (atol BF16_ATOL_REL, or
    BF16_ROUNDED_ATOL_REL under "bfloat16"; ``f32_out``, the f32-storage
    forward under "bfloat16", BF16_F32_OUT_*); in bf16 storage the share
    equal to the bit (BF16_MIN_EQUAL* of groups of BF16_EQUAL_MIN_SIZE* or
    more); with ``exact``, every value a bf16 value."""
    if got.shape != want.shape or got.dtype != want.dtype or not torch.isfinite(got).all():
        return {"failed": [f"shape {tuple(got.shape)}, dtype {got.dtype} (want "
                           f"{tuple(want.shape)}, {want.dtype}) or non-finite values"]}
    g, w = got.double(), want.double()
    err, scale = (g - w).abs(), float(w.abs().max())
    rounded = precision == "bfloat16"
    rtol, atol = ((BF16_F32_OUT_RTOL, BF16_F32_OUT_ATOL_REL) if f32_out else
                  (BF16_RTOL, BF16_ROUNDED_ATOL_REL if rounded else BF16_ATOL_REL))
    share = float((err / (atol * scale + rtol * w.abs()).clamp_min(1e-300)).max())
    equal = float((got == want).double().mean())
    floor, size = ((BF16_MIN_EQUAL_ROUNDED, BF16_EQUAL_MIN_SIZE_ROUNDED) if rounded
                   else (BF16_MIN_EQUAL, BF16_EQUAL_MIN_SIZE))
    failed = []
    if not share <= 1.0:
        failed.append(f"max |err| {float(err.max())} is past its gate (share {share})")
    if got.dtype == torch.bfloat16 and got.numel() >= size and not equal >= floor:
        failed.append(f"only {equal} of the elements equal to the bit")
    if exact and not torch.equal(got, got.to(torch.bfloat16).to(got.dtype)):
        failed.append("not bf16 values")
    within = float((err <= BF16_ATOL_REL * scale + BF16_RTOL * w.abs()).double().mean())
    return {"max_abs_err": float(err.max()), "gate_share": share, "one_ulp_share": within,
            "bit_equal_share": equal, "failed": failed}


def ulp_gate(what, got, want, precision, **kw):
    """Raise unless ``got`` passes its bf16 gate (:func:`bf16_readings`);
    returns the readings."""
    readings = bf16_readings(got, want, precision, **kw)
    failed = readings.pop("failed")
    if failed:
        raise AssertionError(f"{what}: {'; '.join(failed)}")
    return readings


def control_summary(mode, shape, readings):
    """A control case: whether the gate refused it, and its readings (the
    largest gate share, the least share equal to the bit, what failed)."""
    failed = [f"{name}: {f}" for name, r in readings.items() for f in r["failed"]]
    return {"mode": mode, "shape": list(shape), "refused": bool(failed),
            "gate_share": max(r.get("gate_share", float("inf")) for r in readings.values()),
            "bit_equal_share": min(r.get("bit_equal_share", 0.0) for r in readings.values()),
            "failed": failed[:3]}


def expect_refused(what, controls):
    """Raise unless the gate refused every control case."""
    passed = [(c["mode"], c["shape"]) for c in controls if not c["refused"]]
    if passed:
        raise AssertionError(f"{what}: the bf16 gate took the kernel's \"float32\" "
                             f"instantiation in a rounded mode at {passed}")


def f32_digests(kind):
    """sha256 of the f32 field kernel's results at TRAIN_SHAPES from a fixed
    seed: ``kind`` "forward" digests the output, "backward" the six
    cotangent groups in order.  It calls only entry points that older trees
    of the port share, so a run against one on the same card shows whether
    the f32 bits moved."""
    from online_neural_cdes_tpu_torch.ops import kernels

    gen = torch.Generator().manual_seed(13)
    digests = {}
    for shape in TRAIN_SHAPES:
        B, Hd, HHd, I, n = shape
        trunk, head_w, head_b, z, dx = random_field(gen, *shape, "cuda")
        g = random_cotangent(gen, B, Hd, "cuda")
        if kind == "forward":
            with torch.inference_mode():
                outs = [kernels.fused_matmul_field(trunk, head_w, head_b, z, dx, Hd, I)]
        else:
            outs = [t for _, t in bwd_groups(kernels._backward(trunk, head_w, head_b, z, dx,
                                                                g, Hd, I))]
        h = hashlib.sha256()
        for t in outs:
            h.update(t.contiguous().cpu().numpy().tobytes())
        digests["x".join(map(str, shape))] = h.hexdigest()
    return digests


def phase_env():
    from online_neural_cdes_tpu_torch.utils.cuda_build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60,
                          ).stdout.strip().splitlines()[-1]
    props = torch.cuda.get_device_properties(0)
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc,
         triton=importlib.util.find_spec("triton") is not None,
         cutlass_headers=os.path.isdir("/usr/local/cutlass/include"),
         card=card_line(), kind=torch.cuda.get_device_name(0),
         capability=f"{props.major}.{props.minor}", sms=props.multi_processor_count,
         count=torch.cuda.device_count())


def phase_build():
    from online_neural_cdes_tpu_torch.utils.cuda_build import CSRC, build_library

    sources = sorted(p.name for p in CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        libs = dict(zip(sources, pool.map(build_library, sources)))
    seconds = time.perf_counter() - t0
    ptxas, spills = {}, {}
    for name, lib in libs.items():
        lines = lib.with_suffix(".log").read_text().splitlines()
        ptxas[name] = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]
        function = None
        for ln in lines:
            if "Function properties for" in ln:
                function = ln.split("Function properties for")[-1].strip()
            elif "spill stores" in ln and not ln.strip().startswith("0 bytes stack frame, 0 "):
                spills.setdefault(name, []).append(f"{function}: {ln.strip()}")
    emit("build", sources=sources, seconds=seconds, ptxas=ptxas, spills=spills)


def forward_grid(B, Hd, HHd, I):
    """The forward kernel's launch geometry at a shape, as its library
    states it (``oncde_fused_field_forward_grid``)."""
    from online_neural_cdes_tpu_torch.ops import kernels

    grid = (ctypes.c_int * 6)()
    fn = kernels.fused_field_kernel.helper(
        "oncde_fused_field_forward_grid", [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)],
        ctypes.c_int)
    if fn(B, Hd, HHd, I, grid):
        return {"path": "tensor cores", "trunk_blocks": grid[0],
                "head_blocks": grid[1] * grid[2], "cluster": grid[2],
                "head_rows": grid[3], "channels_per_group": grid[4],
                "head_clusters_at_once": grid[5]}
    return {"path": "cuda cores", "blocks": grid[0] * grid[1]}


def phase_kernel(pk):
    """The forward kernel against its plain version over the sweep and the
    wide shape, a repeat call giving the same bits; CUDA-event times at the
    timed shapes beside both bounds and the plain version's time, with each
    of the kernel's launches' device time (profiler, 20 calls)."""
    from online_neural_cdes_tpu_torch.ops import kernels

    gen = torch.Generator().manual_seed(1)
    errors, timings = [], {}
    with torch.inference_mode():
        for shape in SWEEP + FWD_WIDE:
            B, Hd, HHd, I, n = shape
            trunk, head_w, head_b, z, dx = random_field(gen, *shape, "cuda")
            got = kernels.fused_matmul_field(trunk, head_w, head_b, z, dx, Hd, I)
            again = kernels.fused_matmul_field(trunk, head_w, head_b, z, dx, Hd, I)
            want = kernels._forward_reference(trunk, head_w, head_b, z, dx, Hd, I)
            torch.cuda.synchronize()
            if got.shape != (B, Hd) or not torch.isfinite(got).all():
                raise AssertionError(f"kernel output at {shape}: shape "
                                     f"{tuple(got.shape)} or non-finite values")
            if not torch.equal(got, again):
                raise AssertionError(f"kernel at {shape}: two calls on the same inputs "
                                     "differ")
            torch.testing.assert_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL,
                                       msg=lambda m: f"kernel at {shape}: {m}")
            err = (got - want).abs()
            errors.append({"shape": list(shape), "max_abs_err": float(err.max()),
                           "gate_share": float((err / (KERNEL_RTOL * want.abs()
                                                       + KERNEL_ATOL)).max()),
                           "path": forward_grid(B, Hd, HHd, I)["path"]})
        for shape in TIMED:
            B, Hd, HHd, I, n = shape
            trunk, head_w, head_b, z, dx = random_field(gen, *shape, "cuda")
            call = lambda: kernels.fused_matmul_field(trunk, head_w, head_b, z, dx, Hd, I)
            kernel_us = device_us(call, reps=200)
            plain_us = device_us(lambda: kernels._forward_reference(
                trunk, head_w, head_b, z, dx, Hd, I), reps=50)
            timings[shape] = {
                "shape": list(shape), "kernel_us": kernel_us, "plain_us": plain_us,
                **bounds(*field_cost(*shape), pk), **forward_grid(B, Hd, HHd, I),
                "per_launch": per_launch(call)}

        # bf16: the sweep and the wide shape in every mode, against the plain
        # version in the same mode, and in the rounded modes the control;
        # times at the training shapes.
        bf16_sweep, bf16_timed, controls = [], {}, []
        for dtype, precision in BF16_MODES:
            mode = mode_name(dtype, precision)
            f32_out = dtype == torch.float32
            for shape in SWEEP + FWD_WIDE:
                B, Hd, HHd, I, n = shape
                field = cast_field(random_field(gen, *shape, "cuda"), dtype)
                args = (*field, Hd, I, precision)
                got = kernels.fused_matmul_field(*args)
                again = kernels.fused_matmul_field(*args)
                want = kernels._forward_reference(*args)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"kernel {mode} at {shape}: two calls on the same "
                                         "inputs differ")
                bf16_sweep.append({"mode": mode, "shape": list(shape),
                                   **ulp_gate(f"kernel {mode} at {shape}", got, want,
                                              precision, f32_out=f32_out)})
                if precision == "bfloat16":
                    control = kernels.fused_matmul_field(*field, Hd, I, "float32")
                    controls.append(control_summary(mode, shape, {"out": bf16_readings(
                        control, want, precision, f32_out=f32_out)}))
        for dtype, precision in BF16_TIMED:
            mode = mode_name(dtype, precision)
            for shape in TRAIN_SHAPES:
                B, Hd, HHd, I, n = shape
                args = (*cast_field(random_field(gen, *shape, "cuda"), dtype), Hd, I, precision)
                call = lambda: kernels.fused_matmul_field(*args)
                bf16_timed[mode, shape] = {
                    "mode": mode, "shape": list(shape), "kernel_us": device_us(call, reps=200),
                    "plain_us": device_us(lambda: kernels._forward_reference(*args), reps=50),
                    **mode_bounds(mode_products("forward", *shape, dtype, precision),
                                  field_cost(*shape, elem=dtype.itemsize)[1], pk),
                    "per_launch": per_launch(call)}
    emit("kernel", tolerance={"rtol": KERNEL_RTOL, "atol": KERNEL_ATOL},
         sweep=errors, repeat="bit-identical", timed=list(timings.values()),
         library="none: no single PyTorch call computes the fused field",
         bf16={"tolerance": BF16_TOLERANCE, "sweep": bf16_sweep, "repeat": "bit-identical",
               "control": controls, "timed": list(bf16_timed.values())},
         f32_digest=f32_digests("forward"))
    expect_refused("forward kernel", controls)
    return max(e["max_abs_err"] for e in errors), timings, bf16_timed


def random_cotangent(gen, B, Hd, device):
    return torch.randn((B, Hd), generator=gen).to(device)


def bwd_groups(out):
    """The backward's six groups (each trunk layer's pair listed apart) as
    (name, tensor) pairs."""
    dtrunk, dhw, dhb, dz, ddx = out
    groups = [("dz", dz), ("ddx", ddx), ("dhead_w", dhw), ("dhead_b", dhb)]
    for l, layer in enumerate(dtrunk):
        groups += [(f"dtrunk[{l}].w", layer["w"]), (f"dtrunk[{l}].b", layer["b"])]
    return groups


def phase_kernel_bwd(pk):
    """The backward kernel against its plain version (autograd through the
    plain forward) over the forward's sweep, each group within
    BWD_RTOL |want| + BWD_ATOL_REL max|want|; a repeat call gives the same
    bits; CUDA-event times at the two training shapes, with each of the
    kernel's launches' device time (profiler, 20 calls)."""
    from online_neural_cdes_tpu_torch.ops import kernels

    gen = torch.Generator().manual_seed(2)
    errors, timings = [], {}
    for shape in SWEEP:
        B, Hd, HHd, I, n = shape
        trunk, head_w, head_b, z, dx = random_field(gen, *shape, "cuda")
        g = random_cotangent(gen, B, Hd, "cuda")
        args = (trunk, head_w, head_b, z, dx, g, Hd, I)
        got = kernels._backward(*args)
        again = kernels._backward(*args)
        want = kernels._backward_reference(*args)
        torch.cuda.synchronize()
        worst = {}
        for (name, gt), (_, ag), (_, wt) in zip(bwd_groups(got), bwd_groups(again),
                                                 bwd_groups(want)):
            if gt.shape != wt.shape or not torch.isfinite(gt).all():
                raise AssertionError(f"backward kernel at {shape}: {name} has shape "
                                     f"{tuple(gt.shape)} or non-finite values")
            if not torch.equal(gt, ag):
                raise AssertionError(f"backward kernel at {shape}: {name} differs "
                                     "between two calls on the same inputs")
            scale = float(wt.abs().max())
            torch.testing.assert_close(gt, wt, rtol=BWD_RTOL,
                                       atol=BWD_ATOL_REL * scale, msg=lambda m: (
                                           f"backward kernel at {shape}, {name}: {m}"))
            worst[name] = float((gt - wt).abs().max())
        errors.append({"shape": list(shape), "max_abs_err": worst})
    # A width the kernel's tiles cannot hold: the library refuses it, the
    # wrapper raises, and nothing launches.
    trunk, head_w, head_b, z, dx = random_field(gen, 2, 257, 64, 1, 1, "cuda")
    launches = kernels.fused_field_bwd_kernel.launches
    try:
        kernels._backward_kernel(trunk, head_w, head_b, z, dx,
                                 random_cotangent(gen, 2, 257, "cuda"), 257, 1)
    except ValueError as e:
        if "H and HH up to" not in str(e):
            raise
    else:
        raise AssertionError("backward kernel took H=257")
    if kernels.fused_field_bwd_kernel.launches != launches:
        raise AssertionError("backward kernel launched at H=257")
    for shape in [(512, 128, 128, 21, 2), (512, 128, 128, 1, 2)]:
        B, Hd, HHd, I, n = shape
        trunk, head_w, head_b, z, dx = random_field(gen, *shape, "cuda")
        args = (trunk, head_w, head_b, z, dx, random_cotangent(gen, B, Hd, "cuda"),
                Hd, I)
        kernel_us = device_us(lambda: kernels._backward_kernel(*args), reps=100)
        plain_us = device_us(lambda: kernels._backward_reference(*args), reps=20)
        timings[shape] = {"shape": list(shape), "kernel_us": kernel_us,
                          "plain_us": plain_us, **bounds(*field_bwd_cost(*shape), pk),
                          "per_launch": per_launch(lambda: kernels._backward_kernel(*args))}

    # bf16: every group over the sweep in every mode, against autograd
    # through the plain forward in the same mode, and in the rounded modes
    # the control; times at the training shapes.
    bf16_sweep, bf16_timed, controls = [], {}, []
    for dtype, precision in BF16_MODES:
        mode = mode_name(dtype, precision)
        exact = precision == "bfloat16" and dtype == torch.float32
        for shape in SWEEP:
            B, Hd, HHd, I, n = shape
            field = cast_field(random_field(gen, *shape, "cuda"), dtype)
            cotangent = random_cotangent(gen, B, Hd, "cuda").to(dtype)
            args = (*field, cotangent, Hd, I, precision)
            got = kernels._backward(*args)
            again = kernels._backward(*args)
            want = kernels._backward_reference(*args)
            torch.cuda.synchronize()
            groups = {}
            for (name, gt), (_, ag), (_, wt) in zip(bwd_groups(got), bwd_groups(again),
                                                     bwd_groups(want)):
                if not torch.equal(gt, ag):
                    raise AssertionError(f"backward kernel {mode} at {shape}: {name} differs "
                                         "between two calls on the same inputs")
                groups[name] = ulp_gate(f"backward kernel {mode} at {shape}, {name}", gt, wt,
                                        precision, exact=exact and rounded_group(name))
            if precision == "bfloat16":
                control = kernels._backward(*field, cotangent, Hd, I, "float32")
                controls.append(control_summary(mode, shape, {
                    name: bf16_readings(c, w, precision, exact=exact and rounded_group(name))
                    for (name, c), (_, w) in zip(bwd_groups(control), bwd_groups(want))}))
            worst = max(groups, key=lambda k: groups[k]["gate_share"])
            bf16_sweep.append({
                "mode": mode, "shape": list(shape), "worst_group": worst, **groups[worst],
                "one_ulp_share": min(r["one_ulp_share"] for r in groups.values()),
                "bit_equal_share": min(r["bit_equal_share"] for r in groups.values())})
    for dtype, precision in BF16_TIMED:
        mode = mode_name(dtype, precision)
        for shape in TRAIN_SHAPES:
            B, Hd, HHd, I, n = shape
            field = cast_field(random_field(gen, *shape, "cuda"), dtype)
            args = (*field, random_cotangent(gen, B, Hd, "cuda").to(dtype), Hd, I, precision)
            call = lambda: kernels._backward_kernel(*args)
            bf16_timed[mode, shape] = {
                "mode": mode, "shape": list(shape), "kernel_us": device_us(call, reps=100),
                "plain_us": device_us(lambda: kernels._backward_reference(*args), reps=8),
                **mode_bounds(mode_products("backward", *shape, dtype, precision),
                              field_bwd_cost(*shape, elem=dtype.itemsize)[1], pk),
                "per_launch": per_launch(call)}
    emit("kernel_bwd", tolerance={"rtol": BWD_RTOL, "atol_per_max": BWD_ATOL_REL},
         sweep=errors, repeat="bit-identical", timed=list(timings.values()),
         library="none: no single PyTorch call computes the fused field's VJP",
         bf16={"tolerance": BF16_TOLERANCE, "sweep": bf16_sweep, "repeat": "bit-identical",
               "exact_groups_f32_storage": "dz, dhead_w, dtrunk[*].w", "control": controls,
               "timed": list(bf16_timed.values())},
         f32_digest=f32_digests("backward"))
    expect_refused("backward kernel", controls)
    max_err = max(e for entry in errors for e in entry["max_abs_err"].values())
    return max_err, timings, bf16_timed


def stacked_fields(gen, K, shape, device):
    """K random fields of one shape in the K-replica op's stacked layouts,
    and the K single fields."""
    from online_neural_cdes_tpu_torch.experiments.interleave_experiment import (
        stack_fields)

    fields = [random_field(gen, *shape, device) for _ in range(K)]
    weights = stack_fields([{"trunk": f[0], "head_w": f[1], "head_b": f[2]}
                            for f in fields])
    return (*weights, *(torch.stack([f[i] for f in fields]) for i in (3, 4))), fields


def phase_kernel_rk4(pk):
    """The whole-interval RK4 kernel (both entry points) against its plain
    version over the sweep; the K-replica form bit for bit against K single
    launches; a width beyond the library's limit refused with no launch;
    CUDA-event times beside the bound and the plain version's time."""
    from online_neural_cdes_tpu_torch.ops import kernels

    gen = torch.Generator().manual_seed(3)
    errors, multi_errors, timings, multi_timings = [], [], {}, {}
    with torch.inference_mode():
        for shape in RK4_SWEEP:
            B, Hd, HHd, I, n = shape
            trunk, head_w, head_b, z, dx = random_field(gen, *shape, "cuda")
            got = kernels.fused_rk4_interval(trunk, head_w, head_b, z, dx, Hd, I)
            want = kernels._rk4_interval_reference(trunk, head_w, head_b, z, dx, Hd, I)
            torch.cuda.synchronize()
            if got.shape != (B, Hd) or not torch.isfinite(got).all():
                raise AssertionError(f"RK4 kernel output at {shape}: shape "
                                     f"{tuple(got.shape)} or non-finite values")
            torch.testing.assert_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL,
                                       msg=lambda m: f"RK4 kernel at {shape}: {m}")
            errors.append({"shape": list(shape),
                           "max_abs_err": float((got - want).abs().max())})
        for shape, ks in RK4_MULTI:
            B, Hd, HHd, I, n = shape
            for K in ks:
                stacked, fields = stacked_fields(gen, K, shape, "cuda")
                got = kernels.fused_rk4_interval_multi(*stacked, Hd, I)
                singles = torch.stack([kernels.fused_rk4_interval(*f, Hd, I)
                                       for f in fields])
                want = kernels._rk4_interval_multi_reference(*stacked, Hd, I)
                torch.cuda.synchronize()
                if not torch.equal(got, singles):
                    raise AssertionError(
                        f"K-replica RK4 kernel at {shape}, K={K}: differs from K single "
                        f"launches by {float((got - singles).abs().max())}")
                torch.testing.assert_close(
                    got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL,
                    msg=lambda m: f"K-replica RK4 kernel at {shape}, K={K}: {m}")
                multi_errors.append({"shape": list(shape), "K": K,
                                     "max_abs_err": float((got - want).abs().max()),
                                     "vs_single_launches": "bit-identical"})
        # A width beyond the library's limit: refused, nothing launched.
        wide = kernels.rk4_max_dim() + 1
        stacked, (field,) = stacked_fields(gen, 1, (2, wide, 64, 1, 1), "cuda")
        counts = (kernels.fused_rk4_kernel.launches,
                  kernels.fused_rk4_multi_kernel.launches)
        for op, args in ((kernels.fused_rk4_interval, field),
                         (kernels.fused_rk4_interval_multi, stacked)):
            try:
                op(*args, wide, 1)
            except ValueError as e:
                if "H and HH up to" not in str(e):
                    raise
            else:
                raise AssertionError(f"{op.__name__} took H={wide}")
        if counts != (kernels.fused_rk4_kernel.launches,
                      kernels.fused_rk4_multi_kernel.launches):
            raise AssertionError(f"the RK4 kernel launched at H={wide}")

        for shape in RK4_TIMED:
            B, Hd, HHd, I, n = shape
            args = (*random_field(gen, *shape, "cuda"), Hd, I)
            timings[shape] = {
                "shape": list(shape),
                "kernel_us": device_us(lambda: kernels.fused_rk4_interval(*args),
                                       reps=100),
                "plain_us": device_us(lambda: kernels._rk4_interval_reference(*args),
                                      reps=5),
                **bounds(*rk4_cost(*shape), pk), "blocks": -(-B // 8)}
        for K in RK4_MULTI_TIMED:
            B, Hd, HHd, I, n = TRAIN_SHAPE
            args = (*stacked_fields(gen, K, TRAIN_SHAPE, "cuda")[0], Hd, I)
            multi_timings[K] = {
                "shape": list(TRAIN_SHAPE), "K": K,
                "kernel_us": device_us(lambda: kernels.fused_rk4_interval_multi(*args),
                                       reps=100),
                "plain_us": device_us(
                    lambda: kernels._rk4_interval_multi_reference(*args), reps=2),
                **bounds(*rk4_cost(*TRAIN_SHAPE, K=K), pk), "blocks": K * -(-B // 8)}
    emit("kernel_rk4", tolerance={"rtol": KERNEL_RTOL, "atol": KERNEL_ATOL},
         sweep=errors, multi=multi_errors, refused_width=wide,
         timed=list(timings.values()), timed_multi=list(multi_timings.values()),
         library="none: no single PyTorch call computes an RK4 interval of the "
                 "fused field")
    return (max(e["max_abs_err"] for e in errors),
            max(e["max_abs_err"] for e in multi_errors), timings, multi_timings)


def flagship_model(device, interpolation="rectilinear", dtype=torch.float32):
    from online_neural_cdes_tpu_torch import NeuralCDE

    return NeuralCDE(
        input_dim=C, hidden_dim=H, output_dim=1, static_dim=STATIC,
        hidden_hidden_dim=HH, num_layers=N_LAYERS, interpolation=interpolation,
        solver="rk4", return_sequences=True,
        generator=torch.Generator().manual_seed(0), device=device, dtype=dtype,
    )


def make_requests(seed=5):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(MIN_LEN, MAX_LEN + 1, size=N_REQUESTS)
    lengths[0] = MAX_LEN  # pads to 112: 223 knots, 222 intervals
    requests = []
    for length in lengths:
        s = rng.normal(size=(length, C)).astype(np.float32)
        s[:, 0] = np.arange(length)
        holes = rng.random(size=s.shape) < 0.3
        holes[0] = False         # a first row with NaNs is zeroed by the
        holes[:, 0] = False      # stepper but back-filled offline
        s[holes] = np.nan
        requests.append(s)
    static = rng.normal(size=(N_REQUESTS, STATIC)).astype(np.float32)
    return requests, static


def phase_predictor():
    from online_neural_cdes_tpu_torch import Predictor

    coeff_fn = rectilinear_coeffs
    model = flagship_model("cuda")
    pred = Predictor(model, coeff_fn=coeff_fn, batch_buckets=(1, 64),
                     length_multiple=LENGTH_MULTIPLE, device="cuda")
    warmed = pred.precompile(channels=C, max_length=MAX_LEN, static_dim=STATIC)
    requests, static = make_requests()
    padded_len = -(-MAX_LEN // LENGTH_MULTIPLE) * LENGTH_MULTIPLE
    intervals = 2 * padded_len - 2
    expected = intervals * 4  # RK4: four field evaluations per interval

    outs, launches = counted(lambda: pred.predict(requests, static=static))  # serving
    expect_launches("one predict", launches, forward=expected)

    model_cpu = flagship_model("cpu")
    model_cpu.load_state_dict(model.state_dict())
    pred_cpu = Predictor(model_cpu, coeff_fn=coeff_fn, batch_buckets=(1, 64),
                         length_multiple=LENGTH_MULTIPLE, device="cpu")
    outs_cpu = pred_cpu.predict(requests, static=static)
    err = share = 0.0
    for r, g, c in zip(requests, outs, outs_cpu):
        if g.shape != (len(r), 1) or not np.isfinite(g).all():
            raise AssertionError(f"predictor output shape {g.shape} or non-finite")
        np.testing.assert_allclose(g, c, rtol=SERVE_RTOL, atol=SERVE_ATOL)
        err = max(err, float(np.abs(g - c).max()))
        share = max(share, gate_share(g, c, SERVE_RTOL, SERVE_ATOL))

    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        pred.predict(requests, static=static)
        lat.append((time.perf_counter() - t0) * 1e3)
    n_batches = 8
    t0 = time.perf_counter()
    many = pred.predict_many([requests] * n_batches, statics=[static] * n_batches)
    many_ms = (time.perf_counter() - t0) * 1e3 / n_batches
    for got, want in zip(many[-1], outs):
        np.testing.assert_allclose(got, want, rtol=STEP_RTOL, atol=STEP_ATOL)
    emit("predictor", warmed_shapes=warmed, padded_length=padded_len,
         intervals=intervals, kernel_launches=launches["forward"],
         backward_launches=launches["backward"], expected_launches=expected,
         vs_cpu={"max_abs_err": err, "gate_share": share, "rtol": SERVE_RTOL,
                 "atol": SERVE_ATOL},
         predict_ms=percentiles(lat), predict_many_ms_per_batch=many_ms)
    emit("profile", **profile_call(lambda: pred.predict(requests, static=static)))
    return model, requests, static, outs, launches


def profile_call(fn):
    """One call of ``fn`` (ending in a synchronize) under torch.profiler:
    device time by kernel name and the device's busy share of the call's
    wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            entry = by_name.setdefault(evt.name[:60], [0, 0.0])
            entry[0] += 1
            entry[1] += evt.time_range.elapsed_us() / 1e3
    device_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]
    return {"wall_ms": wall_ms,
            "device_busy_ms": device_ms if by_name else "not measured",
            "device_busy_share": device_ms / wall_ms if by_name else "not measured",
            "device_events": sum(n for n, _ in by_name.values()),
            "top": [{"name": k, "count": n, "ms": ms} for k, (n, ms) in top],
            "host_top": [{"name": e.key[:60], "count": e.count,
                          "self_cpu_ms": e.self_cpu_time_total / 1e3} for e in host]}


def phase_stepper(model, requests, static, outs):
    from online_neural_cdes_tpu_torch import OnlineNCDEStepper
    from online_neural_cdes_tpu_torch.data.loader import pad_ragged
    from online_neural_cdes_tpu_torch.ops.kernels import fused_field_kernel

    # Each stream's tail repeats its last row: dX = 0, the state holds.
    x = pad_ragged(requests, target_len=MAX_LEN)          # (64, 100, C)
    stepper = OnlineNCDEStepper(model, static=static, device="cuda")
    stepper.precompile(N_REQUESTS, block_sizes=(MAX_LEN - 1,))
    torch.cuda.synchronize()

    fused_field_kernel.launches = 0
    state = stepper.init(x[:, 0])
    rows, ticks = [stepper.readout(state["z"])], []
    for k in range(1, MAX_LEN):
        t0 = time.perf_counter()
        state, y = stepper.step(state, x[:, k])
        torch.cuda.synchronize()
        ticks.append((time.perf_counter() - t0) * 1e3)
        rows.append(y)
    launches = fused_field_kernel.launches
    if launches != 8 * (MAX_LEN - 1):
        raise AssertionError(f"stepper launched {launches} kernels, expected "
                             f"{8 * (MAX_LEN - 1)}")
    rows = torch.stack(rows, dim=1).cpu().numpy()          # (64, 100, 1)
    err = share = 0.0
    for i, (r, o) in enumerate(zip(requests, outs)):
        np.testing.assert_allclose(rows[i, :len(r)], o, rtol=STEP_RTOL, atol=STEP_ATOL)
        err = max(err, float(np.abs(rows[i, :len(r)] - o).max()))
        share = max(share, gate_share(rows[i, :len(r)], o, STEP_RTOL, STEP_ATOL))

    block = np.ascontiguousarray(np.swapaxes(x[:, 1:65], 0, 1))  # (64, B, C)
    start = stepper.init(x[:, 0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, ys = stepper.step_many(start, block)
    torch.cuda.synchronize()
    many_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    s = start
    for k in range(block.shape[0]):
        s, _ = stepper.step(s, block[k])
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1e3
    np.testing.assert_allclose(ys.cpu().numpy().swapaxes(0, 1), rows[:, 1:65],
                               rtol=STEP_RTOL, atol=STEP_ATOL)
    emit("stepper", streams=N_REQUESTS, ticks=MAX_LEN - 1, kernel_launches=launches,
         vs_predictor={"max_abs_err": err, "gate_share": share, "rtol": STEP_RTOL,
                       "atol": STEP_ATOL},
         tick_ms=percentiles(ticks), step_many_64_ms=many_ms,
         sequential_64_steps_ms=seq_ms)


def rectilinear_coeffs(x):
    from online_neural_cdes_tpu_torch import linear_interpolation_coeffs

    return linear_interpolation_coeffs(x, rectilinear=0)


def train_batch(device, seed=7, coeff_fn=rectilinear_coeffs):
    """The flagship training batch (as ``bench.py``'s flagship step makes
    it): B=512 series of 100 observations, time in channel 0, static
    features, random 0/1 labels per observation; ``coeff_fn`` makes the
    model's coefficients (rectilinear by default)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(TRAIN_B, TRAIN_L, C)).astype(np.float32)
    x[:, :, 0] = np.arange(TRAIN_L)
    static = rng.normal(size=(TRAIN_B, STATIC)).astype(np.float32)
    labels = rng.integers(0, 2, size=(TRAIN_B, TRAIN_L)).astype(np.float32)
    coeffs = coeff_fn(torch.from_numpy(x).to(device))
    return ((torch.from_numpy(static).to(device), coeffs),
            torch.from_numpy(labels).to(device))


def slice_grads(model, inputs, labels, rows, compute_dtype=None):
    """Parameter gradients of the masked BCE on the first ``rows`` rows;
    with ``compute_dtype`` the forward and backward run on the parameters
    and inputs cast to it, as ``make_train_step(compute_dtype=...)`` runs
    them."""
    from online_neural_cdes_tpu_torch.training.metrics import make_loss, masked_temporal_loss

    model.zero_grad(set_to_none=True)
    static, coeffs = inputs
    batch = (static[:rows], coeffs[:rows])
    if compute_dtype is None:
        preds = model(batch)
    else:
        params = {name: p.to(compute_dtype) for name, p in model.named_parameters()}
        preds = torch.func.functional_call(
            model, params, (tuple(t.to(compute_dtype) for t in batch),)).float()
    masked_temporal_loss(make_loss("bce"), preds, labels[:rows]).backward()
    return {name: p.grad.detach().clone() for name, p in model.named_parameters()}


def phase_train():
    from online_neural_cdes_tpu_torch.training.loop import make_train_step

    model = flagship_model("cuda")
    inputs, labels = train_batch("cuda")
    intervals = 2 * TRAIN_L - 2
    expected = {"forward": 2 * 4 * intervals, "backward": 4 * intervals}

    # Step-0 gradients: the card against the CPU port on a 16-row slice.
    model_cpu = flagship_model("cpu")
    model_cpu.load_state_dict(model.state_dict())
    got = slice_grads(model, inputs, labels, GRAD_ROWS)
    want = slice_grads(model_cpu, tuple(t.cpu() for t in inputs), labels.cpu(),
                       GRAD_ROWS)
    grad_err, grad_share = {}, 0.0
    for name, w in want.items():
        g = got[name].cpu()
        if not torch.isfinite(g).all():
            raise AssertionError(f"card gradient of {name} is not finite")
        atol = GRAD_ATOL_REL * float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=GRAD_RTOL, atol=atol,
                                   msg=lambda m: f"gradient of {name}: {m}")
        grad_err[name] = float((g - w).abs().max() / w.abs().max())
        grad_share = max(grad_share, gate_share(g, w, GRAD_RTOL, atol))

    step = make_train_step(model, loss="bce", lr=TRAIN_LR)
    loss, launches = counted(lambda: step(inputs, labels, 1.0))   # the main path
    expect_launches("one training step", launches, **expected)
    losses = [loss]

    step_ms = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step(inputs, labels, 1.0))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    losses = torch.stack(losses).cpu().numpy()
    # Random labels on a fixed batch: the loss falls, though not step by
    # step (the readout's learning rate is 10x), so the gate compares the
    # mean of the last three losses with the first.
    if not np.isfinite(losses).all() or not losses[-3:].mean() < losses[0]:
        raise AssertionError(f"training losses not finite and falling: {losses}")
    profile = profile_call(lambda: step(inputs, labels, 1.0))
    emit("train", batch=TRAIN_B, knots=2 * TRAIN_L - 1, intervals=intervals,
         kernel_launches=launches, expected_launches=expected,
         grads_vs_cpu={"rows": GRAD_ROWS, "max_err_per_max": max(grad_err.values()),
                       "gate_share": grad_share, "rtol": GRAD_RTOL,
                       "atol_per_max": GRAD_ATOL_REL},
         losses=[float(v) for v in losses], train_step_ms=percentiles(step_ms),
         peak_memory_mb=peak_mb, profile=profile)
    return launches, step_summary(step_ms, peak_mb, profile)


def step_summary(step_ms, peak_mb, profile):
    """A training step's numbers that the bf16 step reports beside its own."""
    return {"train_step_ms": percentiles(step_ms), "peak_memory_mb": peak_mb,
            "device_busy_ms": profile["device_busy_ms"],
            "device_by_kernel": profile["top"]}


@contextmanager
def jittered_products(rel, seed=0):
    """Every plain product of the fused field (``kernels._mm``, CPU tensors)
    scaled by (1 + rel N(0, 1)) while the context is open."""
    from online_neural_cdes_tpu_torch.ops import kernels

    mm, gen = kernels._mm, torch.Generator().manual_seed(seed)

    def jittered(a, b, precision):
        out = mm(a, b, precision)
        return out * (1 + rel * torch.randn(out.shape, generator=gen, dtype=out.dtype))

    kernels._mm = jittered
    try:
        yield
    finally:
        kernels._mm = mm


def ratio(num, den):
    """num / den, with 0 / 0 read as 0 (a parameter whose gradient bf16
    leaves exactly as it is)."""
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def bf16_grad_ratios(model, model_cpu, inputs, labels, length):
    """On GRAD_ROWS rows and the first ``length`` observations, per
    parameter: ||card_bf16 - cpu_bf16|| / ||cpu_bf16 - cpu_f32||
    (Frobenius), the largest of them and their median over the parameters;
    and the same for the CPU in bf16 with its products jittered by
    BF16_JITTER in place of the card ("jitter")."""
    bf16 = torch.bfloat16
    static, coeffs = inputs
    inputs = (static, coeffs[:, :2 * length - 1].contiguous())
    labels = labels[:, :length]
    cpu_inputs, cpu_labels = tuple(t.cpu() for t in inputs), labels.cpu()
    got = slice_grads(model, inputs, labels, GRAD_ROWS, bf16)
    want = slice_grads(model_cpu, cpu_inputs, cpu_labels, GRAD_ROWS, bf16)
    f32 = slice_grads(model_cpu, cpu_inputs, cpu_labels, GRAD_ROWS)
    with jittered_products(BF16_JITTER):
        jitter = slice_grads(model_cpu, cpu_inputs, cpu_labels, GRAD_ROWS, bf16)
    for name, g in got.items():
        if not torch.isfinite(g).all():
            raise AssertionError(f"card bf16 gradient of {name} is not finite")

    def shares(grads):
        norm = {n: ratio(float((grads[n].cpu() - w).norm()), float((w - f32[n]).norm()))
                for n, w in want.items()}
        return {"max": max(norm.values()), "median": float(np.median(list(norm.values()))),
                "by_parameter": norm}

    return {"observations": length, "card": shares(got), "jitter": shares(jitter)}


def phase_train_bf16(f32_step=None):
    """One flagship step with ``compute_dtype="bfloat16"`` (the master
    weights and Adam stay f32): its launches; the card's bf16 gradients on
    16 rows against the CPU's, each parameter's within GRAD_BF16_RATIO of
    the CPU's own bf16-vs-f32 distance over the first GRAD_BF16_L
    observations; the first loss within LOSS_BF16_TOL of the f32 one; 10
    more steps with a falling loss; times, profile and peak memory beside
    ``f32_step`` (the f32 step's, when the train phase ran)."""
    from online_neural_cdes_tpu_torch.training.loop import make_train_step
    from online_neural_cdes_tpu_torch.training.metrics import make_loss, masked_temporal_loss

    bf16 = torch.bfloat16
    model = flagship_model("cuda")
    inputs, labels = train_batch("cuda")
    intervals = 2 * TRAIN_L - 2
    expected = {"forward": 2 * 4 * intervals, "backward": 4 * intervals}

    model_cpu = flagship_model("cpu")
    model_cpu.load_state_dict(model.state_dict())
    grads = bf16_grad_ratios(model, model_cpu, inputs, labels, GRAD_BF16_L)
    if not grads["card"]["max"] <= GRAD_BF16_RATIO:
        raise AssertionError(
            f"bf16 gradients on {GRAD_BF16_L} observations: a parameter's is "
            f"{grads['card']['max']} of the CPU's bf16-vs-f32 distance from the CPU's "
            f"(limit {GRAD_BF16_RATIO}): {grads}")
    with torch.no_grad():
        loss_f32 = float(masked_temporal_loss(make_loss("bce"), model(inputs), labels))

    step = make_train_step(model, loss="bce", lr=TRAIN_LR, compute_dtype="bfloat16")
    loss, launches = counted(lambda: step(inputs, labels, 1.0))   # the bf16 main path
    expect_launches("one bf16 training step", launches, **expected)
    if not abs(float(loss) - loss_f32) <= LOSS_BF16_TOL:
        raise AssertionError(f"first bf16 loss {float(loss)} vs f32 {loss_f32}")
    losses = [loss]
    step_ms = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step(inputs, labels, 1.0))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all() or not losses[-3:].mean() < losses[0]:
        raise AssertionError(f"bf16 training losses not finite and falling: {losses}")
    profile = profile_call(lambda: step(inputs, labels, 1.0))
    emit("train_bf16", batch=TRAIN_B, intervals=intervals, compute_dtype="bfloat16",
         kernel_launches=launches, expected_launches=expected,
         grads_vs_cpu={"rows": GRAD_ROWS, "gate": "max", "ratio_limit": GRAD_BF16_RATIO,
                       "jitter": BF16_JITTER, **grads},
         first_loss={"bf16": float(losses[0]), "f32": loss_f32, "limit": LOSS_BF16_TOL},
         losses=[float(v) for v in losses], train_step_ms=percentiles(step_ms),
         peak_memory_mb=peak_mb, profile=profile, f32_step=f32_step)
    return launches


def phase_bench_bf16_leg():
    """The JAX package's bf16 parity leg (bench.py): the flagship field
    (B=512, H=128, I=21, two trunk layers) in bf16 storage under precision
    "bfloat16", forward and the gradient of sum(out.float()**2) with
    respect to the packed weights and z, the card against the CPU, each
    within max|card - cpu| <= LEG_TOL max|cpu| + 1e-5."""
    from online_neural_cdes_tpu_torch.models.vector_fields import VectorField
    from online_neural_cdes_tpu_torch.ops import kernels

    bf16 = torch.bfloat16

    def leg(device):
        field = VectorField(LEG_I, LEG_H, LEG_H, 2, generator=torch.Generator().manual_seed(3),
                            dtype=bf16, device=device)
        packed = kernels.pack_fused_params(field.params, LEG_H, LEG_I)
        leaves = [packed["head_w"], packed["head_b"]] + [t for layer in packed["trunk"]
                                                         for t in (layer["w"], layer["b"])]
        leaves = [t.detach().clone().requires_grad_() for t in leaves]
        rng = np.random.default_rng(3)
        z = torch.from_numpy(rng.normal(size=(LEG_B, LEG_H))).to(device, bf16).requires_grad_()
        dx = torch.from_numpy(rng.normal(size=(LEG_B, LEG_I))).to(device, bf16)
        hw, hb, *flat = leaves
        trunk = [{"w": flat[i], "b": flat[i + 1]} for i in range(0, len(flat), 2)]
        out = kernels.fused_matmul_field(trunk, hw, hb, z, dx, LEG_H, LEG_I, "bfloat16")
        grads = torch.autograd.grad((out.float() ** 2).sum(), leaves + [z])
        names = ["head_w", "head_b"] + [f"trunk[{l}].{k}" for l in range(len(trunk))
                                        for k in ("w", "b")] + ["z"]
        return {"out": out.detach(), **{f"d{n}": g for n, g in zip(names, grads)}}

    got, launches = counted(lambda: leg("cuda"))
    expect_launches("the bf16 leg", launches, forward=1, backward=1)
    want = leg("cpu")
    errs = {}
    for name, w in want.items():
        g = got[name].cpu()
        if g.dtype != bf16 or g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"bf16 leg {name}: dtype {g.dtype}, shape "
                                 f"{tuple(g.shape)} or non-finite values")
        g, w = g.double(), w.double()
        scale = float(w.abs().max())
        errs[name] = float((g - w).abs().max()) / scale
        if not float((g - w).abs().max()) <= LEG_TOL * scale + 1e-5:
            raise AssertionError(f"bf16 leg {name}: max err {errs[name]} of max, past "
                                 f"{LEG_TOL}")
    emit("bench_bf16_leg", shape=[LEG_B, LEG_H, LEG_H, LEG_I, 2], storage="bfloat16",
         precision="bfloat16", kernel_launches=launches, tol=LEG_TOL,
         max_err_per_max=errs)


def phase_predict_bf16():
    """One ``predict`` of the flagship model in bf16 (the requests go in at
    the model's dtype): 888 forward launches and no backward; the card's
    outputs within PREDICT_BF16_RATIO of the CPU's bf16-vs-f32 distance
    (the same weights in f32) from the CPU's, beside the share a jitter of
    the CPU's products by BF16_JITTER gives."""
    from online_neural_cdes_tpu_torch import Predictor

    bf16 = torch.bfloat16
    model = flagship_model("cuda", dtype=bf16)
    pred = Predictor(model, coeff_fn=rectilinear_coeffs, batch_buckets=(1, 64),
                     length_multiple=LENGTH_MULTIPLE, device="cuda")
    pred.precompile(channels=C, max_length=MAX_LEN, static_dim=STATIC)
    requests, static = make_requests()
    padded_len = -(-MAX_LEN // LENGTH_MULTIPLE) * LENGTH_MULTIPLE
    expected = 4 * (2 * padded_len - 2)
    outs, launches = counted(lambda: pred.predict(requests, static=static))  # bf16 serving
    expect_launches("one bf16 predict", launches, forward=expected)
    def cpu_predict(dtype):
        m = flagship_model("cpu", dtype=dtype)
        m.load_state_dict(model.state_dict())
        return Predictor(m, coeff_fn=rectilinear_coeffs, batch_buckets=(1, 64),
                         length_multiple=LENGTH_MULTIPLE, device="cpu").predict(
                             requests, static=static)

    outs_cpu, outs_f32 = cpu_predict(bf16), cpu_predict(torch.float32)
    with jittered_products(BF16_JITTER):
        outs_jitter = cpu_predict(bf16)
    for r, g in zip(requests, outs):
        if g.shape != (len(r), 1) or not np.isfinite(g).all():
            raise AssertionError(f"bf16 predictor output shape {g.shape} or non-finite")

    def dist(xs, ys):
        return max(float(np.abs(x - y).max()) for x, y in zip(xs, ys))

    scale = dist(outs_cpu, outs_f32)
    share, jitter_share = dist(outs, outs_cpu) / scale, dist(outs_jitter, outs_cpu) / scale
    if not share <= PREDICT_BF16_RATIO:
        raise AssertionError(f"bf16 predict: the card is {share} of the CPU's bf16-vs-f32 "
                             f"distance ({scale}) from the CPU (limit {PREDICT_BF16_RATIO})")
    emit("predict_bf16", kernel_launches=launches, expected_launches=expected,
         vs_cpu={"max_abs_err": dist(outs, outs_cpu), "cpu_bf16_vs_f32": scale,
                 "ratio": share, "ratio_limit": PREDICT_BF16_RATIO,
                 "cpu_jitter_ratio": jitter_share, "jitter": BF16_JITTER,
                 "max_abs_output": max(float(np.abs(c).max()) for c in outs_cpu)})
    return launches


def rk4_chain_states(model, inputs):
    """The flagship model's hidden states at every knot by chaining the
    whole-interval RK4 kernel over its rectilinear pieces: even pieces with
    the time channel's head slice (I=1), odd pieces with the full head,
    each with its piece's dX/dt times the knot spacing.  Also the same
    states from ``cdeint`` through the per-stage field kernel."""
    from online_neural_cdes_tpu_torch.ops.cdeint import cdeint
    from online_neural_cdes_tpu_torch.ops.kernels import fused_rk4_interval

    with torch.inference_mode():
        spline, h0 = model._setup_h0(inputs)
        func, even_func, packed, vf_type = model.make_solve_func(h0)
        want = cdeint(spline, func, h0, spline.grid_points, packed, adjoint=False,
                      vector_field_type=vf_type, method="rk4", even_func=even_func,
                      options={"substeps": 1})
        grid, dxdt = spline.host_grid(), spline.piece_data()["dxdt"]
        k, states, z = model.rectilinear_time_channel, [h0], h0
        for i in range(len(grid) - 1):
            dx = dxdt[i] * (grid[i + 1] - grid[i])
            if i % 2 == 0:
                z = fused_rk4_interval(packed["trunk"], packed["head_w_time"],
                                       packed["head_b_time"], z,
                                       dx[:, k:k + 1].contiguous(), H, 1)
            else:
                z = fused_rk4_interval(packed["trunk"], packed["head_w"],
                                       packed["head_b"], z, dx.contiguous(), H, C)
            states.append(z)
        return torch.stack(states, dim=-2), want


def phase_chains():
    """Both interval-chain experiments on the card (their variants and the
    launches of every chain), then the interval kernel chained over the
    flagship training batch against ``cdeint``'s per-stage solve."""
    from online_neural_cdes_tpu_torch.experiments import interleave_experiment, pair_probe

    (probe, inter), launches = counted(                  # the chains' main path
        lambda: (pair_probe.main([]), interleave_experiment.main([])))
    n_probe, n_inter = probe["shape"]["N"], inter["shape"]["N"]
    for name, row in probe["variants"].items():
        per = 2 * n_probe if name.startswith("pair") else n_probe
        want = {"fused_field": 4 * per if name.endswith("_stages") else 0,
                "fused_rk4": per if name.endswith("_interval") else 0}
        if row["launches"] != want or not row["finite"]:
            raise AssertionError(f"pair_probe {name}: launches {row['launches']}, "
                                 f"expected {want}, finite {row['finite']}")
    for name, row in inter["variants"].items():
        if "launches" not in row:
            continue
        k = row.get("K", 1)
        want = ({"fused_rk4": 0, "fused_rk4_multi": n_inter} if name.endswith("interleave")
                else {"fused_rk4": k * n_inter, "fused_rk4_multi": 0})
        if row["launches"] != want:
            raise AssertionError(f"interleave {name}: launches {row['launches']}, "
                                 f"expected {want}")

    model = flagship_model("cuda")
    inputs, _ = train_batch("cuda")
    got, want = rk4_chain_states(model, inputs)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"interval chain states: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite values")
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=CHAIN_RTOL, atol=CHAIN_ATOL_REL * scale,
                               msg=lambda m: f"interval chain vs cdeint: {m}")
    emit("chains", pair_probe=probe["variants"], interleave=inter["variants"],
         parity=inter["parity"], launches=launches,
         model_chain={"intervals": got.shape[-2] - 1,
                      "max_abs_err": float((got - want).abs().max()),
                      "gate_share": gate_share(got.cpu(), want.cpu(), CHAIN_RTOL,
                                               CHAIN_ATOL_REL * scale),
                      "max_abs_state": scale, "rtol": CHAIN_RTOL,
                      "atol_per_max": CHAIN_ATOL_REL})
    return launches


def spline_builders():
    """Every spline coefficient builder of the port, by name."""
    from online_neural_cdes_tpu_torch import (
        SmoothLinearInterpolation, hermite_cubic_coefficients_with_backward_differences,
        linear_interpolation_coeffs, natural_cubic_coeffs, natural_cubic_spline_coeffs)

    def smoothing(quintic):
        return lambda x: SmoothLinearInterpolation.create(
            linear_interpolation_coeffs(x), SMOOTH_EPS,
            match_second_derivatives=quintic).matching_coeffs

    return {"natural_cubic": natural_cubic_coeffs,
            "natural_cubic_v0": natural_cubic_spline_coeffs,
            "hermite": hermite_cubic_coefficients_with_backward_differences,
            "cubic_smoothing": smoothing(False), "quintic_smoothing": smoothing(True)}


def phase_splines():
    """The spline family on the card: every coefficient builder on the
    padded serving batch against the CPU; a Hermite flagship ``Predictor``
    (444 forward launches, 0 backward per ``predict``) against the CPU; one
    Hermite flagship training step (792 forward, 396 backward launches)
    with the card's gradients against the CPU's on 16 rows."""
    from online_neural_cdes_tpu_torch import (
        Predictor, hermite_cubic_coefficients_with_backward_differences as hermite)
    from online_neural_cdes_tpu_torch.data.loader import pad_ragged
    from online_neural_cdes_tpu_torch.training.loop import make_train_step

    requests, static = make_requests()
    x = torch.from_numpy(pad_ragged(requests, bucket_multiple=LENGTH_MULTIPLE))
    coeff_err = {}
    with torch.inference_mode():
        for name, fn in spline_builders().items():
            got, want = fn(x.cuda()).cpu(), fn(x)
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"{name} coefficients on the card: shape "
                                     f"{tuple(got.shape)} or non-finite values")
            scale = float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=SPLINE_RTOL,
                                       atol=SPLINE_ATOL_REL * scale,
                                       msg=lambda m: f"{name} coefficients: {m}")
            coeff_err[name] = {"shape": list(got.shape),
                               "max_err_per_max": float((got - want).abs().max()) / scale}

    # Serving: the flagship widths with Hermite controls.
    model = flagship_model("cuda", "hermite")
    pred = Predictor(model, coeff_fn=hermite, batch_buckets=(1, 64),
                     length_multiple=LENGTH_MULTIPLE, device="cuda")
    pred.precompile(channels=C, max_length=MAX_LEN, static_dim=STATIC)
    intervals = x.shape[1] - 1
    outs, serve = counted(lambda: pred.predict(requests, static=static))  # Hermite serving
    expect_launches("one Hermite predict", serve, forward=4 * intervals)
    model_cpu = flagship_model("cpu", "hermite")
    model_cpu.load_state_dict(model.state_dict())
    outs_cpu = Predictor(model_cpu, coeff_fn=hermite, batch_buckets=(1, 64),
                         length_multiple=LENGTH_MULTIPLE, device="cpu").predict(
                             requests, static=static)
    serve_err = serve_share = 0.0
    for r, g, c in zip(requests, outs, outs_cpu):
        if g.shape != (len(r), 1) or not np.isfinite(g).all():
            raise AssertionError(f"Hermite predictor output shape {g.shape} or non-finite")
        np.testing.assert_allclose(g, c, rtol=SERVE_RTOL, atol=SERVE_ATOL)
        serve_err = max(serve_err, float(np.abs(g - c).max()))
        serve_share = max(serve_share, gate_share(g, c, SERVE_RTOL, SERVE_ATOL))
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        pred.predict(requests, static=static)
        lat.append((time.perf_counter() - t0) * 1e3)

    # Training: one Hermite flagship step, B=512, 100 observations.
    model = flagship_model("cuda", "hermite")
    inputs, labels = train_batch("cuda", coeff_fn=hermite)
    model_cpu.load_state_dict(model.state_dict())
    got = slice_grads(model, inputs, labels, GRAD_ROWS)
    want = slice_grads(model_cpu, tuple(t.cpu() for t in inputs), labels.cpu(), GRAD_ROWS)
    grad_err = {}
    for name, w in want.items():
        g = got[name].cpu()
        if not torch.isfinite(g).all():
            raise AssertionError(f"Hermite card gradient of {name} is not finite")
        torch.testing.assert_close(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * float(w.abs().max()),
                                   msg=lambda m: f"Hermite gradient of {name}: {m}")
        grad_err[name] = float((g - w).abs().max() / w.abs().max())
    step = make_train_step(model, loss="bce", lr=TRAIN_LR)
    train_intervals = TRAIN_L - 1
    loss, train = counted(lambda: step(inputs, labels, 1.0))  # Hermite training
    expect_launches("one Hermite training step", train, forward=8 * train_intervals,
                    backward=4 * train_intervals)
    losses = [loss]
    step_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        losses.append(step(inputs, labels, 1.0))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError(f"Hermite training losses not finite: {losses}")
    emit("splines", coefficients=coeff_err,
         coeff_tolerance={"rtol": SPLINE_RTOL, "atol_per_max": SPLINE_ATOL_REL},
         hermite_predict={"intervals": intervals, "kernel_launches": serve,
                          "vs_cpu": {"max_abs_err": serve_err, "gate_share": serve_share,
                                     "rtol": SERVE_RTOL, "atol": SERVE_ATOL},
                          "predict_ms": percentiles(lat)},
         hermite_train={"batch": TRAIN_B, "intervals": train_intervals,
                        "kernel_launches": train,
                        "grads_vs_cpu": {"rows": GRAD_ROWS,
                                         "max_err_per_max": max(grad_err.values()),
                                         "rtol": GRAD_RTOL, "atol_per_max": GRAD_ATOL_REL},
                        "losses": [float(v) for v in losses],
                        "train_step_ms": percentiles(step_ms)})
    return serve, train


def phase_toy():
    """The toy under the rectilinear, Hermite and natural cubic schemes,
    card against CPU from the same weights and data."""
    from online_neural_cdes_tpu_torch.experiments import sim_bm_toy as toy

    data = {device: toy.toy_data(TOY_PATHS, 3, device) for device in ("cuda", "cpu")}
    for scheme in TOY_SCHEMES:
        runs = {device: toy.train_scheme(
            scheme, data[device], epochs=TOY_EPOCHS, hidden=10, width=256, reps=1,
            batch_size=TOY_BATCH, device=device) for device in ("cuda", "cpu")}
        gpu, cpu = runs["cuda"], runs["cpu"]
        np.testing.assert_allclose(gpu["losses"], cpu["losses"], rtol=TOY_RTOL,
                                   atol=TOY_ATOL, err_msg=scheme)
        before, after = float(gpu["train_acc_before"][0]), float(gpu["train_acc"][0])
        if not after > before:
            raise AssertionError(f"toy {scheme}: train accuracy did not rise: "
                                 f"{before} -> {after}")
        emit("toy", scheme=scheme, paths=TOY_PATHS, epochs=TOY_EPOCHS,
             steps=int(gpu["losses"].shape[1]),
             loss_first_last=[float(gpu["losses"][0, 0]), float(gpu["losses"][0, -1])],
             vs_cpu={"max_abs_err": float(np.abs(gpu["losses"] - cpu["losses"]).max()),
                     "rtol": TOY_RTOL, "atol": TOY_ATOL},
             train_acc_before=before, train_acc=after,
             test_acc=float(gpu["test_acc"][0]), seconds_card=gpu["seconds"],
             seconds_cpu=cpu["seconds"])


def times(t):
    return {"ms": t["kernel_us"] / 1e3, "plain_ms": t["plain_us"] / 1e3,
            "bound_ms": t["bound_us"] / 1e3, "bound_by": t["bound_by"],
            "bound_tc_us": t["bound_tc_us"]}


def kernel_entry(name, source, replaces, launches, max_err, timings):
    """One kernel's entry: its times at TRAIN_SHAPE, and every timed
    shape's under ``by_shape``."""
    return {"name": name, "route": "cuda",
            "source": f"online_neural_cdes_tpu_torch/csrc/{source}",
            "replaces": f"online_neural_cdes_tpu/ops/kernels.py:{replaces}",
            "launches": launches, "max_abs_err": max_err,
            **times(timings[TRAIN_SHAPE]), "library_ms": None,
            "timed_shape": list(TRAIN_SHAPE),
            "by_shape": [{"shape": list(shape), **times(t)}
                         for shape, t in timings.items()]}


PHASES = ("kernel", "kernel_bwd", "kernel_rk4", "predictor", "stepper", "train",
          "chains", "splines", "toy", "train_bf16", "predict_bf16", "bench_bf16_leg")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", nargs="+", choices=PHASES, default=list(PHASES),
                    help="development aid: run only these phases (env and build "
                         "always run) and stop without the kernels and ok lines; "
                         "the smoke run proper takes no arguments")
    phases = set(ap.parse_args(argv).phases)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pk = peaks(torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    phase_env()
    phase_build()
    if "kernel" in phases:
        max_err, timings, timings_bf16 = phase_kernel(pk)
    if "kernel_bwd" in phases:
        max_err_bwd, timings_bwd, timings_bwd_bf16 = phase_kernel_bwd(pk)
    if "kernel_rk4" in phases:
        max_err_rk4, max_err_multi, timings_rk4, timings_multi = phase_kernel_rk4(pk)
    if phases & {"predictor", "stepper"}:
        model, requests, static, outs, serve_launches = phase_predictor()
    if "stepper" in phases:
        phase_stepper(model, requests, static, outs)
    f32_step = None
    if "train" in phases:
        train_launches, f32_step = phase_train()
    if "chains" in phases:
        chain_launches = phase_chains()
    if "splines" in phases:
        hermite_serve, hermite_train = phase_splines()
    if "toy" in phases:
        phase_toy()
    if "train_bf16" in phases:
        train_bf16_launches = phase_train_bf16(f32_step)
    if "predict_bf16" in phases:
        predict_bf16_launches = phase_predict_bf16()
    if "bench_bf16_leg" in phases:
        phase_bench_bf16_leg()
    if any(m.split(".")[0] in ("jax", "jaxlib", "flax") for m in sys.modules):
        raise AssertionError("JAX was imported")
    if phases != set(PHASES):
        print(card_line(), flush=True)
        return 0

    # Every kernel's launches on each path; ``launches`` is the count on
    # its own slice's main path: the training step for the field kernels,
    # the interval chains for the RK4 kernels.
    by_path = {"predict": serve_launches, "train_step": train_launches,
               "hermite_predict": hermite_serve, "hermite_train_step": hermite_train,
               "interval_chain": chain_launches, "train_step_bf16": train_bf16_launches,
               "predict_bf16": predict_bf16_launches}

    def paths(key):
        return {path: counts[key] for path, counts in by_path.items()}

    entries = []
    for kernel, source, replaces, key, err, tm, tm_bf16, main_path in (
            ("fused_matmul_field", "fused_field.cu", 184, "forward", max_err, timings,
             timings_bf16, "train_step"),
            ("fused_matmul_field_bwd", "fused_field_bwd.cu", 367, "backward",
             max_err_bwd, timings_bwd, timings_bwd_bf16, "train_step"),
            ("fused_rk4_interval", "fused_rk4_interval.cu", 511, "rk4", max_err_rk4,
             timings_rk4, None, "interval_chain")):
        entry = kernel_entry(kernel, source, replaces, by_path[main_path][key], err, tm)
        entry["launches_by_path"] = paths(key)
        if tm_bf16 is not None:
            entry["by_dtype"] = [{"mode": t["mode"], "shape": t["shape"], **times(t)}
                                 for t in tm_bf16.values()]
        entries.append(entry)
    k_main = RK4_MULTI_TIMED[0]
    entries.append({
        "name": "fused_rk4_interval_multi", "route": "cuda",
        "source": "online_neural_cdes_tpu_torch/csrc/fused_rk4_interval.cu",
        "replaces": "online_neural_cdes_tpu/ops/kernels.py:637",
        "launches": chain_launches["rk4_multi"], "max_abs_err": max_err_multi,
        **times(timings_multi[k_main]), "library_ms": None, "K": k_main,
        "timed_shape": list(TRAIN_SHAPE),
        "by_K": [{"K": k, **times(t)} for k, t in timings_multi.items()],
        "launches_by_path": paths("rk4_multi")})
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
