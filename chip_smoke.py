#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's serving and training paths at the width of the
repository's flagship online NCDE (C=21 with time in channel 0, H=HH=128,
two trunk layers, static_dim=10, rectilinear, RK4 one step per knot,
return_sequences) with random weights from a seed, and prints one JSON line
per phase:

1. env       -- torch, CUDA, nvcc, triton, CUTLASS headers, the card.
2. build     -- builds every kernel from ``online_neural_cdes_tpu_torch/csrc``,
                one ``nvcc`` per source, all started together.
3. kernel    -- the fused field's forward kernel against its plain PyTorch
                version on the card over a shape sweep, and its time (CUDA
                events) beside its bound and the plain version's time.
4. kernel_bwd -- the same for the backward kernel: all five cotangent
                groups over the sweep, identical bits on a repeat call, and
                a width its tiles cannot hold refused without a launch.
5. predictor -- ``Predictor`` serving 64 ragged, NaN-holding requests: the
                kernel's launch count for one forward, the outputs against
                the same predictor on the CPU, and request latencies.
   profile   -- one ``predict`` under torch.profiler: device time by kernel
                and the device's busy share of the call.
6. stepper   -- ``OnlineNCDEStepper`` over 64 streams x 99 ticks against
                the predictor's rows, and tick latencies.
7. train     -- ``make_train_step`` (Adam, BCE, lr 5e-4, interval adjoint)
                on a B=512 flagship batch: both kernels' launch counts for
                one step, the card's gradients against the CPU port's on a
                16-row slice, falling losses, step times, the profile of a
                step and the peak device memory.
8. toy       -- the rectilinear Brownian-motion toy trained on the card and
                on the CPU from the same weights and data: the loss curves
                agree and the last-time train accuracy rises.

Then a line with every kernel's numbers, a line with the card's name and
power limit as ``nvidia-smi`` gives them, and, as the last line,
``{"ok": true, "device": {...}}``.  Any failure raises: the run then exits
non-zero without that last line.  It needs a CUDA card, and it imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import torch

# Flagship online NCDE (the repository's MIMIC-scale configuration).
C, H, HH, N_LAYERS, STATIC = 21, 128, 128, 2, 10
N_REQUESTS, MIN_LEN, MAX_LEN = 64, 60, 100
LENGTH_MULTIPLE = 16
# (B, H, HH, I, n_trunk): the serving shapes (I=21 value pieces, I=1 time
# pieces, B=1 and 64 buckets), the flagship training batch's two shapes,
# and odd widths.
SWEEP = [(64, 128, 128, 21, 2), (64, 128, 128, 1, 2), (1, 128, 128, 21, 2),
         (512, 128, 128, 21, 2), (512, 128, 128, 1, 2), (5, 96, 196, 21, 3),
         (33, 256, 64, 21, 4)]
# The training step's dominant shape: the kernels line reports each
# kernel's times here, where most of its counted launches run.
TRAIN_SHAPE = (512, 128, 128, 21, 2)
TIMED = [(64, 128, 128, 21, 2), (64, 128, 128, 1, 2),
         (512, 128, 128, 21, 2), (512, 128, 128, 1, 2)]
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5   # the sums run in another order
# Backward kernel vs its plain version, each of the five groups: |err| <=
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
# Training: B=512 flagship batch, 100 observations -> 199 knots.
TRAIN_B, TRAIN_L, TRAIN_LR, TRAIN_STEPS = 512, 100, 5e-4, 10
GRAD_ROWS = 16
# Card vs CPU parameter gradients over 198 RK4 intervals forward and 198
# reverse (adjoint) in f32, summed in other orders on the two devices: per
# tensor, |err| <= GRAD_RTOL |want| + GRAD_ATOL_REL max|want|.
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-3
# Toy: 4096 paths of 3 points, batches of 1024, 20 epochs; card vs CPU
# loss curves after 80 Adam steps in f32 (Adam divides by the root of the
# second moment, which amplifies round-off where gradients are small).
TOY_PATHS, TOY_BATCH, TOY_EPOCHS = 4096, 1024, 20
TOY_RTOL, TOY_ATOL = 1e-3, 1e-4


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def peaks(name: str):
    """(f32 CUDA-core FLOP/s, HBM bytes/s) from NVIDIA's data sheets."""
    if "PCIe" in name:
        return 51e12, 2.0e12
    return 67e12, 3.35e12  # SXM


def field_cost(B, Hd, HHd, I, n):
    """Operations and the least bytes moved (each input read once, the
    output written once) of one fused-field call, f32."""
    weights = Hd * HHd + (n - 1) * HHd * HHd + n * HHd + HHd * I * Hd + I * Hd
    flops = 2 * B * (Hd * HHd + (n - 1) * HHd * HHd + HHd * I * Hd + I * Hd)
    nbytes = 4 * (B * Hd + B * I + weights + B * Hd)
    return flops, nbytes


def field_bwd_cost(B, Hd, HHd, I, n):
    """Operations (forward recompute, weight grads and input grads of every
    product) and the least bytes (inputs z, dX, g and the weights read
    once; dz, ddX and the weight grads written once) of one backward call,
    f32."""
    weights = Hd * HHd + (n - 1) * HHd * HHd + n * HHd + HHd * I * Hd + I * Hd
    flops = 3 * 2 * B * (Hd * HHd + (n - 1) * HHd * HHd + HHd * I * Hd)
    nbytes = 4 * (2 * B * Hd + B * I + weights + B * Hd + B * I + weights)
    return flops, nbytes


def bound(flops, nbytes, peak_flops, peak_bytes):
    """(bound in us, what bounds it)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bytes
    return max(t_ops, t_bytes) * 1e6, "operations" if t_ops > t_bytes else "bytes"


def device_us(fn, reps) -> float:
    """Device time per call: CUDA events around ``reps`` calls that the
    host queues behind a ~0.1 s sleep kernel, so they run back to back on
    the card whatever the host's per-call cost.  Keep reps x launches per
    call well under CUDA's queue of about a thousand pending launches."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    if host_ms > 80.0:
        raise RuntimeError(f"device_us: queueing {reps} calls took {host_ms:.1f} ms,"
                           " longer than the sleep; the time would be host-bound")
    return start.elapsed_time(end) * 1e3 / reps


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
    ptxas = {name: [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, lib in libs.items()}
    emit("build", sources=sources, seconds=seconds, ptxas=ptxas)


def phase_kernel(peak_flops, peak_bytes):
    from online_neural_cdes_tpu_torch.ops import kernels

    gen = torch.Generator().manual_seed(1)
    errors, timings = [], {}
    with torch.inference_mode():
        for shape in SWEEP:
            B, Hd, HHd, I, n = shape
            trunk, head_w, head_b, z, dx = random_field(gen, *shape, "cuda")
            got = kernels.fused_matmul_field(trunk, head_w, head_b, z, dx, Hd, I)
            want = kernels._forward_reference(trunk, head_w, head_b, z, dx, Hd, I)
            torch.cuda.synchronize()
            if got.shape != (B, Hd) or not torch.isfinite(got).all():
                raise AssertionError(f"kernel output at {shape}: shape "
                                     f"{tuple(got.shape)} or non-finite values")
            torch.testing.assert_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
            err = float((got - want).abs().max())
            errors.append({"shape": list(shape), "max_abs_err": err})
        for shape in TIMED:
            B, Hd, HHd, I, n = shape
            trunk, head_w, head_b, z, dx = random_field(gen, *shape, "cuda")
            bound_us, bound_by = bound(*field_cost(*shape), peak_flops, peak_bytes)
            kernel_us = device_us(lambda: kernels.fused_matmul_field(
                trunk, head_w, head_b, z, dx, Hd, I), reps=200)
            plain_us = device_us(lambda: kernels._forward_reference(
                trunk, head_w, head_b, z, dx, Hd, I), reps=50)
            timings[shape] = {
                "shape": list(shape), "kernel_us": kernel_us, "plain_us": plain_us,
                "bound_us": bound_us, "bound_by": bound_by,
                "blocks": -(-B // 8) * -(-Hd // 32)}
    emit("kernel", tolerance={"rtol": KERNEL_RTOL, "atol": KERNEL_ATOL},
         sweep=errors, timed=list(timings.values()),
         library="none: no single PyTorch call computes the fused field")
    return max(e["max_abs_err"] for e in errors), timings


def random_cotangent(gen, B, Hd, device):
    return torch.randn((B, Hd), generator=gen).to(device)


def bwd_groups(out):
    """The backward's five groups as (name, tensor) pairs."""
    dtrunk, dhw, dhb, dz, ddx = out
    groups = [("dz", dz), ("ddx", ddx), ("dhead_w", dhw), ("dhead_b", dhb)]
    for l, layer in enumerate(dtrunk):
        groups += [(f"dtrunk[{l}].w", layer["w"]), (f"dtrunk[{l}].b", layer["b"])]
    return groups


def phase_kernel_bwd(peak_flops, peak_bytes):
    """The backward kernel against its plain version (autograd through the
    plain forward) over the forward's sweep, each group within
    BWD_RTOL |want| + BWD_ATOL_REL max|want|; a repeat call gives the same
    bits; CUDA-event times at the two training shapes."""
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
        bound_us, bound_by = bound(*field_bwd_cost(*shape), peak_flops, peak_bytes)
        kernel_us = device_us(lambda: kernels._backward_kernel(*args), reps=100)
        plain_us = device_us(lambda: kernels._backward_reference(*args), reps=20)
        timings[shape] = {"shape": list(shape), "kernel_us": kernel_us,
                          "plain_us": plain_us, "bound_us": bound_us,
                          "bound_by": bound_by,
                          "launches": profile_call(
                              lambda: kernels._backward_kernel(*args))["top"]}
    emit("kernel_bwd", tolerance={"rtol": BWD_RTOL, "atol_per_max": BWD_ATOL_REL},
         sweep=errors, repeat="bit-identical", timed=list(timings.values()),
         library="none: no single PyTorch call computes the fused field's VJP")
    max_err = max(e for entry in errors for e in entry["max_abs_err"].values())
    return max_err, timings


def flagship_model(device):
    from online_neural_cdes_tpu_torch import NeuralCDE

    return NeuralCDE(
        input_dim=C, hidden_dim=H, output_dim=1, static_dim=STATIC,
        hidden_hidden_dim=HH, num_layers=N_LAYERS, interpolation="rectilinear",
        solver="rk4", return_sequences=True,
        generator=torch.Generator().manual_seed(0), device=device,
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
    from online_neural_cdes_tpu_torch import Predictor, linear_interpolation_coeffs
    from online_neural_cdes_tpu_torch.ops.kernels import (
        fused_field_bwd_kernel, fused_field_kernel)

    coeff_fn = partial(linear_interpolation_coeffs, rectilinear=0)
    model = flagship_model("cuda")
    pred = Predictor(model, coeff_fn=coeff_fn, batch_buckets=(1, 64),
                     length_multiple=LENGTH_MULTIPLE, device="cuda")
    warmed = pred.precompile(channels=C, max_length=MAX_LEN, static_dim=STATIC)
    requests, static = make_requests()
    padded_len = -(-MAX_LEN // LENGTH_MULTIPLE) * LENGTH_MULTIPLE
    intervals = 2 * padded_len - 2
    expected = intervals * 4  # RK4: four field evaluations per interval

    torch.cuda.synchronize()
    fused_field_kernel.launches = 0
    fused_field_bwd_kernel.launches = 0
    outs = pred.predict(requests, static=static)        # the serving path
    launches = {"forward": fused_field_kernel.launches,
                "backward": fused_field_bwd_kernel.launches}
    if launches["forward"] != expected:
        raise AssertionError(f"kernel launched {launches['forward']} times, "
                             f"expected {expected}")
    if launches["backward"]:
        raise AssertionError(f"serving launched the backward kernel "
                             f"{launches['backward']} times")

    model_cpu = flagship_model("cpu")
    model_cpu.load_state_dict(model.state_dict())
    pred_cpu = Predictor(model_cpu, coeff_fn=coeff_fn, batch_buckets=(1, 64),
                         length_multiple=LENGTH_MULTIPLE, device="cpu")
    outs_cpu = pred_cpu.predict(requests, static=static)
    err = 0.0
    for r, g, c in zip(requests, outs, outs_cpu):
        if g.shape != (len(r), 1) or not np.isfinite(g).all():
            raise AssertionError(f"predictor output shape {g.shape} or non-finite")
        np.testing.assert_allclose(g, c, rtol=SERVE_RTOL, atol=SERVE_ATOL)
        err = max(err, float(np.abs(g - c).max()))

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
         vs_cpu={"max_abs_err": err, "rtol": SERVE_RTOL, "atol": SERVE_ATOL},
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
    err = 0.0
    for i, (r, o) in enumerate(zip(requests, outs)):
        np.testing.assert_allclose(rows[i, :len(r)], o, rtol=STEP_RTOL, atol=STEP_ATOL)
        err = max(err, float(np.abs(rows[i, :len(r)] - o).max()))

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
         vs_predictor={"max_abs_err": err, "rtol": STEP_RTOL, "atol": STEP_ATOL},
         tick_ms=percentiles(ticks), step_many_64_ms=many_ms,
         sequential_64_steps_ms=seq_ms)


def train_batch(device, seed=7):
    """The flagship training batch (as ``bench.py``'s flagship step makes
    it): B=512 series of 100 observations, time in channel 0, static
    features, random 0/1 labels per observation."""
    from online_neural_cdes_tpu_torch import linear_interpolation_coeffs

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(TRAIN_B, TRAIN_L, C)).astype(np.float32)
    x[:, :, 0] = np.arange(TRAIN_L)
    static = rng.normal(size=(TRAIN_B, STATIC)).astype(np.float32)
    labels = rng.integers(0, 2, size=(TRAIN_B, TRAIN_L)).astype(np.float32)
    coeffs = linear_interpolation_coeffs(torch.from_numpy(x).to(device), rectilinear=0)
    return ((torch.from_numpy(static).to(device), coeffs),
            torch.from_numpy(labels).to(device))


def slice_grads(model, inputs, labels, rows):
    """Parameter gradients of the masked BCE on the first ``rows`` rows."""
    from online_neural_cdes_tpu_torch.training.metrics import make_loss, masked_temporal_loss

    model.zero_grad(set_to_none=True)
    static, coeffs = inputs
    preds = model((static[:rows], coeffs[:rows]))
    masked_temporal_loss(make_loss("bce"), preds, labels[:rows]).backward()
    return {name: p.grad.detach().clone() for name, p in model.named_parameters()}


def phase_train():
    from online_neural_cdes_tpu_torch.ops.kernels import (
        fused_field_bwd_kernel, fused_field_kernel)
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
    grad_err = {}
    for name, w in want.items():
        g = got[name].cpu()
        if not torch.isfinite(g).all():
            raise AssertionError(f"card gradient of {name} is not finite")
        torch.testing.assert_close(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * float(w.abs().max()),
                                   msg=lambda m: f"gradient of {name}: {m}")
        grad_err[name] = float((g - w).abs().max() / w.abs().max())

    step = make_train_step(model, loss="bce", lr=TRAIN_LR)
    torch.cuda.synchronize()
    fused_field_kernel.launches = 0
    fused_field_bwd_kernel.launches = 0
    losses = [step(inputs, labels, 1.0)]                 # the main path
    torch.cuda.synchronize()
    launches = {"forward": fused_field_kernel.launches,
                "backward": fused_field_bwd_kernel.launches}
    if launches != expected:
        raise AssertionError(f"one training step launched {launches}, expected "
                             f"{expected}")

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
                       "rtol": GRAD_RTOL, "atol_per_max": GRAD_ATOL_REL},
         losses=[float(v) for v in losses], train_step_ms=percentiles(step_ms),
         peak_memory_mb=peak_mb, profile=profile)
    return launches


def phase_toy():
    """The rectilinear toy, card against CPU from the same weights and
    data."""
    from online_neural_cdes_tpu_torch.experiments import sim_bm_toy as toy

    runs = {}
    for device in ("cuda", "cpu"):
        runs[device] = toy.train_scheme(
            "rectilinear", toy.toy_data(TOY_PATHS, 3, device), epochs=TOY_EPOCHS,
            hidden=10, width=256, reps=1, batch_size=TOY_BATCH, device=device)
    gpu, cpu = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(gpu["losses"], cpu["losses"], rtol=TOY_RTOL,
                               atol=TOY_ATOL)
    before, after = float(gpu["train_acc_before"][0]), float(gpu["train_acc"][0])
    if not after > before:
        raise AssertionError(f"toy train accuracy did not rise: {before} -> {after}")
    emit("toy", scheme="rectilinear", paths=TOY_PATHS, epochs=TOY_EPOCHS,
         steps=int(gpu["losses"].shape[1]),
         loss_first_last=[float(gpu["losses"][0, 0]), float(gpu["losses"][0, -1])],
         vs_cpu={"max_abs_err": float(np.abs(gpu["losses"] - cpu["losses"]).max()),
                 "rtol": TOY_RTOL, "atol": TOY_ATOL},
         train_acc_before=before, train_acc=after,
         test_acc=float(gpu["test_acc"][0]), seconds_card=gpu["seconds"],
         seconds_cpu=cpu["seconds"])


def kernel_entry(name, source, replaces, launches, max_err, timings):
    """One kernel's entry: its times at TRAIN_SHAPE, and every timed
    shape's under ``by_shape``."""
    def times(t):
        return {"ms": t["kernel_us"] / 1e3, "plain_ms": t["plain_us"] / 1e3,
                "bound_ms": t["bound_us"] / 1e3, "bound_by": t["bound_by"]}

    return {"name": name, "route": "cuda",
            "source": f"online_neural_cdes_tpu_torch/csrc/{source}",
            "replaces": f"online_neural_cdes_tpu/ops/kernels.py:{replaces}",
            "launches": launches, "max_abs_err": max_err,
            **times(timings[TRAIN_SHAPE]), "library_ms": None,
            "timed_shape": list(TRAIN_SHAPE),
            "by_shape": [{"shape": list(shape), **times(t)}
                         for shape, t in timings.items()]}


PHASES = ("kernel", "kernel_bwd", "predictor", "stepper", "train", "toy")


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
    peak_flops, peak_bytes = peaks(torch.cuda.get_device_name(0))

    phase_env()
    phase_build()
    if "kernel" in phases:
        max_err, timings = phase_kernel(peak_flops, peak_bytes)
    if "kernel_bwd" in phases:
        max_err_bwd, timings_bwd = phase_kernel_bwd(peak_flops, peak_bytes)
    if phases & {"predictor", "stepper"}:
        model, requests, static, outs, serve_launches = phase_predictor()
    if "stepper" in phases:
        phase_stepper(model, requests, static, outs)
    if "train" in phases:
        train_launches = phase_train()
    if "toy" in phases:
        phase_toy()
    if any(m.split(".")[0] in ("jax", "jaxlib", "flax") for m in sys.modules):
        raise AssertionError("JAX was imported")
    if phases != set(PHASES):
        print(card_line(), flush=True)
        return 0

    # launches: each kernel's count in this slice's main path, one flagship
    # training step; launches_by_path adds the serving path's.
    entries = []
    for kernel, source, replaces, key, err, tm in (
            ("fused_matmul_field", "fused_field.cu", 184, "forward", max_err, timings),
            ("fused_matmul_field_bwd", "fused_field_bwd.cu", 367, "backward",
             max_err_bwd, timings_bwd)):
        entry = kernel_entry(kernel, source, replaces, train_launches[key], err, tm)
        entry["launches_by_path"] = {"predict": serve_launches[key],
                                     "train_step": train_launches[key]}
        entries.append(entry)
    print(json.dumps({"kernels": entries}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
