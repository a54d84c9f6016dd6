#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's serving path at the width of the repository's flagship
online NCDE (C=21 with time in channel 0, H=HH=128, two trunk layers,
static_dim=10, rectilinear, RK4 one step per knot, return_sequences) with
random weights from a seed, and prints one JSON line per phase:

1. env       -- torch, CUDA, nvcc, triton, CUTLASS headers, the card.
2. build     -- builds every kernel from ``online_neural_cdes_tpu_torch/csrc``.
3. kernel    -- each kernel against its plain PyTorch version on the card
                over a shape sweep, and its time (CUDA events) beside its
                bound and the plain version's time.
4. predictor -- ``Predictor`` serving 64 ragged, NaN-holding requests: the
                kernel's launch count for one forward, the outputs against
                the same predictor on the CPU, and request latencies.
   profile   -- one ``predict`` under torch.profiler: device time by kernel
                and the device's busy share of the call.
5. stepper   -- ``OnlineNCDEStepper`` over 64 streams x 99 ticks against
                the predictor's rows, and tick latencies.

Then a line with every kernel's numbers, a line with the card's name and
power limit as ``nvidia-smi`` gives them, and, as the last line,
``{"ok": true, "device": {...}}``.  Any failure raises: the run then exits
non-zero without that last line.  It needs a CUDA card, and it imports
nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from functools import partial

import numpy as np
import torch

# Flagship online NCDE (the repository's MIMIC-scale configuration).
C, H, HH, N_LAYERS, STATIC = 21, 128, 128, 2, 10
N_REQUESTS, MIN_LEN, MAX_LEN = 64, 60, 100
LENGTH_MULTIPLE = 16
# (B, H, HH, I, n_trunk): the serving shapes (I=21 value pieces, I=1 time
# pieces, B=1 and 64 buckets), the flagship training batch, and odd widths.
SWEEP = [(64, 128, 128, 21, 2), (64, 128, 128, 1, 2), (1, 128, 128, 21, 2),
         (512, 128, 128, 21, 2), (5, 96, 196, 21, 3), (33, 256, 64, 21, 4)]
TIMED = [(64, 128, 128, 21, 2), (64, 128, 128, 1, 2),
         (512, 128, 128, 21, 2), (512, 128, 128, 1, 2)]
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5   # the sums run in another order
SERVE_RTOL, SERVE_ATOL = 1e-3, 1e-4     # card vs CPU over 222 RK intervals
# Stepper vs predictor on one card: the same kernel arithmetic, but the
# readout sums over H=128 in other orders (a 64x128 product per tick
# against one (64*223)x128 product), and f32 round-off grows over 198 RK
# intervals.
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5


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
    libs = {name: build_library(name) for name in sources}
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
            flops, nbytes = field_cost(*shape)
            bound_us = max(flops / peak_flops, nbytes / peak_bytes) * 1e6
            kernel_us = device_us(lambda: kernels.fused_matmul_field(
                trunk, head_w, head_b, z, dx, Hd, I), reps=200)
            plain_us = device_us(lambda: kernels._forward_reference(
                trunk, head_w, head_b, z, dx, Hd, I), reps=50)
            timings[shape] = {
                "shape": list(shape), "kernel_us": kernel_us, "plain_us": plain_us,
                "bound_us": bound_us,
                "bound_by": "operations" if flops / peak_flops > nbytes / peak_bytes
                else "bytes",
                "blocks": -(-B // 8) * -(-Hd // 32)}
    emit("kernel", tolerance={"rtol": KERNEL_RTOL, "atol": KERNEL_ATOL},
         sweep=errors, timed=list(timings.values()),
         library="none: no single PyTorch call computes the fused field")
    return max(e["max_abs_err"] for e in errors), timings


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
    from online_neural_cdes_tpu_torch.ops.kernels import fused_field_kernel

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
    outs = pred.predict(requests, static=static)        # the main path
    launches = fused_field_kernel.launches
    if launches != expected:
        raise AssertionError(f"kernel launched {launches} times, expected {expected}")

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
         intervals=intervals, kernel_launches=launches, expected_launches=expected,
         vs_cpu={"max_abs_err": err, "rtol": SERVE_RTOL, "atol": SERVE_ATOL},
         predict_ms=percentiles(lat), predict_many_ms_per_batch=many_ms)
    phase_profile(pred, requests, static)
    return model, requests, static, outs, launches


def phase_profile(pred, requests, static):
    """One ``predict`` under torch.profiler: device time by kernel name and
    the device's busy share of the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict(requests, static=static)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            entry = by_name.setdefault(evt.name[:60], [0, 0.0])
            entry[0] += 1
            entry[1] += evt.time_range.elapsed_us() / 1e3
    device_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    emit("profile", wall_ms=wall_ms,
         device_busy_ms=device_ms if by_name else "not measured",
         device_busy_share=device_ms / wall_ms if by_name else "not measured",
         device_events=sum(n for n, _ in by_name.values()),
         top=[{"name": k, "count": n, "ms": ms} for k, (n, ms) in top])


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bytes = peaks(name)

    phase_env()
    phase_build()
    max_err, timings = phase_kernel(peak_flops, peak_bytes)
    model, requests, static, outs, launches = phase_predictor()
    phase_stepper(model, requests, static, outs)
    if any(m.split(".")[0] in ("jax", "jaxlib", "flax") for m in sys.modules):
        raise AssertionError("JAX was imported")

    main_shape = timings[(64, 128, 128, 21, 2)]
    print(json.dumps({"kernels": [{
        "name": "fused_matmul_field",
        "route": "cuda",
        "source": "online_neural_cdes_tpu_torch/csrc/fused_field.cu",
        "replaces": "online_neural_cdes_tpu/ops/kernels.py:184",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_shape["kernel_us"] / 1e3,
        "plain_ms": main_shape["plain_us"] / 1e3,
        "bound_ms": main_shape["bound_us"] / 1e3,
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
