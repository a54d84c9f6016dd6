"""The fused field kernels' precision scheme, rehearsed on the CPU.

``csrc/fused_field_bwd.cu`` runs every product of the fused field's VJP on
the tensor cores in 3xTF32, and ``csrc/fused_field.cu`` every product of
the forward (for H and HH up to 256): each f32 operand x is split into a
TF32 "big" part (x rounded to nearest, ties away from zero, as
``cvt.rna.tf32.f32`` rounds) and a TF32 "small" part (x - big, rounded the
same way), and a product accumulates big*big + big*small + small*big.  This
file emulates that arithmetic in numpy (operands rounded as the kernel
rounds them, sums in float64):

- the backward's three head products and its trunk products at the
  flagship training shapes, held against ``kernels._backward_reference``
  in float64 with the kernel's gate on the card: per cotangent group,
  |err| <= 1e-4 |want| + 1e-5 max|want|;
- the forward's trunk and head products, with tanh, the bias and the dX
  sum in float32 and the channel groups summed in the kernel's order, held
  against ``kernels._forward_reference`` in float64 with the forward's
  gate on the card, |err| <= 1e-4 |want| + 1e-5 (absolute).

- the whole-interval RK4 kernel's tensor-core route (``csrc/rk4_mma.cuh``):
  four stages of trunk and head products with the channels summed in its
  subset order, held against ``kernels._rk4_interval_reference`` in float64
  with the forward's gate, at both training shapes.

3xTF32 meets those gates; a single TF32 pass (big*big alone) does not.
The one-pass cases are the reason the kernels split: they document, before
any chip time, that one pass of the tensor cores is not an f32 product.

bf16 operands (bf16 storage, or precision "bfloat16"): a bf16 value has 8
significant bits, so it is exact in TF32 and its small part is 0.  The
kernels drop the passes that multiply by such a part (f32 x bf16: two
passes, bf16 x bf16: one); the emulation shows that this leaves the
3xTF32 product's bits as they are, and that the forward kernel's bf16
arithmetic meets the one-ulp gate of ``chip_smoke.py`` against the plain
version in bf16.  Under precision "bfloat16" that gate also refuses the
same arithmetic with the operands left unrounded.  The interval kernel in
bf16 storage drops passes only where the operand is bf16-exact (the weights,
and z in stage 1's first layer): marking a later stage's f32 input exact
misses the plain version's bits.
"""

import numpy as np
import pytest
import torch

from online_neural_cdes_tpu_torch.ops import kernels

torch.set_num_threads(1)

RTOL, ATOL_PER_MAX = 1e-4, 1e-5   # chip_smoke.py's BWD_RTOL, BWD_ATOL_REL
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5   # chip_smoke.py's KERNEL_RTOL, KERNEL_ATOL
# (B, H, HH, I, n_trunk): the flagship step's value pieces and the
# time-channel slice at a smaller batch.
SHAPES = [(512, 128, 128, 21, 2), (64, 128, 128, 1, 2)]
# The forward's: those two and a ragged one (H and HH not multiples of 8,
# five single-channel groups summed across a cluster).
FWD_SHAPES = SHAPES + [(17, 42, 37, 5, 1)]
# head_forward's grid (csrc/fused_field.cu::head_forward_grid): kTargetBlocks
# SMs, channel groups for kWaveBlocks blocks, at most kMaxGroups of them (a
# portable cluster).
TARGET_BLOCKS, WAVE_BLOCKS, MAX_GROUPS, STRIP = 132, 99, 8, 64


def tf32(x):
    """x (float32) rounded to TF32: add half a TF32 ulp to the bit pattern
    and clear the 13 low mantissa bits (round to nearest, ties away from
    zero, for every finite x)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x.astype(np.float32) - big)


def mm_3xtf32(a, b):
    (ab, as_), (bb, bs) = split(a), split(b)
    f = np.float64
    return ((ab.astype(f) @ bb.astype(f)) + (ab.astype(f) @ bs.astype(f))
            + (as_.astype(f) @ bb.astype(f))).astype(np.float32)


def mm_1xtf32(a, b):
    return (tf32(a).astype(np.float64) @ tf32(b).astype(np.float64)).astype(np.float32)


def mm_passes(a, b, exact_a, exact_b):
    """The kernels' product with the passes they run (mma_tf32.cuh's
    mma_3xtf32<EA, EB>): the 3xTF32 terms in the same order, less the ones
    that multiply by a small part the kernel knows to be 0."""
    (ab, as_), (bb, bs) = split(a), split(b)
    f = np.float64
    acc = ab.astype(f) @ bb.astype(f)
    if not exact_b:
        acc = acc + ab.astype(f) @ bs.astype(f)
    if not exact_a:
        acc = acc + as_.astype(f) @ bb.astype(f)
    return acc.astype(np.float32)


def bf16(x):
    """x rounded to bf16 (nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


def backward_emulated(mm, trunk, head_w, head_b, z, dx, g, n_in):
    """The kernel's backward with every product through ``mm`` and the
    elementwise steps in float32, in the kernel's order of operations."""
    us = [z]
    for layer in trunk:
        us.append(np.maximum(mm(us[-1], layer["w"]) + layer["b"], 0).astype(np.float32))
    batch, hidden = z.shape
    a = np.tanh(mm(us[-1], head_w) + head_b).astype(np.float32)
    a3 = a.reshape(batch, n_in, hidden)
    ddx = np.einsum("bih,bh->bi", a3.astype(np.float64), g.astype(np.float64))
    dpre = ((dx[:, :, None] * g[:, None, :]).reshape(batch, -1)
            * (1 - a * a)).astype(np.float32)
    dhw = mm(us[-1].T.copy(), dpre)
    dhb = dpre.astype(np.float64).sum(0)
    du = mm(dpre, head_w.T.copy())
    dtrunk = [None] * len(trunk)
    for l in range(len(trunk) - 1, -1, -1):
        dv = (du * (us[l + 1] > 0)).astype(np.float32)
        dtrunk[l] = {"w": mm(us[l].T.copy(), dv), "b": dv.astype(np.float64).sum(0)}
        du = mm(dv, trunk[l]["w"].T.copy())
    return dtrunk, dhw, dhb, du, ddx


def channels_per_group(batch, hidden, n_in):
    """head_forward_grid's channels a group: the largest row tile (16, 32
    or 64 rows) whose blocks still give half the SMs a block, then as many
    channel groups as three quarters of one wave hold.  (Its shared-memory
    check never binds at these widths.)"""
    hstrips = -(-hidden // STRIP)
    most = min(n_in, MAX_GROUPS)
    rows = 16
    for r in (32, 64):
        if -(-batch // r) * hstrips * most >= TARGET_BLOCKS // 2:
            rows = r
    groups = min(max(WAVE_BLOCKS // (-(-batch // rows) * hstrips), 1), most)
    return -(-n_in // groups)


def forward_emulated(mm, trunk, head_w, head_b, z, dx, n_in):
    """The forward kernel with every product through ``mm`` and tanh, the
    bias and the dX sum in float32, in the kernel's order: within a channel
    group, out = fma(tanh(pre_i + b_i), dX_i, out) over its channels in
    order; then the groups' partials summed in group order from 0."""
    u = z
    for layer in trunk:
        u = np.maximum(mm(u, layer["w"]) + layer["b"], 0).astype(np.float32)
    batch, hidden = z.shape
    a = np.tanh(mm(u, head_w) + head_b).astype(np.float32).reshape(batch, n_in, hidden)
    cpg = channels_per_group(batch, hidden, n_in)
    out = np.zeros((batch, hidden), np.float32)
    for i0 in range(0, n_in, cpg):
        part = np.zeros((batch, hidden), np.float32)
        for i in range(i0, min(n_in, i0 + cpg)):
            # fmaf: one rounding of a * dX + part
            part = (a[:, i].astype(np.float64) * dx[:, i:i + 1] + part).astype(np.float32)
        out = (out + part).astype(np.float32)
    return out


def forward_gate_ratio(mm, shape):
    """max err / gate of the emulated forward against the plain forward in
    float64."""
    batch, hidden, hh, n_in, n_trunk = shape
    trunk, head_w, head_b, z, dx, _ = inputs(shape)
    got = forward_emulated(mm, trunk, head_w, head_b, z, dx, n_in)
    t64 = lambda x: torch.from_numpy(x).double()
    want = kernels._forward_reference(
        [{k: t64(v) for k, v in layer.items()} for layer in trunk], t64(head_w),
        t64(head_b), t64(z), t64(dx), hidden, n_in).numpy()
    err = np.abs(got.astype(np.float64) - want)
    return float((err / (FWD_RTOL * np.abs(want) + FWD_ATOL)).max())


def inputs(shape, seed=0):
    """Seeded weights and inputs at chip_smoke.py's scales, float32."""
    batch, hidden, hh, n_in, n_trunk = shape
    rng = np.random.default_rng(seed)

    def u(size, fan_in):
        bound = 1.0 / fan_in ** 0.5
        return rng.uniform(-bound, bound, size=size).astype(np.float32)

    trunk, d_in = [], hidden
    for _ in range(n_trunk):
        trunk.append({"w": u((d_in, hh), d_in), "b": u((hh,), d_in)})
        d_in = hh
    head_w, head_b = u((hh, n_in * hidden), hh), u((n_in * hidden,), hh)
    z, dx, g = (rng.standard_normal(s).astype(np.float32)
                for s in ((batch, hidden), (batch, n_in), (batch, hidden)))
    return trunk, head_w, head_b, z, dx, g


def gate_ratios(mm, shape):
    """err / gate of every cotangent group, emulated against the plain
    backward in float64."""
    batch, hidden, hh, n_in, n_trunk = shape
    trunk, head_w, head_b, z, dx, g = inputs(shape)
    got = backward_emulated(mm, trunk, head_w, head_b, z, dx, g, n_in)
    t64 = lambda x: torch.from_numpy(x).double()
    want = kernels._backward_reference(
        [{k: t64(v) for k, v in layer.items()} for layer in trunk], t64(head_w),
        t64(head_b), t64(z), t64(dx), t64(g), hidden, n_in)
    ratios = {}
    for name, gt, wt in [("dhead_w", got[1], want[1]), ("dhead_b", got[2], want[2]),
                         ("dz", got[3], want[3]), ("ddx", got[4], want[4])] + [
            (f"dtrunk[{l}].{k}", got[0][l][k], want[0][l][k])
            for l in range(n_trunk) for k in ("w", "b")]:
        wt = wt.detach().numpy()
        err = np.abs(gt.astype(np.float64) - wt)
        ratios[name] = float((err / (RTOL * np.abs(wt) + ATOL_PER_MAX * np.abs(wt).max())).max())
    return ratios


def test_tf32_rounds_to_nearest_with_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                      # TF32's spacing at 1
    x = np.array([one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4, -(one + ulp / 2),
                  one + ulp / 2 - np.float32(2.0 ** -23)], dtype=np.float32)
    np.testing.assert_array_equal(
        tf32(x), np.array([one, one + ulp, one + ulp, -(one + ulp), one], dtype=np.float32))
    # big + small keeps about 21 of f32's 24 bits.
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    big, small = split(x)
    np.testing.assert_array_equal(tf32(big), big)
    np.testing.assert_array_equal(tf32(small), small)
    rel = np.abs((big.astype(np.float64) + small) - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -21


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_3xtf32_meets_the_backward_gate(shape):
    ratios = gate_ratios(mm_3xtf32, shape)
    assert max(ratios.values()) < 1.0, ratios


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_one_tf32_pass_misses_the_backward_gate(shape):
    ratios = gate_ratios(mm_1xtf32, shape)
    assert max(ratios.values()) > 10.0, ratios


@pytest.mark.parametrize("shape", FWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_3xtf32_meets_the_forward_gate(shape):
    ratio = forward_gate_ratio(mm_3xtf32, shape)
    assert ratio < 1.0, ratio


@pytest.mark.parametrize("shape", FWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_one_tf32_pass_misses_the_forward_gate(shape):
    ratio = forward_gate_ratio(mm_1xtf32, shape)
    assert ratio > 10.0, ratio


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_reduced_passes_equal_3xtf32_on_bf16_operands(shape):
    """At the flagship's product shapes: a bf16 value's TF32 small part is
    0, so the two-pass f32 x bf16 product and the one-pass bf16 x bf16
    product equal the three-pass product to the bit."""
    trunk, head_w, _, z, _, _ = inputs(shape)
    a, w16 = z, bf16(head_w)
    np.testing.assert_array_equal(split(w16)[1], 0)
    np.testing.assert_array_equal(mm_passes(a, w16, False, True), mm_3xtf32(a, w16))
    a16 = bf16(a)
    np.testing.assert_array_equal(mm_passes(a16, w16, True, True), mm_3xtf32(a16, w16))
    u = np.maximum(mm_3xtf32(z, trunk[0]["w"]), 0)
    np.testing.assert_array_equal(mm_passes(u, bf16(trunk[1]["w"]), False, True),
                                  mm_3xtf32(u, bf16(trunk[1]["w"])))


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_forward_meets_the_one_ulp_gate(shape, precision):
    """The forward kernel in bf16 storage, emulated: bf16 operands widened
    to f32, products in the passes the kernel runs (under "bfloat16" the
    activations rounded to bf16 before each product), tanh, the bias and
    the dX sum in float32 in the kernel's order, the output rounded to
    bf16; against the plain version in bf16 within chip_smoke.py's gate:
    |err| <= 2^-7 |want| + atol max|want|, atol 1e-5 (2^-8 under
    "bfloat16", where a rounded activation that lands on its neighbour
    reaches every sum downstream)."""
    batch, hidden, hh, n_in, n_trunk = shape
    trunk, head_w, head_b, z, dx, _ = inputs(shape)
    trunk = [{k: bf16(v) for k, v in layer.items()} for layer in trunk]
    head_w, head_b, z, dx = (bf16(t) for t in (head_w, head_b, z, dx))
    rnd = precision == "bfloat16"
    mm = ((lambda a, b: mm_passes(bf16(a), b, True, True)) if rnd
          else (lambda a, b: mm_passes(a, b, False, True)))
    got = bf16(forward_emulated(mm, trunk, head_w, head_b, z, dx, n_in)).astype(np.float64)
    t16 = lambda x: torch.from_numpy(x).bfloat16()
    want = kernels._forward_reference(
        [{k: t16(v) for k, v in layer.items()} for layer in trunk], t16(head_w),
        t16(head_b), t16(z), t16(dx), hidden, n_in, precision).double().numpy()
    atol = (2.0 ** -8 if rnd else 1e-5) * np.abs(want).max()
    np.testing.assert_array_less(np.abs(got - want), 2.0 ** -7 * np.abs(want) + atol + 1e-300)
    assert float((got == want).mean()) >= 0.99


# chip_smoke.py's gates under precision "bfloat16": in f32 storage the
# output is not rounded and its gate is 2^-10 |want| + 2^-11 max|want|; in
# bf16 storage 2^-7 |want| + 2^-8 max|want| with 80% of the bits equal.
F32_OUT_RTOL, F32_OUT_ATOL_PER_MAX = 2.0 ** -10, 2.0 ** -11
ROUNDED_RTOL, ROUNDED_ATOL_PER_MAX, ROUNDED_MIN_EQUAL = 2.0 ** -7, 2.0 ** -8, 0.80


def rounded_gate(got, want, storage):
    """(whether ``got`` passes chip_smoke.py's gate for precision "bfloat16"
    in ``storage``, the share of its error bound it uses)."""
    err, scale = np.abs(got - want), np.abs(want).max()
    if storage == "float32":
        tol, equal = F32_OUT_RTOL * np.abs(want) + F32_OUT_ATOL_PER_MAX * scale, 1.0
    else:
        tol = ROUNDED_RTOL * np.abs(want) + ROUNDED_ATOL_PER_MAX * scale
        equal = float((got == want).mean())
    share = float((err / tol).max())
    return share <= 1.0 and equal >= ROUNDED_MIN_EQUAL, share


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_rounded_mode_gate_refuses_operands_left_unrounded(shape, storage):
    """Precision "bfloat16", emulated: the forward kernel with each
    product's operands rounded to bf16 meets chip_smoke.py's gate for that
    mode against the plain version, and the same arithmetic on the operands
    as stored (the kernel's "float32" instantiation, the control that
    chip_smoke.py runs on the card) is refused."""
    batch, hidden, hh, n_in, n_trunk = shape
    trunk, head_w, head_b, z, dx, _ = inputs(shape)
    cast = bf16 if storage == "bfloat16" else (lambda x: x)
    trunk = [{k: cast(v) for k, v in layer.items()} for layer in trunk]
    head_w, head_b, z, dx = (cast(t) for t in (head_w, head_b, z, dx))
    stored = lambda x: torch.from_numpy(x).to(getattr(torch, storage))
    want = kernels._forward_reference(
        [{k: stored(v) for k, v in layer.items()} for layer in trunk], stored(head_w),
        stored(head_b), stored(z), stored(dx), hidden, n_in, "bfloat16").double().numpy()

    def emulated(mm):
        return cast(forward_emulated(mm, trunk, head_w, head_b, z, dx, n_in)).astype(np.float64)

    rounded = emulated(lambda a, b: mm_passes(bf16(a), bf16(b), True, True))
    as_stored = emulated(lambda a, b: mm_passes(a, b, False, storage == "bfloat16"))
    ok, share = rounded_gate(rounded, want, storage)
    assert ok, share
    ok, share = rounded_gate(as_stored, want, storage)
    assert not ok, share


def test_forward_channel_groups_follow_the_kernels_grid():
    """The grids the kernel's design note states: 6 groups of 4 channels
    at B=512, I=21 (64-row tiles), one group at I=1 (16-row tiles)."""
    assert channels_per_group(512, 128, 21) == 4
    assert channels_per_group(512, 128, 1) == 1
    assert channels_per_group(64, 128, 21) == 3
    assert channels_per_group(17, 42, 5) == 1


# ------------------------------------------- the whole-interval RK4 kernel

# (B, H, HH, I, n_trunk): the interval kernel's training shapes.
RK4_SHAPES = [(512, 128, 128, 21, 2), (512, 128, 128, 1, 2)]
# csrc/rk4_mma.cuh at H=128: a cluster of four blocks, each owning a strip
# of h = 32 state columns; 8 warps over its h / 8 = 4 n8 tiles leave S = 2
# channel subsets, channel i in subset i % S.
RK4_SUBSETS = 2


def rk4_interval_emulated(mm_at, trunk, head_w, head_b, z, dx, n_in, subsets=RK4_SUBSETS):
    """One RK4 (3/8) interval as the tensor-core interval kernel computes
    it: every product through ``mm_at(stage, layer)`` (layer n: the head),
    bias, relu and tanh in float32; each subset s of the channels (i % S ==
    s) sums fma(tanh(pre_i + b_i), dX_i, acc) in channel order, and the
    subsets' partials are added in subset order; the state updates in
    float32 with the kernel's expressions."""
    f32 = np.float32
    batch, hidden = z.shape
    n = len(trunk)

    def field(stage, x):
        u = x
        for l, layer in enumerate(trunk):
            u = np.maximum(mm_at(stage, l)(u, layer["w"]) + layer["b"], 0).astype(f32)
        a = np.tanh(mm_at(stage, n)(u, head_w) + head_b).astype(f32)
        a = a.reshape(batch, n_in, hidden)
        parts = []
        for s in range(min(subsets, n_in)):
            acc = np.zeros((batch, hidden), f32)
            for i in range(s, n_in, subsets):
                acc = (a[:, i].astype(np.float64) * dx[:, i:i + 1] + acc).astype(f32)
            parts.append(acc)
        k = parts[0]
        for p in parts[1:]:
            k = (k + p).astype(f32)
        return k

    third = f32(1.0 / 3.0)
    z0 = z.astype(f32)
    k1 = field(0, z0)
    k2 = field(1, (z0 + third * k1).astype(f32))
    k3 = field(2, ((z0 + k2).astype(f32) - third * k1).astype(f32))
    k4 = field(3, (((z0 + k1).astype(f32) - k2).astype(f32) + k3).astype(f32))
    return (z0 + ((k1 + f32(3) * (k2 + k3)).astype(f32) + k4).astype(f32)
            * f32(0.125)).astype(f32)


def rk4_plain(trunk, head_w, head_b, z, dx, n_in, dtype):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
    return kernels._rk4_interval_reference(
        [{k: t(v) for k, v in layer.items()} for layer in trunk], t(head_w), t(head_b),
        t(z), t(dx), z.shape[1], n_in).double().numpy()


@pytest.mark.parametrize("shape", RK4_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_rk4_interval_3xtf32_meets_the_kernel_gate(shape):
    """The interval kernel's 3xTF32 products in its channel-subset order,
    over one interval, held to the plain version in float64 within
    chip_smoke.py's gate for the kernel, |err| <= 1e-4 |want| + 1e-5; one
    TF32 pass a product does not meet it."""
    batch, hidden, hh, n_in, n_trunk = shape
    trunk, head_w, head_b, z, dx, _ = inputs(shape)
    want = rk4_plain(trunk, head_w, head_b, z, dx, n_in, torch.float64)

    def ratio(mm):
        got = rk4_interval_emulated(lambda s, l: mm, trunk, head_w, head_b, z, dx, n_in)
        err = np.abs(got.astype(np.float64) - want)
        return float((err / (FWD_RTOL * np.abs(want) + FWD_ATOL)).max())

    assert ratio(mm_3xtf32) < 1.0
    assert ratio(mm_1xtf32) > 10.0


def test_rk4_interval_bf16_drops_only_passes_on_bf16_exact_operands():
    """bf16 storage, emulated at the flagship shape: the weights are
    bf16-exact (every product drops its weight's small-part pass) and so
    is stage 1's first-layer operand z; the kernel's result, rounded once to
    bf16, meets chip_smoke.py's one-ulp gate against the plain version in
    bf16 with >= 99% of the bits equal.  Marking stage 2's first-layer
    operand (z + k1 / 3, an f32 sum) bf16-exact too drops real low-order
    bits: its products differ from the three-pass ones, and the result
    misses the plain version's bits."""
    shape = RK4_SHAPES[0]
    batch, hidden, hh, n_in, n_trunk = shape
    trunk, head_w, head_b, z, dx, _ = inputs(shape, seed=1)
    trunk = [{k: bf16(v) for k, v in layer.items()} for layer in trunk]
    head_w, head_b, z, dx = (bf16(t) for t in (head_w, head_b, z, dx))
    want = rk4_plain(trunk, head_w, head_b, z, dx, n_in, torch.bfloat16)

    def kernel_mm(exact_a_stages):
        return lambda s, l: (lambda a, b: mm_passes(a, b, l == 0 and s in exact_a_stages,
                                                    True))

    def readings(exact_a_stages):
        got = bf16(rk4_interval_emulated(kernel_mm(exact_a_stages), trunk, head_w, head_b,
                                         z, dx, n_in)).astype(np.float64)
        err = np.abs(got - want)
        share = float((err / (2.0 ** -7 * np.abs(want) + 1e-5 * np.abs(want).max())).max())
        return share, float((got == want).mean())

    share, equal = readings({0})
    assert share <= 1.0 and equal >= 0.99, (share, equal)
    # The same products as three passes: dropping z's small part changes no bit.
    np.testing.assert_array_equal(mm_passes(z, trunk[0]["w"], True, True),
                                  mm_3xtf32(z, trunk[0]["w"]))
    x2 = (z + np.float32(1.0 / 3.0) * np.tanh(z)).astype(np.float32)  # an f32 stage input
    assert not np.array_equal(mm_passes(x2, trunk[0]["w"], True, True),
                              mm_3xtf32(x2, trunk[0]["w"]))
    share_wrong, equal_wrong = readings({0, 1})
    assert share_wrong > 1.0 and equal_wrong < 0.99, (share_wrong, equal_wrong)
