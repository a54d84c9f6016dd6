"""The relu-flip locator of ``chip_smoke.py``'s bf16 backward gate, on the
CPU.

A relu input near 0 can fall on the other side of 0 in the kernel than in
the plain version; the backward row then differs by the whole gradient
through that unit.  ``chip_smoke.py`` holds such a row against the plain
version with that one decision taken the other way (``bf16_relu_flips``).
Here a decision is taken the other way on purpose in a copy of the plain
version, which stands in for the kernel: the locator must name it, the
flippable plain version must equal the plain version to the bit, and a
row that no near-zero decision explains must be refused.
"""

import pytest
import torch

import chip_smoke as smoke
from online_neural_cdes_tpu_torch.ops import kernels

SHAPE = (64, 32, 32, 3, 2)


def _case(dtype, seed=2):
    gen = torch.Generator().manual_seed(seed)
    B, Hd, HHd, I, n = SHAPE
    field = smoke.cast_field(smoke.random_field(gen, *SHAPE, "cpu"), dtype)
    return field, smoke.random_cotangent(gen, B, Hd, "cpu").to(dtype)


@pytest.mark.parametrize("dtype,precision", smoke.BF16_MODES)
def test_flippable_plain_version_is_the_plain_version_to_the_bit(dtype, precision):
    field, g = _case(dtype)
    _, Hd, _, I, _ = SHAPE
    got, pres = smoke.plain_bwd_flipped(field, g, Hd, I, precision, [])
    want = kernels._backward_reference(*field, g, Hd, I, precision)
    for (name, a), (_, b) in zip(smoke.bwd_groups(got), smoke.bwd_groups(want)):
        assert torch.equal(a, b), name
    assert len(pres) == len(field[0])


@pytest.mark.parametrize("dtype,precision", smoke.BF16_MODES)
def test_locator_names_a_decision_taken_the_other_way(dtype, precision):
    field, g = _case(dtype)
    _, Hd, _, I, _ = SHAPE
    plain, pres = smoke.plain_bwd_flipped(field, g, Hd, I, precision, [])
    for r in range(SHAPE[0]):
        # This row's relu input nearest 0 over the trunk, within the margin.
        margin, l, j = min((float(v), l, int(k))
                           for l, pre in enumerate(pres)
                           for v, k in zip(*torch.sort(pre[r].double().abs()
                                                       / pre[r].double().abs().max())))
        if margin > smoke.BF16_FLIP_MARGIN:
            continue
        got, _ = smoke.plain_bwd_flipped(field, g, Hd, I, precision, [(l, r, j)])
        if float(smoke.bwd_row_shares(got, plain, precision)[r]) > 1.0:
            break
    else:
        pytest.fail("no row whose nearest decision moves it past its gate")
    flips, located = smoke.bf16_relu_flips("planted", field, g, Hd, I, precision,
                                           got, plain)
    assert flips == [(l, r, j)]
    assert located[0]["row"] == r and located[0]["row_share_before"] > 1.0


def test_locator_refuses_a_row_no_decision_explains():
    field, g = _case(torch.bfloat16)
    _, Hd, _, I, _ = SHAPE
    plain, _ = smoke.plain_bwd_flipped(field, g, Hd, I, "float32", [])
    got = list(plain)
    got[3] = plain[3].clone()
    got[3][9] *= 1.1   # dz of row 9 off by 10%
    with pytest.raises(AssertionError, match="row 9 is past its gate"):
        smoke.bf16_relu_flips("scaled", field, g, Hd, I, "float32", got, plain)


# The forward's gate: a row of the output past its gate, against the plain
# forward with one activation's bf16 rounding taken to the other neighbour.


def test_bf16_neighbours_bracket_each_value():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -9, 1.0 + 3 * 2.0 ** -9, -3.3, 0.0, 1e-30])
    near, other = smoke.bf16_neighbours(x)
    assert torch.equal(near, x.to(torch.bfloat16))
    lo = torch.minimum(near.float(), other.float())
    hi = torch.maximum(near.float(), other.float())
    assert bool(((lo <= x) & (x <= hi)).all())
    assert other[0] == near[0] and other[4] == near[4]          # bf16 values
    assert other[1] != near[1] and other[3] != near[3]
    step = (hi - lo)[[1, 2, 3]]
    assert torch.equal(step, torch.tensor([2.0 ** -7, 2.0 ** -7, 2.0 ** -6]))


@pytest.mark.parametrize("dtype,precision", smoke.BF16_MODES)
def test_rounded_plain_forward_is_the_plain_forward_to_the_bit(dtype, precision):
    field, _ = _case(dtype)
    _, Hd, _, I, _ = SHAPE
    got, acts = smoke.plain_fwd_rounded(field, Hd, I, precision, [])
    assert torch.equal(got, kernels._forward_reference(*field, Hd, I, precision))
    assert len(acts) == (len(field[0]) + 1 if precision == "bfloat16" else 0)


def test_forward_locator_names_a_rounding_taken_the_other_way():
    """In f32 storage under "bfloat16" (the output's tight gate), an
    activation near its midpoint rounded the other way moves its row past
    the gate; the locator names it."""
    field, _ = _case(torch.float32)
    _, Hd, _, I, _ = SHAPE
    plain, acts = smoke.plain_fwd_rounded(field, Hd, I, "bfloat16", [])
    planted = None
    for r in range(SHAPE[0]):
        for _, l, j in sorted(smoke.nearest_midpoint(acts, r))[:1]:
            got, _ = smoke.plain_fwd_rounded(field, Hd, I, "bfloat16", [(l, r, j)])
            if float(smoke.fwd_row_shares(got, plain, "bfloat16", True)[r]) > 1.0:
                planted = (l, r, j)
                break
        if planted:
            break
    else:
        pytest.fail("no row whose nearest rounding moves it past its gate")
    flips, located = smoke.bf16_rounding_flips("planted", field, Hd, I, "bfloat16",
                                               got, plain, True)
    assert flips == [planted]
    assert located[0]["row"] == planted[1] and located[0]["kind"] == "bf16 rounding"


def test_forward_locator_refuses_a_row_no_rounding_explains():
    field, _ = _case(torch.float32)
    _, Hd, _, I, _ = SHAPE
    plain, _ = smoke.plain_fwd_rounded(field, Hd, I, "bfloat16", [])
    got = plain.clone()
    got[9] *= 1.1   # row 9 off by 10%
    with pytest.raises(AssertionError, match="row 9 is past its gate"):
        smoke.bf16_rounding_flips("scaled", field, Hd, I, "bfloat16", got, plain, True)
