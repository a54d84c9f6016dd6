import pytest

import chip_smoke
from port_bench import costs

CFG = {"input_dim": 21, "hidden_dim": 128, "hidden_hidden_dim": 128, "num_layers": 2,
       "interpolation": "rectilinear"}


def test_field_costs_by_hand():
    # B=2, H=3, HH=4, I=5, two trunk layers: the products z W1 (3x4), u W2
    # (4x4), u W_o (4x15) and the dX sum (5x3), two operations each.
    assert costs.field_cost(2, 3, 4, 5, 2) == (2 * 2 * (12 + 16 + 60 + 15),
                                                4 * (2 * 3 + 2 * 5 + 111 + 2 * 3))
    # The VJP: three times each product, no dX sum; z, dX, g and the
    # weights read, dz, ddX and the weight grads written.
    assert costs.field_bwd_cost(2, 3, 4, 5, 2) == (3 * 2 * 2 * (12 + 16 + 60),
                                                    4 * (2 * 2 * 3 + 2 * 5 + 111 + 2 * 3
                                                         + 2 * 5 + 111))
    assert costs.rk4_cost(2, 3, 4, 5, 2, K=3) == (3 * 4 * 412, 3 * 532)


@pytest.mark.parametrize("shape", [(16384, 128, 128, 21, 2), (16384, 128, 128, 1, 2),
                                   (32768, 128, 128, 21, 2), (5, 96, 196, 21, 3)])
def test_frozen_copies_match_the_smoke_run(shape):
    assert costs.field_cost(*shape) == chip_smoke.field_cost(*shape)
    assert costs.field_bwd_cost(*shape) == chip_smoke.field_bwd_cost(*shape)
    assert costs.rk4_cost(*shape, K=2) == chip_smoke.rk4_cost(*shape, K=2)


def test_schedules():
    f21, b21 = costs.field_cost(8, 128, 128, 21, 2)[0], costs.field_bwd_cost(8, 128, 128, 21, 2)[0]
    f1, b1 = costs.field_cost(8, 128, 128, 1, 2)[0], costs.field_bwd_cost(8, 128, 128, 1, 2)[0]
    assert costs.train_step_flops(CFG, 8, 10) == 4 * 9 * (f21 + b21 + f1 + b1)
    hermite = dict(CFG, interpolation="hermite")
    assert costs.train_step_flops(hermite, 8, 10) == 4 * 9 * (f21 + b21)
    assert costs.tick_flops(CFG, 8) == 4 * (f1 + f21)


def test_bound_prices_tf32_and_hbm():
    assert costs.bound_s(495e12, 0) == pytest.approx(1.0)
    assert costs.bound_s(0, 3.35e12) == pytest.approx(1.0)
    flops, nbytes = costs.field_cost(16384, 128, 128, 21, 2)
    assert costs.call_bound_s("forward", 16384, CFG, 21) == costs.bound_s(flops, nbytes)
