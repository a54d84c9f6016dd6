"""The plain reference against the port's plain CPU path, at a tiny size in
float64: the same weights and raw series give the same losses, first
gradients, Adam steps and streamed scores (the test may import both; the
reference itself imports nothing of the port)."""

import pytest
import torch

from online_neural_cdes_tpu_torch import (
    NeuralCDE, OnlineNCDEStepper, hermite_cubic_coefficients_with_backward_differences,
    linear_interpolation_coeffs)
from online_neural_cdes_tpu_torch.training.loop import make_train_step
from port_bench import traffic
from port_bench.reference import ncde as reference

C, H, S = 21, 32, 10
MIX = {"series": 6, "length": 9, "pool": 3, "gap_mean": 1.0, "nan_share": 0.3,
       "label_share": 0.3}


def model_and_batches(interpolation, seed=123):
    gen = torch.Generator().manual_seed(seed)
    b = traffic.generate(MIX, C, S, gen, "cpu")
    model = NeuralCDE(input_dim=C, hidden_dim=H, output_dim=1, static_dim=S,
                      hidden_hidden_dim=H, num_layers=2, interpolation=interpolation,
                      solver="rk4", return_sequences=True, device="cpu", dtype=torch.float64,
                      generator=gen)
    cast = [(b.x[k].double(), b.static[k].double(), b.labels[k].double()) for k in range(3)]
    return model, cast


@pytest.mark.parametrize("interpolation", ["rectilinear", "hermite"])
def test_three_adam_steps(interpolation):
    model, batches = model_and_batches(interpolation)
    p0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    build = (lambda x: linear_interpolation_coeffs(x, rectilinear=0)) \
        if interpolation == "rectilinear" else hermite_cubic_coefficients_with_backward_differences
    step = make_train_step(model, loss="bce", lr=5e-4)
    losses = []
    for k, (x, static, labels) in enumerate(batches):
        losses.append(step((static, build(x)), labels, 1.0))
        if k == 0:
            grad1 = {n: step.optimizer.state[p]["exp_avg"] / 0.1
                     for n, p in model.named_parameters()}
    want_losses, want_grad1, want_after = reference.train_steps(p0, interpolation, batches, 5e-4)
    torch.testing.assert_close(torch.stack(losses), want_losses, rtol=1e-12, atol=0)
    for name, p in model.named_parameters():
        torch.testing.assert_close(grad1[name], want_grad1[name], rtol=1e-9, atol=1e-12)
        torch.testing.assert_close(p.detach(), want_after[name], rtol=1e-9, atol=1e-12)


def test_one_streamed_cycle():
    model, batches = model_and_batches("rectilinear")
    x, static, _ = batches[0]
    bank = x.transpose(0, 1)
    stepper = OnlineNCDEStepper(model, static=static, device="cpu")
    state, got = stepper.init(bank[0]), []
    for k in range(1, bank.shape[0]):
        state, y = stepper.step(state, bank[k])
        got.append(y[:, 0])
    want = reference.tick_cycle({k: v.detach() for k, v in model.state_dict().items()},
                                static, bank)
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-10, atol=1e-12)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12, -3.0 - 2.0 ** -10])
    got = reference.tf32_round(x)
    # Ten mantissa bits: a tie rounds away from zero; -3 - 2^-10 is half of
    # -3's step (2^-9) below it, so it rounds away too.
    assert got.tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -3.0 - 2.0 ** -9]
