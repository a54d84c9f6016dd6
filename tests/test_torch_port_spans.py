"""The port's spans (``utils/profiling.py``): off, they cost a flag check
and record nothing; on, a training step records its seven spans under
one unit, the reverse solve under the backward call from any thread,
without moving a bit of the step; they show in the operator's trace and
share the profiler's clock.  The self-time arithmetic of the benchmark's
reader (``port_bench/spans.py``) on a hand-made record."""

import json
import os
import sys
import threading

import pytest
import torch

from online_neural_cdes_tpu_torch import (
    NeuralCDE, hermite_cubic_coefficients_with_backward_differences,
    linear_interpolation_coeffs,
)
from online_neural_cdes_tpu_torch.ops import cdeint
from online_neural_cdes_tpu_torch.serving import OnlineNCDEStepper
from online_neural_cdes_tpu_torch.training.loop import make_train_step
from online_neural_cdes_tpu_torch.utils import profiling
from port_bench import spans as bench_spans

SEVEN = {"oncde.train.step", "oncde.train.backward", "oncde.train.optimizer",
         "oncde.model.forward", "oncde.spline.setup", "oncde.cdeint.scan",
         "oncde.cdeint.adjoint"}
B, L, C, S = 5, 7, 3, 2


def batch(interpolation, seed=0):
    """Static features, coefficients and 0/1 labels of B series with the
    time in channel 0 and a few values missing."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(B, L, C, generator=gen)
    x[..., 0] = torch.cumsum(torch.rand(B, L, generator=gen) + 0.1, dim=-1)
    x[1, 2, 1] = x[3, 4, 2] = float("nan")
    if interpolation == "rectilinear":
        coeffs = linear_interpolation_coeffs(x, rectilinear=0)
    else:
        coeffs = hermite_cubic_coefficients_with_backward_differences(x)
    labels = (torch.rand(B, L, generator=gen) < 0.3).to(torch.float32)
    return (torch.randn(B, S, generator=gen), coeffs), labels


def model_and_step(interpolation):
    torch.manual_seed(11)
    model = NeuralCDE(input_dim=C, hidden_dim=6, output_dim=1, static_dim=S,
                      hidden_hidden_dim=5, num_layers=2, interpolation=interpolation,
                      solver="rk4", adjoint=True, return_sequences=True, device="cpu")
    return model, make_train_step(model, loss="bce", lr=1e-2)


def test_spans_off_record_nothing():
    assert profiling.span("a") is profiling.span("b") is profiling.unit("c")
    with profiling.collect_spans() as records:
        pass
    model, step = model_and_step("rectilinear")
    inputs, labels = batch("rectilinear")
    step(inputs, labels, 1.0)
    with profiling.span("x"), profiling.unit("y"):
        pass
    assert records == [] and not profiling._on


@pytest.mark.parametrize("interpolation", ["rectilinear", "hermite"])
def test_spans_leave_the_step_bit_identical(interpolation):
    inputs, labels = batch(interpolation)
    runs = []
    for on in (False, True):
        model, step = model_and_step(interpolation)
        if on:
            with profiling.collect_spans() as records:
                loss = step(inputs, labels, 1.0)
            assert records
        else:
            loss = step(inputs, labels, 1.0)
        runs.append((loss, {n: p.grad.clone() for n, p in model.named_parameters()},
                     {n: p.detach().clone() for n, p in model.named_parameters()}))
    (loss0, grads0, weights0), (loss1, grads1, weights1) = runs
    assert torch.equal(loss0, loss1)
    for n in grads0:
        assert torch.equal(grads0[n], grads1[n]), n
        assert torch.equal(weights0[n], weights1[n]), n


def on_another_thread(backward):
    """``backward`` run on a thread of its own, as autograd's device thread
    runs it on a card."""

    def threaded(ctx, *grads):
        out = {}
        worker = threading.Thread(target=lambda: out.update(value=backward(ctx, *grads)))
        worker.start()
        worker.join(timeout=60)
        assert not worker.is_alive()
        return out["value"]

    return staticmethod(threaded)


@pytest.mark.parametrize("interpolation,threaded", [("rectilinear", False),
                                                    ("hermite", False),
                                                    ("rectilinear", True)])
def test_each_step_records_its_seven_spans(interpolation, threaded, monkeypatch):
    model, step = model_and_step(interpolation)
    function = (cdeint._FixedCDEAdjointPaired if interpolation == "rectilinear"
                else cdeint._FixedCDEAdjoint)
    if threaded:
        monkeypatch.setattr(function, "backward", on_another_thread(function.backward))
    inputs, labels = batch(interpolation)
    with profiling.collect_spans() as records:
        for _ in range(2):
            step(inputs, labels, 1.0)
    units = [i for i, s in enumerate(records) if s.unit_id == i]
    assert [records[i].name for i in units] == ["oncde.train.step"] * 2
    for u in units:
        mine = [s for s in records if s.unit_id == u]
        assert {s.name for s in mine} == SEVEN
        names = [s.name for s in mine]
        assert names.count("oncde.train.optimizer") == 2
        assert all(names.count(n) == 1 for n in SEVEN - {"oncde.train.optimizer"})
        assert all(s.end_ns is not None and s.start_ns <= s.end_ns for s in mine)
        adjoint = next(s for s in mine if s.name == "oncde.cdeint.adjoint")
        assert records[adjoint.parent].name == "oncde.train.backward"
        assert (adjoint.thread_id != records[u].thread_id) == threaded
        parents = {s.name: records[s.parent].name for s in mine if s.parent is not None}
        assert parents["oncde.cdeint.scan"] == "oncde.model.forward"
        assert parents["oncde.spline.setup"] == "oncde.model.forward"
        assert parents["oncde.model.forward"] == "oncde.train.step"
    assert len(records) == 2 * 8


def test_a_tick_is_a_unit_with_its_upload():
    model, _ = model_and_step("rectilinear")
    stepper = OnlineNCDEStepper(model, static=torch.randn(B, S).numpy(), device="cpu")
    rows = torch.randn(3, B, C).numpy()
    state = stepper.init(rows[0])
    with profiling.collect_spans() as records:
        for x in rows[1:]:
            state, _ = stepper.step(state, x)
    assert [(s.name, s.unit_id, s.parent) for s in records] == [
        ("oncde.serve.step", 0, None), ("oncde.serve.upload", 0, 0),
        ("oncde.serve.step", 2, None), ("oncde.serve.upload", 2, 2)]


def test_spans_from_many_threads_lose_no_record():
    """More threads than cores open nested spans inside one unit, with the
    interpreter switching threads as often as it can: every record is
    kept, closed, and parented on its own thread or, at a thread's top
    level, to the unit."""
    threads, depth, rounds = 2 * (os.cpu_count() or 4), 3, 50

    def work():
        for _ in range(rounds):
            with profiling.span("a"), profiling.span("b"), profiling.span("c"):
                pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.collect_spans() as records, profiling.unit("oncde.train.step"):
            workers = [threading.Thread(target=work) for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
            assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(switch)
    assert len(records) == 1 + threads * rounds * depth
    assert all(s.unit_id == 0 and s.end_ns is not None for s in records)
    for s in records[1:]:
        parent = records[s.parent]
        want = {"a": "oncde.train.step", "b": "a", "c": "b"}[s.name]
        assert parent.name == want
        assert want == "oncde.train.step" or parent.thread_id == s.thread_id


def test_self_time_counts_a_child_on_another_thread():
    """A unit of 100 ns: its backward 20-90 on the unit's thread, whose
    adjoint child 30-80 ran on thread 2, and an optimizer span 90-98."""
    Span = profiling.Span
    records = [Span("oncde.train.step", 0, None, 1, 0, 100),
               Span("oncde.train.backward", 0, 0, 1, 20, 90),
               Span("oncde.cdeint.adjoint", 0, 1, 2, 30, 80),
               Span("oncde.train.optimizer", 0, 0, 1, 90, 98)]
    assert bench_spans.self_ns(records) == [100 - 70 - 8, 70 - 50, 50, 8]
    seg = bench_spans.SpannedSegment(device=[("k", 0, 100)], spans=records)
    assert bench_spans.span_self_ms(seg, "adjoint") == 50 / 1e6
    assert bench_spans.span_self_ms(seg, "loop") == (22 + 20) / 1e6
    assert sum(bench_spans.span_self_ms(seg, g)
               for g in bench_spans.TRAIN_GROUPS) == 100 / 1e6


def test_a_span_is_named_in_the_operators_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as log_dir:
        with profiling.unit("oncde.train.step"), profiling.span("oncde.cdeint.scan"):
            torch.ones(4) + 1
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"oncde.train.step", "oncde.cdeint.scan"} <= names
    assert not profiling._on and not profiling._mirror


def test_a_span_brackets_the_profiler_events_inside_it():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            profiling.collect_spans() as records:
        with profiling.unit("oncde.serve.step"):
            torch.ones(256, 256) @ torch.ones(256, 256)
    (record,) = records
    (mm,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert record.start_ns <= mm.start_ns() <= mm.start_ns() + mm.duration_ns() \
        <= record.end_ns
