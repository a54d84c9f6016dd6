"""On the card: the port's spans and the profiler's device events share a
clock.  A sleeping kernel's end falls inside the span around the
``torch.cuda.synchronize()`` that waits for it.  Run there with

    python3 -m pytest port_bench/tests/test_port_bench_spans_card.py -q -s
"""

import pytest
import torch

CYCLES = 50_000_000          # ~25-35 ms at the H100's clocks


@pytest.mark.card
def test_a_kernels_end_falls_in_the_span_that_waits_for_it(card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from online_neural_cdes_tpu_torch.utils import profiling

    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            profiling.collect_spans() as records:
        torch.cuda._sleep(CYCLES)
        with profiling.unit("oncde.wait"):
            torch.cuda.synchronize(card)
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
    assert kernels
    end = max(e.start_ns() + e.duration_ns() for e in kernels)
    (wait,) = records
    print(f"kernel end to the span's end: {(wait.end_ns - end) / 1e3:.1f} us; "
          f"span start to the kernel end: {(end - wait.start_ns) / 1e6:.3f} ms "
          f"({torch.cuda.get_device_name(card)})")
    assert wait.start_ns <= end <= wait.end_ns
