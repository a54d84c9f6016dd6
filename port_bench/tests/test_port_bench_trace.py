"""The pairing of the field kernels on the device with the field ops on the
host, which the rooflines read: a lost pairing fails the run."""

import pytest

from port_bench import trace

FWD = [("trunk_forward<4>", 0, 10), ("head_forward<4>", 10, 20)]
BWD = [("trunk_forward<4>", 40, 10), ("head_backward<4>", 50, 30),
       ("trunk_backward<4>", 80, 5), ("weight_grad<4>", 85, 5)]


def op(batch, channels):
    return (trace.FORWARD_OP, 0, 1, [[batch, 128], [batch, channels]])


def test_paired_calls_carry_their_shapes():
    seg = trace.Segment(device=FWD + BWD, host=[op(64, 21)])
    assert trace.field_calls(seg) == [["forward", 64, 21, 30e-9],
                                      ["backward", 64, 21, 50e-9]]


def test_no_field_kernel_reads_nothing():
    seg = trace.Segment(device=[("add_kernel", 0, 5)], host=[op(64, 21)])
    assert trace.field_calls(seg) == []


@pytest.mark.parametrize("device,host", [(FWD, []), (FWD + FWD, [op(64, 21)]),
                                         (FWD, [op(64, 21), op(64, 1)]), (BWD, [])])
def test_unpaired_kernels_raise(device, host):
    with pytest.raises(RuntimeError, match="unpaired"):
        trace.field_calls(trace.Segment(device=device, host=host))
