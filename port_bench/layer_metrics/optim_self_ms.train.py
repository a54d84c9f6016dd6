"""Host milliseconds a traced training step spent in ``zero_grad``, the
learning rates and Adam's update (``oncde.train.optimizer``), less their
inner spans' time: the ``spanned`` segment's ``optim`` group
(``port_bench/spans.py``)."""

from port_bench import spans


def read(r):
    return spans.span_self_ms(getattr(r, "spanned", None), "optim")
