"""Device idle milliseconds a traced training step whose gaps fell, at
their middle, in ``zero_grad``, the learning rates and Adam's update
(``oncde.train.optimizer``): the ``spanned`` segment's ``optim`` group
(``port_bench/spans.py``)."""

from port_bench import spans


def read(r):
    return spans.span_idle_ms(getattr(r, "spanned", None), "optim")
