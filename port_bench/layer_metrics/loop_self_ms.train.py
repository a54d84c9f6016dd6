"""Host milliseconds a traced training step spent in the step, its backward
call and the model's forward outside their inner spans
(``oncde.train.step``, ``oncde.train.backward``,
``oncde.model.forward``), less their inner spans' time: the ``spanned``
segment's ``loop`` group (``port_bench/spans.py``)."""

from port_bench import spans


def read(r):
    return spans.span_self_ms(getattr(r, "spanned", None), "loop")
