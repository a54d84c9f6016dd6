"""Device idle milliseconds a traced training step whose gaps fell, at
their middle, in the step, its backward call and the model's forward
outside their inner spans (``oncde.train.step``,
``oncde.train.backward``, ``oncde.model.forward``) or under no span: the
``spanned`` segment's ``loop`` group (``port_bench/spans.py``)."""

from port_bench import spans


def read(r):
    return spans.span_idle_ms(getattr(r, "spanned", None), "loop")
