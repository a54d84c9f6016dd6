"""Data parallelism and seed ensembles over ``torch.distributed``
(``mesh.py``, ``ensemble.py``).

The JAX package's third module here, ``parallel/sequence.py`` (the
time-pipelined solve over a ``seq`` axis with its reverse-schedule
adjoint), is ROADMAP item 18b: its entry points raise, naming it.
"""

from online_neural_cdes_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    replicate,
    shard_batch,
)


def _sequence_not_ported(name: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"parallel.{name} is not ported yet (ROADMAP item 18b: parallel/sequence.py, "
            "the time-pipelined solve over a seq axis and its reverse-schedule adjoint)")

    refuse.__name__ = name
    return refuse


make_sequence_mesh = _sequence_not_ported("make_sequence_mesh")
ncde_apply_pipelined = _sequence_not_ported("ncde_apply_pipelined")
pipelined_cde_solve = _sequence_not_ported("pipelined_cde_solve")
