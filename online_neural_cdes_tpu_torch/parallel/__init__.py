"""Data parallelism, seed ensembles and the time-pipelined solve over
``torch.distributed`` (``mesh.py``, ``ensemble.py``, ``sequence.py``).
"""

from online_neural_cdes_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    replicate,
    shard_batch,
)
from online_neural_cdes_tpu_torch.parallel.sequence import (  # noqa: F401
    PipelinedNCDE,
    make_sequence_mesh,
    ncde_apply_pipelined,
    pipelined_cde_solve,
)
