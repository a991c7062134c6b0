"""The device mesh (``mesh.py``: data x model), the column-cut layers of its
model axis (``tensor.py``) and the sweep over it (``sweep.py``)."""

from vqattack_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    make_mesh,
    shard_batch,
    shard_params,
)
from vqattack_tpu_torch.parallel.sweep import batched_attack_step, make_sweep_runner  # noqa: F401
