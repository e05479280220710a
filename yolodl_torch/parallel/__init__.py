"""Parallelism: data-parallel training over ranks and multi-device inference
(``mesh.py``, ``dp.py``), and the pipeline stage planner (``pipeline.py``).
Tensor parallelism and ZeRO-1 are ROADMAP A14b, the pipeline model A14c."""

from .mesh import (  # noqa: F401
    DataMesh,
    ModelReplicas,
    init_process_group,
    make_mesh,
    replica_devices,
)
from .dp import (  # noqa: F401
    make_dp_train_step, replicate_state, shard_batch, shard_batch_multiprocess,
)
from .pipeline import plan_stages  # noqa: F401
