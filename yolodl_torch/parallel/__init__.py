"""Parallelism, one process per rank: data-parallel training and
multi-device inference (``mesh.py``, ``dp.py``), ZeRO-1 (``zero.py``),
tensor parallelism and TP × ZeRO-1 on a 2-D data × model mesh (``tp.py``),
GPipe pipeline parallelism over ``n_stages × dp`` ranks (``pipeline.py``),
and spatial parallelism, the image height cut over a ``data × space`` mesh
(``spatial.py``, ``spatial_model.py``; imported from their modules, as the
reference's are, and not exported here)."""

from .mesh import (  # noqa: F401
    DataMesh,
    ModelReplicas,
    PPMesh,
    TPMesh,
    init_process_group,
    make_mesh,
    make_pp_mesh,
    make_tp_mesh,
    replica_devices,
)
from .dp import (  # noqa: F401
    make_dp_train_step, replicate_state, shard_batch, shard_batch_multiprocess,
)
from .zero import make_zero_train_step, place_zero_state, zero_init  # noqa: F401
from .pipeline import (  # noqa: F401
    PipelineModel, PipelineTrainState, PipelineTrainStep, plan_stages,
)
from .tp import (  # noqa: F401
    gather_train_state,
    make_tp_infer,
    make_tp_train_step,
    make_tp_zero_train_step,
    place_tp_state,
    place_tp_zero_state,
    shard_batch_tp,
    tp_shardings,
    tp_zero_shardings,
)
