from .ema import ema_init, ema_update  # noqa: F401
from .loop import (  # noqa: F401
    TrainConfig,
    TrainState,
    collect_step_metrics,
    make_batch_grads,
    make_multi_step,
    make_optimizer,
    make_train_step,
    param_maxima,
    train_init,
)
from .lr_schedule import LrScheduleConfig, lr_at_step, make_schedule_fn  # noqa: F401
