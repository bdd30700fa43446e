from code_intelligence_tpu_torch.training.callbacks import (
    Callback,
    CSVLogger,
    EarlyStopping,
    History,
    JSONLLogger,
    ReduceLROnPlateau,
    SaveBest,
)
from code_intelligence_tpu_torch.training.loop import (
    LMTrainer,
    TrainConfig,
    TrainState,
)
from code_intelligence_tpu_torch.training.schedules import (
    one_cycle_lr,
    one_cycle_momentum,
)

__all__ = [
    "Callback",
    "CSVLogger",
    "EarlyStopping",
    "History",
    "JSONLLogger",
    "LMTrainer",
    "ReduceLROnPlateau",
    "SaveBest",
    "TrainConfig",
    "TrainState",
    "one_cycle_lr",
    "one_cycle_momentum",
]
