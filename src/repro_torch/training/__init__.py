from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import SyntheticLMData
from repro_torch.training.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.training.train import TrainState, make_train_step

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "make_train_step",
           "TrainState", "SyntheticLMData", "CheckpointManager"]
