from repro_torch.training.optim import (AdamWConfig, adamw_init, adamw_update,
                                        cosine_schedule, wsd_schedule)
from repro_torch.training.train import TrainConfig, Trainer

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "wsd_schedule", "TrainConfig", "Trainer"]
