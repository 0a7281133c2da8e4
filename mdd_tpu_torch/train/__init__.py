"""The trainer, the plateau learning-rate machine and checkpoints."""

from mdd_tpu_torch.train.plateau import PlateauScheduler, PlateauAction
from mdd_tpu_torch.train.loop import Trainer
