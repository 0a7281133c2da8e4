"""Configuration."""

from mdd_tpu_torch.utils.config import Config, load_config
