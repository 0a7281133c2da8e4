"""The CTC-attention model."""

from mdd_tpu_torch.models.ctc_model import CTCAttentionModel, ModelConfig
