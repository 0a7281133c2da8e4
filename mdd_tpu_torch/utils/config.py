"""YAML config system (counterpart of mdd_tpu/utils/config.py).

Loads the reference's ctc_config.yaml schema (train_ctc.py:107-115) into a
typed dataclass, field for field as mdd_tpu does, so one YAML file
configures both packages.  The reference passes CNN shape hyper-parameters as python
literals through eval() (train_ctc.py:147-151); we parse them with
ast.literal_eval — same accepted configs, no code execution.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Any

import yaml


def _literal(v):
    if isinstance(v, str):
        try:
            return ast.literal_eval(v)
        except (ValueError, SyntaxError):
            return v
    return v


@dataclasses.dataclass
class Config:
    # experiment
    exp_name: str = "default"
    checkpoint_dir: str = "checkpoints/"
    seed: int = 1234

    # data
    vocab_file: str = ""
    train_scp_path: str = ""
    train_lab_path: str = ""
    train_trans_path: str = ""
    valid_scp_path: str = ""
    valid_lab_path: str = ""
    valid_trans_path: str = ""
    test_scp_path: str = ""
    test_lab_path: str = ""
    test_trans_path: str = ""
    test_wrd_path: str = ""
    left_ctx: int = 0
    right_ctx: int = 2
    n_skip_frame: int = 2
    n_downsample: int = 2
    num_workers: int = 0
    shuffle_train: bool = True
    feature_dim: int = 81
    mel: bool = False
    feature_type: str = "fbank"

    # model
    rnn_input_size: int = 243
    rnn_hidden_size: int = 384
    rnn_layers: int = 4
    rnn_type: str = "nn.LSTM"
    bidirectional: bool = True
    batch_norm: bool = True
    drop_out: float = 0.2
    add_cnn: bool = True
    layers: int = 2
    channel: Any = ((1, 32), (32, 32))
    kernel_size: Any = ((3, 3), (3, 3))
    stride: Any = ((1, 2), (2, 2))
    padding: Any = ((1, 1), (1, 1))
    pooling: Any = None
    activation_function: str = "relu"
    output_class_dim: int = 0
    use_text_attention: bool = True
    compute_dtype: str = "float32"
    use_pallas_lstm: bool = False

    # training
    use_gpu: bool = True          # accepted for compat; the CLI's --device decides
    init_lr: float = 0.001
    num_epoches: int = 500
    end_adjust_acc: float = 2.0
    lr_decay: float = 0.5
    batch_size: int = 64
    weight_decay: float = 0.0005
    verbose_step: int = 50
    max_adjust_times: int = 8
    plateau_patience: int = 10
    # training and data-pipeline fields: read by the trainer and the
    # loaders (`train`; num_buckets is read by neither package's code)
    checkpoint_every: int = 5
    augment_mode: int = 2
    mutation_prob: float = 0.1
    num_buckets: int = 8
    time_quantum: int = 64      # pad batch time axis to a multiple of this
    label_quantum: int = 16     # pad label axes to a multiple of this
    device_frontend: bool = False
    wire_dtype: str = ""        # "" = float32; "bfloat16"
    device_cache: bool = False      # corpus on the device (data/device_cache)
    # the streaming loader's global batch schedule even in one process (it
    # is the default with several); for holding one process to several
    global_schedule: bool = False

    # decoding
    decode_type: str = "Beam"     # reference quirk: anything != 'Greedy' -> Beam
    beam_width: int = 10
    lm_alpha: float = 0.0
    lm_path: str = ""

    # parallelism: mdd_tpu's data-parallel mesh width: 0 = every local
    # card, N = the first N (a rank a card, parallel/launch.py); on the
    # CPU 0 = one process, N = N ranks
    data_parallel: int = 0

    def model_config(self, num_class: int):
        from mdd_tpu_torch.models.ctc_model import ModelConfig

        channels = tuple(c[1] for c in self.channel)
        input_dim = self.feature_dim * (self.left_ctx + 1 + self.right_ctx)
        return ModelConfig(
            input_dim=input_dim,
            num_class=num_class,
            conv_channels=channels,
            conv_kernels=tuple(tuple(k) for k in self.kernel_size),
            conv_strides=tuple(tuple(s) for s in self.stride),
            conv_padding=tuple(tuple(p) for p in self.padding),
            rnn_hidden_size=self.rnn_hidden_size,
            rnn_layers=self.rnn_layers,
            use_text_attention=self.use_text_attention,
            text_vocab_size=max(45, num_class + 2),
            dropout=self.drop_out,
            compute_dtype=self.compute_dtype,
            use_pallas_lstm=self.use_pallas_lstm,
        )


def load_config(path: str) -> Config:
    with open(path, "r", encoding="utf-8") as f:
        raw = yaml.safe_load(f) or {}
    cfg = Config()
    literal_fields = {"channel", "kernel_size", "stride", "padding", "pooling"}
    for k, v in raw.items():
        if k in literal_fields:
            v = _literal(v)
        if hasattr(cfg, k):
            setattr(cfg, k, v)
    if cfg.wire_dtype and not cfg.device_frontend:
        # the wire dtype only takes effect on the device-frontend path
        # (host-spliced loaders always ship float32); silently ignoring
        # it would hide a config mistake
        raise ValueError(
            "wire_dtype=%r requires device_frontend: true — the bf16 wire "
            "format is only consumed by the on-device splice/skip path"
            % cfg.wire_dtype)
    if cfg.device_cache and not cfg.device_frontend:
        raise ValueError(
            "device_cache: true requires device_frontend: true — the cache "
            "stores raw features and relies on on-device splice/skip")
    return cfg


def check_distributed_width(cfg: Config, process_count: int) -> None:
    """Refuse a data-parallel width that a torchrun run (`--distributed`)
    does not have, instead of training on another: there every rank is
    one of mdd_tpu's processes, one card of the mesh with `batch_size`
    rows of its own, so `data_parallel` is 0 or the rank count."""
    if cfg.data_parallel not in (0, process_count):
        raise ValueError(
            f"data_parallel: {cfg.data_parallel} but this --distributed run "
            f"has {process_count} rank(s): under torchrun every rank is one "
            "card of the mesh and batch_size counts its own rows, so "
            "data_parallel is 0 or the rank count; without --distributed "
            "(and torchrun) `train` itself starts data_parallel ranks on "
            "this host's cards, which share one batch of batch_size rows")
