"""The port's one float32 rule (utils/precision.strict_float32): float32 on
a CUDA device turns TF32 off for cuBLAS and cuDNN, anything else leaves
the flags alone; Trainer and EvalSession both reach it, and no other file
of the port sets the flags.  A torch.device("cuda") needs no card."""

import pathlib
import re

import pytest
import torch

from mdd_tpu_torch.data.vocab import Vocab
from mdd_tpu_torch.evals import evaluate
from mdd_tpu_torch.models.ctc_model import CTCAttentionModel, ModelConfig
from mdd_tpu_torch.train import loop
from mdd_tpu_torch.utils import precision

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = ModelConfig(input_dim=24, num_class=8, conv_channels=(4, 4),
                   rnn_hidden_size=8, rnn_layers=1, text_embed_size=8,
                   text_vocab_size=9)


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.fixture
def tf32_on():
    """Both flags on for the test, and as they were afterwards."""
    saved = _flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("device", [torch.device("cuda"), "cuda", "cuda:1"])
def test_float32_on_cuda_turns_both_flags_off(tf32_on, device):
    precision.strict_float32(device, "float32")
    assert _flags() == (False, False)
    assert precision.tf32_flags() == ("cuBLAS allow_tf32=False, "
                                      "cuDNN allow_tf32=False")


@pytest.mark.parametrize("device,dtype", [
    (torch.device("cuda"), "bfloat16"), (torch.device("cpu"), "float32"),
    ("cpu", "bfloat16")])
def test_other_dtypes_and_the_cpu_leave_the_flags_alone(tf32_on, device,
                                                        dtype):
    precision.strict_float32(device, dtype)
    assert _flags() == (True, True)


@pytest.fixture
def recorder(monkeypatch):
    calls = []
    record = lambda device, dtype: calls.append((torch.device(device), dtype))
    monkeypatch.setattr(loop, "strict_float32", record)
    monkeypatch.setattr(evaluate, "strict_float32", record)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainer_applies_the_rule_before_it_builds_the_model(
        recorder, monkeypatch, dtype):
    built = []
    monkeypatch.setattr(loop, "CTCAttentionModel",
                        lambda cfg: built.append(list(recorder))
                        or CTCAttentionModel(cfg))
    cfg = ModelConfig(**{**TINY.__dict__, "compute_dtype": dtype})
    loop.Trainer(cfg, device="cpu")
    assert recorder == [(torch.device("cpu"), dtype)]
    assert built == [recorder]          # called before the model was built


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_session_applies_the_rule(recorder, dtype):
    cfg = ModelConfig(**{**TINY.__dict__, "compute_dtype": dtype})
    model = CTCAttentionModel(cfg)
    model.init_parameters(torch.Generator().manual_seed(0))
    vocab = Vocab([f"p{i}" for i in range(6)])
    evaluate.EvalSession(cfg, model.state_dict(), vocab, device="cpu")
    assert recorder == [(torch.device("cpu"), dtype)]


def test_fit_logs_the_flags_at_start(tmp_path):
    lines = []
    trainer = loop.Trainer(TINY, device="cpu")
    trainer.fit([], [], num_epochs=0, log=lines.append)
    assert lines[0] == ("compute_dtype float32 on cpu: "
                        + precision.tf32_flags())


def test_no_other_file_of_the_port_sets_the_flags():
    """The rule lives in one place: chip_smoke.py and every other port
    module reach it through strict_float32."""
    setter = re.compile(r"backends\.(cuda\.matmul|cudnn)\.allow_tf32\s*=(?!=)")
    files = sorted((ROOT / "mdd_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    hits = [str(p.relative_to(ROOT)) for p in files
            if setter.search(p.read_text())]
    assert hits == ["mdd_tpu_torch/utils/precision.py"]
    assert setter.search("torch.backends.cudnn.allow_tf32 = False")
    assert not setter.search('"cuDNN allow_tf32=False"')
