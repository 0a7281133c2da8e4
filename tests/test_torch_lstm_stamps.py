"""The LSTM stamp tool (mdd_tpu_torch/ops/lstm_stamps.py) where no card is
needed: its shapes, the bindings it makes of another tree's scan kernels
(`scan_bindings`, which chip_smoke.py's phase kernel-scan times its turns
against the parent tree with) and its refusal without a card.  Its
timings need the card (`python -m mdd_tpu_torch.ops.lstm_stamps`, and
chip_smoke.py)."""

import sys
from pathlib import Path

import pytest
import torch

from mdd_tpu_torch.ops import build, lstm_cuda, lstm_stamps

# the entry points of a tree that built its scan kernels as instances of
# lstm_fwd.cu / lstm_bwd.cu (five backward buffers, no dW_hh step scratch)
INLINE_FWD = """
int mdd_lstm_scan_fwd(const void* x_proj, const void* w_hh, void* hs,
                      void* cs, unsigned* barrier, int n_steps, int batch,
                      int hidden, int dtype, void* stream) {
  return 0;
}
"""
INLINE_BWD = """
int mdd_lstm_scan_bwd(const void* x_proj, const void* w_hh, const void* hs,
                      const void* cs, const float* dhs, void* dx_proj,
                      void* dw_hh, float* z, float* dg, float* exchange,
                      unsigned* barrier, int n_steps, int batch, int hidden,
                      int dtype, int parts, void* stream) {
  return 0;
}
"""


def _tree(root: Path, files: dict) -> Path:
    csrc = root / "mdd_tpu_torch" / "csrc"
    csrc.mkdir(parents=True)
    for name, text in files.items():
        (csrc / name).write_text(text)
    return root


@pytest.mark.parametrize("text,shape", [
    ("64", (64, 48)), ("1", (1, 48)), ("1x7", (1, 7)),
    ("512x48", (512, 48))])
def test_shapes_are_a_batch_or_a_batch_by_steps(text, shape):
    assert lstm_stamps.parse_shape(text, 48) == shape


def test_this_trees_scan_kernels_bind_as_the_package_binds_them():
    """This tree taken as the parent: csrc/lstm_scan.cu's entry points
    under the package's own binding classes, their argument lists those of
    the C functions (the stream last); nothing is built on the CPU."""
    tree = build.CSRC.parent.parent
    fwd, bwd = lstm_stamps.scan_bindings(tree)
    assert type(fwd) is lstm_cuda.LstmScanFwdKernel
    assert type(bwd) is lstm_cuda.LstmScanBwdKernel
    source = build.CSRC / "lstm_scan.cu"
    assert fwd.source == bwd.source == str(source.resolve())
    text = source.read_text()
    for kernel in (fwd, bwd):
        assert lstm_stamps.entry_params(text, kernel.entry) == len(
            kernel.argtypes) + 1
        assert kernel._lib is None and kernel.launches == 0
    # bindings of their own: the package's counters are not theirs
    assert fwd is not lstm_cuda.lstm_scan_fwd_kernel
    assert bwd is not lstm_cuda.lstm_scan_bwd_kernel


def test_a_tree_with_the_scan_kernels_in_the_lstm_sources_binds_them_so(
        tmp_path):
    """A tree without lstm_scan.cu whose lstm_fwd.cu / lstm_bwd.cu define
    the scan entry points: bound with that layout's argument lists (the
    backward's five buffers)."""
    tree = _tree(tmp_path, {"lstm_fwd.cu": INLINE_FWD,
                            "lstm_bwd.cu": INLINE_BWD})
    fwd, bwd = lstm_stamps.scan_bindings(tree)
    assert type(fwd) is lstm_stamps._InlineScanFwd
    assert type(bwd) is lstm_stamps._InlineScanBwd
    assert fwd.source.endswith("lstm_fwd.cu")
    assert bwd.source.endswith("lstm_bwd.cu")
    assert len(fwd.argtypes) + 1 == lstm_stamps.entry_params(
        INLINE_FWD, "mdd_lstm_scan_fwd")
    assert len(bwd.argtypes) + 1 == lstm_stamps.entry_params(
        INLINE_BWD, "mdd_lstm_scan_bwd") == 17


@pytest.mark.parametrize("files", [
    {},
    {"lstm_fwd.cu": "int mdd_lstm_fwd(void* stream) { return 0; }"},
    {"lstm_fwd.cu": INLINE_FWD},
    {"lstm_scan.cu": INLINE_FWD + INLINE_BWD},
    {"lstm_scan.cu": (build.CSRC / "lstm_scan.cu").read_text().replace(
        "int dtype, void* stream", "int dtype, int extra, void* stream")},
], ids=["empty", "no-scan-entry", "no-backward", "scan-file-old-args",
        "scan-file-other-args"])
def test_a_tree_without_callable_scan_kernels_gets_no_bindings(tmp_path,
                                                               files):
    """No entry points, only one of them, or argument lists that no
    binding here takes: None, and the caller leaves the turns out."""
    assert lstm_stamps.scan_bindings(_tree(tmp_path, files)) is None


def test_the_tool_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["lstm_stamps", "--kernel", "scan-bwd",
                                      "--parent", "."])
    with pytest.raises(SystemExit, match="no CUDA device"):
        lstm_stamps.main()
