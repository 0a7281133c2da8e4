"""The frame-stamp tool of the beam, CTC and WER kernels
(mdd_tpu_torch/ops/frame_stamps.py) where no card is needed: its shapes,
the bindings it makes (stamped, skeleton and another tree's kernel, each
its own library), the stamp and skeleton builds that its flags select in
the sources, and its refusal without a card; and the WER wrapper's one
launch a call (no zeroed counts).  Its timings need the card (`python -m
mdd_tpu_torch.ops.frame_stamps`, and chip_smoke.py)."""

import sys

import pytest
import torch

from mdd_tpu_torch.ops import (beam_cuda, build, ctc_cuda, frame_stamps,
                               wer_cuda)

# the entry point of a gradient kernel that takes no weights scratch (the
# one that summed the classes on its frame chain)
SCRATCHLESS_ENTRY = """
int mdd_ctc_beta_grad(const float* lp, long long lp_st, long long lp_sb,
                      const long long* input_lengths, const long long* labels,
                      long long lab_sb, long long lab_sl,
                      const long long* label_lengths, int T, int B, int C,
                      int L, long long blank, const float* alphas,
                      const float* nll, const float* g, float* grad,
                      long long gr_st, long long gr_sb, void* stream) {
  return 0;
}
"""


def _params(source: str, entry: str) -> int:
    return source.split(f"int {entry}(")[1].split(")")[0].count(",") + 1


@pytest.mark.parametrize("text,shape", [("64", (64, 110)), ("1", (1, 110)),
                                        ("512x80", (512, 80))])
def test_shapes_are_a_batch_or_a_batch_by_frames(text, shape):
    assert frame_stamps.parse_shape(text, 110) == shape


@pytest.mark.parametrize("name", sorted(frame_stamps.KERNELS))
def test_stamped_and_skeleton_builds_are_libraries_of_their_own(name):
    source, cls, prefix, _ = frame_stamps.KERNELS[name]
    flags = {"normal": (), "stamps": (f"-D{prefix}_STAMPS",
                                      "-DMDD_STAMP_THREAD=32"),
             "skeleton": (f"-D{prefix}_SKELETON",)}
    paths = set()
    for extra in flags.values():
        kernel = frame_stamps.binding(name, None, extra)
        assert type(kernel) is cls and kernel.extra_flags == extra
        assert kernel.source == source and kernel.launches == 0
        paths.add(build.library_path(source, extra))
    assert len(paths) == 3


@pytest.mark.parametrize("name", sorted(frame_stamps.KERNELS))
def test_the_sources_hold_the_stamp_and_skeleton_builds(name):
    """The flags the tool passes select code in the kernel's source: the
    stamp counters and their two entry points, the skeleton's frame
    loop."""
    source, _, prefix, entry = frame_stamps.KERNELS[name]
    text = (build.CSRC / source).read_text()
    stamped = text.split(f"#ifdef {prefix}_STAMPS")
    assert len(stamped) == 3   # the counters, and the entry points
    assert f"const char* {entry}_stamp_names()" in stamped[2]
    assert f"int {entry}_read_stamps(long long* out, int n)" in stamped[2]
    assert f"{prefix}_SKELETON" in text and "MDD_STAMP_THREAD" in text


def test_the_kernels_argument_lists_match_their_entry_points():
    """A ctypes binding's argument list is the C entry point's, the stream
    last (no compiler here to check it)."""
    for source, kernel, entry in (
            ("ctc_loss.cu", ctc_cuda.CtcBetaGradKernel, "mdd_ctc_beta_grad"),
            ("ctc_loss.cu", ctc_cuda.CtcAlphaKernel, "mdd_ctc_alpha"),
            ("ctc_beam.cu", beam_cuda.CtcBeamKernel, "mdd_ctc_beam"),
            ("wer.cu", wer_cuda.GreedyWerKernel, "mdd_greedy_wer")):
        text = (build.CSRC / source).read_text()
        assert len(kernel.argtypes) + 1 == _params(text, entry)


def test_another_trees_gradient_kernel_is_bound_by_its_own_signature(
        tmp_path):
    """A source whose entry point takes no weights scratch gets the
    argument list without it; this tree's source keeps the package's."""
    old = tmp_path / "ctc_loss.cu"
    old.write_text(SCRATCHLESS_ENTRY)
    kernel = frame_stamps.binding("beta_grad", str(old))
    assert type(kernel) is frame_stamps._ParentBetaGrad
    assert kernel.source == str(old.resolve())
    assert len(kernel.argtypes) + 1 == _params(SCRATCHLESS_ENTRY,
                                               "mdd_ctc_beta_grad")
    here = frame_stamps.binding("beta_grad",
                                str(build.CSRC / "ctc_loss.cu"))
    assert type(here) is ctc_cuda.CtcBetaGradKernel
    tree = tmp_path / "tree"
    assert frame_stamps.parent_source("beam", tree) == str(
        tree / "mdd_tpu_torch" / "csrc" / "ctc_beam.cu")


def test_the_tool_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["frame_stamps", "--kernel", "beam"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        frame_stamps.main()


def test_another_trees_wer_kernel_gets_its_counts_zeroed(tmp_path):
    """A WER source that adds its counts into a caller-zeroed buffer is
    bound with a wrapper that zeroes them; this tree's kernel writes its
    counts itself."""
    old = tmp_path / "wer.cu"
    old.write_text("atomicAdd(counts, d);\n")
    kernel = frame_stamps.binding("wer", str(old))
    assert type(kernel) is frame_stamps._ParentWer
    assert kernel.source == str(old.resolve())
    here = frame_stamps.binding("wer", str(build.CSRC / "wer.cu"))
    assert type(here) is wer_cuda.GreedyWerKernel
    assert "atomicAdd(counts" not in (build.CSRC / "wer.cu").read_text()


def test_the_wer_wrapper_launches_once_and_zeroes_nothing(monkeypatch):
    """`GreedyWerKernel.__call__` allocates its distances and counts
    uninitialised and makes one launch: no torch.zeros (a fill kernel of
    its own on the card) before it."""
    def no_zeros(*_, **__):
        raise AssertionError("the WER wrapper zeroed a buffer")

    launches = []
    kernel = wer_cuda.GreedyWerKernel()
    monkeypatch.setattr(wer_cuda, "_check", lambda *_: None)
    monkeypatch.setattr(torch, "zeros", no_zeros)
    monkeypatch.setattr(kernel, "_launch",
                        lambda device, *args: launches.append(args))
    b, t, l = 3, 5, 4
    dist, counts = kernel(torch.ones((b, t), dtype=torch.int64),
                          torch.full((b,), t, dtype=torch.int64),
                          torch.ones((b, l), dtype=torch.int64),
                          torch.full((b,), l, dtype=torch.int64),
                          torch.ones(b, dtype=torch.bool))
    assert len(launches) == 1
    assert dist.shape == (b,) and counts.shape == (2,)
    assert launches[0][-2:] == (dist.data_ptr(), counts.data_ptr())
    assert len(launches[0]) == len(wer_cuda.GreedyWerKernel.argtypes)
