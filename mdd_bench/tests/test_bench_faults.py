"""A run at the tests' small size on the CPU, the harness's look for a card
skipped: the sound program is correct; the control (the reference in
float8 in the program's place) and each fault the cell can have, planted
under the timed path, come out not correct.

The limits here are the small size's, set as the cell's are (above the
sound program's readings over a dozen seeds, below the control's over
five): the cell's own are set from its readings at its own size on the
card (PERF.md)."""

import pytest
import torch

from mdd_bench import control, faults, harness
from mdd_bench.tests import small

# sound, seeds 100-111: logprob 0.071-0.182, loss 1.6e-4-1.2e-3, grad
# 0.026-0.086, update 0.0048-0.0111; control, seeds 200-204: logprob
# 1.16-1.98, loss 0.0063-0.030, grad 0.36-1.94, update 0.026-0.034
LIMITS = {"batch_mismatch": 0, "wer_count_gap": 0, "logprob_gap": 0.45,
          "loss_gap": 0.003, "grad_gap": 0.2, "update_gap": 0.018}


def _run(seed=2 ** 31 + 11):
    return harness.run_cell(small.CELL, seed, 0.5, False, device="cpu",
                            cfg_override=small.CFG, mix_override=small.MIX,
                            limits=LIMITS)


def _failed(res):
    return {k for k, c in res["checks"].items()
            if not c["value"] <= c["limit"]}


def test_the_sound_program_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def test_the_control_is_not_correct():
    for seed in (3, 4, 5):
        checks = control.control_checks(small.CELL, seed, "cpu",
                                        cfg_override=small.CFG,
                                        mix_override=small.MIX,
                                        limits=LIMITS)
        assert {k for k, c in checks.items()
                if c["value"] > c["limit"]}, checks


@pytest.mark.parametrize("fault, caught", [
    ("state_unchanged", {"grad_gap", "update_gap"}),
    ("half_batch", {"loss_gap"}),
    ("answer_altered", {"wer_count_gap"}),
    ("token_altered", {"batch_mismatch"})])
def test_a_planted_fault_is_not_correct(fault, caught):
    with faults.planted(fault):
        res = _run()
    assert not res["correct"]
    assert caught <= _failed(res), res["checks"]


@pytest.mark.cuda
def test_the_control_on_the_card_at_the_cells_size():
    """The cell's own size on the card: the program's readings and the
    control's, for the limits (run by `python3 -m mdd_bench.control`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    checks = control.control_checks(small.CELL, 1, "cuda")
    assert {k for k, c in checks.items() if c["value"] > c["limit"]}
