"""The port's corpus tool (mdd_tpu_torch/tools/synthetic_corpus.py) vs
tools/synthetic_corpus.py: the same bytes in every file for both profiles
at a small size, and, with the recovered 41-unit inventory
(results/synthetic_full_hard_torch/units, `sil` first), the hard test
split of mdd_tpu's quality runs label for label."""

import importlib.util
from pathlib import Path

import pytest

from mdd_tpu_torch.tools import synthetic_corpus as port

ROOT = Path(__file__).resolve().parents[1]
UNITS = ROOT / "results" / "synthetic_full_hard_torch" / "units"
FILES = [f"{split}{suffix}" for split in ("train", "dev", "test")
         for suffix in (".ark", ".scp", "_phn_text",
                        "_transcript_phn_text")] + ["units"]


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "reference_synthetic_corpus", ROOT / "tools" / "synthetic_corpus.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read(out: Path) -> dict:
    return {name: (out / name).read_bytes() for name in FILES}


@pytest.mark.parametrize("profile", ["easy", "hard"])
def test_same_bytes_as_the_tool(tmp_path, profile):
    """Both write into one directory in turn (the scp holds the ark's
    path), with the recovered inventory under 'hard' and the tool's own
    default under 'easy'."""
    kw = dict(profile=profile, min_phones=16, max_phones=40,
              units=str(UNITS) if profile == "hard" else None)
    out = tmp_path / "corpus"
    _reference_tool().main(str(out), 6, 3, 2, **kw)
    want = _read(out)
    for name in FILES:
        (out / name).unlink()
    port.cli([str(out), "6", "3", "2", "--profile", profile,
              "--min-phones", "16", "--max-phones", "40"]
             + (["--units", str(UNITS)] if profile == "hard" else []))
    got = _read(out)
    assert got == want
    assert got["test.scp"].count(b"\n") == 2 and len(got["train.ark"]) > 0


def test_recovered_inventory():
    units = port.read_units(str(UNITS))
    assert len(units) == 41 and units[0] == "sil" and units[-1] == "err"
    assert len(set(units)) == 41


def _keyed(path: Path) -> dict:
    out = {}
    for line in path.read_text().splitlines():
        utt, *phones = line.split()
        out[utt] = [p for p in phones if p != "sil"]
    return out


def test_hard_test_split_reproduces_the_reference_runs(tmp_path):
    """900 utterances of 16-40 phones, seed 2: the canonical and labeled
    phones of every utterance equal mdd_tpu's hard-recipe dumps
    (transcribe.log, human_seq.log; those hold no `sil`)."""
    port.make_split(tmp_path, "test", 900, seed=2, min_phones=16,
                    max_phones=40, phones=port.read_units(str(UNITS)),
                    profile="hard")
    runs = ROOT / "results" / "synthetic_full_hard_r5"
    canonical = _keyed(tmp_path / "test_transcript_phn_text")
    labels = _keyed(tmp_path / "test_phn_text")
    want_canonical = _keyed(runs / "transcribe.log")
    want_labels = _keyed(runs / "human_seq.log")
    assert len(want_canonical) == len(want_labels) == len(canonical) == 900
    assert canonical == want_canonical
    assert labels == want_labels
