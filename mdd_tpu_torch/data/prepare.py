"""Corpus preparation: TIMIT + L2-ARCTIC -> Kaldi-style data dirs
(counterpart of mdd_tpu/data/prepare.py; the files it writes are equal
byte for byte).

Python redesign of the reference's shell/python prep layer
(egs/attention_aug/local/: timit_data_prep.sh, normalize_phone.py,
l2arctic_prep.py, timit_l2_merge.sh, timit_split.py;
steps/get_model_units.py), producing the same per-split text files:

  wav.scp                 uttid -> wav path
  phn_text                human-annotated actual phones
  transcript_phn_text     canonical prompt phones
  wrd_text                words

Differences by design: no sph2pipe subprocess (our wav reader ingests
NIST SPHERE directly — frontend/wav.py), no `eval()` of split names,
deterministic speaker splits via an explicit seed, and everything is an
importable function the CLI drives.
"""

from __future__ import annotations

import os
import random
import re
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

from mdd_tpu_torch.data.textgrid import TextGrid
from mdd_tpu_torch.lexicon.phones import (
    del_repeat_sil,
    normalize_annotated_phone,
    normalize_canonical_phone,
)
from mdd_tpu_torch.lexicon.timit import map_timit_phones

# Fixed L2-ARCTIC speaker splits (reference l2arctic_prep.py:17-19).
# Order: Spanish, Vietnamese, Hindi, Mandarin, Korean, Arabic.
L2_TRAIN_SPK = ["EBVS", "ERMS", "HQTV", "PNV", "ASI", "RRBI",
                "BWC", "LXC", "HJK", "HKK", "ABA", "SKA"]
L2_DEV_SPK = ["MBMPS", "THV", "SVBI", "NCC", "YDCK", "YBAA"]
L2_TEST_SPK = ["NJS", "TLV", "TNI", "TXHC", "YKWK", "ZHAA"]
L2_SPLITS = {"train": L2_TRAIN_SPK, "dev": L2_DEV_SPK, "test": L2_TEST_SPK}

# TextGrids that fail to parse upstream (reference l2arctic_prep.py:20-21).
L2_LOAD_ERROR_FILES = (
    "YDCK/annotation/arctic_a0209.TextGrid",
    "YDCK/annotation/arctic_a0272.TextGrid",
)

# Mandarin-accent speakers, used for the per-accent evaluation breakdown
# (reference test_ctc_nosil.py:153-163).
L2_MANDARIN_SPK = ["TXHC", "BWC", "LXC", "NCC"]


def _write_keyed(path: Path, rows: Iterable[Tuple[str, str]]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for utt, text in sorted(rows):
            f.write(f"{utt} {text}\n")


# ---------------------------------------------------------------------------
# L2-ARCTIC
# ---------------------------------------------------------------------------

def _normalize_annotation_tier(tier) -> Tuple[List[str], List[str]]:
    """Annotation tier -> (actual phones, canonical phones).

    Reference l2arctic_prep.py:60-115: a mark is either a plain canonical
    phone or "canonical,actual,errtype"; empty marks are silence.
    """
    actual: List[str] = []
    canonical: List[str] = []
    for iv in tier:
        mark = iv.mark or ""
        if mark == "":
            actual.append("sil")
            canonical.append("sil")
            continue
        fields = mark.split(",")
        canonical.append(normalize_canonical_phone(fields[0]))
        actual.append(normalize_annotated_phone(
            fields[1] if len(fields) > 1 else fields[0]))
    return actual, canonical


def _normalize_canonical_tier(tier) -> List[str]:
    """arpa_textgrid tier -> canonical phones (l2arctic_prep.py:117-143).

    The reference appends "sil" for an empty mark and then *also* falls
    through and appends the empty string; the empty string vanishes when
    the text file is re-tokenized, so the net effect — reproduced here —
    is a single "sil".
    """
    out: List[str] = []
    for iv in tier:
        mark = iv.mark or ""
        if mark == "":
            out.append("sil")
            continue
        out.append(normalize_canonical_phone(mark))
    return out


def prepare_l2arctic(
    l2_path: str,
    save_path: str,
    split: str,
    keep_reduced: bool = True,
    phones_tier: int = 1,
) -> int:
    """Prepare one L2-ARCTIC split. Returns the number of utterances.

    Reference l2arctic_prep.py semantics: glob `*/annotation/*.TextGrid`,
    filter by the fixed speaker split, skip the two known-bad files, and
    emit wav.scp / wrd_text / phn_text (annotated actual phones) /
    transcript_phn_text (arpa_textgrid canonical phones) /
    a_transcript_phn_text (annotation-tier canonical phones), all with
    repeated sil collapsed.  `keep_reduced=False` gives the 39-phone
    cnn-rnn-ctc variant (ah0->ah, er0->er).
    """
    spk_set = set(L2_SPLITS[split])
    root = Path(l2_path)
    out = Path(save_path)
    out.mkdir(parents=True, exist_ok=True)

    rows_wav, rows_wrd = [], []
    rows_phn, rows_can, rows_a_can = [], [], []

    def _fold(phones: List[str]) -> List[str]:
        if keep_reduced:
            return phones
        return [{"ah0": "ah", "er0": "er"}.get(p, p) for p in phones]

    for tg_path in sorted(root.glob("*/annotation/*.TextGrid")):
        rel = "/".join(tg_path.parts[-3:])
        if rel in L2_LOAD_ERROR_FILES:
            continue
        spk = tg_path.parts[-3]
        if spk not in spk_set:
            continue
        utt = f"{spk}_{tg_path.name[:-len('.TextGrid')]}"
        wav_path = str(tg_path).replace("/annotation/", "/wav/").replace(
            ".TextGrid", ".wav")
        txt_path = str(tg_path).replace("/annotation/", "/transcript/").replace(
            ".TextGrid", ".txt")
        can_path = str(tg_path).replace("/annotation/", "/arpa_textgrid/").replace(
            ".TextGrid", ".TextGrid")

        tg = TextGrid.fromFile(str(tg_path))
        actual, a_canonical = _normalize_annotation_tier(tg[phones_tier])

        can_tg = TextGrid.fromFile(can_path)
        canonical = _normalize_canonical_tier(can_tg[phones_tier])

        rows_wav.append((utt, wav_path))
        if os.path.exists(txt_path):
            with open(txt_path, "r", encoding="utf-8") as f:
                words = f.read().strip().lower()
            rows_wrd.append((utt, words))
        rows_phn.append((utt, " ".join(del_repeat_sil(_fold(actual)))))
        rows_can.append((utt, " ".join(del_repeat_sil(_fold(canonical)))))
        rows_a_can.append((utt, " ".join(del_repeat_sil(_fold(a_canonical)))))

    _write_keyed(out / "wav.scp", rows_wav)
    _write_keyed(out / "wav_sph.scp", rows_wav)
    _write_keyed(out / "wrd_text", rows_wrd)
    _write_keyed(out / "phn_text", rows_phn)
    _write_keyed(out / "transcript_phn_text", rows_can)
    _write_keyed(out / "a_transcript_phn_text", rows_a_can)
    return len(rows_wav)


# ---------------------------------------------------------------------------
# TIMIT
# ---------------------------------------------------------------------------

def _read_timit_column_file(path: Path) -> List[str]:
    """Read a TIMIT .PHN/.WRD file: `start end token` rows -> tokens."""
    toks = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3:
                toks.append(parts[2])
    return toks


def prepare_timit(
    timit_dir: str,
    save_path: str,
    speakers: Sequence[str] | None = None,
    phoneme_map: str = "60-41",
) -> int:
    """Prepare TIMIT train data. Returns the number of utterances.

    Reference timit_data_prep.sh:28-70 semantics: walk TRAIN/TEST
    dialect-region dirs, keep SI & SX sentences of the selected speakers,
    uttid = SPEAKER_SENTENCE, map the 60-phone transcripts (60-48 / 60-41
    dropping `q`), and copy phn_text to transcript_phn_text (native
    speech: canonical == annotated).  wav.scp points at the original
    audio; no sph2pipe needed (frontend/wav.py reads NIST SPHERE).
    """
    root = Path(timit_dir)
    out = Path(save_path)
    out.mkdir(parents=True, exist_ok=True)
    spk_set = {s.upper() for s in speakers} if speakers is not None else None

    rows_wav, rows_wrd, rows_phn = [], [], []
    for sub in ("TRAIN", "TEST", "train", "test"):
        base = root / sub
        if not base.is_dir():
            continue
        for spk_dir in sorted(base.glob("DR*/*")):
            spk = spk_dir.name.upper()
            if spk_set is not None and spk not in spk_set:
                continue
            for phn_file in sorted(spk_dir.glob("*")):
                if phn_file.suffix.lower() != ".phn":
                    continue
                stem = phn_file.stem
                if stem.upper().startswith("SA"):
                    continue  # only SI & SX sentences
                utt = f"{spk}_{stem.upper()}"
                wav = None
                for cand in (phn_file.with_suffix(".WAV.wav"),
                             phn_file.with_suffix(".WAV"),
                             phn_file.with_suffix(".wav")):
                    if cand.exists():
                        wav = cand
                        break
                if wav is None:
                    continue
                phones = map_timit_phones(
                    _read_timit_column_file(phn_file), phoneme_map)
                rows_phn.append((utt, " ".join(phones)))
                rows_wav.append((utt, str(wav)))
                wrd_file = next((phn_file.with_suffix(s) for s in
                                 (".WRD", ".wrd")
                                 if phn_file.with_suffix(s).exists()), None)
                if wrd_file is not None:
                    rows_wrd.append(
                        (utt, " ".join(_read_timit_column_file(wrd_file))))

    _write_keyed(out / "wav.scp", rows_wav)
    _write_keyed(out / "wav_sph.scp", rows_wav)
    _write_keyed(out / "wrd_text", rows_wrd)
    _write_keyed(out / "phn_text", rows_phn)
    _write_keyed(out / "transcript_phn_text", rows_phn)
    return len(rows_wav)


def split_timit_speakers(
    speakers_by_region: Dict[str, List[str]],
    n_dev: int = 4,
    n_test: int = 4,
    seed: int = 0,
) -> Dict[str, List[str]]:
    """Random per-dialect-region speaker split (local/timit_split.py:36-53),
    made reproducible with an explicit seed."""
    rng = random.Random(seed)
    out = {"train": [], "dev": [], "test": []}
    for region in sorted(speakers_by_region):
        spks = list(speakers_by_region[region])
        idx = list(range(len(spks)))
        rng.shuffle(idx)
        out["dev"] += [spks[i] for i in idx[:n_dev]]
        out["test"] += [spks[i] for i in idx[n_dev:n_dev + n_test]]
        out["train"] += [spks[i] for i in idx[n_dev + n_test:]]
    return out


# ---------------------------------------------------------------------------
# Merge + vocabulary
# ---------------------------------------------------------------------------

MERGE_FILES = ("phn_text", "transcript_phn_text", "wav.scp",
               "wav_sph.scp", "wrd_text")


def merge_data_dirs(dirs: Sequence[str], out_dir: str) -> None:
    """Concatenate per-split text files (timit_l2_merge.sh:11-13)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for name in MERGE_FILES:
        with open(out / name, "w", encoding="utf-8") as w:
            for d in dirs:
                p = Path(d) / name
                if p.exists():
                    w.write(p.read_text(encoding="utf-8"))


def build_units(train_phn_text: str, units_file: str) -> List[str]:
    """Scan training phn_text -> modelling units, in first-seen order
    (steps/get_model_units.py:11-27)."""
    units: Dict[str, bool] = {}
    with open(train_phn_text, "r", encoding="utf-8") as f:
        for line in f:
            for tok in line.strip().split(" ")[1:]:
                units.setdefault(tok, True)
    out = list(units)
    with open(units_file, "w", encoding="utf-8") as f:
        for u in out:
            f.write(u + "\n")
    return out
