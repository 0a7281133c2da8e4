"""The training traffic: a synthetic corpus in the recipe's layout, made
from the run's seed.

A frozen copy of the statistics of `mdd_tpu_torch/tools/synthetic_corpus.py`
(`make_split`, the "easy" profile): each utterance is `min_phones` to
`max_phones - 1` phones between two `sil`, each phone `min_dur` to
`max_dur - 1` raw frames of its fixed 81-bin signature plus Gaussian noise,
and each inner phone of the actual (labelled) sequence is substituted with
probability `error_rate`.  It is vectorised: one noise draw for the whole
corpus.

The sizes (phone counts and durations) come from the mix's own
`sizes_seed`, so every run seed has the same multiset of utterance lengths,
the same buckets and the same work; the seed permutes which utterance has
which size and draws the phones, the substitutions and the noise.  The
noise, nearly all of the corpus's numbers, is drawn by a torch Generator
on the run's device in one call.

`write` puts the corpus where the program reads it: a Kaldi binary ark +
scp, `train_phn_text`, `train_transcript_phn_text` and `units`.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import List

import numpy as np
import torch

FEAT_DIM = 81


def phone_signature(idx: int) -> np.ndarray:
    """The fixed mel-band template of the phone with inventory index
    `idx` (synthetic_corpus.phone_signature)."""
    sig_rng = np.random.default_rng(1000 + idx)
    centers = sig_rng.choice(np.arange(4, FEAT_DIM - 4), size=3,
                             replace=False)
    base = np.full(FEAT_DIM, -1.0, np.float32)
    for c in centers:
        width = sig_rng.integers(2, 5)
        lo, hi = max(0, c - width), min(FEAT_DIM, c + width)
        base[lo:hi] = 2.0 + sig_rng.uniform(0.0, 1.0)
    return base


@dataclasses.dataclass
class Corpus:
    utts: List[str]
    feats: List[np.ndarray]        # (T_i, 81) float32, views of one array
    actual: List[List[str]]        # the labels
    canonical: List[List[str]]     # the prompts' transcripts
    units: List[str]

    @property
    def lengths(self) -> np.ndarray:
        return np.asarray([f.shape[0] for f in self.feats], np.int64)


def sizes(mix: dict) -> List[np.ndarray]:
    """Each utterance's phone durations (sil included), from the mix's
    `sizes_seed` alone."""
    rng = np.random.default_rng(int(mix["sizes_seed"]))
    n = int(mix["n_utts"])
    counts = rng.integers(mix["min_phones"], mix["max_phones"], n) + 2
    durs = rng.integers(mix["min_dur"], mix["max_dur"], int(counts.sum()))
    return np.split(durs, np.cumsum(counts)[:-1])


def generate(mix: dict, units: List[str], seed: int,
             device: str | torch.device = "cpu") -> Corpus:
    rng = np.random.default_rng(seed)
    content = [p for p in units if p != "sil"]
    sil = units.index("sil")
    content_idx = np.asarray([units.index(p) for p in content])
    per_utt = sizes(mix)
    order = rng.permutation(len(per_utt))
    durs = [per_utt[k] for k in order]
    counts = np.asarray([len(d) for d in durs])
    n_inner = int((counts - 2).sum())
    canon_inner = content_idx[rng.integers(len(content), size=n_inner)]
    subst = rng.random(n_inner) < mix["error_rate"]
    actual_inner = np.where(
        subst, content_idx[rng.integers(len(content), size=n_inner)],
        canon_inner)
    all_durs = np.concatenate(durs)
    total = int(all_durs.sum())
    sig = torch.from_numpy(
        np.stack([phone_signature(i) for i in range(len(units))]))
    # sil at both ends of every utterance, the drawn phones between
    phone_ends = np.cumsum(counts)
    inner = np.ones(int(counts.sum()), bool)
    inner[phone_ends - 1] = False
    inner[phone_ends - counts] = False
    actual_all = np.full(inner.shape, sil)
    actual_all[inner] = actual_inner
    canon_all = np.full(inner.shape, sil)
    canon_all[inner] = canon_inner
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    noise = torch.randn((total, FEAT_DIM), generator=gen, device=device)
    frame_phone = torch.from_numpy(np.repeat(actual_all, all_durs))
    feats_all = (sig.to(device)[frame_phone.to(device)]
                 + float(mix["noise"]) * noise).cpu().numpy()
    frame_ends = np.cumsum([int(d.sum()) for d in durs])
    feats = np.split(feats_all, frame_ends[:-1])
    act = np.split(actual_all, phone_ends[:-1])
    can = np.split(canon_all, phone_ends[:-1])
    return Corpus(
        utts=[f"train_{i:05d}" for i in range(len(durs))], feats=feats,
        actual=[[units[j] for j in a] for a in act],
        canonical=[[units[j] for j in c] for c in can], units=list(units))


def paths(out: Path) -> dict:
    """The files of a corpus written under `out`, by the config keys that
    name them."""
    return {"train_scp_path": str(out / "train.scp"),
            "train_lab_path": str(out / "train_phn_text"),
            "train_trans_path": str(out / "train_transcript_phn_text"),
            "vocab_file": str(out / "units")}


def write(corpus: Corpus, out: Path) -> dict:
    """Write the corpus in the recipe's layout under `out`; -> `paths`."""
    out.mkdir(parents=True, exist_ok=True)
    ark = out / "train.ark"
    scp_lines = []
    with open(ark, "wb") as f:
        for utt, m in zip(corpus.utts, corpus.feats):
            f.write(utt.encode() + b" ")
            offset = f.tell()
            f.write(b"\x00BBFM \x04" + struct.pack("<i", m.shape[0])
                    + b"\x04" + struct.pack("<i", m.shape[1]))
            f.write(np.ascontiguousarray(m, np.float32).tobytes())
            scp_lines.append(f"{utt} {ark}:{offset}\n")
    (out / "train.scp").write_text("".join(scp_lines))
    (out / "train_phn_text").write_text("".join(
        f"{u} {' '.join(a)}\n" for u, a in zip(corpus.utts, corpus.actual)))
    (out / "train_transcript_phn_text").write_text("".join(
        f"{u} {' '.join(c)}\n"
        for u, c in zip(corpus.utts, corpus.canonical)))
    (out / "units").write_text("".join(u + "\n" for u in corpus.units))
    return paths(out)
