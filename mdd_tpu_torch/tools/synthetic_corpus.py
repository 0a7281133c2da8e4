"""Synthetic MDD corpus generator (counterpart of tools/synthetic_corpus.py).

Writes a corpus in the training layout (fbank ark/scp + phn_text +
transcript_phn_text + units) where each phone has a fixed spectral
signature over the 81 mel bins, durations are random, and
"mispronunciations" are substitutions between the canonical transcript and
the actual (labeled) phones.  NumPy only, with the same generators, draws
and profiles as the tool it ports, so one seed writes the same bytes.

  python -m mdd_tpu_torch.tools.synthetic_corpus OUT n_train n_dev n_test \\
      [--profile easy|hard] [--min-phones 16] [--max-phones 40] [--units F]

Splits use seeds train 0, dev 1, test 2.  `--units` sets the phone
inventory (one unit a line, `sil` included); its order fixes each phone's
signature, so the inventory file is part of the corpus.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from mdd_tpu_torch.frontend import kaldi_io

PHONES = ["sil", "aa", "ae", "ah", "b", "d", "eh", "er", "f", "g", "ih",
          "iy", "k", "l", "m", "n", "ow", "p", "r", "s", "t", "uw", "z"]
FEAT_DIM = 81
MIN_DUR, MAX_DUR = 6, 16

# "hard" profile knobs (see hard_signature): confusable clusters, noise,
# coarticulation and channel offsets that keep the flagship model in the
# reference's regime (dev acc ~0.85, PER 10-20%) instead of solving it
HARD_CLUSTER = 4      # phones per confusable cluster (shared base bands)
HARD_SEP = 0.35       # amplitude of the per-phone distinguishing bumps
HARD_NOISE = 1.3      # per-frame noise sigma (easy profile: 0.35)
HARD_XFADE = 4        # coarticulation crossfade frames at each boundary
HARD_CHANNEL = 0.6    # per-utterance channel offset sigma (log-mel bias)


def phone_signature(idx: int) -> np.ndarray:
    """A fixed mel-band template per phone (deterministic by index)."""
    sig_rng = np.random.default_rng(1000 + idx)
    centers = sig_rng.choice(np.arange(4, FEAT_DIM - 4), size=3,
                             replace=False)
    base = np.full(FEAT_DIM, -1.0, np.float32)
    for c in centers:
        width = sig_rng.integers(2, 5)
        lo, hi = max(0, c - width), min(FEAT_DIM, c + width)
        base[lo:hi] = 2.0 + sig_rng.uniform(0.0, 1.0)
    return base


def hard_signature(idx: int) -> np.ndarray:
    """Confusable template: phones of one cluster (idx // HARD_CLUSTER)
    share their 3 loud base bands; two bumps of height ~HARD_SEP tell a
    phone from its siblings, so under HARD_NOISE their posteriors stay
    near-tied."""
    cluster = idx // HARD_CLUSTER
    c_rng = np.random.default_rng(2000 + cluster)
    centers = c_rng.choice(np.arange(4, FEAT_DIM - 4), size=3,
                           replace=False)
    base = np.full(FEAT_DIM, -1.0, np.float32)
    for c in centers:
        width = int(c_rng.integers(2, 5))
        base[max(0, c - width):min(FEAT_DIM, c + width)] = \
            2.0 + c_rng.uniform(0.0, 1.0)
    p_rng = np.random.default_rng(3000 + idx)
    bumps = p_rng.choice(np.arange(2, FEAT_DIM - 2), size=2, replace=False)
    for b in bumps:
        base[b - 1:b + 2] += HARD_SEP * p_rng.uniform(0.7, 1.3)
    return base


def synth_utterance(phones: Sequence[str], rng: np.random.Generator,
                    inventory: Sequence[str] = PHONES,
                    profile: str = "easy") -> np.ndarray:
    """(T, 81) float32 features of the phone sequence."""
    if profile == "easy":
        sigs = []
        for p in phones:
            dur = int(rng.integers(MIN_DUR, MAX_DUR))
            frames = phone_signature(inventory.index(p))[None, :] \
                + 0.35 * rng.standard_normal((dur, FEAT_DIM)).astype(
                    np.float32)
            sigs.append(frames)
        return np.concatenate(sigs, axis=0)

    # hard: confusable templates + coarticulation + channel + heavy noise
    durs = [int(rng.integers(MIN_DUR, MAX_DUR)) for _ in phones]
    clean = np.concatenate([
        np.repeat(hard_signature(inventory.index(p))[None, :], d, axis=0)
        for p, d in zip(phones, durs)], axis=0)
    # coarticulation: a moving average over time blends adjacent phone
    # spectra at each boundary
    if HARD_XFADE > 1:
        k = HARD_XFADE
        pad = np.pad(clean, ((k // 2, k - 1 - k // 2), (0, 0)), mode="edge")
        kern = np.ones(k, np.float32) / k
        clean = np.apply_along_axis(
            lambda col: np.convolve(col, kern, mode="valid"), 0, pad)
    offset = HARD_CHANNEL * rng.standard_normal(FEAT_DIM).astype(np.float32)
    gain = 1.0 + 0.1 * rng.standard_normal()
    noise = HARD_NOISE * rng.standard_normal(clean.shape).astype(np.float32)
    return (gain * clean + offset[None, :] + noise).astype(np.float32)


def make_split(out: Path, name: str, n: int, seed: int,
               error_rate: float = 0.15,
               min_phones: int = 4, max_phones: int = 12,
               phones: Optional[Sequence[str]] = None,
               profile: str = "easy") -> None:
    """Write `name`.ark / .scp / _phn_text / _transcript_phn_text: `n`
    utterances of min_phones to max_phones - 1 phones between two `sil`
    (4-12 phones, ~0.6-1.5 s, keeps tests fast; 16-40 matches TIMIT /
    L2-ARCTIC lengths).  Under 'hard' half the injected substitutions are
    cluster siblings of the canonical phone, as real L2 errors sound close
    to the phone they replace."""
    inventory = list(phones) if phones is not None else PHONES
    rng = np.random.default_rng(seed)
    content = [p for p in inventory if p != "sil"]
    out.mkdir(parents=True, exist_ok=True)

    def substitute(phone: str) -> str:
        if profile == "hard" and rng.random() < 0.5:
            cluster = inventory.index(phone) // HARD_CLUSTER
            sibs = [p for p in content
                    if inventory.index(p) // HARD_CLUSTER == cluster
                    and p != phone]
            if sibs:
                return sibs[int(rng.integers(len(sibs)))]
        return content[int(rng.integers(len(content)))]

    with kaldi_io.ArkScpWriter(str(out / f"{name}.ark"),
                               str(out / f"{name}.scp")) as w, \
            open(out / f"{name}_phn_text", "w") as lab, \
            open(out / f"{name}_transcript_phn_text", "w") as trn:
        for i in range(n):
            utt = f"{name}_{i:05d}"
            length = int(rng.integers(min_phones, max_phones))
            canonical = ["sil"] + [content[rng.integers(len(content))]
                                   for _ in range(length)] + ["sil"]
            actual = list(canonical)
            # substitutions only, so the alignment stays simple to verify
            for j in range(1, len(actual) - 1):
                if rng.random() < error_rate:
                    actual[j] = substitute(actual[j])
            w.write(utt, synth_utterance(actual, rng, inventory, profile))
            lab.write(f"{utt} {' '.join(actual)}\n")
            trn.write(f"{utt} {' '.join(canonical)}\n")


def read_units(path: str) -> List[str]:
    return [ln.strip() for ln in Path(path).read_text().splitlines()
            if ln.strip()]


def main(out_dir: str, n_train: int = 400, n_dev: int = 60,
         n_test: int = 60, profile: str = "easy",
         min_phones: int = 4, max_phones: int = 12,
         units: Optional[str] = None) -> None:
    out = Path(out_dir)
    phones = read_units(units) if units else None
    for name, n, seed in (("train", n_train, 0), ("dev", n_dev, 1),
                          ("test", n_test, 2)):
        make_split(out, name, n, seed=seed, profile=profile,
                   min_phones=min_phones, max_phones=max_phones,
                   phones=phones)
    with open(out / "units", "w") as f:
        for p in (phones or PHONES):
            f.write(p + "\n")
    print(f"synthetic corpus -> {out} ({n_train}/{n_dev}/{n_test}, "
          f"profile={profile})")


def cli(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m mdd_tpu_torch.tools.synthetic_corpus",
        description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("sizes", nargs="*", type=int, default=[400, 60, 60],
                    help="n_train n_dev n_test (an omitted size keeps its "
                         "default: 400, 60, 60)")
    ap.add_argument("--profile", choices=("easy", "hard"), default="easy")
    ap.add_argument("--min-phones", type=int, default=4)
    ap.add_argument("--max-phones", type=int, default=12)
    ap.add_argument("--units", default=None,
                    help="units file overriding the phone inventory")
    a = ap.parse_args(argv)
    sizes = list(a.sizes) + [400, 60, 60][len(a.sizes):]
    main(a.out_dir, *sizes[:3], profile=a.profile,
         min_phones=a.min_phones, max_phones=a.max_phones, units=a.units)


if __name__ == "__main__":
    cli()
