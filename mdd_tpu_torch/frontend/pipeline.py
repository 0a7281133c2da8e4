"""Batched feature extraction: wav.scp -> features ark/scp + CMVN
(counterpart of mdd_tpu/frontend/pipeline.py).

The reference's Kaldi feature stage (compute-fbank-feats |
compute-cmvn-stats | apply-cmvn --norm-vars=true | copy-feats) as one
pass: audio is read directly (wav or NIST SPHERE), fbank or MFCC runs
batched on the device over waveforms zero-padded to a 0.5 s sample
quantum and is cut back to each item's own frame count on the host, CMVN
stats accumulate on the host in float64, and the normalized features land
in a binary ark/scp pair.  `BatchedFbank` is also the serving path's
front end.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from mdd_tpu_torch.frontend import kaldi_io
from mdd_tpu_torch.frontend.cmvn import (CmvnStats, apply_cmvn,
                                         write_kaldi_cmvn_text)
from mdd_tpu_torch.frontend.fbank import FbankConfig, compute_fbank_batch
from mdd_tpu_torch.frontend.mfcc import MfccConfig, compute_mfcc_batch
from mdd_tpu_torch.frontend.wav import read_audio, resample


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class BatchedFbank:
    """Features of a list of waveforms -> list of (T_i, D) host arrays.

    Dispatches on the config's type: FbankConfig -> compute_fbank_batch,
    MfccConfig -> compute_mfcc_batch (the reference runner's `feat_type`
    switch)."""

    def __init__(self, cfg: FbankConfig | MfccConfig = FbankConfig(),
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self._fn = (compute_mfcc_batch if isinstance(cfg, MfccConfig)
                    else compute_fbank_batch)

    @torch.inference_mode()
    def __call__(self, wavs: Sequence[np.ndarray]) -> List[np.ndarray]:
        lengths = np.asarray([len(w) for w in wavs], np.int32)
        s_max = _round_up(int(lengths.max()), 8000)  # 0.5 s sample quantum
        batch = np.zeros((len(wavs), s_max), np.float32)
        for i, w in enumerate(wavs):
            batch[i, : len(w)] = w
        feats, counts = self._fn(torch.from_numpy(batch).to(self.device),
                                 lengths, self.cfg)
        feats = feats.cpu().numpy()
        return [feats[i, : counts[i]] for i in range(len(wavs))]


def _load_waveform(path: str, sample_rate: int) -> np.ndarray:
    data, sr = read_audio(path)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if sr != sample_rate:
        data = resample(data, sr, sample_rate)
    return data.astype(np.float32)


def extract_split(
    wav_scp: str,
    out_dir: str,
    name: str = "fbank",
    cfg: FbankConfig | MfccConfig = FbankConfig(),
    cmvn: CmvnStats | None = None,
    batch_size: int = 16,
    sample_rate: int = 16000,
    device: str | torch.device = "cuda",
) -> Tuple[str, CmvnStats]:
    """Extract one split's features to `<out_dir>/<name>.{ark,scp}`.

    Without `cmvn` (a training split) the stats are accumulated over this
    split and written to `<out_dir>/global_<name>_cmvn.txt`; the reference
    trains CMVN on train and applies it everywhere.  Returns (scp path,
    the CMVN stats applied)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    scp = kaldi_io.read_scp(wav_scp)
    # file size as a cheap length proxy: tight padding buckets
    utts = sorted(sorted(scp), key=lambda u: os.path.getsize(scp[u])
                  if os.path.exists(scp[u]) else 0)
    featurize = BatchedFbank(cfg, device)
    raw: Dict[str, np.ndarray] = {}
    stats = None if cmvn is not None else CmvnStats(
        np.zeros(cfg.feat_dim), np.zeros(cfg.feat_dim), 0.0)
    for start in range(0, len(utts), batch_size):
        chunk = utts[start: start + batch_size]
        wavs = [_load_waveform(scp[u], sample_rate) for u in chunk]
        for u, f in zip(chunk, featurize(wavs)):
            raw[u] = f
            if stats is not None:
                f64 = f.astype(np.float64)
                stats.sum += f64.sum(axis=0)
                stats.sum_sq += (f64 ** 2).sum(axis=0)
                stats.count += f.shape[0]
    if stats is not None:
        cmvn = stats
        write_kaldi_cmvn_text(cmvn, str(out / f"global_{name}_cmvn.txt"))
    scp_path = str(out / f"{name}.scp")
    with kaldi_io.ArkScpWriter(str(out / f"{name}.ark"), scp_path) as w:
        for u in sorted(raw):
            w.write(u, apply_cmvn(raw[u], cmvn))
    return scp_path, cmvn


def featurize_wavs(
    paths: Dict[str, str],
    cmvn: CmvnStats,
    cfg: FbankConfig | MfccConfig = FbankConfig(),
    sample_rate: int = 16000,
    device: str | torch.device = "cuda",
) -> Dict[str, np.ndarray]:
    """In-memory features of {utt: wav path}, the committed training CMVN
    applied (the product inference path)."""
    featurize = BatchedFbank(cfg, device)
    utts = sorted(paths)
    out: Dict[str, np.ndarray] = {}
    for start in range(0, len(utts), 16):
        chunk = utts[start: start + 16]
        wavs = [_load_waveform(paths[u], sample_rate) for u in chunk]
        for u, f in zip(chunk, featurize(wavs)):
            out[u] = apply_cmvn(f, cmvn)
    return out
