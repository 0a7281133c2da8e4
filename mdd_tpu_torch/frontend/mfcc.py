"""Kaldi-compatible MFCC features on the device (counterpart of
mdd_tpu/frontend/mfcc.py).

The third `feat_type` of the reference's feature runner (fbank / mfcc /
spectrogram), on the port's fbank: log-mel energies from the same DFT and
mel products, then one more (T, num_bins) @ (num_bins, num_ceps) product
against an orthonormal DCT-II basis and the cepstral lifter.  Kaldi's
MfccComputer at its defaults except where the reference's mfcc.conf
overrides them: 23 mel bins, 13 cepstra, povey window (fbank.conf's
hamming applies to the fbank path only), lifter Q=22 (coeff_j = 1 + Q/2
sin(pi j / Q)), DCT row 0 = 1/sqrt(N) and row k = sqrt(2/N) cos(pi/N
(n + 0.5) k), and use_energy=false, so C0 is kept (liftered by 1.0)
instead of being replaced by the raw log energy.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from mdd_tpu_torch.frontend.fbank import (FbankConfig, compute_fbank_batch,
                                          num_frames)


@dataclasses.dataclass(frozen=True)
class MfccConfig:
    sample_rate: int = 16000
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    num_mel_bins: int = 23       # MfccOptions default (fbank: 80)
    num_ceps: int = 13
    use_energy: bool = False     # the reference's mfcc.conf
    raw_energy: bool = True
    cepstral_lifter: float = 22.0
    preemphasis: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"   # the frame options' default
    dither: float = 0.0
    low_freq: float = 20.0
    high_freq: float = 0.0
    snip_edges: bool = True

    @property
    def feat_dim(self) -> int:
        return self.num_ceps

    def fbank_config(self) -> FbankConfig:
        """The mel front end the MFCC rides on: log-mels + raw energy."""
        return FbankConfig(
            sample_rate=self.sample_rate,
            frame_length_ms=self.frame_length_ms,
            frame_shift_ms=self.frame_shift_ms,
            num_mel_bins=self.num_mel_bins,
            use_energy=self.use_energy,
            raw_energy=self.raw_energy,
            preemphasis=self.preemphasis,
            remove_dc_offset=self.remove_dc_offset,
            window_type=self.window_type,
            dither=self.dither,
            low_freq=self.low_freq,
            high_freq=self.high_freq,
            snip_edges=self.snip_edges,
        )


@functools.lru_cache(maxsize=8)
def _dct_and_lifter(num_bins: int, num_ceps: int, lifter_q: float):
    """((num_bins, num_ceps) DCT-II basis, (num_ceps,) lifter), float32
    numpy: Kaldi's ComputeDctMatrix transposed for a right product, and
    ComputeLifterCoeffs."""
    n = np.arange(num_bins, dtype=np.float64)
    k = np.arange(num_ceps, dtype=np.float64)
    dct = np.sqrt(2.0 / num_bins) * np.cos(
        np.pi / num_bins * np.outer(n + 0.5, k))
    dct[:, 0] = 1.0 / np.sqrt(num_bins)
    if lifter_q != 0.0:
        lifter = 1.0 + 0.5 * lifter_q * np.sin(np.pi * k / lifter_q)
    else:
        lifter = np.ones(num_ceps)
    return dct.astype(np.float32), lifter.astype(np.float32)


def compute_mfcc_batch(waveforms: torch.Tensor, lengths: np.ndarray,
                       cfg: MfccConfig = MfccConfig(),
                       generator: torch.Generator | None = None):
    """Batched MFCC over zero-padded waveforms, on waveforms' device ->
    (features (B, T_max, num_ceps) tensor, frame_counts (B,) numpy).

    Kaldi's MfccComputer::Compute: log-mel energies -> DCT -> lifter ->
    (use_energy only) C0 := the raw log energy."""
    fb, counts = compute_fbank_batch(waveforms, lengths, cfg.fbank_config(),
                                     generator)
    if cfg.use_energy:
        log_energy, log_mels = fb[..., 0], fb[..., 1:]
    else:
        log_mels = fb
    dct, lifter = (torch.from_numpy(m).to(fb.device) for m in
                   _dct_and_lifter(cfg.num_mel_bins, cfg.num_ceps,
                                   cfg.cepstral_lifter))
    ceps = torch.matmul(log_mels, dct) * lifter
    if cfg.use_energy:
        ceps = torch.cat([log_energy[..., None], ceps[..., 1:]], dim=-1)
    return ceps, counts


def compute_mfcc(waveform: torch.Tensor, cfg: MfccConfig = MfccConfig(),
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """(num_samples,) float32 in int16 scale -> (T, num_ceps) MFCCs."""
    feats, _ = compute_mfcc_batch(waveform[None],
                                  np.asarray([waveform.shape[0]]), cfg,
                                  generator)
    return feats[0]


__all__ = ["MfccConfig", "compute_mfcc", "compute_mfcc_batch", "num_frames"]
