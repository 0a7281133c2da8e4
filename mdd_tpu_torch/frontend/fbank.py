"""Kaldi-compatible log-mel filterbank features on the device (counterpart
of mdd_tpu/frontend/fbank.py).

The same algorithm as mdd_tpu's: frame 25 ms / shift 10 ms @ 16 kHz,
snip-edges, per-frame DC removal, raw log-energy (before the window),
preemphasis 0.97, hamming window, zero padding to 512, power spectrum
over the first 256 bins, Kaldi mel triangles (1127 ln(1 + f/700), low
20 Hz, high nyquist), log with a float-epsilon floor, energy at feature
index 0.  The 512-point real DFT is one (frames x 512) @ (512 x 512)
matmul against precomputed cos/sin bases and the mel projection one
(frames x 256) @ (256 x 80) matmul.  Dither (`FbankConfig.dither`, the
stddev of Gaussian noise added to every frame before the DC removal) is
off by default, as in mdd_tpu, and applies only where the caller passes a
`torch.Generator` (mdd_tpu takes a PRNG key): serving and `feat` run
deterministic features.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

FLT_EPS = float(np.finfo(np.float32).eps)


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    sample_rate: int = 16000
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    num_mel_bins: int = 80
    use_energy: bool = True
    raw_energy: bool = True
    preemphasis: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "hamming"
    dither: float = 0.0  # Kaldi's binaries default to 1.0; off here, as in
    # mdd_tpu (train-time dither through a caller's torch.Generator)
    low_freq: float = 20.0
    high_freq: float = 0.0  # <=0 -> offset from nyquist
    snip_edges: bool = True
    use_log_fbank: bool = True
    use_power: bool = True

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000.0)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000.0)

    @property
    def padded_length(self) -> int:
        n = 1
        while n < self.frame_length:
            n *= 2
        return n

    @property
    def feat_dim(self) -> int:
        return self.num_mel_bins + (1 if self.use_energy else 0)


def _window_function(cfg: FbankConfig) -> np.ndarray:
    n = cfg.frame_length
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    if cfg.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif cfg.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif cfg.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif cfg.window_type == "rectangular":
        w = np.ones(n)
    else:
        raise ValueError(f"unknown window type {cfg.window_type}")
    return w.astype(np.float32)


def _mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


@functools.lru_cache(maxsize=8)
def _dft_and_mel_matrices(cfg: FbankConfig):
    """(padded, 2 * nbins) DFT basis and (nbins, num_mel) mel bank, numpy.

    nbins = padded / 2 (nyquist excluded), as Kaldi's MelBanks evaluates
    the triangles on fft bins 0 .. padded/2 - 1."""
    padded = cfg.padded_length
    nbins = padded // 2
    k = np.arange(padded)[:, None]
    f = np.arange(nbins)[None, :]
    ang = 2.0 * np.pi * k * f / padded
    dft = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)

    nyquist = 0.5 * cfg.sample_rate
    high = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    mel_low, mel_high = _mel_scale(cfg.low_freq), _mel_scale(high)
    delta = (mel_high - mel_low) / (cfg.num_mel_bins + 1)
    mel_freqs = _mel_scale(np.arange(nbins) * (cfg.sample_rate / padded))
    bank = np.zeros((nbins, cfg.num_mel_bins), dtype=np.float64)
    for b in range(cfg.num_mel_bins):
        left = mel_low + b * delta
        center = left + delta
        right = center + delta
        up = (mel_freqs - left) / (center - left)
        down = (right - mel_freqs) / (right - center)
        bank[:, b] = np.maximum(0.0, np.minimum(up, down))
    return dft, bank.astype(np.float32)


def num_frames(num_samples: int, cfg: FbankConfig) -> int:
    if cfg.snip_edges:
        if num_samples < cfg.frame_length:
            return 0
        return 1 + (num_samples - cfg.frame_length) // cfg.frame_shift
    return (num_samples + cfg.frame_shift // 2) // cfg.frame_shift


def frame_counts(lengths: np.ndarray, cfg: FbankConfig) -> np.ndarray:
    """(B,) valid sample counts -> (B,) int32 frame counts."""
    return np.asarray([num_frames(int(n), cfg) for n in lengths], np.int32)


def dither_noise(shape, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """Standard normal noise of `shape`, drawn on the generator's device
    and moved to `device` (a CPU generator gives the same bits for a CPU
    and a CUDA batch)."""
    return torch.randn(shape, generator=generator,
                       device=generator.device).to(device)


def compute_fbank_batch(waveforms: torch.Tensor, lengths: np.ndarray,
                        cfg: FbankConfig = FbankConfig(),
                        generator: torch.Generator | None = None):
    """Batched fbank over zero-padded waveforms, on waveforms' device.

    Args:
      waveforms: (B, S_max) float32 in int16 scale, zero-padded.
      lengths: (B,) valid sample counts (host).
      generator: draws the dither noise when cfg.dither is not 0 (one
        independent draw a frame sample, every row its own; mdd_tpu's
        vmap over one key gives every row of a batch the same draws).
        Without it, or at dither 0, no noise is added.
    Returns (features (B, T_max, D) float32 tensor, frame_counts (B,) int32
    numpy).  Every row is framed over the padded length, as mdd_tpu's vmap
    over compute_fbank does; frames past a row's own count are padding.
    """
    t = num_frames(waveforms.shape[1], cfg)
    length, shift = cfg.frame_length, cfg.frame_shift
    need = max((t - 1) * shift + length, waveforms.shape[1], length)
    wav = torch.nn.functional.pad(waveforms.float(),
                                  (0, need - waveforms.shape[1]))
    frames = wav.unfold(1, length, shift)[:, :t]            # (B, T, L)
    if cfg.dither != 0.0 and generator is not None:
        frames = frames + cfg.dither * dither_noise(frames.shape, generator,
                                                    frames.device)
    if cfg.remove_dc_offset:
        frames = frames - frames.mean(dim=2, keepdim=True)
    if cfg.use_energy and cfg.raw_energy:
        log_energy = torch.log(torch.clamp(
            (frames * frames).sum(dim=2), min=FLT_EPS))
    if cfg.preemphasis != 0.0:
        frames = torch.cat(
            [frames[..., :1] - cfg.preemphasis * frames[..., :1],
             frames[..., 1:] - cfg.preemphasis * frames[..., :-1]], dim=2)
    window = torch.from_numpy(_window_function(cfg)).to(frames.device)
    frames = frames * window
    if cfg.use_energy and not cfg.raw_energy:
        log_energy = torch.log(torch.clamp(
            (frames * frames).sum(dim=2), min=FLT_EPS))
    dft, mel = (torch.from_numpy(m).to(frames.device)
                for m in _dft_and_mel_matrices(cfg))
    padded = cfg.padded_length
    frames = torch.nn.functional.pad(frames, (0, padded - length))
    spec = torch.matmul(frames, dft)
    nbins = padded // 2
    power = spec[..., :nbins] ** 2 + spec[..., nbins:] ** 2
    if not cfg.use_power:
        power = torch.sqrt(power)
    mel_energies = torch.matmul(power, mel)
    if cfg.use_log_fbank:
        mel_energies = torch.log(torch.clamp(mel_energies, min=FLT_EPS))
    if cfg.use_energy:
        mel_energies = torch.cat([log_energy[..., None], mel_energies], dim=2)
    return mel_energies, frame_counts(lengths, cfg)


def compute_fbank(waveform: torch.Tensor, cfg: FbankConfig = FbankConfig(),
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """(num_samples,) float32 in int16 scale -> (T, feat_dim) features."""
    feats, _ = compute_fbank_batch(waveform[None],
                                   np.asarray([waveform.shape[0]]), cfg,
                                   generator)
    return feats[0]
