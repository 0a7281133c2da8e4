"""Log-magnitude spectrogram front end, the legacy alternative feature
(counterpart of mdd_tpu/frontend/spectrogram.py).

The reference's make_spectrum.py path: STFT magnitude -> log1p ->
per-utterance mean / variance normalization, framed from sample 0 (no
centring), with the DFT as one product against a cos/sin basis on the
device.  `make_spectrum` writes the features of a wav.scp to an ark/scp
pair, without a CMVN stage.
"""

from __future__ import annotations

import numpy as np
import torch

from mdd_tpu_torch.frontend import kaldi_io
from mdd_tpu_torch.frontend.fbank import FbankConfig, _window_function
from mdd_tpu_torch.frontend.wav import read_audio, resample


def compute_spectrogram(
    waveform: torch.Tensor,
    sample_rate: int = 16000,
    window_size: float = 0.025,
    window_stride: float = 0.01,
    window: str = "hamming",
    normalize: bool = True,
) -> torch.Tensor:
    """(num_samples,) -> (T, n_fft//2 + 1) log1p magnitude spectrogram on
    waveform's device; T = 1 + (num_samples - n_fft) // hop (at least 1,
    a short waveform's frame repeating its last sample), normalized by the
    utterance's own mean and (population) standard deviation."""
    n_fft = int(sample_rate * window_size)
    hop = int(sample_rate * window_stride)
    n = waveform.shape[0]
    t = 1 + max(0, (n - n_fft)) // hop
    device = waveform.device
    idx = (torch.arange(t, device=device)[:, None] * hop
           + torch.arange(n_fft, device=device)[None, :])
    frames = waveform.float()[idx.clamp(0, n - 1)]
    cfg = FbankConfig(sample_rate=sample_rate,
                      frame_length_ms=window_size * 1000.0,
                      window_type=window)
    frames = frames * torch.from_numpy(_window_function(cfg)).to(device)

    padded = 1
    while padded < n_fft:
        padded *= 2
    nbins = padded // 2 + 1
    k = np.arange(padded)[:, None]
    f = np.arange(nbins)[None, :]
    ang = 2.0 * np.pi * k * f / padded
    dft = torch.from_numpy(np.concatenate(
        [np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)).to(device)

    frames = torch.nn.functional.pad(frames, (0, padded - n_fft))
    spec = torch.matmul(frames, dft)
    out = torch.log1p(torch.sqrt(spec[:, :nbins] ** 2 + spec[:, nbins:] ** 2))
    if normalize:
        out = (out - out.mean()) / torch.clamp(out.std(correction=0),
                                               min=1e-8)
    return out


def mel_warp(spec: torch.Tensor, sample_rate: int = 16000,
             window_size: float = 0.025) -> torch.Tensor:
    """Resample a (T, n_bins) linear-frequency log spectrogram onto the mel
    scale by linear interpolation between fft bins (the reference's
    utils/tools.F_Mel, librosa.mel_frequencies semantics) -> (T, n_bins)."""
    spec = torch.as_tensor(spec)
    n_mels = spec.shape[1]
    max_mel = 2595.0 * np.log10(1.0 + sample_rate / 2.0 / 700.0)
    freqs = 700.0 * (10.0 ** (np.linspace(0.0, max_mel, n_mels) / 2595.0)
                     - 1.0)
    mel_bin = freqs * window_size           # fractional fft-bin index
    left = np.floor(mel_bin).astype(np.int64)
    right = torch.from_numpy(np.clip(left + 1, 0, n_mels - 1)).to(spec.device)
    frac = torch.from_numpy((mel_bin - left).astype(np.float32)).to(
        spec.device)
    left = torch.from_numpy(np.clip(left, 0, n_mels - 1)).to(spec.device)
    return (spec[:, right] - spec[:, left]) * frac + spec[:, left]


def make_spectrum(wav_scp: str, ark_file: str, scp_file: str, log=print,
                  device: str | torch.device = "cuda") -> int:
    """wav.scp -> normalized spectrogram ark/scp (the reference's
    make_spectrum.py); returns the utterance count."""
    n = 0
    with kaldi_io.ArkScpWriter(ark_file, scp_file) as w:
        with open(wav_scp, "r", encoding="utf-8") as f:
            for line in f:
                utt, path = line.strip().split(maxsplit=1)
                data, sr = read_audio(path)
                if data.ndim > 1:
                    data = data.mean(axis=1)
                if sr != 16000:
                    data = resample(data, sr, 16000)
                wav = torch.from_numpy(np.asarray(data, np.float32)).to(device)
                with torch.inference_mode():
                    w.write(utt, compute_spectrogram(wav).cpu().numpy())
                n += 1
                if n % 10 == 0:
                    log(f"Processed {n} sentences...")
    log(f"Done. Processed {n} sentences...")
    return n
