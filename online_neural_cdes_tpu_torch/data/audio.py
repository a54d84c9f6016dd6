"""MFCC features as torch functions on an explicit device.

Counterpart of the JAX package's ``data/audio.py`` (numpy on the host),
with torchaudio's ``MFCC(log_mels=True, melkwargs=dict(n_fft=360,
n_mels=32), n_mfcc=10)`` conventions: a center-padded reflect STFT with a
periodic Hann window (``torch.stft`` with torchaudio ``Spectrogram``'s
arguments), the power spectrogram, the HTK mel filterbank without
normalisation, natural-log mels (``log(mel + 1e-6)``) and the orthonormal
DCT-II as a product.  SpeechCommands holds ~35k clips of 16,000 samples,
so the work runs on the card unless ``device="cpu"`` is asked for; it runs
in float64 by default, as the JAX module does, and returns float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from online_neural_cdes_tpu_torch.utils.device import resolve_device

__all__ = ["mfcc", "mel_filterbank"]


def _hz_to_mel(f):
    return 2595.0 * math.log10(1.0 + f / 700.0)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                   f_min: float = 0.0, f_max: Optional[float] = None, *,
                   device=None, dtype=torch.float64) -> torch.Tensor:
    """(n_freqs, n_mels) triangular HTK filterbank (torchaudio's
    ``melscale_fbanks`` without normalisation) on ``device``."""
    device = resolve_device(device)
    f_max = f_max or sample_rate / 2.0
    all_freqs = torch.linspace(0.0, sample_rate / 2.0, n_freqs, dtype=dtype, device=device)
    mel_pts = torch.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2,
                             dtype=dtype, device=device)
    f_pts = 700.0 * (10.0 ** (mel_pts / 2595.0) - 1.0)
    f_diff = f_pts.diff()
    slopes = f_pts[None, :] - all_freqs[:, None]           # (n_freqs, n_mels+2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return torch.clamp_min(torch.minimum(down, up), 0.0)


def _stft_power(audio: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Center-padded (reflect) periodic-Hann power spectrogram, torchaudio
    ``Spectrogram(power=2)``'s call of ``torch.stft``.
    audio: (..., T) -> (..., n_fft//2+1, frames)."""
    lead = audio.shape[:-1]
    window = torch.hann_window(n_fft, periodic=True, dtype=audio.dtype, device=audio.device)
    spec = torch.stft(audio.reshape(-1, audio.shape[-1]), n_fft=n_fft, hop_length=hop,
                      win_length=n_fft, window=window, center=True, pad_mode="reflect",
                      normalized=False, onesided=True, return_complex=True)
    power = spec.abs() ** 2
    return power.reshape(lead + power.shape[-2:])


def _dct2_ortho(n_mfcc: int, n_mels: int, *, device=None, dtype=torch.float64) -> torch.Tensor:
    """(n_mfcc, n_mels) orthonormal DCT-II basis."""
    device = resolve_device(device)
    k = torch.arange(n_mfcc, dtype=dtype, device=device)[:, None]
    n = torch.arange(n_mels, dtype=dtype, device=device)[None, :]
    basis = torch.cos(math.pi / n_mels * (n + 0.5) * k)
    basis[0] *= 1.0 / math.sqrt(2.0)
    return basis * math.sqrt(2.0 / n_mels)


def _features(audio, sample_rate, n_fft, hop, n_mels, n_mfcc, log_mels, device, dtype):
    """The cepstra (..., n_mfcc, frames) at ``dtype`` on ``device``."""
    device = resolve_device(device)
    audio = torch.as_tensor(audio).to(device=device, dtype=dtype)
    power = _stft_power(audio, n_fft, hop)
    fb = mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, device=device, dtype=dtype)
    mels = torch.einsum("...ft,fm->...mt", power, fb)
    if log_mels:
        feats = torch.log(mels + 1e-6)
    else:
        # torchaudio's amplitude_to_db path (top_db=80 clamp omitted).
        feats = 10.0 * torch.log10(torch.clamp_min(mels, 1e-10))
    return torch.einsum("km,...mt->...kt", _dct2_ortho(n_mfcc, n_mels, device=device,
                                                       dtype=dtype), feats)


def mfcc(audio, sample_rate: int = 16000, n_fft: int = 360, hop: Optional[int] = None,
         n_mels: int = 32, n_mfcc: int = 10, log_mels: bool = True, *,
         device=None, dtype=torch.float64) -> torch.Tensor:
    """audio (..., T) (a numpy array or a tensor) -> MFCC (..., frames,
    n_mfcc) float32 on ``device`` (the card unless ``"cpu"`` is asked
    for), computed at ``dtype``.  ``n_fft=360`` and the default hop of
    ``n_fft // 2`` give 89 frames of a one-second 16 kHz clip."""
    hop = hop or n_fft // 2
    out = _features(audio, sample_rate, n_fft, hop, n_mels, n_mfcc, log_mels, device, dtype)
    return out.transpose(-2, -1).to(torch.float32)
