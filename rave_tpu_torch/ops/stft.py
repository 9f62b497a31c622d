"""Short-time Fourier transform with the JAX package's conventions.

Port of ``hann_window``, ``stft``, ``mel_filterbank`` and
``multiscale_stft`` in ``rave_tpu/ops/stft.py``.  The FFT itself is
``torch.stft`` (cuFFT on the card), as the JAX package leaves it to XLA
outside any Pallas kernel. The layout at the boundary stays the JAX
package's: time-major ``(..., frames, n_fft // 2 + 1)``. The JAX
package's hand-written VJP of its framing is a TPU lowering workaround;
here autograd differentiates ``torch.stft``. A bf16 signal takes the
JAX package's route: the frames are windowed in bf16 and the FFT runs
on them widened to float32 (``torch.stft`` takes no bf16).
``mel_filterbank`` is a
numpy copy, read by the data pipeline's mel-k-means units, the
mel-scaled spectral distances (``num_mels``) and the hybrid encoder's
mel front end.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=None)
def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann, matching ``torch.hann_window`` defaults."""
    n = np.arange(win_length)
    return (0.5 * (1 - np.cos(2 * np.pi * n / win_length))).astype(np.float32)


@lru_cache(maxsize=None)
def _window(n_fft: int, win_length: int, device: torch.device) -> torch.Tensor:
    """The Hann window of ``win_length`` centred with zeros in ``n_fft``
    (the JAX package's padding), kept on ``device``; read-only."""
    win = hann_window(win_length)
    lp = (n_fft - win_length) // 2
    return _constant(np.pad(win, (lp, n_fft - win_length - lp)), device)


def _constant(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` as a tensor on ``device`` for a module-level cache: made
    outside inference mode, so that a first call under
    ``torch.inference_mode`` does not cache an inference tensor, which
    autograd may not save."""
    with torch.inference_mode(False):
        return torch.from_numpy(a).to(device)


def _reflect_index(T: int, pad: int) -> np.ndarray:
    """Source index of each sample of a signal of ``T`` samples padded
    by ``pad`` on both sides in numpy's (and ``jnp.pad``'s) ``reflect``
    mode, which reflects again and again where ``pad >= T``: a
    triangle wave of period ``2 (T - 1)``."""
    i = np.arange(-pad, T + pad)
    if T == 1:
        return np.zeros_like(i)
    period = 2 * (T - 1)
    i = i % period
    return np.where(i < T, i, period - i)


def _pad_reflect(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``(N, T)`` padded by ``pad`` on both sides in numpy's reflect
    mode; ``F.pad`` where it agrees (it raises where ``pad >= T``)."""
    T = x.shape[-1]
    if pad < T:
        return F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    idx = torch.from_numpy(_reflect_index(T, pad)).to(x.device)
    return x[:, idx]


def stft(x: torch.Tensor, n_fft: int, hop_length: int,
         win_length: Optional[int] = None, center: bool = True,
         pad_mode: str = "reflect", normalized: bool = False) -> torch.Tensor:
    """Complex STFT, ``x (..., T)`` -> ``(..., n_frames, n_fft // 2 + 1)``.

    ``center`` pads ``n_fft // 2`` on both sides with ``pad_mode``
    (``reflect`` as numpy reflects, also where the pad is at least the
    signal's length); frame ``k`` starts at ``k * hop_length``; the
    window is the periodic Hann of ``win_length`` zero-padded to
    ``n_fft`` in the middle.
    """
    win_length = win_length or n_fft
    window = _window(n_fft, win_length, x.device).to(x.dtype)
    lead, T = x.shape[:-1], x.shape[-1]
    flat = x.reshape(-1, T)
    if center:
        pad = n_fft // 2
        flat = (_pad_reflect(flat, pad) if pad_mode == "reflect" else
                F.pad(flat[:, None], (pad, pad), mode=pad_mode)[:, 0])
    if flat.shape[-1] < n_fft:
        raise ValueError(f"signal length {flat.shape[-1]} shorter than "
                         f"frame {n_fft}")
    if x.dtype == torch.bfloat16:
        return _stft_bf16(flat, window, hop_length, normalized).reshape(
            *lead, -1, n_fft // 2 + 1)
    spec = torch.stft(flat, n_fft, hop_length, n_fft, window, center=False,
                      normalized=False, onesided=True, return_complex=True)
    if normalized:
        spec = spec / torch.sqrt(torch.sum(window * window))
    return spec.transpose(-1, -2).reshape(*lead, spec.shape[-1],
                                          spec.shape[-2])


def _stft_bf16(flat: torch.Tensor, window: torch.Tensor, hop_length: int,
               normalized: bool) -> torch.Tensor:
    """The JAX package's STFT of a bf16 signal ``(N, T)`` (padded):
    frames windowed in bf16 (each product rounded to bf16), ``rfft`` of
    the frames widened to float32, ``normalized`` dividing by the float32
    root of the bf16 window's squared sum.  The framing runs on a float32
    view, so that its gradient sums the overlapping frames in float32
    and rounds once, as the JAX package's overlap-add does."""
    frames = flat.float().unfold(-1, window.shape[0], hop_length)
    frames = frames.to(torch.bfloat16) * window
    spec = torch.fft.rfft(frames.float(), dim=-1)
    if normalized:
        spec = spec / torch.sqrt(torch.sum(window.float() ** 2))
    return spec


@lru_cache(maxsize=None)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: Optional[float] = None,
                   htk: bool = False,
                   norm: Optional[str] = "slaney") -> np.ndarray:
    """Mel filterbank, (n_mels, n_fft//2+1).

    Defaults reimplement ``librosa.filters.mel`` (slaney scale + slaney
    norm), used by the reference ``MelScale`` (``rave/core.py:264-275``).
    ``htk=True, norm=None`` gives the ``torchaudio.transforms
    .MelSpectrogram`` defaults the reference's hybrid front end uses
    (``configs/hybrid.gin`` sets neither, so torchaudio's htk/no-norm
    defaults apply).
    """
    fmax = fmax or sample_rate / 2

    if htk:
        def hz_to_mel(f):
            return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

        def mel_to_hz(m):
            return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)
    else:
        def hz_to_mel(f):
            f = np.asarray(f, dtype=np.float64)
            mel = f / (200.0 / 3)
            min_log_hz = 1000.0
            min_log_mel = min_log_hz / (200.0 / 3)
            logstep = np.log(6.4) / 27.0
            return np.where(f >= min_log_hz,
                            min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                            mel)

        def mel_to_hz(m):
            m = np.asarray(m, dtype=np.float64)
            f = m * (200.0 / 3)
            min_log_hz = 1000.0
            min_log_mel = min_log_hz / (200.0 / 3)
            logstep = np.log(6.4) / 27.0
            return np.where(m >= min_log_mel,
                            min_log_hz * np.exp(logstep * (m - min_log_mel)), f)

    fftfreqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    weights = np.maximum(
        0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    if norm == "slaney":
        enorm = 2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels])
        weights *= enorm[:, None]
    return weights.astype(np.float32)


def multiscale_stft(x: torch.Tensor, scales: Sequence[int],
                    magnitude: bool = True, normalized: bool = False,
                    sample_rate: int = 44100,
                    num_mels: Optional[int] = None) -> list[torch.Tensor]:
    """One centred STFT per scale ``s`` (``n_fft = s``, hop ``s // 4``),
    its magnitude unless ``magnitude`` is false; with ``num_mels``, the
    magnitude times the librosa (slaney scale, slaney norm) mel basis of
    ``sample_rate``, ``(..., frames, num_mels)``.  ``x`` is ``(B, T)`` or
    channels-first ``(B, C, T)``, taken as ``B * C`` signals in that
    order (the JAX package's ``(B, T, C)`` transposed)."""
    x = x.reshape(-1, x.shape[-1])
    out = []
    for scale in scales:
        s = stft(x, scale, scale // 4, normalized=normalized)
        if num_mels is not None:
            out.append(s.abs() @ mel_matrix(sample_rate, scale, num_mels,
                                            x.device).T)
            continue
        out.append(s.abs() if magnitude else s)
    return out


@lru_cache(maxsize=None)
def mel_matrix(sample_rate: int, n_fft: int, n_mels: int,
               device: torch.device, htk: bool = False,
               norm: Optional[str] = "slaney") -> torch.Tensor:
    """:func:`mel_filterbank` as a float32 tensor on ``device``;
    read-only."""
    return _constant(mel_filterbank(sample_rate, n_fft, n_mels, htk=htk,
                                    norm=norm), device)
