"""Pitch (f0) estimation and the decoder's f0 conditioning feature.

Port of ``rave_tpu/ops/pitch.py``: the batched YIN of the fork's serving
path (FFT autocorrelation, the cumulative-mean-normalised difference and
the descent to the local minimum, all vectorised), the per-item voiced
log-f0 statistics, and the normalised-f0 feature appended to the decoder
latent (the fork's ``myforward`` composition).  The FFTs are
``torch.fft`` (cuFFT on the card), as the JAX package leaves them to XLA
outside any Pallas kernel.

``f0_norm_feature`` resamples with ``jax.image.resize(..., "linear")``'s
semantics, which antialias when they shrink (127 f0 frames become 64
latent frames at 131072 samples): ``F.interpolate``'s bilinear mode with
``antialias=True`` on a one-row image is the same filter; plain
``mode="linear"`` is not.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEUTRAL_LOG_F0 = math.log(160.0)   # the median of an all-unvoiced item


def yin_f0(x: torch.Tensor, sr: int, frame_length: int = 2048,
           hop: int = 1024, fmin: float = 50.0, fmax: float = 550.0,
           threshold: float = 0.1) -> torch.Tensor:
    """Batched YIN f0: audio ``(B, T)`` -> ``(B, n_frames)`` in Hz, 0
    where unvoiced.  A signal shorter than one frame is zero-padded to
    one; frame ``k`` starts at ``k * hop``."""
    B, T = x.shape
    if T < frame_length:
        x = F.pad(x, (0, frame_length - T))
    frames = x.float().unfold(-1, frame_length, hop)        # (B, n, L)
    n = frames.shape[1]
    w = frame_length // 2

    # the difference function d(tau) by FFT autocorrelation
    spec = torch.fft.rfft(frames, 2 * frame_length, dim=-1)
    acf = torch.fft.irfft(spec * spec.conj(), dim=-1)[..., :w]
    # d(tau) = E[0..L-tau-1] + E[tau..L-1] - 2 corr(tau)
    energy = torch.cumsum(frames * frames, dim=-1)
    e0 = energy[..., -1:]
    e_tau = e0 - torch.cat([frames.new_zeros(B, n, 1),
                            energy[..., :w - 1]], dim=-1)
    e_first = torch.flip(energy, dims=(-1,))[..., :w]
    d = e_first + e_tau - 2 * acf

    # cumulative mean normalisation
    tau = torch.arange(1, w, dtype=frames.dtype, device=frames.device)
    cmdf = d[..., 1:] * tau / (torch.cumsum(d[..., 1:], dim=-1) + 1e-9)
    cmdf = torch.cat([frames.new_ones(B, n, 1), cmdf], dim=-1)   # (B, n, w)

    tau_min = int(sr / fmax)
    tau_max = min(int(sr / fmin), w - 1)
    search = cmdf[..., tau_min:tau_max]                    # (B, n, S)
    S = search.shape[-1]
    below = search < threshold
    # argmax of an integer mask: the first index where it holds
    first = torch.where(below.any(-1), torch.argmax(below.int(), dim=-1),
                        torch.argmin(search, dim=-1))      # (B, n)

    # descend to the local minimum: the first j >= first whose slope is
    # not negative
    slope_up = torch.cat([torch.diff(search, dim=-1) >= 0,
                          below.new_ones(B, n, 1)], dim=-1)
    at_or_after = (torch.arange(S, device=x.device)[None, None, :]
                   >= first[..., None])
    sel = torch.argmax((at_or_after & slope_up).int(), dim=-1)

    val = torch.gather(search, -1, sel[..., None])[..., 0]
    voiced = val < threshold
    tau_est = sel + tau_min

    # parabolic interpolation around the minimum, on the full cmdf
    t0 = torch.clamp(tau_est, 1, w - 2)[..., None]
    d0 = torch.gather(cmdf, -1, t0 - 1)[..., 0]
    d1 = torch.gather(cmdf, -1, t0)[..., 0]
    d2 = torch.gather(cmdf, -1, t0 + 1)[..., 0]
    denom = 2 * (d0 - 2 * d1 + d2)
    delta = torch.where(denom.abs() > 1e-12, (d0 - d2) / (denom + 1e-12),
                        torch.zeros_like(denom))
    tau_ref = t0[..., 0] + torch.clamp(delta, -1, 1)
    return torch.where(voiced, sr / torch.clamp(tau_ref, min=1e-6),
                       torch.zeros_like(tau_ref))


def voiced_log_stats(f0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-item ``(median, std)`` of log-f0 over the voiced frames of
    ``f0`` ``(B, n)`` -> ``((B,), (B,))``: the lower median (the voiced
    values sorted, unvoiced ones as ``inf`` at the end) and the biased
    std.  An all-unvoiced item gets ``log 160``; fewer than two voiced
    frames give std 1."""
    voiced = f0 > 0
    cnt = voiced.sum(-1)
    log_f0 = torch.log(torch.clamp(f0, min=1e-6))
    srt = torch.sort(torch.where(voiced, log_f0,
                                 torch.full_like(f0, math.inf)), dim=-1)[0]
    mid = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"),
                      0, f0.shape[-1] - 1)
    med = torch.gather(srt, -1, mid[:, None])[:, 0]
    med = torch.where(cnt > 0, med, torch.full_like(med, NEUTRAL_LOG_F0))
    lf0v = torch.where(voiced, log_f0, torch.zeros_like(f0))
    n = torch.clamp(cnt, min=1).to(f0.dtype)
    mean = torch.where(cnt > 0, lf0v.sum(-1) / n, med)
    var = torch.where(voiced, (lf0v - mean[:, None]) ** 2,
                      torch.zeros_like(f0)).sum(-1) / n
    std = torch.where(cnt > 1, torch.sqrt(var), torch.ones_like(var))
    return med, std


def resize_linear(a: torch.Tensor, size: int) -> torch.Tensor:
    """``(B, n)`` -> ``(B, size)``: ``jax.image.resize(a, (B, size),
    "linear")``, half-pixel centres, antialiased when it shrinks."""
    if a.shape[-1] == size:
        return a
    return F.interpolate(a[:, None, None], size=(1, size), mode="bilinear",
                         align_corners=False, antialias=True)[:, 0, 0]


def f0_norm_feature(f0: torch.Tensor, median: torch.Tensor,
                    std: torch.Tensor, out_frames: int,
                    channels: int = 1) -> torch.Tensor:
    """The normalised-f0 feature at the latent frame rate: voiced frames
    of ``f0`` ``(B, n)`` z-scored in log space by ``median``/``std``
    ``(B,)``, unvoiced ones 0, resampled to ``out_frames`` as
    :func:`resize_linear` does -> ``(B, out_frames, channels)``."""
    voiced = f0 > 0
    log_f0 = torch.log(torch.clamp(f0, min=1e-6))
    feat = torch.where(voiced, (log_f0 - median[:, None])
                       / (std[:, None] + 1e-6), torch.zeros_like(f0))
    feat = resize_linear(feat, out_frames).float()[..., None]
    return feat.expand(-1, -1, channels) if channels > 1 else feat


def pitch_feature(x: torch.Tensor, out_frames: int, sr: int,
                  hop: int = 1024, fmin: float = 50.0, fmax: float = 550.0,
                  median: Optional[torch.Tensor] = None,
                  std: Optional[torch.Tensor] = None, channels: int = 1,
                  estimator: str = "yin", fcpe_ckpt: str = ""
                  ) -> torch.Tensor:
    """Audio ``(B, T, 1)`` -> the decoder's pitch conditioning
    ``(B, out_frames, channels)``: f0, normalised by ``median``/``std``
    (speaker statistics) or, where they are not given, by the item's own
    :func:`voiced_log_stats`.

    ``estimator="fcpe"`` with a torchfcpe checkpoint at ``fcpe_ckpt``
    takes f0 from the FCPE network (on ``x``'s device) at one frame per
    ``hop`` samples; without one (an empty or missing path, the latter
    warned about once) it is YIN, as in the JAX package."""
    f0 = None
    if estimator == "fcpe":
        from ..models.pitch_fcpe import fcpe_f0, get_fcpe
        model = get_fcpe(fcpe_ckpt, x.device)
        if model is not None:
            f0 = fcpe_f0(model, x[..., 0], sr,
                         out_frames=max(1, x.shape[1] // hop),
                         fmin=fmin, fmax=fmax)
    if f0 is None:
        f0 = yin_f0(x[..., 0], sr, hop=hop, fmin=fmin, fmax=fmax)
    if median is None or std is None:
        med_u, std_u = voiced_log_stats(f0)
        median = med_u if median is None else median
        std = std_u if std is None else std
    return f0_norm_feature(f0, median, std, out_frames, channels)
