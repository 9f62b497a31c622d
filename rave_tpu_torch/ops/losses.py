"""Audio distances and GAN losses of the train steps, and the filtered-
noise helpers of the noise generators.

Port of ``rave_tpu/ops/losses.py``: ``mod_sigmoid``, ``mean_difference``,
``audio_distance_v1`` (linear or mel-scaled), ``mr_stft_resolutions``,
``multi_resolution_stft_loss``, ``spectral_distance``,
``encodec_audio_distance``, ``weighted_instantaneous_spectral_distance``,
the GAN objectives, ``amp_to_impulse_response`` and ``fft_convolve``.
The KL schedules (``get_beta_kl`` and its cyclic forms) live with the
other schedules in :mod:`rave_tpu_torch.train.schedules`.  Means
accumulate in float32.
The JAX package's packed spectral features (``valid_frac``) have no
counterpart here: the port's discriminators return native feature maps,
whose plain means are what the packed ones correct to.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from ..parallel import mesh
from .precision import sigmoid, weak
from .stft import mel_matrix, multiscale_stft, stft


def mod_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``2 sigmoid(x)^2.3 + 1e-7`` (in bf16 with the constants rounded
    to bf16 and :func:`~rave_tpu_torch.ops.precision.sigmoid`, as JAX
    computes it)."""
    return 2 * sigmoid(x) ** weak(2.3, x) + weak(1e-7, x)


def mean_difference(target: torch.Tensor, value: torch.Tensor,
                    norm: str = "L1", relative: bool = False) -> torch.Tensor:
    """Mean L1 or L2 distance, optionally relative to the target's mean
    magnitude."""
    diff = target - value
    # a ratio of means couples the rows: under a process group both are
    # the global batch's (a plain mean is linear in the rows)
    mean = mesh.global_mean if relative else torch.Tensor.mean
    if norm == "L1":
        d = mean(diff.abs(), dtype=torch.float32)
        if relative:
            return d / mean(target.abs(), dtype=torch.float32)
        return d
    if norm == "L2":
        d = mean(diff * diff, dtype=torch.float32)
        if relative:
            return d / mean(target * target, dtype=torch.float32)
        return d
    raise ValueError(f"norm must be L1 or L2, got {norm}")


def audio_distance_v1(x: torch.Tensor, y: torch.Tensor,
                      scales: Sequence[int] = (2048, 1024, 512, 256, 128),
                      log_epsilon: float = 1e-7, sample_rate: int = 44100,
                      num_mels: Optional[int] = None) -> torch.Tensor:
    """Per scale, the relative L2 distance of the STFT magnitudes (mel-
    scaled with ``num_mels``, :func:`~rave_tpu_torch.ops.stft.
    multiscale_stft`) plus the L1 distance of their
    ``log(. + log_epsilon)``, summed over the scales.  ``x``, ``y``:
    ``(B, T)`` or channels-first ``(B, C, T)``."""
    total = x.new_zeros((), dtype=torch.float32)
    for a, b in zip(multiscale_stft(x, scales, sample_rate=sample_rate,
                                    num_mels=num_mels),
                    multiscale_stft(y, scales, sample_rate=sample_rate,
                                    num_mels=num_mels)):
        total = total + mean_difference(a, b, "L2", relative=True)
        total = total + mean_difference(torch.log(a + log_epsilon),
                                        torch.log(b + log_epsilon), "L1")
    return total


def mr_stft_resolutions(sample_rate: int = 44100,
                        specs_ms: Sequence[tuple] = ((5, 25), (10, 50), (2, 10))
                        ) -> list[tuple[int, int, int]]:
    """``(n_fft, hop, win)`` triples from ``(hop_ms, win_ms)`` pairs."""
    out = []
    for hop_ms, win_ms in specs_ms:
        hop = int(0.001 * hop_ms * sample_rate)
        win = int(0.001 * win_ms * sample_rate)
        n_fft = int(math.pow(2, int(math.log2(win)) + 1))
        out.append((n_fft, hop, win))
    return out


def _stft_mag(x: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    s = stft(x, n_fft, hop, win_length=win)
    # |s|^2 clipped at 1e-7 before the root
    return torch.sqrt(torch.clamp(s.real.square() + s.imag.square(), min=1e-7))


def _batch_norm2(t: torch.Tensor) -> torch.Tensor:
    """The 2-norm of ``t`` flattened, rows included: over the global batch
    under a process group."""
    if not mesh.batch_sharded():
        return torch.linalg.vector_norm(t)
    return torch.sqrt(mesh.all_reduce_sum((t * t).sum()))


def multi_resolution_stft_loss(x: torch.Tensor, y: torch.Tensor,
                               resolutions: Sequence[tuple[int, int, int]]
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Spectral convergence and log-magnitude L1, each averaged over the
    resolutions.  ``x``, ``y``: ``(B, T)``.  The convergence is the
    2-norm of the whole flattened difference, batch included, over that
    of ``y``."""
    sc = x.new_zeros(())
    mag = x.new_zeros(())
    for n_fft, hop, win in resolutions:
        xm = _stft_mag(x, n_fft, hop, win)
        ym = _stft_mag(y, n_fft, hop, win)
        sc = sc + _batch_norm2(ym - xm) / _batch_norm2(ym)
        mag = mag + torch.mean(torch.abs(torch.log(ym) - torch.log(xm)))
    n = len(resolutions)
    return sc / n, mag / n


def _mono(x: torch.Tensor) -> torch.Tensor:
    """Audio ``(B, T, 1)`` -> ``(B, T)``; ``(B, T)`` as it is."""
    return x[..., 0] if x.dim() == 3 else x


def spectral_distance(x: torch.Tensor, y: torch.Tensor, n_fft: int,
                      sample_rate: int = 44100,
                      norms: Sequence[str] = ("L1",),
                      power: Optional[float] = 1.0,
                      mel: Optional[int] = None) -> torch.Tensor:
    """Single-scale (mel-)spectrogram distance: the magnitude of an
    uncentred STFT (hop ``n_fft // 4``), times the librosa mel basis with
    ``mel`` bands, to the ``power``, then the sum over ``norms`` of
    :func:`mean_difference` with ``y``'s as the target.  ``x``, ``y``:
    ``(B, T)``."""

    def spec(a):
        s = stft(a, n_fft, n_fft // 4, center=False).abs()
        if mel:
            s = s @ mel_matrix(sample_rate, n_fft, mel, a.device).T
        if power is not None and power != 1.0:
            s = s ** power
        return s

    sx, sy = spec(x), spec(y)
    total = x.new_zeros((), dtype=torch.float32)
    for norm in norms:
        total = total + mean_difference(sy, sx, norm)
    return total


def encodec_audio_distance(x: torch.Tensor, y: torch.Tensor,
                           scales: Sequence[int] = (32, 64, 128, 256, 512,
                                                    1024, 2048),
                           sample_rate: int = 44100,
                           mel: Optional[int] = None) -> dict:
    """The L1 waveform distance and the sum over ``scales`` of
    :func:`spectral_distance` with norms L1 and L2.  ``x``, ``y``:
    ``(B, T)`` or audio ``(B, T, 1)``."""
    x, y = _mono(x), _mono(y)
    spec = x.new_zeros((), dtype=torch.float32)
    for s in scales:
        spec = spec + spectral_distance(x, y, s, sample_rate,
                                        norms=("L1", "L2"), mel=mel)
    return {"waveform_distance": mean_difference(y, x, "L1"),
            "spectral_distance": spec}


def _instantaneous_frequency(phase: torch.Tensor) -> torch.Tensor:
    """The phase's derivative along the last (frequency) axis, each step
    wrapped into [-pi, pi), cumulated, then differenced once more."""
    d = phase[..., 1:] - phase[..., :-1]
    d = torch.remainder(d + math.pi, 2 * math.pi) - math.pi
    unwrapped = torch.cumsum(d, dim=-1)
    return unwrapped[..., 1:] - unwrapped[..., :-1]


def weighted_instantaneous_spectral_distance(
        x: torch.Tensor, y: torch.Tensor,
        scales: Sequence[int] = (2048, 1024, 512, 256, 128),
        weighted: bool = False) -> dict:
    """Per scale of a complex multi-scale STFT: the relative L2 distance
    of the magnitudes plus the L1 distance of their ``log1p``
    (``spectral_distance``), and the L2 distance of the instantaneous
    frequencies, each weighted with ``weighted`` by
    ``clip(log1p(|x|), 0, 1)`` (``phase_distance``).  ``x``, ``y``:
    ``(B, T)`` or audio ``(B, T, C)``, as in the JAX package."""
    if x.dim() == 3:
        x, y = x.transpose(1, 2), y.transpose(1, 2)
    spec = x.new_zeros((), dtype=torch.float32)
    phase = x.new_zeros((), dtype=torch.float32)
    for a, b in zip(multiscale_stft(x, scales, magnitude=False),
                    multiscale_stft(y, scales, magnitude=False)):
        aa, ba = a.abs(), b.abs()
        spec = spec + mean_difference(aa, ba, "L2", relative=True)
        spec = spec + mean_difference(torch.log1p(aa), torch.log1p(ba), "L1")
        ia = _instantaneous_frequency(torch.angle(a))
        ib = _instantaneous_frequency(torch.angle(b))
        if weighted:
            mask = torch.clamp(torch.log1p(aa[..., 2:]), 0.0, 1.0)
            ia, ib = ia * mask, ib * mask
        phase = phase + mean_difference(ia, ib, "L2")
    return {"spectral_distance": spec, "phase_distance": phase}


def hinge_gan(score_real, score_fake):
    loss_dis = torch.mean(F.relu(1 - score_real) + F.relu(1 + score_fake))
    loss_gen = -torch.mean(score_fake)
    return loss_dis, loss_gen


def ls_gan(score_real, score_fake):
    loss_dis = torch.mean((score_real - 1) ** 2 + score_fake ** 2)
    loss_gen = torch.mean((score_fake - 1) ** 2)
    return loss_dis, loss_gen


def nonsaturating_gan(score_real, score_fake):
    sr = torch.clamp(torch.sigmoid(score_real), 1e-7, 1 - 1e-7)
    sf = torch.clamp(torch.sigmoid(score_fake), 1e-7, 1 - 1e-7)
    loss_dis = -torch.mean(torch.log(sr) + torch.log(1 - sf))
    loss_gen = -torch.mean(torch.log(sf))
    return loss_dis, loss_gen


GAN_LOSSES: dict[str, Callable] = {
    "hinge": hinge_gan,
    "ls": ls_gan,
    "nonsaturating": nonsaturating_gan,
}


def amp_to_impulse_response(amp: torch.Tensor,
                            target_size: int) -> torch.Tensor:
    """Band amplitudes ``(..., bands)`` -> a windowed impulse response
    ``(..., target_size)``: the inverse real FFT of the amplitudes as
    zero-phase spectra, centred, times a symmetric Hann window, padded
    to ``target_size`` and rolled back so that it starts at 0."""
    ir = torch.fft.irfft(amp.to(torch.complex64), dim=-1)
    n = ir.shape[-1]
    ir = torch.roll(ir, n // 2, dims=-1)
    win = 0.5 * (1 - torch.cos(2 * math.pi * torch.arange(
        n, device=ir.device, dtype=ir.dtype) / (n - 1)))
    ir = F.pad(ir * win, (0, int(target_size) - n))
    return torch.roll(ir, -n // 2, dims=-1)


def fft_convolve(signal: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Linear convolution of ``signal`` with ``kernel`` on the last axis
    (both of length ``T``) by FFT: the signal zero-padded on the right,
    the kernel on the left, the second half of the circular result."""
    T = signal.shape[-1]
    signal = F.pad(signal, (0, T))
    kernel = F.pad(kernel, (kernel.shape[-1], 0))
    out = torch.fft.irfft(torch.fft.rfft(signal) * torch.fft.rfft(kernel),
                          n=signal.shape[-1])
    return out[..., out.shape[-1] // 2:]
