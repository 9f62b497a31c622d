"""The FCPE neural pitch estimator (torchfcpe's CFNaiveMelPE).

Port of ``rave_tpu/models/pitch_fcpe.py``: 16 kHz audio, a 128-band
log-mel front end (n_fft 1024, hop 160), a conv input stack, six
conv-only conformer layers (LayerNorm, pointwise 512 -> 2048 with GLU,
depthwise k = 31, swish, pointwise 1024 -> 512) and a LayerNorm and
linear head to 360 cent bins with sigmoid confidences, decoded by the
local argmax over cents with an unvoiced threshold.  The network is
frozen (inference only); its convs, norms and matmuls are plain PyTorch,
as the JAX package computes them outside any Pallas kernel.

``load_fcpe_checkpoint`` reads a torchfcpe checkpoint strictly (every key
present, every shape exact, nothing left over but the unused per-layer
norms) without importing ``torchfcpe``; ``get_fcpe`` loads one once per
process and path.  ``resample_to`` is the estimator's own polyphase
resampler (a Kaiser-windowed sinc, beta 8, 32 taps per phase), not
:mod:`~rave_tpu_torch.ops.resampler`.
"""

from __future__ import annotations

import os
import warnings
from math import gcd
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..ops.pitch import resize_linear
from ..ops.stft import _pad_reflect, hann_window, mel_filterbank

# fcpe_c_v001 model constants
SR = 16000
N_MELS = 128
N_FFT = 1024
WIN = 1024
HOP = 160
F0_MIN = 32.70
F0_MAX = 1975.5
OUT_DIMS = 360
HIDDEN = 512
N_LAYERS = 6
KERNEL = 31
EXPANSION = 2
INNER = HIDDEN * EXPANSION


def f0_to_cent(f0):
    return 1200.0 * np.log2(f0 / 10.0)


def cent_to_f0(cent: torch.Tensor) -> torch.Tensor:
    return 10.0 * 2.0 ** (cent / 1200.0)


def cent_table() -> np.ndarray:
    """The 360 bins' cents, ``F0_MIN`` to ``F0_MAX``, float32."""
    return np.linspace(f0_to_cent(F0_MIN), f0_to_cent(F0_MAX),
                       OUT_DIMS).astype(np.float32)


class ConformerConv(nn.Module):
    """``x + pw2(swish(dw(glu(pw1(ln(x))))))`` on ``(B, T, C)``."""

    def __init__(self):
        super().__init__()
        self.ln = nn.LayerNorm(HIDDEN, eps=1e-5)
        self.pw1 = nn.Linear(HIDDEN, 2 * INNER)
        self.dw = nn.Conv1d(INNER, INNER, KERNEL, padding=KERNEL // 2,
                            groups=INNER)
        self.pw2 = nn.Linear(INNER, HIDDEN)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.pw1(self.ln(x)).chunk(2, dim=-1)
        h = self.dw((a * torch.sigmoid(b)).transpose(1, 2)).transpose(1, 2)
        return x + self.pw2(F.silu(h))


class FCPE(nn.Module):
    """CFNaiveMelPE: log-mel ``(B, frames, 128)`` -> sigmoid confidences
    ``(B, frames, 360)``.  Its state dict is the JAX parameter tree's
    names (``in0``, ``in_gn``, ``in1``, ``layers.i.{ln,pw1,dw,pw2}``,
    ``norm``, ``out``) in torch layouts."""

    def __init__(self):
        super().__init__()
        self.in0 = nn.Conv1d(N_MELS, HIDDEN, 3, padding=1)
        self.in_gn = nn.GroupNorm(4, HIDDEN, eps=1e-5)
        self.in1 = nn.Conv1d(HIDDEN, HIDDEN, 3, padding=1)
        self.layers = nn.ModuleList(ConformerConv() for _ in range(N_LAYERS))
        self.norm = nn.LayerNorm(HIDDEN, eps=1e-5)
        self.out = nn.Linear(HIDDEN, OUT_DIMS)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.in_gn(self.in0(mel.transpose(1, 2))), 0.01)
        x = self.in1(x).transpose(1, 2)
        for layer in self.layers:
            x = layer(x)
        return torch.sigmoid(self.out(self.norm(x)))


def decode_local_argmax(latent: torch.Tensor, threshold: float = 0.006,
                        window: int = 9) -> torch.Tensor:
    """Confidences ``(B, frames, 360)`` -> f0 in Hz, 0 where the peak
    confidence is at most ``threshold``: the confidence-weighted mean
    cent of the ``window`` bins around the argmax."""
    ct = torch.from_numpy(cent_table()).to(latent.device)
    conf, idx = latent.max(dim=-1)
    offs = torch.arange(window, device=latent.device) - window // 2
    gather = torch.clamp(idx[..., None] + offs, 0, OUT_DIMS - 1)
    y_l = torch.gather(latent, -1, gather)
    cents = (ct[gather] * y_l).sum(-1) / torch.clamp(y_l.sum(-1), min=1e-12)
    f0 = cent_to_f0(cents)
    return torch.where(conf > threshold, f0, torch.zeros_like(f0))


# ----------------------------------------------------------------------
# resampling and the mel front end
# ----------------------------------------------------------------------

def _resample_kernel(up: int, down: int, taps_per_phase: int = 32,
                     beta: float = 8.0) -> np.ndarray:
    """Kaiser-windowed sinc for ``up/down`` resampling, float32."""
    m = max(up, down)
    half = taps_per_phase * m
    n = np.arange(-half, half + 1)
    cutoff = 1.0 / m
    h = cutoff * np.sinc(cutoff * n) * np.kaiser(len(n), beta) * up
    return h.astype(np.float32)


def _polyphase_bank(up: int, down: int) -> tuple[np.ndarray, int]:
    """The filter of :func:`_resample_kernel` as ``up`` phase filters
    ``(up, 1, L)`` and the left padding of the input.

    The JAX package convolves the input dilated by ``up`` (zeros between
    samples), padded by ``pad = (len(h) - 1) / 2`` on both sides, with
    ``h`` at stride ``down``.  Output ``n = q * up + r`` then takes
    ``x[q * down + c_r + m] * h[k_r + m * up]`` for ``m >= 0``, with
    ``c_r = ceil((r * down - pad) / up)`` and ``k_r = c_r * up - r * down
    + pad``: phase ``r``'s row holds those taps, shifted by ``c_r`` less
    the smallest ``c_r``, which the input's left padding absorbs."""
    h = _resample_kernel(up, down)
    pad = (len(h) - 1) // 2
    c = [-((pad - r * down) // up) for r in range(up)]   # ceil division
    c_min = min(c)
    rows = []
    for r in range(up):
        k = c[r] * up - r * down + pad
        taps = h[k::up]
        rows.append(np.concatenate([np.zeros(c[r] - c_min, np.float32),
                                    taps]))
    width = max(len(t) for t in rows)
    bank = np.zeros((up, 1, width), np.float32)
    for r, t in enumerate(rows):
        bank[r, 0, :len(t)] = t
    return bank, -c_min


def resample_to(x: torch.Tensor, sr: int, target: int) -> torch.Tensor:
    """``(B, T)`` at ``sr`` -> ``(B, n)`` at ``target``, the JAX
    package's polyphase resample computed as one strided convolution with
    ``up`` output channels (one per phase).  ``n`` is ``T * up // down``,
    or the JAX convolution's ``(T - 1) * up // down + 1`` samples where
    that is fewer (upsampling)."""
    if sr == target:
        return x
    g = gcd(sr, target)
    up, down = target // g, sr // g
    bank, left = _polyphase_bank(up, down)
    T = x.shape[1]
    want = min(T * up // down, (T - 1) * up // down + 1)
    q = -(-want // up)                      # output positions per phase
    need = (q - 1) * down + bank.shape[-1]
    xp = F.pad(x, (left, max(0, need - left - T)))
    w = torch.from_numpy(bank).to(x.device, x.dtype)
    y = F.conv1d(xp[:, None], w, stride=down)[..., :q]     # (B, up, q)
    return y.transpose(1, 2).reshape(x.shape[0], -1)[:, :want]


def log_mel(x16: torch.Tensor) -> torch.Tensor:
    """16 kHz audio ``(B, T)`` -> ``(B, frames, 128)`` log-mel: reflect
    padding of ``(N_FFT - HOP) / 2``, the periodic Hann window, slaney
    mels up to 8 kHz, ``log(clamp(mel, 1e-5))``."""
    xp = _pad_reflect(x16, (N_FFT - HOP) // 2)
    win = torch.from_numpy(hann_window(WIN)).to(x16.device, x16.dtype)
    frames = xp.unfold(-1, N_FFT, HOP) * win
    mag = torch.fft.rfft(frames, dim=-1).abs()
    fb = torch.from_numpy(mel_filterbank(SR, N_FFT, N_MELS, fmax=SR // 2)
                          ).to(x16.device, x16.dtype)
    return torch.log(torch.clamp(mag @ fb.T, min=1e-5))


def fcpe_f0(model: FCPE, x: torch.Tensor, sr: int,
            out_frames: Optional[int] = None, threshold: float = 0.006,
            fmin: float = 50.0, fmax: float = 550.0) -> torch.Tensor:
    """Audio ``(B, T)`` at ``sr`` -> f0 ``(B, out_frames)`` in Hz, 0 where
    unvoiced: resampled to 16 kHz, log-mel, the network, the local-argmax
    decode; detections below ``fmin`` unvoiced, above ``fmax`` clamped;
    then resampled to ``out_frames`` as ``jax.image.resize`` does."""
    x16 = resample_to(x.float(), sr, SR)
    f0 = decode_local_argmax(model(log_mel(x16)), threshold)
    f0 = torch.where(f0 < fmin, torch.zeros_like(f0),
                     torch.clamp(f0, max=fmax))
    if out_frames is not None and f0.shape[1] != out_frames:
        f0 = resize_linear(f0, out_frames)
    return f0


# ----------------------------------------------------------------------
# torchfcpe checkpoints
# ----------------------------------------------------------------------

def load_fcpe_checkpoint(path: str) -> dict:
    """A torchfcpe checkpoint (a dict with a ``model`` state dict, or the
    state dict itself, its keys possibly under a wrapper prefix) -> the
    state dict of :class:`FCPE`.  Strict: a missing key raises
    ``KeyError``; a tensor of another shape, or a weight left over
    (anything but the per-layer ``net.encoder_layers.*.norm.*``, which
    the conv-only forward does not use), raises ``ValueError``.  The
    weight norm of ``output_proj`` is resolved; pointwise convs
    ``(out, in, 1)`` become linear weights ``(out, in)``.  Tensors only
    are read (``weights_only=True``)."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = raw.get("model", raw) if isinstance(raw, dict) else raw
    if not isinstance(sd, dict):
        sd = sd.state_dict()
    sd = {k: torch.as_tensor(v).detach().float() for k, v in sd.items()
          if hasattr(v, "shape")}
    if not any(k.startswith("input_stack") for k in sd):
        pref = next((k.split("input_stack")[0] for k in sd
                     if "input_stack" in k), None)
        if pref is None:
            raise ValueError(
                f"{path}: no input_stack.* keys; not a CFNaiveMelPE "
                f"state dict (keys: {sorted(sd)[:8]}...)")
        sd = {k[len(pref):]: v for k, v in sd.items() if k.startswith(pref)}

    def take(key, want_shape):
        if key not in sd:
            raise KeyError(f"{path}: missing {key}")
        w = sd.pop(key)
        if tuple(w.shape) != tuple(want_shape):
            raise ValueError(f"{path}: {key} shape {tuple(w.shape)} != "
                             f"expected {tuple(want_shape)} (refusing to "
                             "reshape)")
        return w

    def wn_linear(prefix, i, o):
        """A weight-normed linear: ``g * v / ||v||`` row by row."""
        if f"{prefix}.weight" in sd:
            w = sd.pop(f"{prefix}.weight")
        else:
            v = sd.pop(f"{prefix}.weight_v")
            g = sd.pop(f"{prefix}.weight_g")
            w = g * v / torch.linalg.norm(v, dim=1, keepdim=True)
        if tuple(w.shape) != (o, i):
            raise ValueError(f"{prefix}: {tuple(w.shape)} != {(o, i)}")
        return w

    out = {
        "in0.weight": take("input_stack.0.weight", (HIDDEN, N_MELS, 3)),
        "in0.bias": take("input_stack.0.bias", (HIDDEN,)),
        "in_gn.weight": take("input_stack.1.weight", (HIDDEN,)),
        "in_gn.bias": take("input_stack.1.bias", (HIDDEN,)),
        "in1.weight": take("input_stack.3.weight", (HIDDEN, HIDDEN, 3)),
        "in1.bias": take("input_stack.3.bias", (HIDDEN,)),
        "norm.weight": take("norm.weight", (HIDDEN,)),
        "norm.bias": take("norm.bias", (HIDDEN,)),
        "out.weight": wn_linear("output_proj", HIDDEN, OUT_DIMS),
        "out.bias": take("output_proj.bias", (OUT_DIMS,)),
    }
    for li in range(N_LAYERS):
        base, dst = f"net.encoder_layers.{li}.conformer.net", f"layers.{li}"
        out.update({
            f"{dst}.ln.weight": take(f"{base}.0.weight", (HIDDEN,)),
            f"{dst}.ln.bias": take(f"{base}.0.bias", (HIDDEN,)),
            f"{dst}.pw1.weight": take(f"{base}.2.weight",
                                      (2 * INNER, HIDDEN, 1))[..., 0],
            f"{dst}.pw1.bias": take(f"{base}.2.bias", (2 * INNER,)),
            f"{dst}.dw.weight": take(f"{base}.4.conv.weight",
                                     (INNER, 1, KERNEL)),
            f"{dst}.dw.bias": take(f"{base}.4.conv.bias", (INNER,)),
            f"{dst}.pw2.weight": take(f"{base}.6.weight",
                                      (HIDDEN, INNER, 1))[..., 0],
            f"{dst}.pw2.bias": take(f"{base}.6.bias", (HIDDEN,)),
        })
    # nothing silently discarded: a checkpoint trained with self-attention
    # (conv_only=False) carries weights this conv-only layout cannot use
    leftover = [k for k in sd
                if not (k.startswith("net.encoder_layers.") and ".norm." in k)]
    if leftover:
        raise ValueError(
            f"{path}: {len(leftover)} unconsumed weight keys (e.g. "
            f"{sorted(leftover)[:5]}); the checkpoint does not match the "
            "conv-only CFNaiveMelPE layout this reader supports (was it "
            "trained with conv_only=False / self-attention?)")
    return out


# path -> the FCPE state dict on the CPU, or None where the path is missing
_CACHE: dict = {}
# (path, device) -> the frozen module on that device
_MODULES: dict = {}


def get_fcpe(path: str, device="cuda") -> Optional[FCPE]:
    """The frozen FCPE of the checkpoint at ``path`` on ``device`` (the
    card unless the caller asks for another; raises without CUDA), read
    once per process; None for an empty path, and for a missing one with
    a warning the first time (the caller then takes YIN)."""
    if not path:
        return None
    if path not in _CACHE:
        if not os.path.exists(path):
            warnings.warn(f"pitch_ckpt {path!r} not found: falling back "
                          "to the YIN estimator", stacklevel=2)
            _CACHE[path] = None
        else:
            _CACHE[path] = load_fcpe_checkpoint(path)
    if _CACHE[path] is None:
        return None
    device = resolve_device(device)
    key = (path, str(device))
    if key not in _MODULES:
        model = FCPE()
        model.load_state_dict(_CACHE[path])
        _MODULES[key] = model.to(device).eval().requires_grad_(False)
    return _MODULES[key]
