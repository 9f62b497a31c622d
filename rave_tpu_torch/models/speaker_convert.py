"""The reference's torch speaker-encoder checkpoint, mapped onto the port's
:class:`~rave_tpu_torch.models.speaker.SpeakerRAVE`.

Port of ``rave_tpu/models/speaker_convert.py``.  The reference loads a
VoxCeleb-pretrained ECAPA state dict whose keys carry the prefix
``__S__.`` and may bundle PQMF weights; its modules are named as in the
reference's ``SpeakerRAVE``.  Here:

* the ``__S__.`` prefix is dropped and ``pqmf.*`` entries are split off;
* a weight-normed conv comes as a plain ``weight`` or as torch
  ``weight_norm``'s ``weight_g``/``weight_v`` pair; the port's convs are
  always weight-normed (``v``, ``g``), so a plain weight becomes
  ``v = w, g = ||w||``, which resolves back to ``w``;
* the attention convs stay plain, the BatchNorm running statistics are
  buffers, and ``fc6`` keeps torch's ``Linear`` layout.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

# reference module -> port module, the weight-normed convs
_WN_CONV_MAP = {"in_layer": "in_layer", "cat_layer": "cat_layer",
                "out_layer": "out_layer"}
for _l in ("layer2", "layer3", "layer4"):
    # Residual(DilatedUnit).aligned.branches.0 is the unit; its net is
    # [act, conv k, act, conv 1], so the convs are entries 1 and 3
    _WN_CONV_MAP[f"{_l}.0.aligned.branches.0.net.1"] = \
        f"{_l}.residual.inner.conv1"
    _WN_CONV_MAP[f"{_l}.0.aligned.branches.0.net.3"] = \
        f"{_l}.residual.inner.conv2"
    _WN_CONV_MAP[f"{_l}.2"] = f"{_l}.down"

# the plain convs of the attention head, its BatchNorms and the head
_PLAIN_MAP = {"attention.0": "attn1", "attention.3": "attn2", "fc6": "fc6"}
_BN_MAP = {"attention.2": "attn_bn", "bn5": "bn5"}


def strip_speaker_statedict(sd: Mapping) -> tuple[dict, dict]:
    """The reference's ``__S__.`` rewrite and PQMF split: returns
    ``(speaker_sd, pqmf_sd)``."""
    speaker, pqmf = {}, {}
    for name, value in sd.items():
        new = name.replace("__S__.", "")
        if "pqmf" in new:
            pqmf[new.replace("pqmf.", "")] = value
        else:
            speaker[new] = value
    return speaker, pqmf


def _f32(value) -> torch.Tensor:
    return torch.as_tensor(value).detach().to(torch.float32)


def _resolve_weight(sd: Mapping, prefix: str) -> torch.Tensor:
    """Plain ``weight`` or weight-norm ``weight_g``/``weight_v``."""
    if f"{prefix}.weight" in sd:
        return _f32(sd[f"{prefix}.weight"])
    g, v = _f32(sd[f"{prefix}.weight_g"]), _f32(sd[f"{prefix}.weight_v"])
    dims = tuple(range(1, v.dim()))
    return g * v / torch.sqrt((v * v).sum(dim=dims, keepdim=True) + 1e-12)


def convert_speaker_state(sd: Mapping) -> dict:
    """A (stripped) reference speaker state dict -> the state dict of the
    port's BatchNorm ``SpeakerRAVE`` (parameters and running statistics);
    a missing key raises ``KeyError``."""
    out = {}
    for ref, port in _WN_CONV_MAP.items():
        if f"{ref}.weight_g" in sd:
            v = _f32(sd[f"{ref}.weight_v"])
            g = _f32(sd[f"{ref}.weight_g"]).reshape(-1, 1, 1)
        else:
            v = _resolve_weight(sd, ref)
            g = torch.sqrt((v * v).sum(dim=(1, 2), keepdim=True) + 1e-12)
        out.update({f"{port}.v": v, f"{port}.g": g,
                    f"{port}.bias": _f32(sd[f"{ref}.bias"])})
    for ref, port in _PLAIN_MAP.items():
        out[f"{port}.weight"] = _resolve_weight(sd, ref)
        out[f"{port}.bias"] = _f32(sd[f"{ref}.bias"])
    for ref, port in _BN_MAP.items():
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{port}.{leaf}"] = _f32(sd[f"{ref}.{leaf}"])
    return out


def load_speaker_checkpoint(path: str) -> dict:
    """Read a ``__S__.``-prefixed reference checkpoint (tensors only,
    ``weights_only=True``) -> the port's speaker state dict."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(raw, "state_dict"):
        raw = raw.state_dict()
    if "state_dict" in raw and isinstance(raw["state_dict"], dict):
        raw = raw["state_dict"]
    speaker_sd, _pqmf = strip_speaker_statedict(raw)
    return convert_speaker_state(speaker_sd)


def install_speaker_weights(model: nn.Module, state: Mapping) -> None:
    """Copy a converted speaker state dict into ``model.speaker_encoder``
    in place.  Keys and shapes must match exactly: the converter applies
    every layout change itself, so a tensor of the right size but another
    shape (an untransposed matrix) is a layout fault, and is refused, not
    reshaped."""
    dst = model.speaker_encoder.state_dict()
    if set(dst) != set(state):
        raise ValueError(
            f"speaker state: keys {sorted(set(state) ^ set(dst))} are not "
            "in both the converted state and the model")
    for name, value in state.items():
        if tuple(dst[name].shape) != tuple(value.shape):
            raise ValueError(
                f"speaker state {name}: converted shape "
                f"{tuple(value.shape)} vs model {tuple(dst[name].shape)} "
                "(layout mismatch; refusing to reshape)")
    with torch.no_grad():
        for name, value in state.items():
            dst[name].copy_(value)
