"""Load the JAX package's parameters into the port's modules.

``load_flax_params(model, params, batch_stats, model_state)`` takes the
``params`` tree of a ``rave_tpu`` RAVE (and, for a speaker encoder or an
EncoderV1 with BatchNorms, the ``batch_stats`` collection beside it; for
the discrete head and AdaIN, the ``quantizer`` and ``adain`` collections in
``model_state``, the dict ``StreamingRAVE(model_state=...)`` takes in the
JAX package) as nested dicts of numpy arrays (convert with
``jax.tree.map(np.asarray, tree)`` on the JAX side) and fills a
:class:`~rave_tpu_torch.models.rave.RAVE`.
``load_discriminator_params(disc, params)`` fills a discriminator of
:mod:`~rave_tpu_torch.models.discriminators`.  Both raise on a flax leaf
left unused or a torch parameter left unfilled.  Nothing here imports
JAX.

Flax names modules by type in construction order, and binds a
``Residual``'s inner ``DilatedUnit`` to the parent's scope: under
``encoder`` sit ``Conv1d_0..`` and ``DilatedUnit_0..`` directly, each
``DilatedUnit_i`` holding ``Conv1d_0`` (dilated) and ``Conv1d_1`` (1x1).
``Activation_i`` (a Snake ``alpha``; a leaky ReLU owns nothing) and
``AdaIN_i`` (state in the ``adain`` collection) are counted the same way,
and so is ``GRULayer_i``, whose flax cells ``cell{l}/{ir,iz,in,hr,hz,hn}``
(Dense kernels ``(in, out)``; ``hr`` and ``hz`` without bias) become
layer ``l``'s gate stacks ``weight_ih{l}`` ``[ir|iz|in]`` and
``weight_hh{l}`` ``[hr|hz|hn]`` ``(3 dim, dim)``, ``bias_ih{l}`` and
``bias_hn{l}``.  The mel front end has no parameters.
The noise generators and the v1 blocks (``UpsampleLayer``,
``ResidualStack`` > ``ResidualBlock`` > ``ResidualLayer``) have scopes
of their own, like ``DilatedUnit``; EncoderV1's ``BatchNorm_i`` takes
``scale``/``bias`` from ``params`` and its running statistics from
``batch_stats/encoder``.
The port registers its modules in the same order, so counting them by
type walks the same names.  A codebook's ``embed`` ``(K, D)`` keeps its
layout; an AdaIN's statistics ``(B, 1, C)`` and scalars become the packed
state ``(B, C, 8)`` of :class:`~rave_tpu_torch.models.blocks.AdaIN`, set
as the module's cache (the state an offline pass reads;
:func:`adain_states` lists them for ``StreamingRAVE(adain_state=...)``).
Layouts: a ``Conv1d`` kernel ``(k, in, out)`` becomes ``(out, in, k)``;
a ``ConvTranspose1d`` kernel ``(k, in, out)`` becomes ``(in, out, k)``
(no flip); weight-norm gains ``(1, 1, out)``
take the shape of the port's per-output-channel gain.  The speaker
encoder's named modules keep their flax names (``layer2`` .. ``fc6``,
``in_layer`` being flax's ``Conv1d_0``); a flax ``Dense`` kernel
``(in, out)`` becomes a ``Linear`` weight ``(out, in)``; the latent
adversary's ``layers_i`` is entry ``i`` of its ``Sequential``; the AAM
head's ``weight`` keeps its layout.  A
discriminator ``WNConv_i`` is the ``i``-th entry of its module's
``convs`` (the Descript MRD's ``band{b}_conv{l}`` and ``post`` keep their
names), its ``v`` ``(*k, in, out)`` becoming ``(out, in, *k)``.
``load_fcpe_params(fcpe, params)`` fills the FCPE pitch estimator
(:class:`~rave_tpu_torch.models.pitch_fcpe.FCPE`) from the JAX package's
FCPE tree, whose names it keeps (``layers`` a list there).
"""

from __future__ import annotations

from typing import Iterator, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .models.blocks import (Activation, AdaIN, BatchNorm, DilatedUnit,
                            GRULayer, NoiseGeneratorV1, NoiseGeneratorV2,
                            ResidualBlock, ResidualLayer, ResidualStack,
                            UpsampleLayer)
from .models.discriminators import WNConv
from .models.latent import DiscreteHead
from .models.speaker import CohortNorm
from .ops.conv import Conv1d, ConvTranspose1d

# modules with a flax scope of their own, whose children the loader walks
_SCOPES = (DilatedUnit, NoiseGeneratorV1, NoiseGeneratorV2, ResidualBlock,
           ResidualLayer, ResidualStack, UpsampleLayer)
_NAMED = (Conv1d, ConvTranspose1d, Activation, AdaIN, BatchNorm,
          GRULayer) + _SCOPES
# flax GRUCell's Dense modules, in the port's row order of each gate stack
_GRU_GATES = (("weight_ih", ("ir", "iz", "in"), "kernel"),
              ("weight_hh", ("hr", "hz", "hn"), "kernel"),
              ("bias_ih", ("ir", "iz", "in"), "bias"),
              ("bias_hn", ("hn",), "bias"))


def _flax_children(module: nn.Module, counts=None) -> Iterator:
    """``(flax_name, module)`` for each parameter-owning child, in order."""
    counts = {} if counts is None else counts
    for child in module.children():
        if isinstance(child, _NAMED):
            kind = type(child).__name__
            n = counts.get(kind, 0)
            counts[kind] = n + 1
            yield f"{kind}_{n}", child
        else:
            yield from _flax_children(child, counts)


def _torch_value(module: nn.Module, leaf: str, arr: np.ndarray) -> tuple:
    """``(torch param name, array in the torch layout)``."""
    if leaf == "bias":
        return "bias", arr
    transposed = isinstance(module, ConvTranspose1d)
    if leaf == "g":
        shape = (1, -1, 1) if transposed else (-1, 1, 1)
        return "g", arr.reshape(shape)
    name = {"v": "v", "kernel": "weight"}[leaf]
    return name, arr.transpose((1, 2, 0) if transposed else (2, 1, 0))


def load_conv_params(conv: nn.Module, leaves: Mapping) -> list:
    """Copy one flax conv's leaves (``v``/``g``/``kernel``/``bias``) into
    a port ``Conv1d`` or ``ConvTranspose1d``; returns the torch
    parameters filled."""
    filled = []
    for leaf, arr in leaves.items():
        pname, value = _torch_value(conv, leaf, np.asarray(arr))
        param = getattr(conv, pname)
        if param is None or tuple(param.shape) != value.shape:
            raise ValueError(
                f"{leaf}: flax {np.shape(arr)} does not fit "
                f"{pname} {None if param is None else tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.array(value)))
        filled.append(param)
    return filled


def _leaves(tree: Mapping, path: str = "") -> Iterator[str]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, f"{path}{k}/")
        else:
            yield path + k


class _Loader:
    """Copies flax leaves into torch tensors, remembering which leaves it
    used and which tensors it filled."""

    def __init__(self):
        self.used, self.filled = set(), set()

    def leaf(self, tensor: torch.Tensor, tree: Mapping, path: str,
             name: str, layout=lambda a: a) -> None:
        if name not in tree:
            raise KeyError(f"{path}{name} missing from the flax tree")
        self.put(tensor, layout(np.asarray(tree[name])), [path + name])

    def put(self, tensor: torch.Tensor, value: np.ndarray,
            leaves: list) -> None:
        """Copy ``value``, made of the flax ``leaves`` (full paths), into
        ``tensor``."""
        if tuple(tensor.shape) != value.shape:
            raise ValueError(f"{leaves}: flax {value.shape} does not "
                             f"fit {tuple(tensor.shape)}")
        with torch.no_grad():
            tensor.copy_(torch.from_numpy(np.array(value)))
        self.used.update(leaves)
        self.filled.add(id(tensor))

    def gru(self, gru: GRULayer, tree: Mapping, path: str) -> None:
        """Each flax cell of a ``GRULayer`` into its layer's gate stacks
        (a Dense kernel ``(in, out)`` becomes rows ``(out, in)``)."""
        for layer in range(gru.num_layers):
            cell, cell_path = tree.get(f"cell{layer}"), f"{path}cell{layer}/"
            for name, gates, leaf in _GRU_GATES:
                missing = [g for g in gates if leaf not in (cell or {}).get(
                    g, {})]
                if missing:
                    raise KeyError(f"{cell_path}{missing[0]}/{leaf} missing "
                                   "from the flax params")
                arrays = [np.asarray(cell[g][leaf]) for g in gates]
                value = np.concatenate(
                    [a.T for a in arrays] if leaf == "kernel" else arrays)
                self.put(getattr(gru, f"{name}{layer}"), value,
                         [f"{cell_path}{g}/{leaf}" for g in gates])

    def conv(self, conv: nn.Module, tree: Mapping, path: str) -> None:
        try:
            params = load_conv_params(conv, tree)
        except ValueError as e:
            raise ValueError(f"{path}{e}") from None
        self.used.update(path + leaf for leaf in tree)
        self.filled.update(id(p) for p in params)

    def named(self, module: nn.Module, tree: Mapping, path: str,
              stats: Optional[Mapping] = None, stats_path: str = "") -> None:
        """The convs, scoped blocks, Snake activations and BatchNorms of
        ``module``, by flax name; a BatchNorm's running statistics from
        ``stats``, the ``batch_stats`` tree at the same place."""
        for name, child in _flax_children(module):
            if isinstance(child, AdaIN) or (
                    isinstance(child, Activation) and child.kind != "snake"):
                continue
            if name not in tree:
                raise KeyError(f"{path}{name} missing from the flax params")
            sub, sub_path = tree[name], f"{path}{name}/"
            if isinstance(child, _SCOPES):
                self.named(child, sub, sub_path,
                           None if stats is None else stats.get(name),
                           f"{stats_path}{name}/")
            elif isinstance(child, Activation):
                self.leaf(child.alpha, sub, sub_path, "alpha")
            elif isinstance(child, GRULayer):
                self.gru(child, sub, sub_path)
            elif isinstance(child, BatchNorm):
                self.leaf(child.weight, sub, sub_path, "scale")
                self.leaf(child.bias, sub, sub_path, "bias")
                if stats is None or name not in stats:
                    raise KeyError(f"{stats_path}{name} missing from the "
                                   "flax batch_stats")
                for buf, leaf in ((child.running_mean, "mean"),
                                  (child.running_var, "var")):
                    self.leaf(buf, stats[name], f"{stats_path}{name}/", leaf)
            else:
                self.conv(child, sub, sub_path)

    def check(self, trees: Mapping, tensors) -> None:
        unused = sorted(set(_leaves(trees)) - self.used)
        if unused:
            raise ValueError(f"flax leaves left unused: {unused}")
        unfilled = [n for n, t in tensors if id(t) not in self.filled]
        if unfilled:
            raise ValueError(f"torch parameters left unfilled: {unfilled}")


def _load_speaker(ld: _Loader, spk: nn.Module, tree: Mapping,
                  stats: Optional[Mapping], path: str,
                  stats_path: str) -> None:
    ld.conv(spk.in_layer, tree["Conv1d_0"], f"{path}Conv1d_0/")
    for name in ("layer2", "layer3", "layer4"):
        ld.named(getattr(spk, name), tree[name], f"{path}{name}/")
    for name in ("cat_layer", "out_layer", "attn1", "attn2"):
        ld.conv(getattr(spk, name), tree[name], f"{path}{name}/")
    for name in ("attn_bn", "bn5"):
        bn = getattr(spk, name)
        ld.leaf(bn.weight, tree[name], f"{path}{name}/", "scale")
        ld.leaf(bn.bias, tree[name], f"{path}{name}/", "bias")
        if not isinstance(bn, CohortNorm):
            ld.leaf(bn.running_mean, stats[name], f"{stats_path}{name}/",
                    "mean")
            ld.leaf(bn.running_var, stats[name], f"{stats_path}{name}/",
                    "var")
    ld.leaf(spk.fc6.weight, tree["fc6"], f"{path}fc6/", "kernel",
            lambda a: a.T)
    ld.leaf(spk.fc6.bias, tree["fc6"], f"{path}fc6/", "bias")


def adain_states(model: nn.Module) -> list:
    """The state of each AdaIN of ``model`` in module order (None where a
    module has none)."""
    return [m.cache for m in model.modules() if isinstance(m, AdaIN)]


def _load_adain(model: nn.Module, tree: Mapping) -> set:
    """Each ``AdaIN_i`` of the encoder's and decoder's ``adain`` trees as
    its module's packed state; returns the leaves used."""
    used, dev = set(), next(model.parameters()).device
    for part in ("encoder", "decoder"):
        for name, child in _flax_children(getattr(model, part)):
            if not isinstance(child, AdaIN):
                continue
            if name not in tree.get(part, {}):
                raise KeyError(f"adain/{part}/{name} missing from the flax "
                               "model state")
            leaves = tree[part][name]
            mean_x = np.asarray(leaves["mean_x"])
            B, _, C = mean_x.shape
            if C != child.dim:
                raise ValueError(f"adain/{part}/{name}: {C} channels for "
                                 f"{child.dim}")
            cols = [np.broadcast_to(np.asarray(leaves[k]).reshape(
                (B, C) if np.ndim(leaves[k]) else ()), (B, C))
                for k in AdaIN.SLOTS]
            child.cache = torch.from_numpy(np.stack(cols, -1).astype(
                np.float32)).to(dev)
            used.update(f"adain/{part}/{name}/{k}" for k in leaves)
    return used


def load_flax_params(model: nn.Module, params: Mapping,
                     batch_stats: Optional[Mapping] = None,
                     model_state: Optional[Mapping] = None) -> None:
    """Copy a ``rave_tpu`` RAVE ``params`` tree (its ``batch_stats``
    collection, needed by a speaker encoder with BatchNorms, and its
    other collections in ``model_state``: ``quantizer`` into the codebook
    buffers, ``adain`` into the AdaIN states) into ``model`` in place.

    Raises if a flax leaf is left unused or a torch tensor unfilled (a
    discrete model's codebooks count only with a ``quantizer`` tree).
    """
    ld = _Loader()
    for part in ("encoder", "decoder"):
        ld.named(getattr(model, part), params[part], f"params/{part}/",
                 (batch_stats or {}).get(part), f"batch_stats/{part}/")
    trees = {"params": params}
    tensors = [("params/" + n, p) for n, p in model.named_parameters()]
    tensors += [(f"batch_stats/encoder/{n}", b)
                for n, b in model.encoder.named_buffers()]
    model_state = dict(model_state or {})
    if "quantizer" in model_state and isinstance(model.latent, DiscreteHead):
        tree = model_state.pop("quantizer")
        trees["quantizer"] = tree
        for i, layer in enumerate(model.latent.rvq.layers):
            book = layer.codebook
            path = f"quantizer/latent/rvq/vq{i}/codebook/"
            sub = tree["latent"]["rvq"][f"vq{i}"]["codebook"]
            for name in ("embed", "embed_avg", "cluster_size", "inited"):
                ld.leaf(getattr(book, name), sub, path, name)
                tensors.append((path + name, getattr(book, name)))
            book._inited_host = None
    if "adain" in model_state:
        trees["adain"] = model_state.pop("adain")
        ld.used |= _load_adain(model, trees["adain"])
    if model_state:
        raise ValueError(f"model state collections left unused: "
                         f"{sorted(model_state)}")
    if batch_stats is not None:
        trees["batch_stats"] = batch_stats
    spk = model.speaker_encoder
    if spk is not None:
        stats = None
        if not isinstance(spk.bn5, CohortNorm):
            if batch_stats is None:
                raise ValueError("a speaker encoder with BatchNorms needs "
                                 "the flax batch_stats")
            stats = batch_stats["speaker_encoder"]
        _load_speaker(ld, spk, params["speaker_encoder"], stats,
                      "params/speaker_encoder/",
                      "batch_stats/speaker_encoder/")
        tensors += [("batch_stats/" + n, b) for n, b in spk.named_buffers()]
    if model.speaker_classifier is not None:
        ld.leaf(model.speaker_classifier.weight, params["speaker_classifier"],
                "params/speaker_classifier/", "weight")
    if model.latent_adversary is not None:
        adv, tree = model.latent_adversary, params["latent_adversary"]
        path = "params/latent_adversary/"
        ld.leaf(adv[0].weight, tree["layers_0"], path + "layers_0/", "scale")
        ld.leaf(adv[0].bias, tree["layers_0"], path + "layers_0/", "bias")
        for i in (1, 3):
            sub, sub_path = tree[f"layers_{i}"], f"{path}layers_{i}/"
            ld.leaf(adv[i].weight, sub, sub_path, "kernel", lambda a: a.T)
            ld.leaf(adv[i].bias, sub, sub_path, "bias")
    if model.ce_projection is not None:
        cp, tree = model.ce_projection, params["ce_projection"]
        path = "params/ce_projection/"
        ld.leaf(cp.norm.weight, tree["LayerNorm_0"], path + "LayerNorm_0/",
                "scale")
        ld.leaf(cp.norm.bias, tree["LayerNorm_0"], path + "LayerNorm_0/",
                "bias")
        ld.leaf(cp.dense.weight, tree["Dense_0"], path + "Dense_0/",
                "kernel", lambda a: a.T)
        ld.leaf(cp.dense.bias, tree["Dense_0"], path + "Dense_0/", "bias")
    ld.check(trees, tensors)


def _load_wnconv(ld: _Loader, conv: nn.Module, tree: Mapping, key: str,
                 path: str) -> None:
    sub, sub_path, nd = tree.get(key), f"{path}{key}/", conv.v.dim() - 2
    if sub is None:
        raise KeyError(f"{sub_path} missing from the flax params")
    to_out_in_k = (nd + 1, nd) + tuple(range(nd))
    ld.leaf(conv.v, sub, sub_path, "v", lambda a: a.transpose(to_out_in_k))
    ld.leaf(conv.g, sub, sub_path, "g", lambda a: a.reshape(conv.g.shape))
    ld.leaf(conv.bias, sub, sub_path, "bias")


def _load_wnconvs(ld: _Loader, module: nn.Module, tree: Mapping,
                  path: str) -> None:
    for name, child in module.named_children():
        if name == "convs":
            for i, conv in enumerate(child):
                _load_wnconv(ld, conv, tree, f"WNConv_{i}", path)
        elif isinstance(child, WNConv):
            _load_wnconv(ld, child, tree, name, path)
        else:
            if name not in tree:
                raise KeyError(f"{path}{name} missing from the flax params")
            _load_wnconvs(ld, child, tree[name], f"{path}{name}/")


def load_discriminator_params(disc: nn.Module, params: Mapping) -> None:
    """Copy a ``rave_tpu`` discriminator ``params`` tree into ``disc``
    in place; raises on an unused leaf or an unfilled parameter."""
    ld = _Loader()
    _load_wnconvs(ld, disc, params, "")
    ld.check(params, list(disc.named_parameters()))


def load_fcpe_params(fcpe: nn.Module, params: Mapping) -> None:
    """Copy the JAX package's FCPE parameter tree (``in0``, ``in_gn``,
    ``in1``, ``layers`` (a list), ``norm``, ``out``) into a port
    :class:`~rave_tpu_torch.models.pitch_fcpe.FCPE` in place: conv
    kernels ``(k, in, out)`` become ``(out, in, k)``, dense kernels
    ``(in, out)`` linear weights ``(out, in)``, norm scales weights.
    Raises on an unused leaf or an unfilled parameter."""
    ld = _Loader()
    tree = {**params, "layers": {str(i): layer for i, layer
                                 in enumerate(params["layers"])}}
    layouts = {"Conv1d": lambda a: a.transpose(2, 1, 0),
               "Linear": lambda a: a.T}
    for name, module in fcpe.named_modules():
        kind = type(module).__name__
        if kind not in ("Conv1d", "Linear", "LayerNorm", "GroupNorm"):
            continue
        sub, path = tree, ""
        for part in name.split("."):
            sub, path = sub[part], f"{path}{part}/"
        if kind in layouts:
            ld.leaf(module.weight, sub, path, "kernel", layouts[kind])
        else:
            ld.leaf(module.weight, sub, path, "scale")
        ld.leaf(module.bias, sub, path, "bias")
    ld.check(tree, list(fcpe.named_parameters()))
