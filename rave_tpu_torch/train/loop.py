"""The train steps of every ported preset and the eval step.

Port of ``rave_tpu/train/loop.py`` (every latent head; ``v1`` and the v2
family, with or without the noise branch):

* Adam groups with ``betas=(adam_b1, adam_b2)`` and eps 1e-8: ENC
  (encoder, latent head, unit CE projection), DEC (decoder), DIS
  (discriminator) and, for a speaker-conditioned config, SPK
  (:func:`spk_group`: the AAM head, the latent adversary and, with
  ``train_speaker_encoder``, the speaker encoder) at
  ``speaker_learning_rate``; a frozen speaker encoder is in no group.
  optax's ``adam`` and ``torch.optim.Adam`` are the same update:
  bias-corrected moments, eps added outside the square root;
* the D-or-G choice is a host-side ``if`` on the integer step: D trains
  on every ``update_discriminator_every``-th step once
  ``step >= phase_1_duration``, G on every other step;
* a G step differentiates the generator only (the discriminator's
  parameters collect no gradient); a D step recomputes the generator
  forward without gradient, its latent noise given or drawn as a G
  step's is;
* the upstream branch (v1, v2) samples the latent with noise ``eps``,
  given to the step or drawn from the state's generator, and adds the KL
  times the beta schedule; its reconstruction loss is
  ``audio_distance_v1`` over the bands and over the audio.  The other
  heads take their regulariser times beta the same way: the Wasserstein
  head's MMD against the normal reference ``draws["ref"]`` (shaped like
  the latent), the spherical head's 0; the Wasserstein and discrete heads
  append the augmentation channels ``draws["aug"]`` ``(B,
  noise_augmentation, T_z)``.  The noise branch of the generator takes
  the uniform ``draws["noise"]``, GeneratorV1's output gated by
  :func:`~rave_tpu_torch.train.schedules.warmed_up`.  A draw left out of
  ``draws`` comes from the state's generator.  EncoderV1's BatchNorms
  (unless ``v1_sample_norm``) normalise by batch statistics and advance
  their running ones in D and G steps alike (a D step runs the
  generator's forward too).  The fork's branch draws no random
  numbers (the decoder sees the detached raw latent and the speaker
  embedding, no noise), so its step is deterministic.  The discrete
  branch quantizes the latent through the residual VQ, gated by
  :func:`~rave_tpu_torch.train.schedules.quantize_enabled`, and adds
  the commitment loss times the beta schedule; its codebooks update in D
  and G steps alike (a D step runs the generator's forward too), their
  random rows drawn by the step's ``sampler`` or else from the state's
  generator.  A pitch config appends the clean signal's normalised f0 to
  the decoder latent in both branches, by the batch's
  ``f0_median``/``f0_std`` (speaker statistics) where it has them.  With
  ``speaker_classes`` and ``batch["speaker"]`` it adds the AAM speaker
  CE (``weights["speaker_ce"]``) and, with ``latent_adversary_weight``,
  the adversary's CE on the latent through gradient reversal; a
  BatchNorm speaker encoder in training mode advances its running
  statistics in D and G steps alike;
* with ``ema_decay`` the state keeps an exponential moving average of
  the generator's parameters, updated after each G step;
* under a process group of several ranks (:mod:`rave_tpu_torch.
  parallel.mesh`; the JAX package's GSPMD step over a batch-sharded
  mesh) ``batch`` and any given draw hold this rank's rows of the global
  batch: the batch-coupled statistics (batch norms, the MMD, the RVQ's
  codebook update, relative distances) span the ranks, each draw left to
  ``state.generator`` is made at the global batch's shape and cut to the
  rank's rows, the gradients are averaged over the ranks before the
  optimizers step (one bucketed all-reduce each, right after
  ``autograd.grad`` and ``backward``) and so are the metrics.  Every
  rank's state stays equal to the others'.  Only the train and eval
  steps couple the ranks (:func:`~rave_tpu_torch.parallel.mesh.
  batch_sharded_step`); serving and export stay rank-local;
* under ``compute_dtype=bfloat16`` the encoder and the decoder run in
  bf16 (:class:`~rave_tpu_torch.models.rave.RAVE`), and so does the
  discriminator: real and fake are cast to bf16 for its one batched
  pass, its last maps go back to float32 for the GAN loss, and feature
  matching takes bf16 differences and float32 means.  The parameters,
  the optimizers and the other losses stay float32, as in the JAX
  package's bf16 step.
"""

from __future__ import annotations

import contextlib
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..config import RAVEConfig
from ..models.discriminators import build_discriminator, member_sub_count
from ..models.rave import RAVE, serving_mode
from ..ops import losses as L
from ..ops.pqmf import _pqmf_kernels
from ..ops.precision import compute_dtype
from ..parallel import mesh
from . import schedules

ENC_GROUP = ("encoder", "latent", "ce_projection")
DEC_GROUP = ("decoder",)


def group_parameters(model: RAVE, group) -> list:
    """The trainable parameters of ``model``'s submodules in ``group``."""
    return [p for name in group if getattr(model, name, None) is not None
            for p in getattr(model, name).parameters()]


def spk_group(cfg: RAVEConfig) -> tuple:
    """The speaker optimizer group (the JAX package's ``_spk_group``): the
    AAM head with ``speaker_classes``, the latent adversary with
    ``latent_adversary_weight`` as well, and the speaker encoder with
    ``train_speaker_encoder``."""
    g = ()
    if cfg.speaker_embedding_size > 0 and cfg.speaker_classes > 0:
        g += ("speaker_classifier",)
        if cfg.latent_adversary_weight > 0:
            g += ("latent_adversary",)
    if cfg.train_speaker_encoder:
        g += ("speaker_encoder",)
    return g


class TrainState:
    """Generator, discriminator, integer step, the optimizers (``spk_opt``
    is None when :func:`spk_group` is empty), the latent noise generator
    (seeded by ``seed``, on ``device``) and, with ``cfg.ema_decay``, the
    EMA of the generator's parameters.

    Modules are initialised from PyTorch's global generator (seed it with
    ``torch.manual_seed``); load converted weights before the first step
    (the optimizers hold the parameter objects, not copies) and then
    :meth:`reset_ema`.
    """

    def __init__(self, cfg: RAVEConfig, device="cuda", step: int = 0,
                 seed: int = 0):
        device = resolve_device(device)
        self.cfg = cfg
        self.model = RAVE(cfg, device=device)
        self.disc = build_discriminator(cfg, device)
        self.step = step
        self.generator = torch.Generator(device=device).manual_seed(seed)
        adam = dict(lr=cfg.learning_rate, betas=(cfg.adam_b1, cfg.adam_b2),
                    eps=1e-8)
        self.enc_params = group_parameters(self.model, ENC_GROUP)
        self.dec_params = group_parameters(self.model, DEC_GROUP)
        self.enc_opt = torch.optim.Adam(self.enc_params, **adam)
        self.dec_opt = torch.optim.Adam(self.dec_params, **adam)
        self.dis_opt = torch.optim.Adam(self.disc.parameters(), **adam)
        self.spk_params = group_parameters(self.model, spk_group(cfg))
        self.spk_opt = None
        if self.spk_params:
            self.spk_opt = torch.optim.Adam(
                self.spk_params,
                **{**adam, "lr": cfg.speaker_learning_rate
                   or cfg.learning_rate})
        self.ema: Optional[dict] = None
        self.reset_ema()

    def reset_ema(self) -> None:
        """Restart the EMA (with ``cfg.ema_decay``) from the generator's
        parameters as they are now."""
        if self.cfg.ema_decay:
            self.ema = {k: p.detach().clone()
                        for k, p in self.model.named_parameters()}

    def update_ema(self) -> None:
        """``ema = ema * decay + params * (1 - decay)``, every generator
        parameter, frozen ones included (as the JAX package's tree)."""
        if self.ema is None:
            return
        d = self.cfg.ema_decay
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                self.ema[k].mul_(d).add_(p, alpha=1 - d)


# ----------------------------------------------------------------------
# losses
# ----------------------------------------------------------------------

def _feature_matching(cfg, feats_real, feats_fake) -> torch.Tensor:
    total = feats_real[0][0].new_zeros((), dtype=torch.float32)
    skip = cfg.num_skipped_features
    for fr, ff in zip(feats_real, feats_fake):
        fr, ff = fr[skip:], ff[skip:]
        if not fr:
            continue
        d = total.new_zeros(())
        for a, b in zip(fr, ff):
            d = d + L.mean_difference(a, b, cfg.feature_matching_norm,
                                      cfg.feature_matching_relative)
        total = total + d / len(fr)
    return total


def _sub_weights(cfg):
    d = cfg.discriminator
    if d.kind != "combine" or d.member_weights is None:
        return None
    w = []
    for m, mw in zip(d.members, d.member_weights):
        w.extend([float(mw)] * member_sub_count(m, d))
    return w


def _gan_terms(cfg, disc, x, y):
    """``(loss_dis, loss_adv, feature_matching)`` from one discriminator
    pass over real and fake together (``x``, ``y``: ``(B, T, 1)``), in
    the compute dtype; the scores go back to float32 for the GAN loss."""
    gan = L.GAN_LOSSES[cfg.gan_loss]
    B = x.shape[0]
    both = torch.cat([x, y], dim=0)
    cdt = compute_dtype(cfg.compute_dtype)
    if cdt != torch.float32:
        both = both.to(cdt)
    feats = disc(both.transpose(1, 2))
    feats_real = [[f[:B] for f in chain] for chain in feats]
    feats_fake = [[f[B:] for f in chain] for chain in feats]
    weights = _sub_weights(cfg)
    loss_dis = x.new_zeros(())
    loss_adv = x.new_zeros(())
    for i, (fr, ff) in enumerate(zip(feats_real, feats_fake)):
        _dis, _adv = gan(fr[-1].to(x.dtype), ff[-1].to(x.dtype))
        w = weights[i] if weights is not None else 1.0
        loss_dis = loss_dis + w * _dis
        loss_adv = loss_adv + w * _adv
    return loss_dis, loss_adv, _feature_matching(cfg, feats_real, feats_fake)


def _class_ce(logits: torch.Tensor, labels: torch.Tensor,
              classes: int) -> torch.Tensor:
    if logits.dtype == torch.bfloat16:
        logits = logits.float()
    oh = F.one_hot(labels, classes).to(logits.dtype)
    return -torch.mean(torch.sum(F.log_softmax(logits, dim=-1) * oh, -1))


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, -1) == labels).float())


def unit_ce_terms(model: RAVE, z_pre: torch.Tensor, units: torch.Tensor,
                  num_units: int):
    """Unit cross-entropy and accuracy of the latent's projection,
    interpolated to the units' frame count."""
    logits = model.project_units(z_pre, units.shape[1])
    return _class_ce(logits, units, num_units), _accuracy(logits, units)


def reverse_gradient(z: torch.Tensor, lam: float) -> torch.Tensor:
    """``z`` forward; backward scales the gradient by ``-lam``."""
    return ((1 + lam) * z).detach() - lam * z


def speaker_terms(cfg: RAVEConfig, model: RAVE, z_pre: torch.Tensor,
                  emb: torch.Tensor, speaker: torch.Tensor) -> dict:
    """The speaker losses of a batch with ids ``speaker`` ``(B,)``: the
    AAM CE of the embedding (target-class margin) and the accuracy of the
    margin-free logits; with ``latent_adversary_weight`` the adversary's
    CE and accuracy on the content latent ``z_pre`` through
    :func:`reverse_gradient`, so that the encoder is pushed to remove what
    the adversary reads."""
    k = cfg.speaker_classes
    out = {"spk_ce": _class_ce(model.classify_speaker(emb, speaker),
                               speaker, k),
           "spk_acc": _accuracy(model.classify_speaker(emb), speaker)}
    if cfg.latent_adversary_weight > 0:
        logits = model.adversary_logits(
            reverse_gradient(z_pre, cfg.latent_adversary_weight))
        out["adv_ce"] = _class_ce(logits, speaker, k)
        out["adv_acc"] = _accuracy(logits, speaker)
    return out


def receptive_field_frames(cfg: RAVEConfig) -> tuple[int, int]:
    """Static ``(left, right)`` crop in band frames: the encoder's total
    kernel extent plus the PQMF taps, with a 9/8 margin, split
    symmetrically (causal graphs put it on the left, bar the offline
    PQMF's right padding)."""
    ke = 2 * cfg.kernel_size + 1
    rf = ke
    stride = 1
    for r, dils in zip(cfg.ratios,
                       cfg.dilations if not isinstance(cfg.dilations[0], int)
                       else [cfg.dilations] * len(cfg.ratios)):
        for d in dils:
            rf += ((cfg.kernel_size - 1) * d) * stride
        rf += 2 * r * stride
        stride *= r
    pq_right = 0
    if cfg.n_band > 1:
        Ha, pad_a, Hs, pad_s = _pqmf_kernels(cfg.pqmf_attenuation,
                                             cfg.n_band)
        rf += Ha.shape[0] + Hs.shape[0]
        pq_right = pad_a + pad_s
    rf_frames = max(1, rf * 9 // 8)
    if cfg.causal:
        return 2 * rf_frames, max(1, pq_right * 9 // 8 + 1)
    return rf_frames, rf_frames


def _forward_losses(cfg: RAVEConfig, model: RAVE, batch: Mapping, step: int,
                    eps: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    sampler=None, draws: Optional[Mapping] = None) -> dict:
    """Generator-side forward: every loss term but the GAN's, the latent
    regulariser (0 for the fork), the speaker terms (``aux``, see
    :func:`speaker_terms`) and the cropped real and fake audio.  The
    variational branch samples the latent with ``eps``, or draws it from
    ``generator``; the discrete branch quantizes it in a train pass
    (``sampler``, else ``generator``); ``draws`` holds the other random
    tensors (``ref``, ``aug``, ``noise``; see the module docstring)."""
    draws = draws or {}
    x = batch["x"]
    bands_x = model.pqmf_forward(x)
    x_p = batch.get("x_perturbed", x)
    bands_xp = model.pqmf_forward(x_p) if x_p is not x else bands_x
    z_pre = model.encode_input(bands_xp, x_p)

    ce = reg = x.new_zeros(())
    if cfg.hubert_units > 0 and "units" in batch:
        ce, _ = unit_ce_terms(model, z_pre, batch["units"], cfg.hubert_units)

    aux = {}
    if cfg.speaker_embedding_size:
        emb = model.speaker_embedding(bands_x)
        if cfg.speaker_classes > 0 and "speaker" in batch:
            aux = speaker_terms(cfg, model, z_pre, emb, batch["speaker"])
        # the decoder sees the detached latent (the encoder trains by the
        # CE terms) and the embedding as it is (a trained speaker encoder
        # learns from the reconstruction and GAN terms too)
        z_dec = model.condition(z_pre.detach(), emb)
    else:
        z_dec, reg = model.reparametrize(
            z_pre, eps, generator, train=True,
            enabled=schedules.quantize_enabled(step, cfg), sampler=sampler,
            ref=draws.get("ref"), aug=draws.get("aug"))
    # a pitch config: the normalised f0 of the clean signal (a function
    # of the data alone, so without gradient), by the batch's speaker
    # statistics where it has them, else by the item's own
    z_dec = model.append_pitch(z_dec, x, batch.get("f0_median"),
                               batch.get("f0_std"))
    bands_y = model.decode_bands(z_dec, draws.get("noise"), generator,
                                 schedules.warmed_up(step, cfg))

    if cfg.valid_signal_crop:
        lc, rc = receptive_field_frames(cfg)
        n = bands_x.shape[2]
        if lc + rc >= n:
            raise ValueError(
                f"valid_signal_crop removes {lc}+{rc} band frames but the "
                f"clip has only {n}; raise n_signal to at least "
                f"~{(lc + rc + 1) * cfg.n_band * 2} samples or set "
                "valid_signal_crop=false")
        bands_x = bands_x[:, :, lc:n - rc]
        bands_y = bands_y[:, :, lc:n - rc]
    x_full = model.pqmf_inverse(bands_x)
    y_full = model.pqmf_inverse(bands_y)

    if cfg.recon_loss == "mrstft":
        res = L.mr_stft_resolutions(cfg.sampling_rate, cfg.mr_stft_specs_ms)
        sc, mag = L.multi_resolution_stft_loss(y_full[..., 0],
                                               x_full[..., 0], res)
        dists = {"audio": (sc + mag) * cfg.mr_stft_weight}
    else:
        dists = {
            "multiband_spectral_distance": L.audio_distance_v1(
                bands_x, bands_y, cfg.stft_scales, cfg.log_epsilon),
            "fullband_spectral_distance": L.audio_distance_v1(
                x_full[..., 0], y_full[..., 0], cfg.stft_scales,
                cfg.log_epsilon)}
    return dict(x=x_full, y=y_full, ce=ce, reg=reg, dists=dists, aux=aux)


# ----------------------------------------------------------------------
# the step
# ----------------------------------------------------------------------

def _metric_names(cfg: RAVEConfig) -> tuple[str, ...]:
    """The metric set of every step, D or G (untaken terms are 0)."""
    names = ["loss_adversarial", "loss_feature_matching", "loss_ce",
             "loss_gen_total", "loss_dis", "loss_regularization"]
    if cfg.recon_loss == "mrstft":
        names.append("loss_audio")
    else:
        names += ["loss_multiband_spectral_distance",
                  "loss_fullband_spectral_distance"]
    if cfg.speaker_embedding_size > 0 and cfg.speaker_classes > 0:
        names += ["loss_speaker_ce", "speaker_accuracy"]
        if cfg.latent_adversary_weight > 0:
            names += ["loss_latent_adversary", "latent_adversary_accuracy"]
    return tuple(sorted(names))


def _fill_metrics(cfg, partial_metrics: Mapping) -> dict:
    out = {k: 0.0 for k in _metric_names(cfg)}
    out.update({k: v.detach() if torch.is_tensor(v) else float(v)
                for k, v in partial_metrics.items()})
    return out


@contextlib.contextmanager
def _frozen(module: torch.nn.Module):
    """Parameters of ``module`` require no gradient inside the block."""
    flags = [p.requires_grad for p in module.parameters()]
    module.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(module.parameters(), flags):
            p.requires_grad_(f)


def _generator_step(cfg: RAVEConfig, state: TrainState, batch,
                    eps: Optional[torch.Tensor], sampler, draws) -> dict:
    with _frozen(state.disc):
        out = _forward_losses(cfg, state.model, batch, state.step, eps,
                              state.generator, sampler, draws)
        loss_terms = dict(out["dists"])
        if not cfg.speaker_embedding_size:
            loss_terms["regularization"] = out["reg"] * schedules.beta_factor(
                state.step, cfg)
        zero = out["ce"].new_zeros(())
        loss_adv = fm = zero
        if schedules.warmed_up(state.step, cfg):
            _, loss_adv, fm = _gan_terms(cfg, state.disc, out["x"], out["y"])
        loss_terms["adversarial"] = loss_adv
        loss_terms["feature_matching"] = fm
        total = zero
        for k, v in loss_terms.items():
            total = total + v * cfg.weights.get(k, 1.0)
        total = total + out["ce"]
        metrics = {f"loss_{k}": v for k, v in loss_terms.items()}
        metrics["loss_ce"] = out["ce"]
        aux = out["aux"]
        if "spk_ce" in aux:
            total = total + aux["spk_ce"] * cfg.weights.get("speaker_ce", 1.0)
            metrics["loss_speaker_ce"] = aux["spk_ce"]
            metrics["speaker_accuracy"] = aux["spk_acc"]
        if "adv_ce" in aux:
            # weight 1: the reversal's -lambda scales the encoder's share,
            # the adversary head trains at full strength
            total = total + aux["adv_ce"]
            metrics["loss_latent_adversary"] = aux["adv_ce"]
            metrics["latent_adversary_accuracy"] = aux["adv_acc"]
        params = state.enc_params + state.dec_params + state.spk_params
        grads = torch.autograd.grad(total, params, allow_unused=True)
    # a parameter the loss does not reach gets a zero gradient, so Adam
    # moves it as optax does (torch's Adam skips a None gradient)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    # the gradient of the global batch under a process group
    mesh.all_reduce_mean([p.grad for p in params])
    state.enc_opt.step()
    state.dec_opt.step()
    if state.spk_opt is not None:
        state.spk_opt.step()
    state.update_ema()
    metrics["loss_gen_total"] = total
    return _fill_metrics(cfg, metrics)


def _discriminator_step(cfg: RAVEConfig, state: TrainState, batch,
                        eps: Optional[torch.Tensor], sampler, draws) -> dict:
    with torch.no_grad():
        out = _forward_losses(cfg, state.model, batch, state.step, eps,
                              state.generator, sampler, draws)
    loss_dis, _, _ = _gan_terms(cfg, state.disc, out["x"], out["y"])
    state.dis_opt.zero_grad(set_to_none=True)
    loss_dis.backward()
    mesh.all_reduce_mean([p.grad for p in state.disc.parameters()])
    state.dis_opt.step()
    return _fill_metrics(cfg, {"loss_dis": loss_dis})


def make_train_step(cfg: RAVEConfig):
    """``train_step(state, batch, eps=None, sampler=None, draws=None) ->
    metrics``: one D or G step
    chosen by ``state.step``, which it then advances.  ``batch`` holds
    ``x`` ``(B, T, 1)`` float32, optionally ``x_perturbed`` (same shape),
    ``units`` ``(B, frames)`` int64 and, for a pitch config,
    ``f0_median``/``f0_std`` ``(B,)`` float32, on the state's device.  ``eps``
    ``(B, latent, T_z)`` is the variational branch's latent noise;
    without it the step draws it from ``state.generator``.  ``sampler``
    ``(samples, num) -> rows`` draws the discrete branch's k-means seeds
    and fresh codes (default: rows with replacement from
    ``state.generator``).  ``draws`` maps ``ref``, ``aug`` and ``noise``
    to the other random tensors of the step (see the module docstring;
    each left out is drawn from ``state.generator``).  Metric values are
    0-d tensors on that device (or 0.0 for an untaken term), plus
    ``beta`` and ``warmed_up`` of the step taken.  A ``compute_dtype``
    other than float32 and bfloat16 raises ``ValueError``."""
    compute_dtype(cfg.compute_dtype)

    def train_step(state: TrainState, batch: Mapping,
                   eps: Optional[torch.Tensor] = None, sampler=None,
                   draws: Optional[Mapping] = None) -> dict:
        step = state.step
        with mesh.batch_sharded_step():
            if schedules.is_discriminator_step(step, cfg):
                metrics = _discriminator_step(cfg, state, batch, eps,
                                              sampler, draws)
            else:
                metrics = _generator_step(cfg, state, batch, eps, sampler,
                                          draws)
            metrics = mesh.mean_metrics(metrics)
        state.step = step + 1
        metrics["beta"] = schedules.beta_factor(step, cfg)
        metrics["warmed_up"] = float(schedules.warmed_up(step, cfg))
        return metrics

    return train_step


def make_eval_step(cfg: RAVEConfig):
    """``eval_step(state, batch, draws=None) -> (metrics, y, z_mean)``: the
    ``audio_distance_v1`` (``validation``) between ``x`` and the full
    forward ``y`` ``(B, T, 1)`` (its augmentation channels and noise
    branch from ``draws`` ``aug`` and ``noise``, else from
    ``state.generator``), and the pre-regularisation
    latent ``(B, T_z, C)``, its first half of the channels for a
    variational head (the posterior mean, which
    ``latent_stats.fit_latent_pca`` takes).  With
    ``units`` in the batch and unit CE in the config, also
    ``val_unit_ce`` and ``val_unit_accuracy``.  The model runs with
    ``train_mode`` off, as the JAX eval step builds it."""

    def eval_step(state: TrainState, batch: Mapping,
                  draws: Optional[Mapping] = None):
        model, x, draws = state.model, batch["x"], draws or {}
        g = state.generator
        with torch.no_grad(), serving_mode(model), mesh.batch_sharded_step():
            # the forward, its encoder pass shared with z_mean
            bands = model.pqmf_forward(x)
            z_pre = model.encode_input(bands, x)
            z = model.inference_latent(x, bands, z_pre, draws.get("aug"), g)
            y = model.decode(z.transpose(1, 2), draws.get("aug"),
                             draws.get("noise"), g)
            t = min(x.shape[1], y.shape[1])
            metrics = {"validation": L.audio_distance_v1(
                x[:, :t, 0], y[:, :t, 0], cfg.stft_scales, cfg.log_epsilon)}
            # the JAX package halves the channels whenever the head is
            # variational, the fork's single-channel latent included
            z_mean = (z_pre.chunk(2, dim=1)[0]
                      if cfg.latent_head == "variational" else z_pre
                      ).transpose(1, 2)
            if cfg.hubert_units > 0 and "units" in batch:
                ce, acc = unit_ce_terms(model, z_pre, batch["units"],
                                        cfg.hubert_units)
                metrics["val_unit_ce"] = ce
                metrics["val_unit_accuracy"] = acc
        return mesh.mean_metrics(metrics), y, z_mean

    return eval_step
