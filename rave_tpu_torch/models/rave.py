"""RAVE v2 codec: PQMF + EncoderV2 + latent head + GeneratorV2, and the
voice-conversion fork's speaker-conditioned variant.

Port of ``rave_tpu/models/rave.py`` for the v2, ``v2_fork``, ``discrete``,
``v3`` and ``discrete_v3`` presets (Snake and AdaIN are options of the
blocks): ``encode`` takes the variational mean (deterministic), the
residual-VQ quantized latent of the discrete head or, speaker-
conditioned, the raw content latent with the frozen speaker embedding
appended; ``encode_indices`` / ``decode_indices`` are the discrete head's
integer codes ``(B, n_quantizers, T_z)``; ``decode`` runs the generator
and PQMF synthesis; ``forward`` is ``decode(encode(x))``; ``convert``
conditions a source's content on a target's speaker embedding.  The same
module serves offline
(``streaming=False``) and chunked streaming (``streaming=True``, caches
carried in the conv modules; the speaker encoder always runs offline).
With ``train_speaker_encoder`` the speaker encoder trains with the rest
(its embedding keeps its gradient; a BatchNorm encoder takes batch
statistics while ``train_mode`` holds), beside the AAM head and the
latent adversary (``train/loop.py``).  With ``pitch_embedding_size``
(the ``pitch`` preset) the decoder latent also carries the normalised f0
of the input audio (:func:`~rave_tpu_torch.ops.pitch.pitch_feature`,
per-utterance statistics): in ``encode`` and ``convert`` (the source's
f0, the target's timbre).

Options outside this slice raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from .. import resolve_device
from ..config import RAVEConfig
from ..ops.conv import StreamSetup
from ..ops.pitch import pitch_feature
from ..ops.pqmf import PQMF, _pqmf_kernels
from .blocks import AdaIN, EncoderV2, GeneratorV2
from .latent import DiscreteHead, VariationalHead
from .quantization import Sampler, sample_vectors
from .speaker import AAMSpeakerHead, SpeakerRAVE


def check_supported(cfg: RAVEConfig) -> None:
    """Raise ``NotImplementedError`` for options this slice lacks."""
    unsupported = [
        (cfg.encoder_version != "v2" or cfg.generator_version != "v2",
         "v1 encoder/generator blocks", "A6"),
        (cfg.use_noise, "the noise generator", "A6"),
        (cfg.use_mel_encoder or cfg.encoder_gru_layers
         or cfg.decoder_gru_layers, "the mel front end and GRU layers", "A7"),
        (cfg.latent_head in ("wasserstein", "spherical"),
         f"the {cfg.latent_head} latent head", "A6"),
        (cfg.noise_augmentation, "noise augmentation of the latent", "A6"),
        (cfg.compute_dtype != "float32",
         f"compute_dtype {cfg.compute_dtype!r}", "A10"),
    ]
    for bad, what, item in unsupported:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported to rave_tpu_torch yet (ROADMAP {item})")
    if cfg.latent_head not in ("variational", "discrete"):
        raise ValueError(f"unknown latent head {cfg.latent_head!r}")
    speaker_norm(cfg)


def speaker_norm(cfg: RAVEConfig) -> str:
    """The speaker encoder's norm: ``"cohort"`` (batch statistics) or
    ``"batch"`` (stored statistics); ``"auto"`` is ``"cohort"`` when the
    encoder is trained from scratch (``train_speaker_encoder``)."""
    norm = cfg.speaker_norm
    if norm == "auto":
        norm = "cohort" if cfg.train_speaker_encoder else "batch"
    if norm not in ("cohort", "batch"):
        raise ValueError(f"unknown speaker_norm {cfg.speaker_norm!r}")
    return norm


def encoder_n_out(cfg: RAVEConfig) -> int:
    """Latent channels per latent dim: 2 (mean, scale) for the variational
    head, 1 for the discrete head or when speaker-conditioned (the fork
    feeds the raw latent to the decoder and trains the encoder by unit CE
    only)."""
    return (VariationalHead.num_out() if cfg.latent_head == "variational"
            and not cfg.speaker_embedding_size else 1)


def pqmf_in_delay(cfg: RAVEConfig) -> int:
    """Streaming delay of the encoder's input stream in band frames (the
    PQMF analysis delay)."""
    if cfg.n_band > 1:
        _, pad_a, _, _ = _pqmf_kernels(cfg.pqmf_attenuation, cfg.n_band)
        return pad_a
    return 0


def make_encoder(cfg: RAVEConfig, ss: StreamSetup) -> EncoderV2:
    return EncoderV2(
        data_size=cfg.effective_encoder_data_size(), capacity=cfg.capacity,
        ratios=cfg.encoder_ratios or cfg.ratios,
        latent_size=cfg.latent_size, n_out=encoder_n_out(cfg),
        kernel_size=cfg.kernel_size,
        dilations=cfg.encoder_dilations or cfg.dilations,
        keep_dim=cfg.keep_dim, activation=cfg.activation,
        weight_norm=cfg.weight_norm, adain=cfg.adain,
        fused=cfg.fused_kernels, in_delay=pqmf_in_delay(cfg), ss=ss)


def make_decoder(cfg: RAVEConfig, ss: StreamSetup) -> GeneratorV2:
    return GeneratorV2(
        data_size=cfg.n_band, capacity=cfg.capacity, ratios=cfg.ratios,
        latent_size=cfg.decoder_latent_size(), kernel_size=cfg.kernel_size,
        dilations=cfg.dilations, keep_dim=cfg.keep_dim,
        amplitude_modulation=cfg.amplitude_modulation,
        activation=cfg.activation, weight_norm=cfg.weight_norm,
        adain=cfg.adain, fused=cfg.fused_kernels, ss=ss)


def band_frame_delay(cfg: RAVEConfig, ss: StreamSetup) -> int:
    """Composite encoder + decoder streaming delay in band frames: the
    encoder's latent-frame delay scaled through the decoder's upsamplers
    plus the decoder's own delay."""
    # built on the meta device: delay algebra only, no memory, no RNG draws
    with torch.device("meta"):
        enc, dec = make_encoder(cfg, ss), make_decoder(cfg, ss)
    return _compose_delay(cfg, enc, dec)


def _compose_delay(cfg: RAVEConfig, enc: EncoderV2, dec: GeneratorV2) -> int:
    dec_ratio_total = 1
    for r in cfg.ratios:
        dec_ratio_total *= r
    return enc.out_delay * dec_ratio_total + dec.out_delay


def stream_setup(cfg: RAVEConfig, streaming: bool) -> StreamSetup:
    return StreamSetup(mode="causal" if cfg.causal else "centered",
                       streaming=streaming)


@contextlib.contextmanager
def serving_mode(model: "RAVE"):
    """``model`` with ``train_mode`` off inside the block (the JAX
    package's ``RAVE(train_mode=False)`` on the same variables), restored
    after it."""
    before = model.train_mode
    model.set_train_mode(False)
    try:
        yield model
    finally:
        model.set_train_mode(before)


class CrossEntropyProjection(nn.Module):
    """Latent -> discrete-unit logits: LayerNorm over the TIME axis (its
    scale and bias have length ``frames``, flax's epsilon 1e-6), a dense
    layer to ``units`` classes, and nearest-index interpolation
    ``(arange(tf) * T) // tf`` to the unit frame count."""

    def __init__(self, latent_size: int, frames: int, units: int = 100,
                 target_frames: int = 148):
        super().__init__()
        self.target_frames = target_frames
        self.norm = nn.LayerNorm(frames, eps=1e-6)
        self.dense = nn.Linear(latent_size, units)

    def forward(self, z: torch.Tensor,
                target_frames: Optional[int] = None) -> torch.Tensor:
        """``z`` ``(B, C, T)`` -> logits ``(B, tf, units)``."""
        logits = self.dense(self.norm(z).transpose(1, 2))   # (B, T, U)
        tf = self.target_frames if target_frames is None else target_frames
        if tf <= 0:
            raise ValueError(f"target_frames must be positive, got {tf}")
        T = logits.shape[1]
        idx = torch.clamp(torch.arange(tf, device=z.device) * T // tf, 0, T - 1)
        return logits[:, idx]


class RAVE(nn.Module):
    """The v2 codec.  Audio ``(B, T, 1)`` <-> latent ``(B, T_z, latent)``.

    Speaker-conditioned configs (``v2_fork``) add the speaker encoder,
    whose 256-dim embedding is appended to the latent (frozen unless
    ``train_speaker_encoder``), and the unit cross-entropy projection
    (``hubert_units``).  ``train_mode`` (the JAX module's flag; see
    :meth:`set_train_mode`) runs a trained BatchNorm speaker encoder on
    batch statistics; serving and evaluation build with
    ``train_mode=False``.  Parameters are initialised from PyTorch's
    global generator (seed it with ``torch.manual_seed``) and placed on
    ``device``.
    """

    def __init__(self, cfg: RAVEConfig, streaming: bool = False,
                 device="cuda", train_mode: bool = True):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.streaming = streaming
        ss = stream_setup(cfg, streaming)
        self.encoder = make_encoder(cfg, ss)
        self.latent = (DiscreteHead(cfg.num_quantizers, cfg.latent_size,
                                    cfg.codebook_size)
                       if cfg.latent_head == "discrete" else VariationalHead())
        self.decoder = make_decoder(cfg, ss)
        # composite streaming delay at the band rate; an odd lag flips
        # the synthesis-side reverse_half mask
        self.band_delay = (_compose_delay(cfg, self.encoder, self.decoder)
                           if streaming else 0)
        self.pqmf = PQMF(attenuation=cfg.pqmf_attenuation, n_band=cfg.n_band,
                         inverse_parity=self.band_delay % 2, ss=ss)
        self.speaker_encoder = None
        if cfg.speaker_embedding_size:
            # built without the stream setup, so offline and centered
            # even in a streaming model
            self.speaker_encoder = SpeakerRAVE(
                cfg.n_band, cohort_norm=speaker_norm(cfg) == "cohort")
            self.speaker_encoder.requires_grad_(cfg.train_speaker_encoder)
        self.ce_projection = None
        if cfg.hubert_units:
            self.ce_projection = CrossEntropyProjection(
                cfg.latent_size * encoder_n_out(cfg),
                cfg.n_signal // cfg.total_ratio(), cfg.hubert_units)
        self.latent_adversary = None
        if (cfg.speaker_embedding_size and cfg.latent_adversary_weight > 0
                and cfg.speaker_classes > 0):
            # speaker probe on the mean and std of the content latent;
            # indices 0, 1, 3 are flax's layers_0, layers_1, layers_3
            width = 2 * cfg.latent_size * encoder_n_out(cfg)
            self.latent_adversary = nn.Sequential(
                nn.LayerNorm(width, eps=1e-6), nn.Linear(width, 128),
                nn.ReLU(), nn.Linear(128, cfg.speaker_classes))
        self.speaker_classifier = None
        if cfg.speaker_embedding_size and cfg.speaker_classes > 0:
            self.speaker_classifier = AAMSpeakerHead(
                cfg.speaker_embedding_size, cfg.speaker_classes)
        self.set_train_mode(train_mode)
        self.to(device)

    def set_train_mode(self, on: bool) -> None:
        """The JAX module's ``train_mode``: AdaIN is the identity while it
        holds; a BatchNorm speaker encoder trained from scratch normalises
        by batch statistics (and advances its running ones) while it
        holds, by stored ones otherwise."""
        self.train_mode = on
        for m in self.modules():
            if isinstance(m, AdaIN):
                m.train_mode = on
        if self.speaker_encoder is not None:
            self.speaker_encoder.train_bn = (
                on and self.cfg.train_speaker_encoder
                and speaker_norm(self.cfg) == "batch")

    def pqmf_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Audio ``(B, T, 1)`` -> bands ``(B, M, T/M)``."""
        return self.pqmf(x)

    def pqmf_inverse(self, y: torch.Tensor) -> torch.Tensor:
        """Bands ``(B, M, T/M)`` -> audio ``(B, T, 1)``."""
        return self.pqmf.inverse(y)

    def encode_input(self, bands: torch.Tensor) -> torch.Tensor:
        """Bands -> pre-regularisation latent ``(B, n_out * latent, T_z)``
        from the first ``encoder_data_size`` bands."""
        return self.encoder(bands[:, :self.cfg.effective_encoder_data_size()])

    def speaker_embedding(self, bands: torch.Tensor) -> torch.Tensor:
        """Speaker embedding ``(B, 256)`` of all bands: with
        ``train_speaker_encoder`` under gradient, else frozen (taken
        without gradient)."""
        if self.cfg.train_speaker_encoder:
            return self.speaker_encoder(bands)
        with torch.no_grad():
            return self.speaker_encoder(bands)

    @staticmethod
    def condition(z: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """Append the embedding ``(B, E)`` to every frame of ``z``
        ``(B, C, T_z)``."""
        return torch.cat([z, emb[:, :, None].expand(-1, -1, z.shape[2])],
                         dim=1)

    def adversary_logits(self, z: torch.Tensor) -> torch.Tensor:
        """Speaker logits ``(B, classes)`` of the latent adversary from the
        content latent ``(B, C, T_z)``: its mean and biased std over time,
        then the MLP."""
        pooled = torch.cat([z.mean(dim=2), z.std(dim=2, correction=0)],
                           dim=-1)
        return self.latent_adversary(pooled)

    def classify_speaker(self, emb: torch.Tensor,
                         labels: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """Speaker-id logits ``(B, classes)`` of the embedding ``(B, E)``
        by the AAM head; with ``labels`` the target class's margin is
        applied."""
        return self.speaker_classifier(emb, labels)

    def reparametrize(self, z: torch.Tensor,
                      eps: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      train: bool = False, enabled=True,
                      sampler: Optional[Sampler] = None):
        """Pre-regularisation latent -> ``(z, regulariser)``.  Variational:
        ``(B, 2 * latent, T_z)`` -> the sample ``(B, latent, T_z)`` and
        the KL, with the noise ``eps`` (shaped like the sample) or drawn
        from ``generator``.  Discrete: the quantized latent (gated by
        ``enabled``) and the commitment loss; a ``train`` pass updates
        the codebooks, its random rows drawn by ``sampler`` or else from
        ``generator``."""
        if isinstance(self.latent, DiscreteHead):
            if train and sampler is None:
                def sampler(samples, num):
                    return sample_vectors(samples, num, generator)
            return self.latent(z, train, enabled, sampler)
        return self.latent(z, eps, generator)

    def project_units(self, z: torch.Tensor,
                      target_frames: Optional[int] = None) -> torch.Tensor:
        """Latent ``(B, C, T_z)`` -> unit logits ``(B, tf, units)``."""
        return self.ce_projection(z, target_frames)

    def append_pitch(self, z: torch.Tensor, x: torch.Tensor,
                     median: Optional[torch.Tensor] = None,
                     std: Optional[torch.Tensor] = None) -> torch.Tensor:
        """With ``pitch_embedding_size``, append to ``z`` ``(B, C, T_z)``
        the normalised f0 of the audio ``x`` ``(B, T, 1)``, by the
        log-f0 ``median``/``std`` ``(B,)`` where given, else by the
        item's own; without it, ``z``."""
        cfg = self.cfg
        if not cfg.pitch_embedding_size:
            return z
        feat = pitch_feature(x, z.shape[2], cfg.sampling_rate,
                             hop=cfg.pitch_hop, fmin=cfg.pitch_fmin,
                             fmax=cfg.pitch_fmax, median=median, std=std,
                             channels=cfg.pitch_embedding_size,
                             estimator=cfg.pitch_estimator,
                             fcpe_ckpt=cfg.pitch_ckpt)
        return torch.cat([z, feat.transpose(1, 2)], dim=1)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Audio ``(B, T, 1)`` -> latent ``(B, T_z, C)``: the variational
        mean or the quantized latent, or the raw latent and the speaker
        embedding; then the normalised f0 of a pitch config."""
        bands = self.pqmf_forward(x)
        return self.inference_latent(x, bands,
                                     self.encode_input(bands)).transpose(1, 2)

    def inference_latent(self, x: torch.Tensor, bands: torch.Tensor,
                         z_pre: torch.Tensor) -> torch.Tensor:
        """The decoder's latent ``(B, C, T_z)`` at inference from the
        audio ``x``, its ``bands`` and their pre-regularisation latent:
        the variational mean or the quantized latent, or the raw latent;
        the speaker embedding appended where there is a speaker encoder;
        then :meth:`append_pitch`."""
        if isinstance(self.latent, DiscreteHead):
            z, _ = self.latent(z_pre)
        elif self.speaker_encoder is None:
            z, _ = VariationalHead.mean_scale(z_pre)
        else:
            z = z_pre
        if self.speaker_encoder is not None:
            z = self.condition(z, self.speaker_embedding(bands))
        return self.append_pitch(z, x)

    def _discrete_head(self, what: str) -> DiscreteHead:
        if not isinstance(self.latent, DiscreteHead):
            raise ValueError(f"{what} requires latent_head=discrete")
        return self.latent

    def encode_indices(self, x: torch.Tensor) -> torch.Tensor:
        """Audio ``(B, T, 1)`` -> RVQ indices ``(B, n_quantizers, T_z)``
        int64 (discrete head only)."""
        head = self._discrete_head("encode_indices")
        return head.encode(self.encode_input(self.pqmf_forward(x)))

    def decode_indices(self, idx: torch.Tensor) -> torch.Tensor:
        """RVQ indices ``(B, n_quantizers, T_z)`` -> audio ``(B, T, 1)``
        (discrete head only)."""
        head = self._discrete_head("decode_indices")
        return self.pqmf_inverse(self.decode_bands(head.decode(idx)))

    def decode_bands(self, z: torch.Tensor) -> torch.Tensor:
        """Latent ``(B, C, T_z)`` -> bands ``(B, M, T/M)``."""
        return self.decoder(z)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latent ``(B, T_z, C)`` -> audio ``(B, T, 1)``."""
        return self.pqmf_inverse(self.decode_bands(z.transpose(1, 2)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))

    def convert(self, x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Voice conversion, offline: the content of ``x`` ``(B, T, 1)``
        in the voice of ``target`` ``(B, T', 1)``.  The first
        ``min(T, T')`` samples of each are cut into ``segs`` segments (4
        from 4 * 32768 samples on, else 2) and embedded as ONE batch,
        sources first, so that a cohort-norm encoder whitens each target
        against the sources; the embedding is the mean over the target's
        segments.  A segment length that is not a multiple of the band
        count fails in the PQMF, as in the JAX package.  A pitch config
        appends the source's normalised f0."""
        if self.speaker_encoder is None:
            raise ValueError("convert needs a speaker-conditioned model")
        bands = self.pqmf_forward(x)
        z = self.encode_input(bands)
        B = target.shape[0]
        T = min(x.shape[1], target.shape[1])
        segs = 4 if T >= 4 * 32768 else 2
        seg_len = T // segs

        def chunks(a):
            return a[:, :segs * seg_len].reshape(B * segs, seg_len,
                                                 a.shape[-1])

        cohort = torch.cat([chunks(x), chunks(target)], dim=0)
        emb_all = self.speaker_embedding(self.pqmf_forward(cohort))
        emb = emb_all.reshape(2, B, segs, -1)[1].mean(dim=1)
        # the source's prosody, the target's timbre
        z = self.append_pitch(self.condition(z, emb), x)
        return self.pqmf_inverse(self.decode_bands(z))
