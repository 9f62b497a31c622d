"""RAVE: PQMF + encoder + latent head + generator, and the voice-conversion
fork's speaker-conditioned variant.

Port of ``rave_tpu/models/rave.py`` for every preset:
``v1`` / ``onnx`` / ``raspberry`` (EncoderV1, GeneratorV1 and its noise
branch), the v2 family (``v2``, ``v2_fork``, ``discrete``, ``v3``,
``discrete_v3``; the ``noise`` toggle adds GeneratorV2's noise branch),
``hybrid`` (the encoder reads the log1p mel spectrogram of the audio,
:class:`~rave_tpu_torch.models.blocks.MelFrontEnd`, with its own ratios
and dilations; GRU layers on the encoder's output and the decoder's
input) and the ``wasserstein`` and ``spherical`` heads.  ``encode``
takes the variational mean (deterministic), the raw latent of the
Wasserstein head, the normalised latent of the spherical head, the
residual-VQ quantized latent of the discrete head (its noise-augmentation
channels appended) or, speaker-conditioned, the raw content latent with the
frozen speaker embedding appended; ``encode_indices`` /
``decode_indices`` are the discrete head's integer codes ``(B,
n_quantizers, T_z)``; ``decode`` re-samples the noise-augmentation
channels of a latent that arrives without them (between the latent and
any trailing speaker or pitch channels), then runs the generator and
PQMF synthesis; ``forward`` is ``decode(encode(x))``; ``convert``
conditions a source's content on a target's speaker embedding.  Every
random draw (the augmentation channels ``aug``, the noise branch's
``noise``) is an argument or comes from a ``generator``; a streaming
model keeps each as a fixed draw in its caches
(:class:`~rave_tpu_torch.ops.conv.StreamDraw`).  The same module serves
offline (``streaming=False``) and chunked streaming (``streaming=True``,
caches carried in the conv modules; the speaker encoder always runs
offline).  With ``train_speaker_encoder`` the speaker encoder trains
with the rest (its embedding keeps its gradient; a BatchNorm encoder
takes batch statistics while ``train_mode`` holds), beside the AAM head
and the latent adversary (``train/loop.py``); so does EncoderV1's
BatchNorm.  With ``pitch_embedding_size`` (the ``pitch`` preset) the
decoder latent also carries the normalised f0 of the input audio
(:func:`~rave_tpu_torch.ops.pitch.pitch_feature`, per-utterance
statistics): in ``encode`` and ``convert`` (the source's f0, the
target's timbre).

``compute_dtype=bfloat16`` runs the encoder on its features cast to
bf16 and the decoder on the latent cast to bf16, each output cast back
to float32 (the JAX package's ``encode_input`` / ``decode_bands``); the
parameters stay float32 and are cast per call, so checkpoints, the
converter and the state dicts do not change.  PQMF, the latent heads,
the speaker encoder, the unit projection and f0 stay float32.

Options outside the port raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from .. import resolve_device
from ..config import RAVEConfig
from ..ops.conv import StreamDraw, StreamSetup
from ..ops.pitch import pitch_feature
from ..ops.precision import compute_dtype
from ..ops.pqmf import PQMF, _pqmf_kernels
from .blocks import (AdaIN, BatchNorm, EncoderV1, EncoderV2, GeneratorV1,
                     GeneratorV2, MelFrontEnd, mel_front_delay)
from .latent import (DiscreteHead, SphericalHead, VariationalHead,
                     WassersteinHead)
from .quantization import Sampler, sample_vectors
from .speaker import AAMSpeakerHead, SpeakerRAVE


HEADS = ("variational", "wasserstein", "spherical", "discrete")


def check_supported(cfg: RAVEConfig) -> None:
    """Raise for options the port does not build.  bf16 with GRU
    layers (``hybrid``) raises ``NotImplementedError``: the JAX package
    cannot run it (flax's GRU cell promotes a bf16 input to float32,
    and its scan refuses a carry that changes dtype), so there is no
    behaviour to port (ROADMAP C)."""
    if (compute_dtype(cfg.compute_dtype) != torch.float32
            and (cfg.encoder_gru_layers or cfg.decoder_gru_layers)):
        raise NotImplementedError(
            f"compute_dtype {cfg.compute_dtype!r} with GRU layers: the JAX "
            "package's GRU scan cannot carry bfloat16 (its cell promotes "
            "to float32), so there is nothing to port (ROADMAP C)")
    if cfg.latent_head not in HEADS:
        raise ValueError(f"unknown latent head {cfg.latent_head!r}")
    for part in ("encoder_version", "generator_version"):
        if getattr(cfg, part) not in ("v1", "v2"):
            raise ValueError(f"unknown {part} {getattr(cfg, part)!r}")
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
    head, 1 for the other heads or when speaker-conditioned (the fork
    feeds the raw latent to the decoder and trains the encoder by unit CE
    only)."""
    return (VariationalHead.num_out() if cfg.latent_head == "variational"
            and not cfg.speaker_embedding_size else 1)


def pqmf_in_delay(cfg: RAVEConfig) -> int:
    """Streaming delay of the encoder's input stream in its frames: the
    mel front end's in mel frames for a mel config, else the PQMF
    analysis delay in band frames."""
    if cfg.use_mel_encoder:
        return mel_front_delay(cfg.mel_n_fft, cfg.mel_hop)
    if cfg.n_band > 1:
        _, pad_a, _, _ = _pqmf_kernels(cfg.pqmf_attenuation, cfg.n_band)
        return pad_a
    return 0


def make_encoder(cfg: RAVEConfig, ss: StreamSetup) -> nn.Module:
    """EncoderV2, or EncoderV1 (``v1`` presets: leaky ReLU, no weight
    norm, whatever the config says of them, as in the JAX package)."""
    if cfg.encoder_version == "v1":
        return EncoderV1(
            data_size=cfg.effective_encoder_data_size(),
            capacity=cfg.capacity, latent_size=cfg.latent_size,
            ratios=cfg.ratios, n_out=encoder_n_out(cfg),
            sample_norm=cfg.v1_sample_norm,
            repeat_layers=cfg.v1_repeat_layers, ss=ss)
    return EncoderV2(
        data_size=(cfg.mel_n_mels if cfg.use_mel_encoder
                   else cfg.effective_encoder_data_size()),
        capacity=cfg.capacity,
        ratios=cfg.encoder_ratios or cfg.ratios,
        latent_size=cfg.latent_size, n_out=encoder_n_out(cfg),
        kernel_size=cfg.kernel_size,
        dilations=cfg.encoder_dilations or cfg.dilations,
        keep_dim=cfg.keep_dim, activation=cfg.activation,
        weight_norm=cfg.weight_norm, adain=cfg.adain,
        fused=cfg.fused_kernels, in_delay=pqmf_in_delay(cfg),
        gru_layers=cfg.encoder_gru_layers, ss=ss)


def make_decoder(cfg: RAVEConfig, ss: StreamSetup) -> nn.Module:
    """GeneratorV2 (with its noise branch under ``use_noise``), or
    GeneratorV1 (``v1`` presets, its noise branch under
    ``v1_use_noise``)."""
    if cfg.generator_version == "v1":
        return GeneratorV1(
            latent_size=cfg.decoder_latent_size(), capacity=cfg.capacity,
            data_size=cfg.n_band, ratios=cfg.ratios,
            loud_stride=cfg.v1_loud_stride, use_noise=cfg.v1_use_noise,
            kernel_sizes=cfg.v1_kernel_sizes,
            dilations_list=cfg.v1_dilations_list,
            activation=cfg.activation, weight_norm=cfg.weight_norm, ss=ss)
    return GeneratorV2(
        data_size=cfg.n_band, capacity=cfg.capacity, ratios=cfg.ratios,
        latent_size=cfg.decoder_latent_size(), kernel_size=cfg.kernel_size,
        dilations=cfg.dilations, keep_dim=cfg.keep_dim,
        amplitude_modulation=cfg.amplitude_modulation,
        use_noise=cfg.use_noise, noise_ratios=cfg.noise_ratios,
        noise_bands=cfg.noise_bands,
        activation=cfg.activation, weight_norm=cfg.weight_norm,
        adain=cfg.adain, fused=cfg.fused_kernels,
        gru_layers=cfg.decoder_gru_layers, ss=ss)


def band_frame_delay(cfg: RAVEConfig, ss: StreamSetup) -> int:
    """Composite encoder + decoder streaming delay in band frames: the
    encoder's latent-frame delay scaled through the decoder's upsamplers
    (the DECODER's ratios: a mel encoder has its own) plus the decoder's
    own delay."""
    # built on the meta device: delay algebra only, no memory, no RNG draws
    with torch.device("meta"):
        enc, dec = make_encoder(cfg, ss), make_decoder(cfg, ss)
    return _compose_delay(cfg, enc, dec)


def _compose_delay(cfg: RAVEConfig, enc: nn.Module, dec: nn.Module) -> int:
    dec_ratio_total = 1
    for r in cfg.ratios:
        dec_ratio_total *= r
    return enc.out_delay * dec_ratio_total + dec.out_delay


def make_head(cfg: RAVEConfig) -> nn.Module:
    if cfg.latent_head == "discrete":
        return DiscreteHead(cfg.num_quantizers, cfg.latent_size,
                            cfg.codebook_size, cfg.noise_augmentation)
    if cfg.latent_head == "wasserstein":
        return WassersteinHead(cfg.noise_augmentation)
    if cfg.latent_head == "spherical":
        return SphericalHead()
    return VariationalHead()


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
    """The codec.  Audio ``(B, T, 1)`` <-> latent ``(B, T_z, latent)``.

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
        self.dtype = compute_dtype(cfg.compute_dtype)
        ss = stream_setup(cfg, streaming)
        self.mel_frontend = (MelFrontEnd(cfg.mel_n_fft, cfg.mel_hop,
                                         cfg.mel_n_mels, cfg.sampling_rate, ss)
                             if cfg.use_mel_encoder else None)
        self.encoder = make_encoder(cfg, ss)
        self.latent = make_head(cfg)
        # the augmentation channels of a latent that goes without them
        self.latent_noise = (StreamDraw("normal", ss)
                             if cfg.noise_augmentation else None)
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
        holds; EncoderV1's BatchNorms, and those of a speaker encoder
        trained from scratch, normalise by batch statistics (and advance
        their running ones) while it holds, by stored ones otherwise."""
        self.train_mode = on
        for m in self.modules():
            if isinstance(m, AdaIN):
                m.train_mode = on
        for m in self.encoder.modules():
            if isinstance(m, BatchNorm):
                m.train_bn = on
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

    def encode_input(self, bands: Optional[torch.Tensor],
                     x: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Bands -> pre-regularisation latent ``(B, n_out * latent, T_z)``
        from the first ``encoder_data_size`` bands; a mel config reads
        the log1p mel spectrogram of the audio ``x`` ``(B, T, 1)`` instead
        (its bands may be None).  The encoder runs in the compute dtype;
        its output is float32."""
        if self.mel_frontend is not None:
            feats = self.mel_frontend(x[..., 0])
        else:
            feats = bands[:, :self.cfg.effective_encoder_data_size()]
        return self._from_trunk(self.encoder(self._to_trunk(feats)))

    def _to_trunk(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` in the compute dtype; under float32 unchanged (a float64
        copy of the model stays float64)."""
        return t if self.dtype == torch.float32 else t.to(self.dtype)

    def _from_trunk(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.dtype == torch.float32 else t.float()

    def input_bands(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The bands of ``x`` where inference reads them (the encoder or
        the speaker encoder), else None: a mel config without a speaker
        encoder runs no PQMF analysis."""
        if self.mel_frontend is not None and self.speaker_encoder is None:
            return None
        return self.pqmf_forward(x)

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

    def encoded_size(self) -> int:
        """Channels of :meth:`encode`'s latent: the decoder's, less the
        augmentation channels, which only the discrete head appends
        there (``decode`` re-samples them for the others)."""
        n = (0 if isinstance(self.latent, DiscreteHead)
             else self.cfg.noise_augmentation)
        return self.cfg.decoder_latent_size() - n

    def latent_aug(self, z: torch.Tensor, aug: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
        """The noise-augmentation channels ``(B, noise_augmentation,
        T_z)`` for the latent ``z`` ``(B, C, T_z)``: ``aug``, or a standard
        normal draw from ``generator`` (a stream's fixed draw while
        streaming); None without ``noise_augmentation``."""
        if self.latent_noise is None:
            return None
        n = self.cfg.noise_augmentation
        return self.latent_noise((z.shape[0], n, z.shape[2]), z, aug,
                                 generator)

    def reparametrize(self, z: torch.Tensor,
                      eps: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      train: bool = False, enabled=True,
                      sampler: Optional[Sampler] = None,
                      ref: Optional[torch.Tensor] = None,
                      aug: Optional[torch.Tensor] = None):
        """Pre-regularisation latent -> ``(z, regulariser)``.  Variational:
        ``(B, 2 * latent, T_z)`` -> the sample ``(B, latent, T_z)`` and
        the KL, with the noise ``eps`` (shaped like the sample) or drawn
        from ``generator``.  Wasserstein: the latent and the MMD to the
        normal reference ``ref`` (shaped like it, or drawn).  Spherical:
        the normalised latent and 0.  Discrete: the quantized latent
        (gated by ``enabled``) and the commitment loss; a ``train`` pass
        updates the codebooks, its random rows drawn by ``sampler`` or
        else from ``generator``.  The Wasserstein and discrete heads
        append the augmentation channels (:meth:`latent_aug` of ``aug``
        or ``generator``)."""
        head = self.latent
        if isinstance(head, DiscreteHead):
            if train and sampler is None:
                def sampler(samples, num):
                    return sample_vectors(samples, num, generator)
            return head(z, train, enabled, sampler,
                        self.latent_aug(z, aug, generator))
        if isinstance(head, WassersteinHead):
            return head(z, ref, self.latent_aug(z, aug, generator),
                        generator)
        if isinstance(head, SphericalHead):
            return head(z)
        return head(z, eps, generator)

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

    def encode(self, x: torch.Tensor, aug: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Audio ``(B, T, 1)`` -> latent ``(B, T_z, C)`` (see
        :meth:`inference_latent`)."""
        bands = self.input_bands(x)
        return self.inference_latent(x, bands, self.encode_input(bands, x),
                                     aug, generator).transpose(1, 2)

    def inference_latent(self, x: torch.Tensor, bands: torch.Tensor,
                         z_pre: torch.Tensor,
                         aug: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
        """The decoder's latent ``(B, C, T_z)`` at inference from the
        audio ``x``, its ``bands`` and their pre-regularisation latent:
        the variational mean, the raw latent (Wasserstein head, or
        speaker-conditioned), the normalised latent (spherical head) or
        the quantized latent with its augmentation channels
        (:meth:`latent_aug`); the speaker embedding appended where there
        is a speaker encoder; then :meth:`append_pitch`."""
        head = self.latent
        if isinstance(head, DiscreteHead):
            z, _ = head(z_pre, aug=self.latent_aug(z_pre, aug, generator))
        elif isinstance(head, SphericalHead):
            z, _ = head(z_pre)
        elif (isinstance(head, VariationalHead)
              and self.speaker_encoder is None):
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
        return head.encode(self.encode_input(self.input_bands(x), x))

    def decode_indices(self, idx: torch.Tensor,
                       aug: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
        """RVQ indices ``(B, n_quantizers, T_z)`` -> audio ``(B, T, 1)``
        (discrete head only; the augmentation channels re-sampled as in
        :meth:`decode`)."""
        head = self._discrete_head("decode_indices")
        return self.decode(head.decode(idx).transpose(1, 2), aug, noise,
                           generator)

    def decode_bands(self, z: torch.Tensor,
                     noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     warmed_up=True) -> torch.Tensor:
        """Latent ``(B, C, T_z)`` -> bands ``(B, M, T/M)``.  ``noise`` (or
        ``generator``) is the noise branch's uniform draw, whose output
        GeneratorV1 gates by ``warmed_up``.  The decoder runs in the
        compute dtype; the bands are float32."""
        z = self._to_trunk(z)
        if isinstance(self.decoder, GeneratorV1):
            y = self.decoder(z, noise, generator, warmed_up)
        else:
            y = self.decoder(z, noise, generator)
        return self._from_trunk(y)

    def decode(self, z: torch.Tensor, aug: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Latent ``(B, T_z, C)`` -> audio ``(B, T, 1)``.  A latent short
        of the ``noise_augmentation`` channels gets them
        (:meth:`latent_aug`) after its first ``latent_size`` channels."""
        cfg = self.cfg
        z = z.transpose(1, 2)
        n = cfg.noise_augmentation
        if n and z.shape[1] == cfg.decoder_latent_size() - n:
            lat = cfg.latent_size
            z = torch.cat([z[:, :lat], self.latent_aug(z, aug, generator),
                           z[:, lat:]], dim=1)
        return self.pqmf_inverse(self.decode_bands(z, noise, generator))

    def forward(self, x: torch.Tensor, aug: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.decode(self.encode(x, aug, generator), aug, noise,
                           generator)

    def convert(self, x: torch.Tensor, target: torch.Tensor,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Voice conversion, offline: the content of ``x`` ``(B, T, 1)``
        in the voice of ``target`` ``(B, T', 1)``.  The first
        ``min(T, T')`` samples of each are cut into ``segs`` segments (4
        from 4 * 32768 samples on, else 2) and embedded as ONE batch,
        sources first, so that a cohort-norm encoder whitens each target
        against the sources; the embedding is the mean over the target's
        segments.  A segment length that is not a multiple of the band
        count fails in the PQMF, as in the JAX package.  A pitch config
        appends the source's normalised f0.  ``noise``/``generator``:
        the noise branch's draw (:meth:`decode_bands`)."""
        if self.speaker_encoder is None:
            raise ValueError("convert needs a speaker-conditioned model")
        bands = self.pqmf_forward(x)
        z = self.encode_input(bands, x)
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
        return self.pqmf_inverse(self.decode_bands(z, noise, generator))
