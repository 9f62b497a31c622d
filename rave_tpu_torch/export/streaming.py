"""Chunked streaming inference and export for the v2 codec, ``v2_fork``,
``discrete`` and ``v3``.

Port of ``rave_tpu/export/streaming.py``.  The model is rebuilt in
streaming mode and the offline parameters are loaded unchanged; each conv
carries its left context (or overlap-add tail, or delay line) as a cache
tensor from one chunk to the next.  The caches are explicit state: built
at construction for ``batch_size``, and every chunk goes through a pure
step ``(caches, x) -> (y, caches)`` (:class:`~rave_tpu_torch.ops.conv.
StreamStep`) over them in a fixed module order, which the stateful
``forward`` / ``encode`` / ``decode`` call with the object's own caches,
``process_file_scan`` replays as a CUDA graph and ``serialize`` exports
with ``torch.export``.  The end-to-end latency is the static
``total_delay_samples``.  For the fork, ``encode`` appends to each frame
the speaker embedding of the chunk's streamed bands (the speaker encoder
runs offline on the chunk alone, without caches), and ``decode`` takes
that latent.  The discrete head adds the integer-code surface
``encode_indices`` / ``decode_indices`` over the same caches.  AdaIN's
statistics and its ``learn_x``/``learn_y`` flags are carried after the
caches (:class:`~rave_tpu_torch.models.blocks.AdaIN`), so the exported
steps and the CUDA-graph replay read the flags the host sets between
chunks (``set_learn_source`` / ``set_learn_target`` / ``reset_source`` /
``reset_target``).

Options: fake stereo (one encode, the decoder run on the batch-duplicated
latent with its own caches, the two decodes as the two channels) and a
host rate ``target_sr`` (streaming resampler stages on both sides of the
model); the latent PCA of the variational head.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

from ..config import DiscriminatorConfig, RAVEConfig
from ..ops.conv import StreamStep, stream_caches
from ..ops.pqmf import _pqmf_kernels
from ..ops.resampler import Resampler
from ..models.blocks import AdaIN
from ..models.rave import RAVE, band_frame_delay, stream_setup


class StreamingRAVE:
    """Stateful chunked encode / decode driver around the streaming model.

    ``params`` is the state dict of an offline :class:`RAVE` of the same
    config (a discrete model's trained codebooks are buffers in it).
    Chunks are audio ``(batch_size, host_chunk, 1)`` at the host rate
    (numpy or tensor); results are tensors on ``device``, stereo audio
    ``(B, T, 2)``.  ``adain_state`` gives the AdaIN modules' initial
    states (module order, each ``(batch_size, C, 8)``; default: no
    statistics, learning off), which :meth:`reset` restores.
    """

    def __init__(self, cfg: RAVEConfig, params: Mapping[str, torch.Tensor],
                 chunk_size: int = 2048, batch_size: int = 1,
                 stereo: bool = False, target_sr: Optional[int] = None,
                 device="cuda", adain_state: Optional[list] = None):
        if chunk_size % cfg.total_ratio():
            raise ValueError(
                f"chunk_size must be a multiple of the total stride "
                f"{cfg.total_ratio()}, got {chunk_size}")
        if stereo and cfg.adain:
            # AdaIN keeps per-batch-slot statistics, which the stereo
            # batch duplication would mix (as in the JAX package)
            raise ValueError("stereo mode not supported with AdaIN")
        self.cfg = cfg
        self.chunk = chunk_size
        self.batch = batch_size
        self.stereo = stereo
        self.model = m = RAVE(cfg, streaming=True, device=device,
                              train_mode=False)
        m.load_state_dict(params)
        m.eval()
        self.device = next(m.parameters()).device
        dev = self.device
        x0 = torch.zeros(batch_size, chunk_size, 1, device=dev)
        z0 = torch.zeros(batch_size, chunk_size // cfg.total_ratio(),
                         cfg.decoder_latent_size(), device=dev)
        self.cache_modules, self.init_caches = stream_caches(m, m.forward, x0)
        self.n_adain = sum(isinstance(c, AdaIN) for c in self.cache_modules)
        if adain_state is not None:
            if len(adain_state) != self.n_adain:
                raise ValueError(f"{len(adain_state)} AdaIN states for "
                                 f"{self.n_adain} AdaIN modules")
            n = len(self.init_caches) - self.n_adain
            for i, a in enumerate(adain_state):
                if a.shape != self.init_caches[n + i].shape:
                    raise ValueError(
                        f"AdaIN state {i}: {tuple(a.shape)} for "
                        f"{tuple(self.init_caches[n + i].shape)}")
                self.init_caches[n + i] = a.to(dev, torch.float32).clone()
        self._forward = StreamStep(m, m.forward, self.cache_modules)
        self._encode = StreamStep(m, m.encode, self.cache_modules)
        self._decode = StreamStep(m, m.decode, self.cache_modules)
        if cfg.latent_head == "discrete":
            self._encode_idx = StreamStep(m, m.encode_indices,
                                          self.cache_modules)
            self._decode_idx = StreamStep(m, m.decode_indices,
                                          self.cache_modules)
        if stereo:
            # the stereo decoder keeps its own caches, at batch 2B
            mods, self.init_dec_caches = stream_caches(
                m, m.decode, torch.cat([z0, z0]))
            self._decode_stereo = StreamStep(m, m.decode, mods)

        self.rs_ratio = 1
        if target_sr is not None and target_sr != cfg.sampling_rate:
            rs = Resampler(target_sr, cfg.sampling_rate,
                           ss=stream_setup(cfg, True)).to(dev)
            self.rs_ratio = rs.ratio
            out_b = 2 * batch_size if stereo else batch_size
            mods, self.init_down_caches = stream_caches(
                rs, rs.to_model_sr,
                torch.zeros(batch_size, chunk_size * rs.ratio, 1, device=dev))
            self._rs_down = StreamStep(rs, rs.to_model_sr, mods)
            mods, self.init_up_caches = stream_caches(
                rs, rs.from_model_sr,
                torch.zeros(out_b, chunk_size, 1, device=dev))
            self._rs_up = StreamStep(rs, rs.from_model_sr, mods)
        self._graph = None
        self._stats = None
        self._n_keep = None
        self.reset()

    # -- latency ----------------------------------------------------------

    def total_delay_samples(self) -> int:
        """Static end-to-end streaming delay in audio samples: the encoder
        and decoder chain (fed by the PQMF analysis delay) plus the PQMF
        synthesis delay."""
        cfg = self.cfg
        pq_s = (_pqmf_kernels(cfg.pqmf_attenuation, cfg.n_band)[3]
                if cfg.n_band > 1 else 0)
        return (band_frame_delay(cfg, stream_setup(cfg, True)) + pq_s) \
            * cfg.n_band

    @property
    def host_chunk(self) -> int:
        """Audio samples per call at the host sample rate."""
        return self.chunk * self.rs_ratio

    # -- stateful API -----------------------------------------------------

    def reset(self) -> None:
        """Every carried cache back to zeros (the next chunk starts anew),
        and the AdaIN state to its initial one."""
        fresh = lambda cs: [c.clone() for c in cs]  # noqa: E731
        self.caches = fresh(self.init_caches)
        if self.stereo:
            self.dec_caches = fresh(self.init_dec_caches)
        if self.rs_ratio > 1:
            self.down_caches = fresh(self.init_down_caches)
            self.up_caches = fresh(self.init_up_caches)

    # -- AdaIN timbre-transfer controls ------------------------------------

    @property
    def adain(self) -> list:
        """The live AdaIN states ``(B, C, 8)``, module order (slots
        :attr:`AdaIN.SLOTS`)."""
        return self.caches[len(self.caches) - self.n_adain:]

    def _set_adain(self, values: Mapping[int, float]) -> None:
        if not self.n_adain:
            raise ValueError("model has no AdaIN layers (adain config)")
        n = len(self.caches) - self.n_adain
        for i in range(n, len(self.caches)):
            s = self.caches[i].clone()
            for slot, v in values.items():
                s[..., slot] = v
            self.caches[i] = s

    def set_learn_source(self, on: bool) -> None:
        """While on (and target learning off), AdaIN folds each chunk's
        statistics into the SOURCE's."""
        self._set_adain({AdaIN.LEARN_X: float(on)})

    def set_learn_target(self, on: bool) -> None:
        """While on, AdaIN folds each chunk's statistics into the
        TARGET's (and learns no source statistics)."""
        self._set_adain({AdaIN.LEARN_Y: float(on)})

    def reset_source(self) -> None:
        self._set_adain({AdaIN.MEAN_X: 0.0, AdaIN.STD_X: 1.0, AdaIN.N_X: 0.0})

    def reset_target(self) -> None:
        self._set_adain({AdaIN.MEAN_Y: 0.0, AdaIN.STD_Y: 1.0, AdaIN.N_Y: 0.0})

    def _tensor(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.float32)
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=self.device)

    def _to_model_rate(self, x: torch.Tensor) -> torch.Tensor:
        if self.rs_ratio > 1:
            x, self.down_caches = self._rs_down(self.down_caches, x)
        return x

    def _from_model_rate(self, y: torch.Tensor) -> torch.Tensor:
        if self.rs_ratio > 1:
            y, self.up_caches = self._rs_up(self.up_caches, y)
        return y

    @torch.inference_mode()
    def forward(self, x_chunk) -> torch.Tensor:
        """Audio chunk ``(B, host_chunk, 1)`` -> audio chunk
        ``(B, host_chunk, 1)``, or ``(B, host_chunk, 2)`` in stereo."""
        if self.stereo:
            return self.decode(self.encode(x_chunk))
        x = self._to_model_rate(self._tensor(x_chunk))
        y, self.caches = self._forward(self.caches, x)
        return self._from_model_rate(y)

    @torch.inference_mode()
    def encode(self, x_chunk) -> torch.Tensor:
        """Audio chunk -> latent ``(B, chunk / total_ratio, C)``: the
        latent, and for the fork the chunk's speaker embedding."""
        x = self._to_model_rate(self._tensor(x_chunk))
        z, self.caches = self._encode(self.caches, x)
        return z

    @torch.inference_mode()
    def decode(self, z) -> torch.Tensor:
        """Latent ``(B, T_z, C)`` -> audio chunk ``(B, T, 1)``, or
        ``(B, T, 2)`` in stereo."""
        z = self._tensor(z)
        if self.stereo:
            y, self.dec_caches = self._decode_stereo(self.dec_caches,
                                                     torch.cat([z, z]))
            y = self._from_model_rate(y)
            B = z.shape[0]
            return torch.cat([y[:B], y[B:]], dim=-1)
        y, self.caches = self._decode(self.caches, z)
        return self._from_model_rate(y)

    @torch.inference_mode()
    def encode_indices(self, x_chunk) -> torch.Tensor:
        """Audio chunk ``(B, chunk, 1)`` at the model rate -> RVQ indices
        ``(B, n_quantizers, chunk / total_ratio)`` int64 (discrete head
        only; mono, as in the JAX package)."""
        idx, self.caches = self._encode_idx(self.caches, self._tensor(x_chunk))
        return idx

    @torch.inference_mode()
    def decode_indices(self, idx) -> torch.Tensor:
        """RVQ indices -> audio chunk ``(B, chunk, 1)`` at the model rate
        (discrete head only)."""
        idx = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        y, self.caches = self._decode_idx(self.caches, idx)
        return y

    def process_file(self, x: np.ndarray) -> np.ndarray:
        """Stream a whole mono signal at the host rate chunk by chunk (a
        ragged end is dropped); returns the streamed output (the first
        channel in stereo) as a numpy array."""
        self.reset()
        hc = self.host_chunk
        T = len(x) - len(x) % hc
        outs = [self.forward(x[i:i + hc].reshape(1, -1, 1))[0, :, 0]
                for i in range(0, T, hc)]
        return torch.cat(outs).cpu().numpy()

    def process_file_scan(self, x: np.ndarray) -> np.ndarray:
        """:meth:`process_file` with the chunk step dispatched once per
        chunk, from zero caches, without touching the object's own.  On a
        CUDA device the step (and the copy of the new caches into static
        ones) is captured once in a CUDA graph and replayed per chunk,
        the counterpart of the JAX package's single ``lax.scan``; on the
        CPU the step runs in a loop.  The AdaIN state starts from the live
        one (the controls set so far; after :meth:`reset` the initial
        one, as in the JAX package), which the last chunk's state then
        replaces.  Stereo and host-rate streams go through
        :meth:`process_file`, as in the JAX package."""
        if self.stereo or self.rs_ratio > 1:
            return self.process_file(x)
        hc = self.chunk
        T = len(x) - len(x) % hc
        chunks = self._tensor(np.asarray(x[:T], np.float32)).reshape(
            -1, 1, hc, 1)
        start = list(self.init_caches)
        if self.n_adain:
            start[-self.n_adain:] = self.adain
        with torch.no_grad():
            if self.device.type == "cuda":
                graph, sx, caches, sy = self._chunk_graph()
                for c, c0 in zip(caches, start):
                    c.copy_(c0)
                ys = torch.empty((len(chunks), *sy.shape), device=self.device)
                for i in range(len(chunks)):
                    sx.copy_(chunks[i])
                    graph.replay()
                    ys[i].copy_(sy)
            else:
                caches, outs = start, []
                for xc in chunks:
                    y, caches = self._forward(caches, xc)
                    outs.append(y)
                ys = torch.stack(outs)
        if self.n_adain:
            self.caches[-self.n_adain:] = [
                c.clone() for c in caches[-self.n_adain:]]
        return ys.reshape(-1).cpu().numpy()

    def _chunk_graph(self):
        """The captured chunk step (graph, static chunk, static caches,
        static output), built at the first call.  A failed capture
        raises."""
        if self._graph is None:
            sx = torch.zeros(1, self.chunk, 1, device=self.device)
            sc = [torch.zeros_like(c) for c in self.init_caches]
            # warm up on a side stream before capture (CUDA-graph rule)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._forward(sc, sx)
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                sy, new = self._forward(sc, sx)
                for c, n in zip(sc, new):
                    c.copy_(n)
            self._graph = (graph, sx, sc, sy)
        return self._graph

    # -- latent post/pre-processing ---------------------------------------

    def set_latent_stats(self, stats: Optional[dict],
                         fidelity: float = 0.95) -> None:
        """PCA fidelity cropping of the variational latent: keep the
        fewest principal directions whose cumulative variance exceeds
        ``fidelity`` (``stats`` from :func:`~rave_tpu_torch.train.
        latent_stats.fit_latent_pca`; None turns it off)."""
        from ..train.latent_stats import n_dims_for_fidelity
        self._stats = stats
        self._n_keep = (n_dims_for_fidelity(stats["fidelity"], fidelity)
                        if stats is not None else None)

    def _spherical(self):
        if self.cfg.latent_head == "spherical":
            raise NotImplementedError(
                "the spherical latent head is not ported to rave_tpu_torch "
                "yet (ROADMAP A6)")

    def postprocess_latent(self, z: np.ndarray) -> np.ndarray:
        """Latent ``(..., C)`` (numpy) -> the compact user-facing one: its
        first principal components when stats are set."""
        self._spherical()
        if self.cfg.latent_head == "variational" and self._stats is not None:
            pca, mean = self._stats["latent_pca"], self._stats["latent_mean"]
            return (z - mean) @ pca.T[:, :self._n_keep]
        return z

    def preprocess_latent(self, z: np.ndarray) -> np.ndarray:
        """Inverse of :meth:`postprocess_latent` (the decode side): the
        dropped components come back as zeros."""
        self._spherical()
        if self.cfg.latent_head == "variational" and self._stats is not None:
            pca, mean = self._stats["latent_pca"], self._stats["latent_mean"]
            full = np.zeros((*z.shape[:-1], pca.shape[0]), z.dtype)
            full[..., :z.shape[-1]] = z
            return full @ pca + mean
        return z

    # -- export -------------------------------------------------------------

    def serialize(self, out_dir: str) -> Path:
        """Write the model-rate mono steps as ``torch.export`` programs
        on the model's device, with their initial caches and the JAX
        package's call convention:

        * ``forward.pt2``, ``encode.pt2``, ``decode.pt2``:
          ``(caches, x) -> (y, caches)`` (reload with
          ``torch.export.load(path).module()``);
        * ``cache_init.npz`` (keys ``c0..cN`` in manifest order: zero
          caches, then the initial AdaIN states) and ``cache_init.bin``
          (the same, raw little-endian);
        * ``io_manifest.txt``: ``meta <chunk> <sr> <batch>``, then one
          ``in`` line per cache and the chunk, one ``out`` line for ``y``
          and per cache (dtype, bytes, rank, dims);
        * ``meta.json``.
        """
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        cfg = self.cfg
        caches = [c.clone() for c in self.init_caches]
        x = torch.zeros(self.batch, self.chunk, 1, device=self.device)
        z = torch.zeros(self.batch, self.chunk // cfg.total_ratio(),
                        cfg.decoder_latent_size(), device=self.device)
        with torch.no_grad():
            for name, step, arg in (("forward", self._forward, x),
                                    ("encode", self._encode, x),
                                    ("decode", self._decode, z)):
                export_step(step, (caches, arg), out / f"{name}.pt2")
            y, new = self._forward(caches, x)
        write_manifest(out, "forward", [*caches, x], [y, *new], caches,
                       chunk=self.chunk, sampling_rate=cfg.sampling_rate,
                       batch=self.batch)
        np.savez(out / "cache_init.npz",
                 **{f"c{i}": c.cpu().numpy() for i, c in enumerate(caches)})
        meta = dict(chunk_size=self.chunk, batch=self.batch,
                    sampling_rate=cfg.sampling_rate,
                    total_delay_samples=int(self.total_delay_samples()),
                    latent_size=cfg.latent_size, adain=self.n_adain > 0,
                    config=cfg.name)
        (out / "meta.json").write_text(json.dumps(meta, indent=2))
        return out


def export_step(step: StreamStep, args: tuple, path: Path) -> None:
    """``torch.export`` (non-strict: the step sets module attributes)
    of ``step`` at ``args``, saved to ``path``."""
    torch.export.save(torch.export.export(step, args, strict=False), path)


def write_manifest(out: Path, prefix: str, inputs, outputs, caches, *,
                   chunk: int, sampling_rate: int, batch: int) -> None:
    """The flat call convention of an exported step, in the JAX package's
    format (``write_pjrt_artifacts``): ``io_manifest.txt`` for
    ``forward``, else ``<prefix>_manifest.txt``, one line per input
    tensor then per output tensor; and the initial ``caches``
    concatenated raw little-endian in manifest order
    (``cache_init.bin``, else ``<prefix>_cache_init.bin``)."""
    lines = [f"meta {chunk} {sampling_rate} {batch}"]
    for kind, tensors in (("in", inputs), ("out", outputs)):
        for t in tensors:
            dims = " ".join(str(d) for d in t.shape)
            nbytes = t.element_size() * t.numel()
            dtype = str(t.dtype).removeprefix("torch.")
            lines.append(f"{kind} {dtype} {nbytes} {t.dim()} {dims}".rstrip())
    first = prefix == "forward"
    (out / ("io_manifest.txt" if first else f"{prefix}_manifest.txt")
     ).write_text("\n".join(lines) + "\n")
    with open(out / ("cache_init.bin" if first
                     else f"{prefix}_cache_init.bin"), "wb") as f:
        for c in caches:
            f.write(np.ascontiguousarray(c.cpu().numpy(), "<f4").tobytes())


def _tuples(v):
    return tuple(_tuples(a) for a in v) if isinstance(v, list) else v


def load_run(run_dir: str, best: bool = False, device="cuda"):
    """The config and the train state of a run written by the port's
    trainer: ``config.json`` and the latest checkpoint (the best-
    validation one with ``best``), restored onto ``device``."""
    from ..train.checkpoint import CheckpointManager
    from ..train.loop import TrainState

    run = Path(run_dir)
    raw = json.loads((run / "config.json").read_text())
    dc = raw.pop("discriminator", None)
    cfg = RAVEConfig(**{k: _tuples(v) for k, v in raw.items()})
    if dc:
        cfg.discriminator = DiscriminatorConfig(
            **{k: _tuples(v) for k, v in dc.items()})
    state = TrainState(cfg, device=device)
    ckpt = CheckpointManager(run)
    if best:
        ckpt.restore_best(state)
    else:
        ckpt.restore(state)
    return cfg, state


def run_params(state) -> dict:
    """The generator's state dict for serving, its parameters from the
    EMA where the run keeps one (the reference export's ``--ema``)."""
    params = dict(state.model.state_dict())
    if state.ema is not None:
        params.update(state.ema)
    return params


def export_main(args) -> None:
    """The ``export`` command: the streaming steps of a run under
    ``<run>/export``, and with ``--voice_conversion`` the conversion step
    and the speaker table of ``--speaker_wavs``."""
    from ..train.latent_stats import load_latent_stats
    device = getattr(args, "device", "cuda")
    cfg, state = load_run(args.run, best=getattr(args, "best", False),
                          device=device)
    params = run_params(state)
    del state
    sr = StreamingRAVE(cfg, params, chunk_size=args.chunk_size,
                       stereo=getattr(args, "stereo", False),
                       target_sr=getattr(args, "target_sr", None),
                       device=device)
    sr.set_latent_stats(load_latent_stats(args.run))
    out = sr.serialize(Path(args.run) / "export")
    print(f"exported streaming model to {out} "
          f"(delay {sr.total_delay_samples()} samples)")

    if getattr(args, "voice_conversion", False):
        if not cfg.speaker_embedding_size:
            raise SystemExit("--voice_conversion needs a speaker-"
                             "conditioned model (e.g. v2_fork)")
        from .voice_conversion import VoiceConverter
        wavs = list(getattr(args, "speaker_wavs", []) or [])
        table = (VoiceConverter.build_speaker_table(cfg, params, wavs,
                                                    device=device)
                 if wavs else None)
        vc = VoiceConverter(cfg, params, chunk_size=args.chunk_size,
                            speaker_table=table, device=device)
        vc.serialize(out)
        print(f"exported voice-conversion step to {out} "
              f"({len(vc.speaker_table)} speaker embeddings)")
