"""Realtime voice-conversion serving of the speaker-conditioned fork.

Port of ``VoiceConverter`` in ``rave_tpu/export/voice_conversion.py``:

* a table of target-speaker embeddings and a ``speaker`` index choosing
  the conversion target;
* ``learn_target`` mode: target audio streamed in, its speaker embedding
  accumulated as the running mean of the chunks' embeddings;
* ``forward``: one source chunk through the streamed PQMF, the encoder,
  the chosen embedding appended to every latent frame, the generator and
  the streamed PQMF synthesis, all on the streaming caches;
* offline enrollment (``embed_speaker_audio``, ``build_speaker_table``):
  a target clip cut into segments and embedded as one batch, with other
  speakers' audio as the cohort a cohort-norm encoder whitens against.

The speaker encoder runs offline on what it is given, in every mode.
The conversion step and the learn-target step are pure functions of the
stream's caches (:class:`~rave_tpu_torch.ops.conv.StreamStep`), which
``serialize`` exports with ``torch.export``.

A pitch config (``pitch_embedding_size``) appends each block's
normalised f0 to the latent: f0 by YIN (or FCPE with a checkpoint) on
the model's device over the block and the 1024 samples before it, then
normalised on the host by the median and std of the last 500 voiced
log-f0 values (numpy float64) and linearly interpolated to the block's
latent frames with aligned corners (``np.interp``; the offline feature
resamples as ``jax.image.resize`` does, with antialiasing; both as in
the JAX package).  ``serialize`` also writes ``convert_pg.pt2``, whose
f0 is computed in the program by YIN with the block's own statistics,
its carried state the caches and the f0 tail.
"""

from __future__ import annotations

import json
from functools import partial
from pathlib import Path
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ..config import RAVEConfig
from ..data.audio_io import load_wav
from ..ops.conv import StreamStep
from ..ops.pitch import (NEUTRAL_LOG_F0, f0_norm_feature, voiced_log_stats,
                         yin_f0)
from ..ops.pqmf import PQMF
from .streaming import StreamingRAVE, export_step, write_manifest


F0_FRAME = 2048     # YIN frame of the streamed f0
RESERVOIR = 500     # voiced log-f0 values the streamed statistics keep


class PitchCarryStep(torch.nn.Module):
    """``convert_pg``'s call convention over the pitch step ``step``
    (``(caches, f0_tail, x, emb) -> ((y, f0_tail), caches)``): ``(carry,
    x, emb) -> (y, carry)``, ``carry`` the caches then the f0 tail.  Its
    flat inputs and outputs are the JAX package's (whose carry ``{"cache",
    "f0_tail"}`` flattens to the caches, then the tail), so that a host
    feeds every output but ``y`` back in, in order."""

    def __init__(self, step: StreamStep):
        super().__init__()
        self.step = step

    def forward(self, carry: list, x: torch.Tensor, emb: torch.Tensor):
        (y, tail), caches = self.step(carry[:-1], carry[-1], x, emb)
        return y, [*caches, tail]


class VoiceConverter:
    """Stateful chunked voice conversion around a streaming fork model.

    ``params`` is the state dict of an offline
    :class:`~rave_tpu_torch.models.rave.RAVE` of the same config (its
    buffers, such as the speaker encoder's BatchNorm statistics,
    included); ``speaker_table`` ``(n, E)`` holds the target embeddings
    (one zero row by default).  Chunks are mono numpy arrays of
    ``chunk_size`` samples.  ``stream`` is the underlying
    :class:`~rave_tpu_torch.export.streaming.StreamingRAVE` (its
    ``total_delay_samples`` is the conversion's latency).
    """

    def __init__(self, cfg: RAVEConfig, params: Mapping[str, torch.Tensor],
                 chunk_size: int = 4096,
                 speaker_table: Optional[np.ndarray] = None, device="cuda"):
        if not cfg.speaker_embedding_size:
            raise ValueError("voice conversion needs a speaker-conditioned "
                             "model (v2_fork)")
        self.stream = StreamingRAVE(cfg, params, chunk_size=chunk_size,
                                    device=device)
        self.model = self.stream.model
        self.device = self.stream.device
        # the offline analysis filterbank of enrollment (no caches)
        self.pqmf = PQMF(cfg.pqmf_attenuation, cfg.n_band).to(self.device)
        size = cfg.speaker_embedding_size
        self.speaker_table = (np.zeros((1, size), np.float32)
                              if speaker_table is None
                              else np.asarray(speaker_table, np.float32))
        self.speaker = 0
        self.learn_target = False
        self._target_acc = np.zeros(size, np.float32)
        self._target_n = 0
        mods = self.stream.cache_modules
        self._convert = StreamStep(self.model, self._convert_chunk, mods)
        self._embed = StreamStep(self.model, self._embed_chunk, mods)
        self._pitch = cfg.pitch_embedding_size > 0
        if self._pitch:
            # f0 frames need frame_length - hop samples before the block
            self._f0_hop = cfg.pitch_hop
            self._tail_len = F0_FRAME - cfg.pitch_hop
            self._z_frames = chunk_size // cfg.total_ratio()
            fcpe = None
            if cfg.pitch_estimator == "fcpe":
                from ..models.pitch_fcpe import get_fcpe
                fcpe = get_fcpe(cfg.pitch_ckpt, self.device)
            if fcpe is not None:
                from ..models.pitch_fcpe import fcpe_f0
                self._f0_fn = lambda xc: fcpe_f0(
                    fcpe, xc, cfg.sampling_rate,
                    out_frames=max(1, xc.shape[1] // self._f0_hop),
                    fmin=cfg.pitch_fmin, fmax=cfg.pitch_fmax)
            else:
                self._f0_fn = partial(
                    yin_f0, sr=cfg.sampling_rate,
                    frame_length=F0_FRAME, hop=self._f0_hop,
                    fmin=cfg.pitch_fmin, fmax=cfg.pitch_fmax)
            self._convert_pg = PitchCarryStep(
                StreamStep(self.model, self._convert_pg_chunk, mods))
            self._reset_pitch()

    def _reset_pitch(self) -> None:
        self._f0_tail = np.zeros(self._tail_len, np.float32)
        self._logf0: list = []

    # ---- nn~-style attributes ------------------------------------------

    def set_speaker(self, idx: int) -> None:
        """Choose table row ``idx`` (clipped to the table) as the target;
        a learned target is forgotten."""
        self.speaker = int(np.clip(idx, 0, len(self.speaker_table) - 1))
        self._target_n = 0
        self._target_acc[:] = 0

    def set_learn_target(self, on: bool) -> None:
        """While on, ``forward`` accumulates the embedding of the chunks it
        gets and returns silence; switching it on starts a new mean.  The
        mean of lone-chunk embeddings is meaningful for a BatchNorm
        (pretrained) encoder only: a cohort-norm encoder whitens every
        lone chunk to the same constant, so enroll those offline."""
        if on and not self.learn_target:
            self._target_acc[:] = 0
            self._target_n = 0
        self.learn_target = bool(on)

    def reset(self) -> None:
        """Forget the streaming caches, and a pitch config's f0 tail and
        log-f0 reservoir (not the target)."""
        self.stream.reset()
        if self._pitch:
            self._reset_pitch()

    def current_embedding(self) -> np.ndarray:
        """The target embedding ``(E,)``: the learned mean if any chunk
        was learned, else the chosen table row."""
        if self._target_n > 0:
            return self._target_acc / self._target_n
        return self.speaker_table[self.speaker]

    # ---- per-chunk processing -------------------------------------------

    def _convert_chunk(self, x: torch.Tensor, emb: torch.Tensor,
                       feat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Source chunk ``(1, chunk, 1)``, target embedding ``(E,)`` and,
        for a pitch config, its f0 feature ``(1, T_z, P)`` -> converted
        chunk ``(1, chunk, 1)``: the streamed PQMF, the encoder, the
        embedding (and the feature) appended to every latent frame, the
        generator and the streamed PQMF synthesis."""
        m = self.model
        z = m.condition(m.encode_input(m.pqmf_forward(x)), emb[None])
        if feat is not None:
            z = torch.cat([z, feat.transpose(1, 2)], dim=1)
        return m.pqmf_inverse(m.decode_bands(z))

    def _convert_pg_chunk(self, f0_tail: torch.Tensor, x: torch.Tensor,
                          emb: torch.Tensor):
        """The self-contained pitch step of ``convert_pg.pt2``: YIN over
        ``f0_tail`` ``(1, tail)`` and the chunk, normalised by the
        block's own statistics -> ``(y, new tail)``."""
        cfg = self.model.cfg
        xc = torch.cat([f0_tail, x[:, :, 0]], dim=1)
        f0 = yin_f0(xc, cfg.sampling_rate, F0_FRAME, self._f0_hop,
                    cfg.pitch_fmin, cfg.pitch_fmax)
        med, std = voiced_log_stats(f0)
        feat = f0_norm_feature(f0, med, std, self._z_frames,
                               cfg.pitch_embedding_size)
        return (self._convert_chunk(x, emb, feat),
                xc[:, -self._tail_len:])

    def _pitch_feature(self, x_chunk: np.ndarray) -> torch.Tensor:
        """The f0 feature ``(1, T_z, P)`` of one block: f0 on the device
        over the tail and the block, the host's reservoir of the last 500
        voiced log-f0 values, ``np.interp`` to the latent frames."""
        xc = np.concatenate([self._f0_tail, x_chunk.astype(np.float32)])
        self._f0_tail = xc[-self._tail_len:]
        f0 = self._f0_fn(torch.from_numpy(xc[None]).to(self.device)
                         )[0].cpu().numpy()
        voiced = f0 > 0
        if voiced.any():
            self._logf0.extend(np.log(f0[voiced]).tolist())
            self._logf0 = self._logf0[-RESERVOIR:]
        if self._logf0:
            med = float(np.median(self._logf0))
            std = float(max(np.std(self._logf0), 1e-3))
        else:
            med, std = NEUTRAL_LOG_F0, 0.5
        feat = np.where(voiced, (np.log(np.maximum(f0, 1e-6)) - med) / std,
                        0.0).astype(np.float32)
        n = len(feat)
        pos = (np.linspace(0, n - 1, self._z_frames) if n > 1
               else np.zeros(self._z_frames))
        feat = np.interp(pos, np.arange(n), feat)
        feat = np.tile(feat[None, :, None],
                       (1, 1, self.model.cfg.pitch_embedding_size))
        return torch.tensor(feat, dtype=torch.float32, device=self.device)

    def _embed_chunk(self, x: torch.Tensor) -> torch.Tensor:
        """Chunk -> its speaker embedding ``(1, E)``; only the streamed
        analysis advances its cache."""
        m = self.model
        return m.speaker_embedding(m.pqmf_forward(x))

    @torch.inference_mode()
    def forward(self, x_chunk: np.ndarray) -> np.ndarray:
        """One source chunk -> the converted chunk ``(chunk,)``, or, while
        learning a target, zeros shaped like ``x_chunk``."""
        st = self.stream
        x = torch.tensor(np.asarray(x_chunk, np.float32).reshape(1, -1, 1),
                         device=self.device)
        if self.learn_target:
            e, st.caches = self._embed(st.caches, x)
            self._target_acc += e[0].cpu().numpy()
            self._target_n += 1
            return np.zeros_like(x_chunk)
        emb = torch.tensor(self.current_embedding(), device=self.device)
        if self._pitch:
            feat = self._pitch_feature(np.asarray(x_chunk).reshape(-1))
            y, st.caches = self._convert(st.caches, x, emb, feat)
        else:
            y, st.caches = self._convert(st.caches, x, emb)
        return y[0, :, 0].cpu().numpy()

    # ---- offline enrollment ----------------------------------------------

    @torch.inference_mode()
    def embed_speaker_audio(self, x: np.ndarray, segments: int = 4,
                            cohort: Optional[np.ndarray] = None
                            ) -> np.ndarray:
        """Speaker embedding ``(E,)`` of the clip ``x``: up to ``segments``
        segments of ``max(32768, len(x) // segments)`` samples (halves of
        at least 8192 when that leaves one), the first segments of
        ``cohort`` (other speakers' audio) appended, embedded offline as
        one batch; the mean over the clip's rows.  A cohort shorter than a
        segment raises, as in the JAX package."""
        x = x.astype(np.float32)
        seg_len = max(32768, len(x) // max(1, segments))
        n = max(1, len(x) // seg_len)
        if n == 1:
            # too short to chunk: halves, so that cohort statistics exist
            seg_len = max(8192, len(x) // 2)
            n = max(1, len(x) // seg_len)
        segs = np.stack([x[i * seg_len:(i + 1) * seg_len]
                         for i in range(n)])[..., None]
        if cohort is not None:
            c = cohort.astype(np.float32)
            m = max(1, min(len(c) // seg_len, n))
            csegs = np.stack([c[i * seg_len:(i + 1) * seg_len]
                              for i in range(m)])[..., None]
            segs = np.concatenate([segs, csegs], axis=0)
        bands = self.pqmf(torch.from_numpy(segs).to(self.device))
        e = self.model.speaker_embedding(bands)
        return e[:n].mean(dim=0).cpu().numpy()

    def table_from_clips(self, clips: Sequence[np.ndarray]) -> np.ndarray:
        """Embedding table ``(len(clips), E)``: each clip embedded with the
        other clips, concatenated, as its cohort."""
        rows = []
        for i, x in enumerate(clips):
            others = [c for j, c in enumerate(clips) if j != i]
            cohort = np.concatenate(others) if others else None
            rows.append(self.embed_speaker_audio(x, cohort=cohort))
        return np.stack(rows).astype(np.float32)

    @staticmethod
    def build_speaker_table(cfg: RAVEConfig,
                            params: Mapping[str, torch.Tensor],
                            wav_paths: Sequence[str],
                            device="cuda") -> np.ndarray:
        """Embedding table of the target speakers' WAV files (one row
        each, see :meth:`table_from_clips`); a file at another rate than
        the model's raises."""
        clips = []
        for p in wav_paths:
            x, sr = load_wav(p)
            if sr != cfg.sampling_rate:
                raise ValueError(f"{p}: {sr} != model sr {cfg.sampling_rate}")
            clips.append(x)
        vc = VoiceConverter(cfg, params, device=device)
        return vc.table_from_clips(clips)

    def serialize(self, out_dir: str) -> Path:
        """Write the conversion step for hosts without Python, on the
        model's device, beside :meth:`StreamingRAVE.serialize`'s files:

        * ``convert.pt2``: ``(caches, x, emb) -> (y, caches)``, ``emb``
          ``(E,)``, and for a pitch config ``(caches, x, emb, feat) ->
          (y, caches)``, ``feat`` ``(1, T_z, P)`` (reload with
          ``torch.export.load(path).module()``);
        * ``spk_embed.pt2``: ``(caches, x) -> (emb, caches)`` for
          learn-target streaming;
        * ``convert_manifest.txt`` and ``convert_cache_init.bin`` (the
          JAX package's call convention), ``convert_meta.json``;
        * ``speaker_table.npy``;
        * for a pitch config, ``convert_pg.pt2``: ``(carry, x, emb) ->
          (y, carry)``, ``carry`` the caches then the f0 tail ``(1,
          1024)`` (zeros at the start), with f0 computed in the program
          (:class:`PitchCarryStep`), and its ``convert_pg_manifest.txt``
          and ``convert_pg_cache_init.bin`` (the caches, then the tail).
        """
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        st = self.stream
        cfg = st.cfg
        caches = [torch.zeros_like(c) for c in st.init_caches]
        x = torch.zeros(1, st.chunk, 1, device=self.device)
        emb = torch.zeros(cfg.speaker_embedding_size, device=self.device)
        args = (x, emb)
        if self._pitch:
            args += (torch.zeros(1, self._z_frames, cfg.pitch_embedding_size,
                                 device=self.device),)
        with torch.no_grad():
            export_step(self._convert, (caches, *args), out / "convert.pt2")
            export_step(self._embed, (caches, x), out / "spk_embed.pt2")
            y, new = self._convert(caches, *args)
        write_manifest(out, "convert", [*caches, *args], [y, *new], caches,
                       chunk=st.chunk, sampling_rate=cfg.sampling_rate,
                       batch=1)
        if self._pitch:
            carry = [*caches,
                     torch.zeros(1, self._tail_len, device=self.device)]
            with torch.no_grad():
                export_step(self._convert_pg, (carry, x, emb),
                            out / "convert_pg.pt2")
                y, new = self._convert_pg(carry, x, emb)
            write_manifest(out, "convert_pg", [*carry, x, emb], [y, *new],
                           carry, chunk=st.chunk,
                           sampling_rate=cfg.sampling_rate, batch=1)
        meta = dict(chunk_size=st.chunk, sampling_rate=cfg.sampling_rate,
                    speaker_embedding_size=cfg.speaker_embedding_size,
                    pitch_embedding_size=cfg.pitch_embedding_size,
                    pitch_hop=cfg.pitch_hop,
                    n_speakers=len(self.speaker_table), config=cfg.name)
        (out / "convert_meta.json").write_text(json.dumps(meta, indent=2))
        np.save(out / "speaker_table.npy", self.speaker_table)
        return out
