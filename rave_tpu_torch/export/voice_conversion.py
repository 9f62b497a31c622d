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
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ..config import RAVEConfig
from ..data.audio_io import load_wav
from ..ops.pqmf import PQMF
from .streaming import StreamingRAVE


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
        """Forget the streaming caches (not the target)."""
        self.stream.reset()

    def current_embedding(self) -> np.ndarray:
        """The target embedding ``(E,)``: the learned mean if any chunk
        was learned, else the chosen table row."""
        if self._target_n > 0:
            return self._target_acc / self._target_n
        return self.speaker_table[self.speaker]

    # ---- per-chunk processing -------------------------------------------

    @torch.inference_mode()
    def forward(self, x_chunk: np.ndarray) -> np.ndarray:
        """One source chunk -> the converted chunk ``(chunk,)``, or, while
        learning a target, zeros shaped like ``x_chunk``."""
        m = self.model
        x = torch.tensor(np.asarray(x_chunk, np.float32).reshape(1, -1, 1),
                         device=self.device)
        # the streamed analysis advances its cache in both modes; in
        # learn-target mode the encoder's and generator's stand still
        bands = m.pqmf_forward(x)
        if self.learn_target:
            self._target_acc += m.speaker_embedding(bands)[0].cpu().numpy()
            self._target_n += 1
            return np.zeros_like(x_chunk)
        emb = torch.tensor(self.current_embedding(), device=self.device)
        z = m.condition(m.encode_input(bands), emb[None])
        return m.pqmf_inverse(m.decode_bands(z))[0, :, 0].cpu().numpy()

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

    def serialize(self, out_dir: str):
        raise NotImplementedError(
            "serialising the conversion step (torch.export in place of "
            "StableHLO) is not ported yet (ROADMAP A9)")
