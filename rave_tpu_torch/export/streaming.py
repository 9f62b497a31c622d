"""Chunked streaming inference (mono) for the v2 codec and ``v2_fork``.

Port of ``StreamingRAVE`` in ``rave_tpu/export/streaming.py``.  The model
is rebuilt in streaming mode and the offline parameters are loaded
unchanged; each conv carries its left context (or overlap-add tail, or
delay line) as a cache tensor from one chunk to the next, and ``reset``
drops every cache.  The end-to-end latency is the static
``total_delay_samples``.  For the fork, ``encode`` appends to each frame
the speaker embedding of the chunk's streamed bands (the speaker encoder
runs offline on the chunk alone, without caches), and ``decode`` takes
that latent.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..config import RAVEConfig
from ..ops.conv import Cached
from ..ops.pqmf import _pqmf_kernels
from ..models.rave import RAVE, band_frame_delay, stream_setup


class StreamingRAVE:
    """Stateful chunked encode / decode driver around the streaming model.

    ``params`` is the state dict of an offline :class:`RAVE` of the same
    config.  Chunks are audio ``(B, chunk_size, 1)`` (numpy or tensor);
    results are tensors on ``device``.  The caches take the batch size of
    the first chunk after a ``reset``.
    """

    def __init__(self, cfg: RAVEConfig, params: Mapping[str, torch.Tensor],
                 chunk_size: int = 2048, stereo: bool = False,
                 target_sr: Optional[int] = None, device="cuda"):
        if chunk_size % cfg.total_ratio():
            raise ValueError(
                f"chunk_size must be a multiple of the total stride "
                f"{cfg.total_ratio()}, got {chunk_size}")
        if stereo:
            raise NotImplementedError(
                "stereo streaming is not ported yet (ROADMAP A9)")
        if target_sr is not None and target_sr != cfg.sampling_rate:
            raise NotImplementedError(
                "the host-rate resampler is not ported yet (ROADMAP A9)")
        self.cfg = cfg
        self.chunk = chunk_size
        self.model = RAVE(cfg, streaming=True, device=device,
                          train_mode=False)
        self.model.load_state_dict(params)
        self.model.eval()
        self.device = next(self.model.parameters()).device

    def total_delay_samples(self) -> int:
        """Static end-to-end streaming delay in audio samples: the encoder
        and decoder chain (fed by the PQMF analysis delay) plus the PQMF
        synthesis delay."""
        cfg = self.cfg
        pq_s = (_pqmf_kernels(cfg.pqmf_attenuation, cfg.n_band)[3]
                if cfg.n_band > 1 else 0)
        return (band_frame_delay(cfg, stream_setup(cfg, True)) + pq_s) \
            * cfg.n_band

    def reset(self) -> None:
        """Forget every carried cache (the next chunk starts from zeros)."""
        for m in self.model.modules():
            if isinstance(m, Cached):
                m.reset_cache()

    def _tensor(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.float32)
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=self.device)

    @torch.inference_mode()
    def forward(self, x_chunk) -> torch.Tensor:
        """Audio chunk ``(B, chunk, 1)`` -> audio chunk ``(B, chunk, 1)``."""
        return self.model(self._tensor(x_chunk))

    @torch.inference_mode()
    def encode(self, x_chunk) -> torch.Tensor:
        """Audio chunk -> latent ``(B, chunk / total_ratio, C)``: the
        latent, and for the fork the chunk's speaker embedding."""
        return self.model.encode(self._tensor(x_chunk))

    @torch.inference_mode()
    def decode(self, z) -> torch.Tensor:
        """Latent ``(B, T_z, C)`` -> audio chunk ``(B, T, 1)``."""
        return self.model.decode(self._tensor(z))

    def process_file(self, x: np.ndarray) -> np.ndarray:
        """Stream a whole mono signal chunk by chunk (a ragged end is
        dropped); returns the streamed output as a numpy array."""
        self.reset()
        T = len(x) - len(x) % self.chunk
        outs = [self.forward(x[i:i + self.chunk].reshape(1, -1, 1))[0, :, 0]
                for i in range(0, T, self.chunk)]
        return torch.cat(outs).cpu().numpy()
