"""YIN f0 tracking, speaker-normalised f0 and per-speaker f0 statistics.

The port's copy of ``rave_tpu/data/pitch.py``: the numpy FFT-
autocorrelation YIN that the perturbation's pitch shifter and the
trainer's conversion metrics read, and ``compute_speaker_stats``, the
per-speaker log-f0 median and std JSON that conditions the ``pitch``
preset (the ``speaker_stats`` command).  numpy only, but for the FCPE
route, which imports torch when it is taken.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def _frame(x: np.ndarray, frame_length: int, hop: int) -> np.ndarray:
    n = 1 + (len(x) - frame_length) // hop
    idx = np.arange(frame_length)[None] + hop * np.arange(n)[:, None]
    return x[idx]


def yin_f0(x: np.ndarray, sr: int, frame_length: int = 2048,
           hop: int = 1024, fmin: float = 50.0, fmax: float = 550.0,
           threshold: float = 0.1) -> np.ndarray:
    """YIN f0 per frame; 0 where unvoiced.

    Cumulative-mean-normalised difference via FFT autocorrelation, like
    the reference (``pitch_utils.py:16-96``).
    """
    frames = _frame(x.astype(np.float64), frame_length, hop)
    w = frame_length // 2
    # difference function d(tau) via autocorrelation
    fft = np.fft.rfft(frames, 2 * frame_length, axis=-1)
    acf = np.fft.irfft(fft * np.conj(fft), axis=-1)[:, :w]
    # d(tau) = E[0..L-tau-1] + E[tau..L-1] - 2*corr(tau) (YIN eq. 6/7,
    # cf. the reference torch `_diff`, pitch_utils.py:52-72)
    energy = np.cumsum(frames ** 2, axis=-1)
    e0 = energy[:, -1:]
    e_tau = e0 - np.concatenate(
        [np.zeros((len(frames), 1)), energy[:, :w - 1]], axis=-1)
    e_first = energy[:, ::-1][:, :w]
    d = e_first + e_tau - 2 * acf
    # cumulative mean normalisation
    tau = np.arange(1, w)
    cmdf = d[:, 1:] * tau / (np.cumsum(d[:, 1:], axis=-1) + 1e-9)
    cmdf = np.concatenate([np.ones((len(frames), 1)), cmdf], axis=-1)

    tau_min = int(sr / fmax)
    tau_max = min(int(sr / fmin), w - 1)
    search = cmdf[:, tau_min:tau_max]
    below = search < threshold
    first = np.where(below.any(1), below.argmax(1), search.argmin(1))
    # YIN: after the first below-threshold crossing, descend to the local
    # minimum (taking the crossing itself biases the period estimate low).
    # Vectorised descent: step every frame one lag right while that
    # improves, until no frame moves.
    n_search = search.shape[1]
    rows = np.arange(len(frames))
    cur = first.copy()
    while True:
        nxt = np.minimum(cur + 1, n_search - 1)
        better = (nxt > cur) & (search[rows, nxt] < search[rows, cur])
        if not better.any():
            break
        cur = np.where(better, nxt, cur)
    first = cur
    tau_est = first + tau_min
    voiced = search[np.arange(len(frames)), first] < threshold

    # parabolic interpolation
    t0 = np.clip(tau_est, 1, w - 2)
    d0 = cmdf[np.arange(len(frames)), t0 - 1]
    d1 = cmdf[np.arange(len(frames)), t0]
    d2 = cmdf[np.arange(len(frames)), t0 + 1]
    denom = 2 * (d0 - 2 * d1 + d2)
    delta = np.where(np.abs(denom) > 1e-12, (d0 - d2) / (denom + 1e-12), 0.0)
    tau_ref = t0 + np.clip(delta, -1, 1)

    f0 = np.where(voiced, sr / np.maximum(tau_ref, 1e-6), 0.0)
    return f0.astype(np.float32)


def f0_norm(f0: np.ndarray, median: float, std: float) -> np.ndarray:
    """Speaker-normalised f0 (reference ``get_f0_norm``,
    ``pitch_utils.py:112-127``): voiced frames z-scored in log space."""
    voiced = f0 > 0
    lf0 = np.where(voiced, np.log(np.maximum(f0, 1e-6)), 0.0)
    return np.where(voiced, (lf0 - median) / (std + 1e-6), 0.0) \
        .astype(np.float32)


def compute_speaker_stats(dataset, out_json: str,
                          max_items_per_speaker: int = 50,
                          pitch_ckpt: str = "", fmin: float = 50.0,
                          fmax: float = 550.0, device="cuda") -> dict:
    """Per-speaker log-f0 statistics of ``dataset``'s first
    ``max_items_per_speaker`` items of each speaker, written to
    ``out_json`` and returned: ``{name: {"mean": median, "std": std}}``
    (``mean`` holds the median of the voiced log-f0 values, as in the JAX
    package; ``std`` is their biased std).  f0 by the numpy YIN, or with
    a ``pitch_ckpt`` by the FCPE network on ``device``; a missing
    checkpoint warns and takes YIN."""
    fcpe_fn = None
    if pitch_ckpt:
        import torch
        from .. import resolve_device
        from ..models.pitch_fcpe import fcpe_f0, get_fcpe
        dev = resolve_device(device)
        model = get_fcpe(pitch_ckpt, dev)
        if model is not None:
            def fcpe_fn(x):
                with torch.inference_mode():
                    xt = torch.as_tensor(np.asarray(x, np.float32),
                                         device=dev)[None]
                    return fcpe_f0(model, xt, dataset.sr, fmin=fmin,
                                   fmax=fmax)[0].cpu().numpy()
    per_speaker: dict[str, list] = {}
    counts: dict[str, int] = {}
    for i in range(len(dataset)):
        item = dataset[i]
        name = dataset.speaker_names[int(item["speaker"])]
        if counts.get(name, 0) >= max_items_per_speaker:
            continue
        counts[name] = counts.get(name, 0) + 1
        f0 = (fcpe_fn(item["x"]) if fcpe_fn is not None
              else yin_f0(item["x"], dataset.sr, fmin=fmin, fmax=fmax))
        v = f0[f0 > 0]
        if len(v):
            per_speaker.setdefault(name, []).extend(np.log(v).tolist())
    stats = {name: {"mean": float(np.median(vals)),
                    "std": float(np.std(np.asarray(vals)))}
             for name, vals in per_speaker.items()}
    Path(out_json).parent.mkdir(parents=True, exist_ok=True)
    Path(out_json).write_text(json.dumps(stats, indent=2))
    return stats
