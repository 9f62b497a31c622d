"""YIN f0 tracking and speaker-normalised f0, in numpy.

The port's copy of ``yin_f0`` and ``f0_norm`` from
``rave_tpu/data/pitch.py``: the FFT-autocorrelation YIN that the
perturbation's pitch shifter and the trainer's conversion metrics read.
The per-speaker statistics (``compute_speaker_stats``) belong to the
pitch slice (ROADMAP A8).
"""

from __future__ import annotations

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
