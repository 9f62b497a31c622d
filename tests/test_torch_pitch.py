"""The port's pitch ops (``rave_tpu_torch/ops/pitch.py``) against
rave_tpu's, on the same numpy inputs, on the CPU.

YIN is held to the JAX package's ``yin_f0`` (both float32) and to the
port's numpy oracle (float64) by one rule: the voiced masks are equal,
and f0 agrees within rtol 1e-4 where both are voiced; a frame may flip
between voiced and unvoiced only where its cmdf minimum lies within 1e-4
of the 0.1 threshold (float32 against float64 rounding of a decision on
the threshold), and at most 1 % of the frames may.  The flips are counted
and printed.  The statistics atol 1e-6; the feature's resize atol 1e-6
(float32 rounding of values of a few units).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rave_tpu.ops import pitch as jp
from rave_tpu_torch.data.pitch import yin_f0 as np_yin
from rave_tpu_torch.ops import pitch as tp

SR = 44100
THRESHOLD = 0.1


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def signals(seed, T=2 * SR):
    """Four test signals ``(4, T)``: a harmonic tone gliding in f0, two
    steady tones with noise, and noise with a voiced middle."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / SR
    f = rng.uniform(80, 300)
    glide = sum(np.sin(2 * np.pi * h * f * (t + 0.4 * t * t)) / h
                for h in range(1, 6))
    out = [0.3 * glide + 0.01 * rng.standard_normal(T)]
    for f0 in rng.uniform(70, 500, 2):
        out.append(0.5 * np.sin(2 * np.pi * f0 * t)
                   + 0.2 * np.sin(4 * np.pi * f0 * t)
                   + 0.05 * rng.standard_normal(T))
    mixed = 0.1 * rng.standard_normal(T)
    mid = slice(T // 3, 2 * T // 3)
    mixed[mid] += 0.5 * np.sin(2 * np.pi * 150.0 * t[mid])
    out.append(mixed)
    return np.stack(out).astype(np.float32)


def cmdf_minimum(x, frame_length=2048, hop=1024, fmin=50.0, fmax=550.0):
    """Each frame's cmdf value at the lag YIN settles on (float64): the
    quantity its voiced decision compares with the threshold."""
    n = 1 + (len(x) - frame_length) // hop
    idx = np.arange(frame_length)[None] + hop * np.arange(n)[:, None]
    frames = x.astype(np.float64)[idx]
    w = frame_length // 2
    spec = np.fft.rfft(frames, 2 * frame_length, axis=-1)
    acf = np.fft.irfft(spec * np.conj(spec), axis=-1)[:, :w]
    energy = np.cumsum(frames ** 2, axis=-1)
    e_tau = energy[:, -1:] - np.concatenate(
        [np.zeros((n, 1)), energy[:, :w - 1]], axis=-1)
    d = energy[:, ::-1][:, :w] + e_tau - 2 * acf
    cmdf = d[:, 1:] * np.arange(1, w) / (np.cumsum(d[:, 1:], -1) + 1e-9)
    search = cmdf[:, int(SR / fmax) - 1:min(int(SR / fmin), w - 1) - 1]
    below = search < THRESHOLD
    cur = np.where(below.any(1), below.argmax(1), search.argmin(1))
    rows = np.arange(n)
    while True:
        nxt = np.minimum(cur + 1, search.shape[1] - 1)
        better = (nxt > cur) & (search[rows, nxt] < search[rows, cur])
        if not better.any():
            return search[rows, cur]
        cur = np.where(better, nxt, cur)


def hold_f0(got, want, x, what):
    """The f0 rule of the module docstring; returns the flip count."""
    flips = 0
    for b in range(len(x)):
        flip = (got[b] > 0) != (want[b] > 0)
        if flip.any():
            near = np.abs(cmdf_minimum(x[b]) - THRESHOLD) < 1e-4
            assert (near | ~flip).all(), (what, b, np.flatnonzero(flip))
        flips += int(flip.sum())
        both = (got[b] > 0) & (want[b] > 0)
        np.testing.assert_allclose(got[b][both], want[b][both], rtol=1e-4)
    assert flips <= 0.01 * got.size, (what, flips, got.size)
    print(f"{what}: {flips} of {got.size} frames flipped")
    return flips


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_yin_matches_jax_and_the_numpy_oracle(seed):
    x = signals(seed)
    got = tp.yin_f0(torch.from_numpy(x), SR).numpy()
    want = np.asarray(jp.yin_f0(jnp.asarray(x), SR))
    assert got.shape == want.shape == (4, 1 + (2 * SR - 2048) // 1024)
    assert (got > 0).mean() > 0.5 and (got == 0).any()
    hold_f0(got, want, x, f"seed {seed} vs JAX")
    oracle = np.stack([np_yin(s, SR) for s in x])
    hold_f0(got, oracle, x, f"seed {seed} vs numpy")


def test_yin_pads_a_short_signal_to_one_frame():
    x = signals(3, T=1500)
    got = tp.yin_f0(torch.from_numpy(x), SR).numpy()
    want = np.asarray(jp.yin_f0(jnp.asarray(x), SR))
    assert got.shape == want.shape == (4, 1)
    hold_f0(got, want, x, "short")


def test_voiced_log_stats_match_jax():
    """Odd and even voiced counts (the lower median), one voiced frame
    (std 1), none (log 160, std 1)."""
    rng = np.random.default_rng(4)
    f0 = rng.uniform(60, 500, (5, 33)).astype(np.float32)
    f0[0, ::3] = 0
    f0[1, :6] = 0
    f0[2, 1:] = 0
    f0[3] = 0
    got = tp.voiced_log_stats(torch.from_numpy(f0))
    want = jp.voiced_log_stats(jnp.asarray(f0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    assert got[0][3] == pytest.approx(np.log(160.0))
    assert got[1][2] == got[1][3] == 1.0


def test_f0_norm_feature_downsampling_is_antialiased():
    """127 f0 frames to 64 latent frames (131072 samples): equal to
    ``jax.image.resize``'s antialiased linear resize; the plain linear
    interpolation is not."""
    rng = np.random.default_rng(5)
    f0 = rng.uniform(80, 400, (2, 127)).astype(np.float32)
    f0[:, ::4] = 0
    med = np.log([150.0, 220.0]).astype(np.float32)
    std = np.array([0.3, 0.2], np.float32)
    args = [torch.from_numpy(a) for a in (f0, med, std)]
    got = tp.f0_norm_feature(*args, out_frames=64, channels=2).numpy()
    want = np.asarray(jp.f0_norm_feature(
        jnp.asarray(f0), jnp.asarray(med), jnp.asarray(std), 64, 2))
    assert got.shape == want.shape == (2, 64, 2)
    np.testing.assert_allclose(got, want, atol=1e-6)
    # the trap: F.interpolate's linear mode does not antialias
    z = np.where(f0 > 0, (np.log(np.maximum(f0, 1e-6)) - med[:, None])
                 / (std[:, None] + 1e-6), 0.0).astype(np.float32)
    plain = F.interpolate(torch.from_numpy(z)[:, None], size=64,
                          mode="linear", align_corners=False)[:, 0].numpy()
    assert np.abs(plain - want[..., 0]).max() > 0.1
    # upsampling (7 frames to 128) agrees too
    up = tp.f0_norm_feature(*[a[:, :7] if a.dim() == 2 else a for a in args],
                            out_frames=128).numpy()
    np.testing.assert_allclose(up, np.asarray(jp.f0_norm_feature(
        jnp.asarray(f0[:, :7]), jnp.asarray(med), jnp.asarray(std), 128)),
        atol=1e-6)


def test_pitch_feature_with_external_statistics_matches_jax():
    """Speaker statistics given, per-utterance ones, and a median alone.
    The feature divides log-f0 by the std, which is 1e-3 on a steady
    tone, so it is held in log-f0 units: times the std it divides by,
    atol 1e-5."""
    x = signals(6, T=65536)[..., None]
    med = np.log([120.0, 200.0, 300.0, 150.0]).astype(np.float32)
    std = np.array([0.2, 0.3, 0.25, 0.4], np.float32)
    _, own_std = jp.voiced_log_stats(jp.yin_f0(jnp.asarray(x[..., 0]), SR))
    own_std = np.asarray(own_std)
    assert own_std.min() < 0.01
    for kw, scale in (({"median": med, "std": std}, std), ({}, own_std),
                      ({"median": med}, own_std)):
        got = tp.pitch_feature(torch.from_numpy(x), 32, SR, **{
            k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
        want = np.asarray(jp.pitch_feature(jnp.asarray(x), 32, SR, **{
            k: jnp.asarray(v) for k, v in kw.items()}))
        assert got.shape == want.shape == (4, 32, 1)
        assert np.abs(want).max() > 0.5
        np.testing.assert_allclose((got - want) * scale[:, None, None], 0,
                                   atol=1e-5)
