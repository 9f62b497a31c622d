"""The rest of the port's loss library against rave_tpu's: the mel-scaled
``multiscale_stft`` and ``audio_distance_v1``, ``spectral_distance``
(mel, power), ``encodec_audio_distance``, the instantaneous-frequency
distance and the KL schedules.

Tolerances: values rtol 1e-5 (float32 sums in another order; another FFT
library), input gradients rtol 1e-5 with an atol of 1e-5 of the largest
element (elements far below the largest carry float32 rounding of the
sums they come from; the instantaneous-frequency distance on signals
with a silent head, see its test); the STFTs and the phase derivative
atol 2e-5 (as ``tests/test_torch_stft_losses.py``, float32 FFTs of
unit-scale signals), the KL schedules rtol 1e-5 (the JAX package's
float32 logs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.ops import losses as jL
from rave_tpu.ops.stft import multiscale_stft as jmultiscale_stft
from rave_tpu_torch.ops import losses as L
from rave_tpu_torch.ops.stft import multiscale_stft
from rave_tpu_torch.train import schedules

SR = 44100


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _signal(shape, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _hold(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-5 * np.abs(want).max())


def _value_and_grad(jfn, tfn, x, y):
    """``fn(x, y)`` and its gradient in ``x`` from both packages."""
    jv, jg = jax.jit(jax.value_and_grad(
        lambda a: jfn(a, jnp.asarray(y))))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tv = tfn(xt, torch.from_numpy(y))
    tv.backward()
    return (tv.item(), xt.grad.numpy()), (float(jv), np.asarray(jg))


@pytest.mark.parametrize("scales,num_mels", [((512, 256), 32),
                                             ((1024,), 64)])
def test_multiscale_stft_mel_matches(scales, num_mels):
    """(B, T) and channels-first (B, C, T) against the JAX package's
    (B, T) and (B, T, C)."""
    x = _signal((2, 3, 4096))
    for got_in, want_in in ((x[:, 0], x[:, 0]),
                            (x, x.transpose(0, 2, 1))):
        want = jmultiscale_stft(jnp.asarray(want_in), scales, sample_rate=SR,
                                num_mels=num_mels)
        got = multiscale_stft(torch.from_numpy(np.ascontiguousarray(got_in)),
                              scales, sample_rate=SR, num_mels=num_mels)
        for g, w in zip(got, want):
            assert g.shape[-1] == num_mels
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


@pytest.mark.parametrize("num_mels", [None, 32])
def test_audio_distance_v1_mel_value_and_gradient(num_mels):
    x, y = _signal((2, 4096), 1), _signal((2, 4096), 2)
    kw = dict(scales=(512, 256), log_epsilon=1e-3, sample_rate=SR,
              num_mels=num_mels)
    (tv, tg), (jv, jg) = _value_and_grad(
        lambda a, b: jL.audio_distance_v1(a, b, **kw),
        lambda a, b: L.audio_distance_v1(a, b, **kw), x, y)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    _hold(tg, jg)


@pytest.mark.parametrize("mel,power,norms", [(None, 1.0, ("L1",)),
                                             (64, 1.0, ("L1", "L2")),
                                             (32, 2.0, ("L2",)),
                                             (None, None, ("L1", "L2"))])
def test_spectral_distance_value_and_gradient(mel, power, norms):
    x, y = _signal((2, 4096), 3), _signal((2, 4096), 4)
    kw = dict(n_fft=512, sample_rate=SR, norms=norms, power=power, mel=mel)
    (tv, tg), (jv, jg) = _value_and_grad(
        lambda a, b: jL.spectral_distance(a, b, **kw),
        lambda a, b: L.spectral_distance(a, b, **kw), x, y)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    _hold(tg, jg)


@pytest.mark.parametrize("mel,audio", [(None, False), (32, True)])
def test_encodec_audio_distance_value_and_gradient(mel, audio):
    """Both terms, and the gradient of their sum; ``audio`` feeds
    ``(B, T, 1)``."""
    shape = (2, 4096, 1) if audio else (2, 4096)
    x, y = _signal(shape, 5), _signal(shape, 6)
    kw = dict(scales=(64, 128, 256, 512), sample_rate=SR, mel=mel)
    jd = jL.encodec_audio_distance(jnp.asarray(x), jnp.asarray(y), **kw)
    td = L.encodec_audio_distance(torch.from_numpy(x), torch.from_numpy(y),
                                  **kw)
    assert set(td) == set(jd)
    for k in jd:
        np.testing.assert_allclose(float(td[k]), float(jd[k]), rtol=1e-5)
    (tv, tg), (jv, jg) = _value_and_grad(
        lambda a, b: sum(jL.encodec_audio_distance(a, b, **kw).values()),
        lambda a, b: sum(L.encodec_audio_distance(a, b, **kw).values()),
        x, y)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    _hold(tg, jg)


def test_instantaneous_frequency_matches():
    phase = np.random.default_rng(7).uniform(-np.pi, np.pi, (3, 5, 129)
                                             ).astype(np.float32)
    want = np.asarray(jL._instantaneous_frequency(jnp.asarray(phase)))
    got = L._instantaneous_frequency(torch.from_numpy(phase)).numpy()
    assert got.shape == want.shape == (3, 5, 127)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("weighted,audio", [(False, False), (True, True)])
def test_weighted_instantaneous_spectral_distance(weighted, audio):
    """Both terms, and the gradient of the spectral term plus a tenth of
    the phase term; ``audio`` feeds ``(B, T, 1)``.

    The signals start with ``n_fft // 2 + 1`` zeros of the largest scale.
    Frame 0 of a reflect-padded centred STFT is symmetric, so its
    spectrum is real: its phases sit at 0 or +-pi, and whether a step
    between two of them wraps to +pi or -pi follows the sign of a
    rounding-level imaginary part, in either package (the phase term of
    two unit-scale noise signals then differs by 8e-4 relative).  A
    zero head makes frame 0 exactly zero, its phases 0 in both.  There
    the JAX package's gradient is NaN (``jnp.angle``'s derivative at 0)
    and the port's finite, so the gradients are held after the head."""
    head = 512 // 2 + 1
    shape = (2, 4096, 1) if audio else (2, 4096)
    x, y = _signal(shape, 8), _signal(shape, 9)
    x[:, :head] = y[:, :head] = 0
    kw = dict(scales=(512, 256), weighted=weighted)
    jd = jL.weighted_instantaneous_spectral_distance(
        jnp.asarray(x), jnp.asarray(y), **kw)
    td = L.weighted_instantaneous_spectral_distance(
        torch.from_numpy(x), torch.from_numpy(y), **kw)
    assert set(td) == set(jd)
    for k in jd:
        np.testing.assert_allclose(float(td[k]), float(jd[k]), rtol=1e-5)

    def total(fn):
        def f(a, b):
            d = fn(a, b, **kw)
            return d["spectral_distance"] + 0.1 * d["phase_distance"]
        return f

    (tv, tg), (jv, jg) = _value_and_grad(
        total(jL.weighted_instantaneous_spectral_distance),
        total(L.weighted_instantaneous_spectral_distance), x, y)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    assert np.isfinite(tg).all()
    _hold(tg[:, head:], jg[:, head:])


def test_distances_are_zero_on_identical_inputs():
    """The properties of ``tests/test_losses.py``: every distance is 0
    between a signal and itself, positive between two."""
    x = torch.from_numpy(_signal((2, 4096), 10))
    y = x + 0.1 * torch.from_numpy(_signal((2, 4096), 11, 1.0))
    d0 = L.encodec_audio_distance(x, x, scales=(256, 512))
    d1 = L.encodec_audio_distance(x, y, scales=(256, 512))
    for k in ("waveform_distance", "spectral_distance"):
        assert float(d0[k]) == 0.0 and float(d1[k]) > 0
    assert float(L.spectral_distance(x, x, 512, mel=64)) == 0.0
    assert float(L.spectral_distance(x, y, 512, norms=("L1", "L2"),
                                     mel=64)) > 0
    assert float(L.audio_distance_v1(x, x, (512,), num_mels=32)) == 0.0


def test_shifted_tone_is_nearer_in_phase_than_another_pitch():
    """A tone shifted by 100 samples has a far smaller instantaneous-
    frequency distance than a tone an octave up; a tone against itself
    has none."""
    t = torch.arange(8192, dtype=torch.float32) / SR
    a = torch.sin(2 * np.pi * 441.0 * t)[None]
    b = torch.sin(2 * np.pi * 441.0 * (t + 100.0 / SR))[None]
    c = torch.sin(2 * np.pi * 882.0 * t)[None]
    dist = L.weighted_instantaneous_spectral_distance
    same, shift, diff = (dist(a, o, scales=(512,)) for o in (a, b, c))
    assert float(same["phase_distance"]) == 0.0
    assert float(same["spectral_distance"]) == 0.0
    assert float(shift["phase_distance"]) < float(diff["phase_distance"])


STEPS = [0, 1, 7, 50, 99, 100, 101, 149, 150, 151, 333, 1000, 12345]


@pytest.mark.parametrize("schedule,args", [
    ("get_beta_kl", (100, 1e-6, 1e-1)),
    ("get_beta_kl_cyclic", (64, 1e-4, 5e-1)),
    ("get_beta_kl_cyclic_annealed", (64, 300, 1e-6, 1e-1))])
def test_kl_schedules_match(schedule, args):
    for step in STEPS:
        want = float(getattr(jL, schedule)(jnp.float32(step), *args))
        got = getattr(schedules, schedule)(step, *args)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   err_msg=f"{schedule} step {step}")


def test_cached_constants_survive_inference_mode():
    """The STFT's window and the mel basis are cached per device; a first
    call under ``torch.inference_mode`` (serving) must not cache an
    inference tensor that a later training pass cannot save for its
    backward."""
    with torch.inference_mode():
        multiscale_stft(torch.randn(1, 4096), (1536,), num_mels=24)
    x = torch.randn(1, 4096, requires_grad=True)
    L.audio_distance_v1(x, torch.randn(1, 4096), (1536,),
                        num_mels=24).backward()
    assert bool(torch.isfinite(x.grad).all()) and float(x.grad.abs().sum()) > 0
