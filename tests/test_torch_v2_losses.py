"""The port's v2 spectral distance and its parts against rave_tpu's.

Tolerances: the reflect-pad index map is exact (it picks samples); the
STFTs atol 2e-5 on unit-scale inputs (float32 FFTs of up to 2048
points in another library, as ``tests/test_torch_stft_losses.py``);
``audio_distance_v1`` rtol 1e-5 (float32 sums in another order); its
input gradient atol 1e-3 of the largest element: the log term's
gradient divides by ``|s| + log_epsilon``, so near-empty bins amplify
float32 rounding in both frameworks (the MR-STFT gradient's tolerance in
that file, for the same reason); ``mod_sigmoid`` rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.ops import losses as jL
from rave_tpu.ops.stft import multiscale_stft as jmultiscale
from rave_tpu.ops.stft import stft as jstft
from rave_tpu_torch.ops import losses as L
from rave_tpu_torch.ops.stft import _reflect_index, multiscale_stft, stft

SCALES = (512, 256, 128)


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


@pytest.mark.parametrize("T,pad", [(1, 3), (2, 5), (4, 6), (5, 4), (100, 256),
                                   (256, 256), (300, 1024)])
def test_reflect_index_is_numpy_reflect(T, pad):
    want = np.pad(np.arange(T), (pad, pad), mode="reflect")
    np.testing.assert_array_equal(_reflect_index(T, pad), want)
    np.testing.assert_array_equal(
        np.asarray(jnp.pad(jnp.arange(T), (pad, pad), mode="reflect")), want)


@pytest.mark.parametrize("T,n_fft", [(100, 512), (256, 512), (300, 2048),
                                     (600, 512)])
def test_stft_centred_pad_at_least_signal(T, n_fft):
    """``center=True`` where ``n_fft // 2 >= T`` (``F.pad`` would raise),
    and one case below it, against the JAX STFT."""
    x = _signal((3, T))
    want = np.asarray(jstft(jnp.asarray(x), n_fft, n_fft // 4))
    got = stft(torch.from_numpy(x), n_fft, n_fft // 4).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("normalized", [False, True])
def test_multiscale_stft_matches(normalized):
    """Channels-first ``(B, C, T)`` against the JAX ``(B, T, C)``, the
    magnitudes and their mel-scaled form."""
    x = _signal((2, 16, 256), 1)
    want = jmultiscale(jnp.asarray(x.transpose(0, 2, 1)), SCALES,
                       normalized=normalized)
    got = multiscale_stft(torch.from_numpy(x), SCALES, normalized=normalized)
    assert len(got) == len(want) == len(SCALES)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)
    complex_ = multiscale_stft(torch.from_numpy(x), SCALES, magnitude=False)
    assert complex_[0].is_complex()
    # the mel-scaled branch (ported with the hybrid preset, ROADMAP A7)
    want = jmultiscale(jnp.asarray(x.transpose(0, 2, 1)), SCALES,
                       normalized=normalized, num_mels=32)
    got = multiscale_stft(torch.from_numpy(x), SCALES, normalized=normalized,
                          num_mels=32)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[-1] == 32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 16, 256), (2, 4096)],
                         ids=["bands", "audio"])
def test_audio_distance_v1_value_and_gradient(shape):
    x, y = _signal(shape, 2), _signal(shape, 3)
    to_jax = (lambda a: a.transpose(0, 2, 1)) if len(shape) == 3 else (
        lambda a: a)

    def jdist(a):
        return jL.audio_distance_v1(a, jnp.asarray(to_jax(y)), SCALES, 1e-7)

    want, g_want = jax.value_and_grad(jdist)(jnp.asarray(to_jax(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = L.audio_distance_v1(xt, torch.from_numpy(y), SCALES, 1e-7)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    g_want = to_jax(np.asarray(g_want))
    scale = np.abs(g_want).max()
    assert scale > 1e-5
    np.testing.assert_allclose(xt.grad.numpy(), g_want, atol=1e-3 * scale)


def test_mod_sigmoid_matches():
    x = _signal((4, 50), 4, 3.0)
    np.testing.assert_allclose(L.mod_sigmoid(torch.from_numpy(x)).numpy(),
                               np.asarray(jL.mod_sigmoid(jnp.asarray(x))),
                               rtol=1e-6)
