"""The port's STFT and losses against rave_tpu's.

Tolerances: the window atol 2e-7 (float32 rounding of the cosine); the
STFT atol 2e-5 on unit-scale inputs of 4096 samples (float32 FFTs of up
to 4096 points, another FFT library); the losses rtol 1e-5 (float32 sums
in another order); the MR-STFT input gradient atol 1e-3 of its largest
element: the log-magnitude term's gradient divides by ``|s|``, so quiet
bins amplify float32 rounding, and against a float64 evaluation the JAX
package's gradient errs by 8e-6 and the port's by 4e-6 at a largest
element of 1.5e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.ops import losses as jL
from rave_tpu.ops.stft import stft as jstft
from rave_tpu_torch.ops import losses as L
from rave_tpu_torch.ops.stft import hann_window, stft

RES = jL.mr_stft_resolutions(44100, ((5, 25), (10, 50), (2, 10)))


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


def test_hann_window_is_torch_periodic():
    np.testing.assert_allclose(hann_window(1102),
                               torch.hann_window(1102).numpy(), atol=2e-7)


@pytest.mark.parametrize("n_fft,hop,win,center", [
    *[(n, h, w, True) for n, h, w in RES],       # MR-STFT, centred
    (2048, 512, None, False),                    # full window, uncentred
    (1024, 160, 800, False),                     # the MRD's (10, 50) ms
    (512, 32, 160, False)])                      # the MRD's (2, 10) ms
def test_stft_matches(n_fft, hop, win, center):
    x = _signal((2, 4096))
    want = np.asarray(jstft(jnp.asarray(x), n_fft, hop, win_length=win,
                            center=center))
    got = stft(torch.from_numpy(x), n_fft, hop, win_length=win,
               center=center).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_mr_stft_resolutions_match():
    assert L.mr_stft_resolutions() == RES
    assert RES == [(2048, 220, 1102), (4096, 441, 2205), (512, 88, 441)]


def test_multi_resolution_stft_loss_value_and_gradient():
    x, y = _signal((2, 8192), 1), _signal((2, 8192), 2)

    def jloss(a):
        sc, mag = jL.multi_resolution_stft_loss(a, jnp.asarray(y), RES)
        return sc + mag, (sc, mag)

    (_, (sc_j, mag_j)), g_j = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    sc, mag = L.multi_resolution_stft_loss(xt, torch.from_numpy(y), RES)
    (sc + mag).backward()
    sc, mag = sc.detach(), mag.detach()
    assert float(sc) == pytest.approx(float(sc_j), rel=1e-5)
    assert float(mag) == pytest.approx(float(mag_j), rel=1e-5)
    scale = np.abs(np.asarray(g_j)).max()
    assert scale > 1e-4
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j),
                               atol=1e-3 * scale)


@pytest.mark.parametrize("name", sorted(jL.GAN_LOSSES))
def test_gan_losses_match(name):
    real, fake = _signal((3, 1, 50), 3, 1.0), _signal((3, 1, 50), 4, 1.0)
    got = L.GAN_LOSSES[name](torch.from_numpy(real), torch.from_numpy(fake))
    want = jL.GAN_LOSSES[name](jnp.asarray(real), jnp.asarray(fake))
    for a, b in zip(got, want):
        assert float(a) == pytest.approx(float(b), rel=1e-5)


@pytest.mark.parametrize("norm", ["L1", "L2"])
@pytest.mark.parametrize("relative", [False, True])
def test_mean_difference_matches(norm, relative):
    a, b = _signal((2, 16, 40), 5), _signal((2, 16, 40), 6)
    got = L.mean_difference(torch.from_numpy(a), torch.from_numpy(b), norm,
                            relative)
    want = jL.mean_difference(jnp.asarray(a), jnp.asarray(b), norm, relative)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    with pytest.raises(ValueError, match="L1 or L2"):
        L.mean_difference(torch.from_numpy(a), torch.from_numpy(b), "L3")
