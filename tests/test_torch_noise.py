"""The filtered-noise path of the port against ``rave_tpu``:
``amp_to_impulse_response``, ``fft_convolve``, NoiseGeneratorV1 and
NoiseGeneratorV2 with the JAX package's uniform draw injected, GeneratorV2
with its noise branch, and the noise generator streamed through its
causal caches with one fixed draw per chunk.

The port takes the draw JAX makes from a key as a tensor: the noise
generator's ``jax.random.uniform(key, ir.shape, f32, -1, 1)``, where
``ir`` is ``(B, T', data_size, prod(ratios))``; the same layout in both.

Tolerances: the impulse response and the FFT convolution 1e-6 (float32
FFTs); the noise generators 1e-5 of the output's largest magnitude
(the branch is quiet at init: its amplitudes are ``mod_sigmoid(x - 5)``,
about 1e-4; a few float32 convs, then the FFTs);
GeneratorV2 with noise 2e-5 times the mean magnitude (float32 through
~15 convs); the stream against the offline pass 1e-6 of the largest
magnitude (the same convs, chunk by chunk).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.models import blocks as jblocks
from rave_tpu.ops import losses as jlosses
from rave_tpu.ops.conv import StreamSetup as JSS
from rave_tpu_torch.convert import _Loader
from rave_tpu_torch.models.blocks import (GeneratorV2, NoiseGeneratorV1,
                                          NoiseGeneratorV2)
from rave_tpu_torch.ops import losses
from rave_tpu_torch.ops.conv import StreamSetup, stream_caches


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cf(a):
    """``(B, T, C)`` numpy -> ``(B, C, T)`` tensor."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1)))


def _load(module, params):
    ld = _Loader()
    ld.named(module, params, "")
    ld.check(params, list(module.named_parameters()))


@pytest.mark.parametrize("target", [8, 64])
def test_impulse_response_and_convolution_match(target):
    r = np.random.default_rng(0)
    amp = r.uniform(0, 2, (2, 6, 16, 5)).astype(np.float32)
    want = np.asarray(jlosses.amp_to_impulse_response(jnp.asarray(amp),
                                                      target))
    got = losses.amp_to_impulse_response(torch.from_numpy(amp), target)
    assert got.shape == want.shape == (2, 6, 16, target)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    sig = r.uniform(-1, 1, want.shape).astype(np.float32)
    want = np.asarray(jlosses.fft_convolve(jnp.asarray(sig),
                                           jnp.asarray(want)))
    got = losses.fft_convolve(torch.from_numpy(sig), got)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def _jax_noise(kind, in_size, T, seed=1):
    """A JAX noise generator, its params, an input ``(1, T, in_size)``,
    the key and the draw it makes from it."""
    if kind == "v1":
        m = jblocks.NoiseGeneratorV1(in_size=in_size, data_size=16)
    else:
        m = jblocks.NoiseGeneratorV2(in_size=in_size, hidden_size=12,
                                     data_size=16, ratios=(2, 2, 2),
                                     noise_bands=5)
    x = (np.random.default_rng(seed).standard_normal((2, T, in_size))
         ).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    params = _np(m.init(jax.random.PRNGKey(0), jnp.asarray(x), key))
    y = np.asarray(jax.jit(m.apply)(params, jnp.asarray(x), key))
    total = 64 if kind == "v1" else 8
    draw = np.array(jax.random.uniform(key, (2, T // total, 16, total),
                                       jnp.float32, -1.0, 1.0))
    return m, params["params"], x, y, draw


def _port_noise(kind, in_size, ss=StreamSetup()):
    if kind == "v1":
        return NoiseGeneratorV1(in_size, 16, ss=ss)
    return NoiseGeneratorV2(in_size, 12, 16, (2, 2, 2), 5, ss=ss)


@pytest.mark.parametrize("kind", ["v1", "v2"])
def test_noise_generator_matches(kind):
    _, params, x, want, draw = _jax_noise(kind, 8, 512)
    ng = _port_noise(kind, 8)
    _load(ng, params)
    with torch.no_grad():
        got = ng(_cf(x), torch.from_numpy(draw))
    assert got.shape == (2, 16, 512)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), want,
                               atol=1e-5 * np.abs(want).max())
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        drawn = ng(_cf(x), generator=g)
    assert drawn.shape == got.shape and not torch.allclose(drawn, got)
    with pytest.raises(ValueError, match="needs a value or a generator"):
        ng(_cf(x))
    with pytest.raises(ValueError, match="uniform draw"):
        ng(_cf(x), torch.from_numpy(draw[:, 1:]))


@pytest.mark.parametrize("kind", ["v1", "v2"])
def test_noise_generator_streams_with_a_fixed_draw(kind):
    """Streamed in chunks through its causal caches with one draw reused
    in every chunk, the branch equals the offline pass over the whole
    input with that draw repeated per chunk."""
    chunk, n = 128, 4
    _, params, x, _, draw = _jax_noise(kind, 8, chunk * n)
    off, live = _port_noise(kind, 8), _port_noise(
        kind, 8, StreamSetup(streaming=True))
    for m in (off, live):
        _load(m, params)
    per = draw.shape[1] // n
    fixed = torch.from_numpy(draw[:, :per].copy())
    with torch.no_grad():
        want = off(_cf(x), fixed.repeat(1, n, 1, 1))
        mods, caches = stream_caches(live, live, _cf(x[:, :chunk]))
        assert live.draw in mods
        caches[mods.index(live.draw)] = fixed
        outs = []
        for i in range(n):
            for m, c in zip(mods, caches):
                m.cache = c
            outs.append(live(_cf(x[:, i * chunk:(i + 1) * chunk])))
            caches = [m.cache for m in mods]
    assert caches[mods.index(live.draw)] is fixed
    np.testing.assert_allclose(torch.cat(outs, 2).numpy(), want.numpy(),
                               atol=1e-6 * float(want.abs().max()))


def test_generator_v2_with_noise_matches():
    """GeneratorV2 with ``use_noise``: the branch fed the last
    activation, added after the amplitude modulation (JAX draws the
    uniform noise from the key it is given)."""
    kw = dict(data_size=16, capacity=4, ratios=(2, 2), latent_size=6,
              kernel_size=3, dilations=((1, 3), (1, 3)),
              amplitude_modulation=True, use_noise=True, noise_hidden=12)
    m = jblocks.GeneratorV2(**kw, ss=JSS())
    z = np.random.default_rng(2).standard_normal((2, 16, 6)).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    params = _np(m.init(jax.random.PRNGKey(0), jnp.asarray(z), key))
    want = np.asarray(jax.jit(m.apply)(params, jnp.asarray(z), key))
    draw = np.array(jax.random.uniform(key, (2, 8, 16, 8), jnp.float32,
                                       -1.0, 1.0))
    gen = GeneratorV2(**kw)
    _load(gen, params["params"])
    with torch.no_grad():
        got = gen(_cf(z), torch.from_numpy(draw)).numpy().transpose(0, 2, 1)
        quiet = gen(_cf(z), torch.zeros(2, 8, 16, 8)).numpy()
    assert got.shape == want.shape == (2, 64, 16)
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).mean())
    # a zero draw silences the branch (the fft convolution of zeros); at
    # init its amplitudes are mod_sigmoid(x - 5), ~1e-5, so it is quiet
    assert 0 < np.abs(quiet.transpose(0, 2, 1) - got).max() < 1e-3
