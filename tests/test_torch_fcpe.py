"""The port's FCPE pitch estimator (``rave_tpu_torch/models/pitch_fcpe.py``)
against rave_tpu's, on the CPU.

``torchfcpe`` and its checkpoint are absent: the network is held, on
random weights, against a torch module built here in torchfcpe's
CFNaiveMelPE layout (the state-dict keys both readers consume, its
output projection weight-normed), saved as a checkpoint.  Fixed widths
(the published model's), 0.5 s of audio.  Tolerances: the resampler and
the log-mel atol 1e-5; the network's confidences atol 1e-5 (float32
through ~20 layers); f0 rtol 1e-5 (float32 through the network and the
decode).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from rave_tpu.models import pitch_fcpe as jf
from rave_tpu.ops.pitch import pitch_feature as jpitch_feature
from rave_tpu_torch.convert import load_fcpe_params
from rave_tpu_torch.models import pitch_fcpe as tf
from rave_tpu_torch.ops.pitch import pitch_feature


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def compiled_here():
    """The JAX reference compiled in this process, not read from the
    persistent compilation cache.  A file that imports
    ``rave_tpu.train.trainer`` in-process (``tests/test_cli_e2e.py``,
    ``test_parallel.py``, ``test_train.py``) points the cache of its
    whole xdist worker at ``~/.jax_cache``, which no machine key
    separates, and never points it back; a log-mel reference read from
    there may come from another machine's compile.  Restored after."""
    before = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    jax.clear_caches()
    yield
    jax.config.update("jax_enable_compilation_cache", before)


def torchfcpe_mirror(seed=0):
    """A module with torchfcpe CFNaiveMelPE's state-dict layout, random
    weights (non-trivial norms included)."""
    torch.manual_seed(seed)

    class Transpose(tnn.Module):
        def forward(self, x):
            return x.transpose(1, 2)

    class DepthWise(tnn.Module):
        def __init__(self, dim, k):
            super().__init__()
            self.conv = tnn.Conv1d(dim, dim, k, groups=dim, padding=k // 2)

        def forward(self, x):
            return self.conv(x)

    class ConfBlock(tnn.Module):
        def __init__(self, dim=tf.HIDDEN, inner=tf.INNER):
            super().__init__()
            self.net = tnn.Sequential(
                tnn.LayerNorm(dim), Transpose(),
                tnn.Conv1d(dim, inner * 2, 1), tnn.GLU(dim=1),
                DepthWise(inner, tf.KERNEL), tnn.SiLU(),
                tnn.Conv1d(inner, dim, 1), Transpose())

        def forward(self, x):
            return x + self.net(x)

    class Layer(tnn.Module):
        def __init__(self):
            super().__init__()
            self.conformer = ConfBlock()
            self.norm = tnn.LayerNorm(tf.HIDDEN)   # unused by the forward

        def forward(self, x):
            return self.conformer(x)

    class Net(tnn.Module):
        def __init__(self):
            super().__init__()
            self.encoder_layers = tnn.ModuleList(
                [Layer() for _ in range(tf.N_LAYERS)])

        def forward(self, x):
            for layer in self.encoder_layers:
                x = layer(x)
            return x

    class Model(tnn.Module):
        def __init__(self):
            super().__init__()
            self.input_stack = tnn.Sequential(
                tnn.Conv1d(tf.N_MELS, tf.HIDDEN, 3, padding=1),
                tnn.GroupNorm(4, tf.HIDDEN), tnn.LeakyReLU(),
                tnn.Conv1d(tf.HIDDEN, tf.HIDDEN, 3, padding=1))
            self.net = Net()
            self.norm = tnn.LayerNorm(tf.HIDDEN)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", FutureWarning)
                self.output_proj = tnn.utils.weight_norm(
                    tnn.Linear(tf.HIDDEN, tf.OUT_DIMS))

        def forward(self, mel):
            x = self.input_stack(mel.transpose(1, 2)).transpose(1, 2)
            return torch.sigmoid(self.output_proj(self.norm(self.net(x))))

    m = Model()
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, (tnn.LayerNorm, tnn.GroupNorm)):
                mod.weight.uniform_(0.5, 1.5)
                mod.bias.normal_(0, 0.1)
    return m.eval()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    m = torchfcpe_mirror()
    path = tmp_path_factory.mktemp("fcpe") / "fcpe_random.pt"
    torch.save({"model": m.state_dict()}, path)
    port = tf.FCPE()
    port.load_state_dict(tf.load_fcpe_checkpoint(str(path)))
    return m, str(path), port.eval(), jf.convert_fcpe_checkpoint(str(path))


def audio(seed, sr, seconds=0.5, batch=2):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    f0 = rng.uniform(100, 400, (batch, 1))      # gliding up by half
    x = 0.4 * np.sin(2 * np.pi * f0 * (t + t * t / (2 * seconds))) \
        + 0.05 * rng.standard_normal((batch, len(t)))
    return x.astype(np.float32)


def test_cent_and_f0_tables():
    np.testing.assert_array_equal(tf.cent_table(), jf.cent_table())
    f0 = np.array([50.0, 110.0, 440.0, 1000.0])
    back = tf.cent_to_f0(torch.from_numpy(tf.f0_to_cent(f0))).numpy()
    np.testing.assert_allclose(back, f0, rtol=1e-12)
    np.testing.assert_allclose(
        tf.cent_to_f0(torch.from_numpy(tf.cent_table())).numpy(),
        np.asarray(jf.cent_to_f0(jnp.asarray(jf.cent_table()))), rtol=1e-6)


@pytest.mark.parametrize("sr", [44100, 48000, 22050, 16000, 8000])
def test_resample_to_matches_jax(sr):
    """Down (44.1 kHz: up 160 / down 441), identity, and up; the same
    samples (``T * up // down``, one fewer when upsampling by 2)."""
    for T in (int(sr * 0.5), 5120, 4097):
        x = audio(1, sr, seconds=T / sr)
        got = tf.resample_to(torch.from_numpy(x), sr, 16000).numpy()
        want = np.asarray(jf.resample_to(jnp.asarray(x), sr, 16000))
        assert got.shape == want.shape
        assert got.shape[1] == T * 16000 // sr - (sr < 16000)
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_log_mel_matches_jax(compiled_here):
    x16 = audio(2, 16000)
    got = tf.log_mel(torch.from_numpy(x16)).numpy()
    want = np.asarray(jf.log_mel(jnp.asarray(x16)))
    frames = 1 + (8000 + tf.N_FFT - tf.HOP - tf.N_FFT) // tf.HOP
    assert got.shape == want.shape == (2, frames, tf.N_MELS)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_network_matches_the_mirror_and_jax(ckpt):
    """The reader's weights in the port's network against the torchfcpe-
    layout module itself and against the JAX package's converter and
    ``fcpe_latent``; then the JAX parameter tree carried by
    ``load_fcpe_params``."""
    mirror, _, port, jparams = ckpt
    mel = np.random.default_rng(3).standard_normal((2, 51, tf.N_MELS)) \
        .astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).numpy()
        ref = mirror(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    want = np.asarray(jf.fcpe_latent(jparams, jnp.asarray(mel)))
    np.testing.assert_allclose(got, want, atol=1e-5)

    tree = jf.init_fcpe_params(jax.random.PRNGKey(4))
    carried = tf.FCPE()
    load_fcpe_params(carried, jax.tree.map(np.asarray, tree))
    with torch.no_grad():
        got = carried(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jf.fcpe_latent(tree, jnp.asarray(mel))), atol=1e-5)


def test_decode_local_argmax_matches_jax():
    rng = np.random.default_rng(5)
    lat = (rng.uniform(0, 0.004, (2, 40, tf.OUT_DIMS))).astype(np.float32)
    peaks = rng.integers(0, tf.OUT_DIMS, (2, 40))
    for b in range(2):
        for i in range(40):
            if i % 5:   # every fifth frame stays below the threshold
                lat[b, i, max(0, peaks[b, i] - 2):peaks[b, i] + 3] += \
                    rng.uniform(0.1, 0.9, len(lat[b, i, max(
                        0, peaks[b, i] - 2):peaks[b, i] + 3]))
    got = tf.decode_local_argmax(torch.from_numpy(lat)).numpy()
    want = np.asarray(jf.decode_local_argmax(jnp.asarray(lat)))
    assert (got == 0).sum() == (want == 0).sum() == 16
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("sr,frames", [(44100, None), (44100, 21), (16000, 7)])
def test_fcpe_f0_matches_jax(ckpt, sr, frames):
    _, _, port, jparams = ckpt
    x = audio(6, sr)
    with torch.no_grad():
        got = tf.fcpe_f0(port, torch.from_numpy(x), sr,
                         out_frames=frames).numpy()
    want = np.asarray(jf.fcpe_f0(jparams, jnp.asarray(x), sr,
                                 out_frames=frames))
    assert got.shape == want.shape
    assert (want > 0).any() and (want <= 550).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_reader_is_strict(ckpt, tmp_path):
    """A wrong shape, a missing key and a left-over weight are refused
    (as by the JAX package's converter); a wrapper prefix is stripped and
    a plain output weight taken as it is."""
    mirror, _, port, _ = ckpt
    sd = mirror.state_dict()

    def save(d, name):
        path = tmp_path / name
        torch.save({"model": d}, path)
        return str(path)

    bad = dict(sd, **{"input_stack.0.weight": torch.zeros(7, 7, 7)})
    for read in (tf.load_fcpe_checkpoint, jf.convert_fcpe_checkpoint):
        with pytest.raises(ValueError, match="refusing to reshape"):
            read(save(bad, "bad.pt"))
    with pytest.raises(KeyError, match="norm.bias"):
        tf.load_fcpe_checkpoint(save(
            {k: v for k, v in sd.items() if k != "norm.bias"}, "miss.pt"))
    extra = dict(sd, **{"net.encoder_layers.0.attn.weight": torch.zeros(2)})
    with pytest.raises(ValueError, match="unconsumed"):
        tf.load_fcpe_checkpoint(save(extra, "extra.pt"))

    wrapped = {"model." + k: v for k, v in sd.items()}
    got = tf.load_fcpe_checkpoint(save(wrapped, "wrapped.pt"))
    for k, v in port.state_dict().items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    plain = {k: v for k, v in sd.items() if "output_proj.weight_" not in k}
    plain["output_proj.weight"] = port.out.weight.detach().clone()
    got = tf.load_fcpe_checkpoint(save(plain, "plain.pt"))
    torch.testing.assert_close(got["out.weight"], port.out.weight.detach())


def test_missing_checkpoint_warns_and_takes_yin():
    """``estimator="fcpe"`` without a checkpoint file: one warning, then
    YIN, equal to the JAX package's same route."""
    x = audio(7, 44100, seconds=8192 / 44100)[:1, :, None]
    path = "/nonexistent/fcpe_missing.pt"
    tf._CACHE.pop(path, None)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = pitch_feature(torch.from_numpy(x), 16, 44100, estimator="fcpe",
                            fcpe_ckpt=path).numpy()
        again = pitch_feature(torch.from_numpy(x), 16, 44100,
                              estimator="fcpe", fcpe_ckpt=path).numpy()
    assert sum("falling back" in str(m.message) for m in w) == 1
    np.testing.assert_array_equal(got, again)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = np.asarray(jpitch_feature(jnp.asarray(x), 16, 44100,
                                         estimator="fcpe", fcpe_ckpt=path))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert tf.get_fcpe("") is None


def test_get_fcpe_defaults_to_the_card(ckpt):
    """``get_fcpe`` without a device asks for the card, as the port's
    other entry points do: on a machine without CUDA it raises, and the
    CPU is taken only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    _, path, _, _ = ckpt
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.get_fcpe(path)
    assert next(tf.get_fcpe(path, "cpu").parameters()).device.type == "cpu"


def test_pitch_feature_fcpe_route_matches_jax(ckpt):
    """``pitch_feature`` through the checkpoint: f0 at one frame per hop,
    per-utterance statistics."""
    _, path, _, _ = ckpt
    x = audio(8, 44100, seconds=16384 / 44100)[..., None]
    got = pitch_feature(torch.from_numpy(x), 32, 44100, estimator="fcpe",
                        fcpe_ckpt=path).numpy()
    want = np.asarray(jpitch_feature(jnp.asarray(x), 32, 44100,
                                     estimator="fcpe", fcpe_ckpt=path))
    assert got.shape == want.shape == (2, 32, 1)
    np.testing.assert_allclose(got, want, atol=1e-4)
