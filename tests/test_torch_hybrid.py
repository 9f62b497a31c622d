"""The port's hybrid preset against rave_tpu's: the mel front end and the
GRU layer, offline and streamed, the converter's GRU layout, the tiny
hybrid model offline, its delay algebra, and the port's stream against
its offline run.

The JAX references stream through the JAX modules' own ``apply`` on
their ``cache`` collection (no JAX ``StreamingRAVE``).  Tolerances: the
mel front end and the GRU atol 1e-5 (float32 FFTs and matmuls in another
order), the tiny model 1e-5 (as ``tests/test_torch_model.py``'s 2e-5
for v2, tighter), the delays exactly, the stream the median relative
error < 0.02 of ``tests/test_streaming.py``'s hybrid case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.config import build_config as jbuild
from rave_tpu.models.blocks import GRULayer as JGRULayer
from rave_tpu.models.blocks import MelFrontEnd as JMelFrontEnd
from rave_tpu.models.rave import RAVE as JRAVE
from rave_tpu.models.rave import band_frame_delay as jband_frame_delay
from rave_tpu.ops.conv import StreamSetup as JStreamSetup
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import _Loader, load_flax_params
from rave_tpu_torch.export.streaming import StreamingRAVE
from rave_tpu_torch.models.blocks import GRULayer, MelFrontEnd
from rave_tpu_torch.models.rave import RAVE, band_frame_delay, stream_setup
from rave_tpu_torch.ops.conv import StreamSetup, StreamStep, stream_caches

# tests/test_streaming.py's tiny hybrid: mel_hop * prod(encoder_ratios)
# equals n_band * prod(ratios)
HYBRID_TINY = ["capacity=4", "n_signal=16384", "batch_size=1",
               "ratios=[2,2]", "dilations=[[1,3],[1,3]]",
               "mel_n_fft=512", "mel_hop=16", "encoder_ratios=[2,2]",
               "encoder_dilations=[[1],[1]]"]
MEL = dict(n_fft=512, hop=16, n_mels=32, sample_rate=16000)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _signal(shape, seed=0, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _jax_stream(module, variables, chunks):
    """``module`` applied chunk by chunk, its ``cache`` collection carried
    (zeros from ``init``)."""
    cache = jax.tree.map(jnp.zeros_like, variables.get("cache", {}))
    params = {k: v for k, v in variables.items() if k != "cache"}
    step = jax.jit(lambda c, a: module.apply({**params, "cache": c}, a,
                                             mutable=["cache"]))
    outs = []
    for c in chunks:
        y, upd = step(cache, jnp.asarray(c))
        cache = upd["cache"]
        outs.append(np.asarray(y))
    return outs


def _port_stream(module, chunks):
    """The port's ``module`` over ``chunks`` through a pure
    :class:`StreamStep`, from the initial caches."""
    mods, caches = stream_caches(module, module, torch.from_numpy(chunks[0]))
    step = StreamStep(module, module, mods)
    outs = []
    with torch.no_grad():
        for c in chunks:
            y, caches = step(caches, torch.from_numpy(c))
            outs.append(y.numpy())
    return outs


def test_mel_front_end_offline_and_streamed_match():
    """Offline and in 1024-sample chunks (its carried sample context)
    against the JAX module; the port's stream equals its offline frames
    shifted by ``mel_front_delay`` past the clip head."""
    x = _signal((2, 8192))
    jm = JMelFrontEnd(**MEL)
    want = np.asarray(jm.apply(jm.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x)), jnp.asarray(x)))
    off = MelFrontEnd(**MEL)
    with torch.no_grad():
        got = off(torch.from_numpy(x)).numpy()
    assert got.shape == (2, MEL["n_mels"], 8192 // MEL["hop"])
    np.testing.assert_allclose(got, want.transpose(0, 2, 1), atol=1e-5)

    chunks = [x[:, i:i + 1024] for i in range(0, 8192, 1024)]
    js = JMelFrontEnd(**MEL, ss=JStreamSetup(streaming=True))
    want_s = np.concatenate(_jax_stream(js, js.init(
        jax.random.PRNGKey(0), jnp.asarray(chunks[0])), chunks), axis=1)
    st = MelFrontEnd(**MEL, ss=StreamSetup(streaming=True))
    got_s = np.concatenate(_port_stream(st, chunks), axis=2)
    np.testing.assert_allclose(got_s, want_s.transpose(0, 2, 1), atol=1e-5)
    D, head = st.out_delay, -(-(MEL["n_fft"] // 2) // MEL["hop"])
    np.testing.assert_allclose(got[:, :, head:got.shape[2] - D],
                               got_s[:, :, head + D:], atol=1e-5)


def _jax_gru(layers, x, streaming=False):
    m = JGRULayer(dim=x.shape[-1], num_layers=layers,
                  ss=JStreamSetup(streaming=streaming))
    return m, m.init(jax.random.PRNGKey(layers), jnp.asarray(x))


@pytest.mark.parametrize("layers", [1, 2])
def test_gru_layer_offline_and_streamed_match(layers):
    """Offline (``torch.gru``) and in chunks of 5 frames, the hidden state
    carried (the hand-stepped cell), against flax's cells."""
    x = _signal((3, 20, 16), seed=layers, scale=1.0)
    m, v = _jax_gru(layers, x)
    params = jax.tree.map(np.asarray, v["params"])
    want = np.asarray(m.apply(v, jnp.asarray(x)))
    gru = GRULayer(16, layers)
    load_flax_params_gru(gru, params)
    xt = np.ascontiguousarray(x.transpose(0, 2, 1))
    with torch.no_grad():
        got = gru(torch.from_numpy(xt)).numpy()
    np.testing.assert_allclose(got, want.transpose(0, 2, 1), atol=1e-5)

    chunks = [x[:, i:i + 5] for i in range(0, 20, 5)]
    ms, vs = _jax_gru(layers, chunks[0], streaming=True)
    want_s = np.concatenate(_jax_stream(ms, {**vs, "params": v["params"]},
                                        chunks), axis=1)
    st = GRULayer(16, layers, StreamSetup(streaming=True))
    st.load_state_dict(gru.state_dict())
    got_s = np.concatenate(_port_stream(
        st, [np.ascontiguousarray(c.transpose(0, 2, 1)) for c in chunks]),
        axis=2)
    np.testing.assert_allclose(got_s, want_s.transpose(0, 2, 1), atol=1e-5)
    # a stream from zero state is the offline run
    np.testing.assert_allclose(got_s, got, atol=1e-5)


def load_flax_params_gru(gru, params):
    """A lone GRULayer filled through the converter, as the first
    ``GRULayer_0`` of an encoder-like parent."""
    parent = torch.nn.Module()
    parent.gru = gru
    ld = _Loader()
    ld.named(parent, {"GRULayer_0": params}, "")
    ld.check({"GRULayer_0": params}, list(parent.named_parameters()))


def test_gru_hand_cell_equals_torch_gru():
    """The stream's hand-stepped cell and ``torch.gru`` (offline and
    training) on the same parameters, with non-zero hidden biases, and
    their gradients."""
    torch.manual_seed(0)
    gru = GRULayer(12, 2)
    with torch.no_grad():
        for name, p in gru.named_parameters():
            if "bias" in name:
                p.normal_()
    x = torch.randn(2, 12, 9)
    y = gru(x)
    seq = x.transpose(1, 2)
    for layer in range(2):
        seq, _ = gru.cell(seq, torch.zeros(2, 12), layer)
    y_cell = seq.transpose(1, 2)
    torch.testing.assert_close(y_cell, y, atol=1e-6, rtol=1e-5)
    g = torch.autograd.grad(y.square().sum(), list(gru.parameters()))
    g_cell = torch.autograd.grad(y_cell.square().sum(),
                                 list(gru.parameters()))
    for a, b in zip(g, g_cell):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_converter_gru_layout():
    """flax's ``cell{l}/{ir,iz,in,hr,hz,hn}`` land in the gate stacks in
    ``[r|z|n]`` order, transposed; a stray or a missing leaf raises."""
    x = _signal((1, 4, 6))
    _, v = _jax_gru(2, x)
    params = jax.tree.map(np.asarray, v["params"])
    gru = GRULayer(6, 2)
    load_flax_params_gru(gru, params)
    cell = params["cell1"]
    np.testing.assert_array_equal(gru.weight_ih1.detach()[6:12].numpy(),
                                  cell["iz"]["kernel"].T)
    np.testing.assert_array_equal(gru.weight_hh1.detach()[12:].numpy(),
                                  cell["hn"]["kernel"].T)
    np.testing.assert_array_equal(gru.bias_ih1.detach()[12:].numpy(),
                                  cell["in"]["bias"])
    np.testing.assert_array_equal(gru.bias_hn1.detach().numpy(),
                                  cell["hn"]["bias"])
    stray = jax.tree.map(lambda a: a, params)
    stray["cell0"]["hr"]["bias"] = np.zeros(6, np.float32)
    with pytest.raises(ValueError, match="unused"):
        load_flax_params_gru(GRULayer(6, 2), stray)
    missing = jax.tree.map(lambda a: a, params)
    del missing["cell1"]["hn"]["bias"]
    with pytest.raises(KeyError, match="cell1/hn/bias"):
        load_flax_params_gru(GRULayer(6, 2), missing)


def _jax_hybrid(over, T=4096, B=2):
    cfg = jbuild(["hybrid"], HYBRID_TINY + over)
    m = JRAVE(cfg=cfg, train_mode=False)
    x = _signal((B, T, 1))
    v = jax.jit(m.init)({"params": jax.random.PRNGKey(0),
                         "latent": jax.random.PRNGKey(1),
                         "noise": jax.random.PRNGKey(2)}, jnp.asarray(x))
    return m, jax.tree.map(np.asarray, v["params"]), x


@pytest.fixture(scope="module", params=[[], ["encoder_gru_layers=1"]],
                ids=["hybrid", "encoder_gru"])
def tiny(request):
    over = request.param
    m, params, x = _jax_hybrid(over)
    model = RAVE(build_config(["hybrid"], HYBRID_TINY + over), device="cpu")
    load_flax_params(model, params)
    return over, m, params, x, model


def test_tiny_hybrid_offline_matches(tiny):
    """encode (the variational mean of the mel encoder), decode (the GRU
    on the latent, then the v2 decoder) and forward, within 1e-5."""
    over, m, params, x, model = tiny
    v = {"params": params}
    z_j = np.asarray(jax.jit(lambda v, a: m.apply(
        v, a, method=JRAVE.encode))(v, jnp.asarray(x)))
    y_j = np.asarray(jax.jit(lambda v, a: m.apply(
        v, a, method=JRAVE.decode))(v, jnp.asarray(z_j)))
    f_j = np.asarray(jax.jit(lambda v, a: m.apply(v, a))(v, jnp.asarray(x)))
    with torch.no_grad():
        z_t = model.encode(torch.from_numpy(x)).numpy()
        y_t = model.decode(torch.from_numpy(z_j)).numpy()
        f_t = model(torch.from_numpy(x)).numpy()
    assert z_t.shape == z_j.shape and f_t.shape == x.shape
    for got, want in ((z_t, z_j), (y_t, y_j), (f_t, f_j)):
        np.testing.assert_allclose(got, want, atol=1e-5)
    gru = model.encoder.gru
    assert (gru is not None) == bool(over)
    assert model.decoder.gru.num_layers == 2


@pytest.mark.parametrize("stack", [["hybrid"], ["hybrid", "causal"]])
def test_hybrid_delays_match(stack):
    """``band_frame_delay`` (the decoder's ratios scale the mel encoder's
    latent delay) and ``total_delay_samples`` equal the JAX package's."""
    for over in ([], HYBRID_TINY):
        jcfg, cfg = jbuild(stack, over), build_config(stack, over)
        jss = JStreamSetup(mode="causal" if jcfg.causal else "centered",
                           streaming=True)
        want = jband_frame_delay(jcfg, jss)
        assert band_frame_delay(cfg, stream_setup(cfg, True)) == want
        from rave_tpu.ops.pqmf import _pqmf_kernels
        pq_s = _pqmf_kernels(jcfg.pqmf_attenuation, jcfg.n_band)[3]
        chunk = 2 * cfg.total_ratio()
        sr = StreamingRAVE(cfg, RAVE(cfg, device="cpu").state_dict(),
                           chunk_size=chunk, device="cpu")
        assert sr.total_delay_samples() == (want + pq_s) * jcfg.n_band


def test_port_stream_matches_its_offline_run(tiny):
    """The port's hybrid stream (mel context, GRU states and conv caches
    carried; 2048-sample chunks) against its offline forward shifted by
    ``total_delay_samples``, with ``tests/test_streaming.py``'s margin
    for the clip head and the GRU state's decay; the CPU file path
    equal to the chunked one."""
    over, _, params, _, model = tiny
    cfg = build_config(["hybrid"], HYBRID_TINY + over)
    x = _signal((1, 16384, 1), seed=7)
    with torch.no_grad():
        y_off = model(torch.from_numpy(x))[0, :, 0].numpy()
    sr = StreamingRAVE(cfg, model.state_dict(), chunk_size=2048,
                       device="cpu")
    y_str = sr.process_file(x[0, :, 0])
    np.testing.assert_array_equal(sr.process_file_scan(x[0, :, 0]), y_str)
    d = sr.total_delay_samples()
    n = len(y_off)
    assert 0 < d < n // 2
    m = 2 * d + cfg.mel_n_fft + 4096
    a, b = y_off[m - d: n - d - 256], y_str[m: n - 256]
    rel = np.median(np.abs(a - b)) / (np.abs(a).mean() + 1e-9)
    assert rel < 0.02, rel
    shapes = [tuple(c.shape) for c in sr.init_caches]
    assert (1, 15 * 16 + 256) in shapes  # the mel context, D = 15
    assert (1, 2, 64) in shapes          # the decoder's two GRU states
