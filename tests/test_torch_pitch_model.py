"""The f0-conditioned fork (``v2_fork`` + ``pitch``) served by the port
against rave_tpu, on the CPU in float32, on the same converted parameters.

Tiny widths (``tests/test_torch_voice_conversion.py``'s), YIN f0 (the
preset's estimator without a checkpoint), chunk 2048.  ``encode``,
``forward`` and ``convert``; ``VoiceConverter`` over chunks with its f0
tail, its log-f0 reservoir and ``reset``; ``serialize``'s
``convert_pg.pt2`` (f0 in the program) against the live step and against
the JAX package's exported ``convert_pg``, its manifest against the JAX
one; ``StreamingRAVE`` of the pitch config.  Tolerance: audio and
latents atol 2e-5 (as the voice-conversion tests); the streamed
statistics are numpy float64 in both packages, over f0 values that agree
to float32 rounding (rtol 1e-5).
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.config import build_config as jbuild
from rave_tpu.export.streaming import StreamingRAVE as JStreamingRAVE
from rave_tpu.export.voice_conversion import VoiceConverter as JVoiceConverter
from rave_tpu.models.rave import RAVE as JRAVE
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import load_flax_params
from rave_tpu_torch.export.streaming import StreamingRAVE
from rave_tpu_torch.export.voice_conversion import VoiceConverter
from rave_tpu_torch.models.rave import RAVE, check_supported

TINY = ["capacity=4", "n_signal=8192", "ratios=[2,2]",
        "dilations=[[1,3],[1,3]]"]
STACK = ["v2_fork", "pitch"]
CHUNK = 2048
ATOL = 2e-5
TABLE = (0.3 * np.random.default_rng(9).standard_normal((3, 256))
         ).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def voices(n, T, seed=0):
    """``n`` synthetic speakers ``(n, T)``: harmonic tones at distinct f0
    plus noise, the f0 gliding so that frames differ."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 44100
    out = []
    for f0 in 90.0 * 1.6 ** np.arange(n):
        phase = 2 * np.pi * f0 * (t + 0.3 * t * t)
        x = sum(np.sin(h * phase + rng.uniform(0, 6)) / h for h in range(1, 6))
        out.append(0.2 * x + 0.02 * rng.standard_normal(T))
    return np.stack(out).astype(np.float32)


@pytest.fixture(scope="module")
def fork():
    jcfg = jbuild(STACK, TINY)
    assert jcfg.pitch_embedding_size == 1 and not jcfg.pitch_ckpt
    m = JRAVE(cfg=jcfg, train_mode=False)
    v = jax.jit(lambda r, a: m.init(r, a, method=JRAVE.warmup))(
        {"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1),
         "noise": jax.random.PRNGKey(2)}, jnp.zeros((1, 8192, 1)))
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    cfg = build_config(STACK, TINY)
    model = RAVE(cfg, device="cpu")
    load_flax_params(model, params, stats)
    return types.SimpleNamespace(
        jcfg=jcfg, m=m, cfg=cfg, model=model.eval(), params=params,
        model_state={"batch_stats": stats},
        variables={"params": params, "batch_stats": stats},
        state=model.state_dict())


def test_check_supported_accepts_the_pitch_preset():
    cfg = build_config(STACK)
    check_supported(cfg)
    assert cfg.decoder_latent_size() == cfg.latent_size + 256 + 1


def test_encode_forward_convert_match_jax(fork):
    x = voices(2, 8192, seed=1)[..., None]
    tgt = voices(2, 8192, seed=2)[::-1].copy()[..., None]
    xt = torch.from_numpy(x)
    with torch.no_grad():
        z = fork.model.encode(xt).numpy()
        y = fork.model(xt).numpy()
        yc = fork.model.convert(xt, torch.from_numpy(tgt)).numpy()
    # one compiled program each, the variables an argument (eagerly,
    # every operation of the model compiles on its own)
    apply = jax.jit(fork.m.apply, static_argnames="method")
    jz = np.asarray(apply(fork.variables, jnp.asarray(x),
                          method=JRAVE.encode))
    assert z.shape == jz.shape == (2, 128, fork.cfg.decoder_latent_size())
    # the pitch channel carries f0 (voiced frames), not zeros
    assert np.abs(z[..., -1]).max() > 0.1
    np.testing.assert_allclose(z, jz, atol=ATOL)
    jy = np.asarray(apply(fork.variables, jnp.asarray(x)))
    np.testing.assert_allclose(y, jy, atol=ATOL)
    jyc = np.asarray(apply(fork.variables, jnp.asarray(x), jnp.asarray(tgt),
                           method=JRAVE.convert))
    np.testing.assert_allclose(yc, jyc, atol=ATOL)


@pytest.fixture(scope="module")
def jax_vc(fork):
    return JVoiceConverter(fork.jcfg, fork.params, chunk_size=CHUNK,
                           speaker_table=TABLE, model_state=fork.model_state)


def test_voice_converter_pitch_chunks_match_jax(fork, jax_vc):
    """Four chunks (the f0 tail and the reservoir carried across them,
    one silent chunk among them), then ``reset`` and two chunks more."""
    ts = VoiceConverter(fork.cfg, fork.state, chunk_size=CHUNK,
                        speaker_table=TABLE, device="cpu")
    ts.set_speaker(1)
    jax_vc.set_speaker(1)
    jax_vc.reset()
    x = voices(1, 6 * CHUNK, seed=3)[0]
    x[2 * CHUNK:3 * CHUNK] = 0.0
    for i in range(4):
        c = x[i * CHUNK:(i + 1) * CHUNK]
        got, want = ts.forward(c), jax_vc.forward(c)
        np.testing.assert_allclose(got, want, atol=ATOL)
        np.testing.assert_array_equal(ts._f0_tail, jax_vc._f0_tail)
        assert len(ts._logf0) == len(jax_vc._logf0) > 0
        np.testing.assert_allclose(ts._logf0, jax_vc._logf0, rtol=1e-5)
    ts.reset()
    jax_vc.reset()
    assert not ts._logf0 and not ts._f0_tail.any()
    for i in range(4, 6):
        c = x[i * CHUNK:(i + 1) * CHUNK]
        np.testing.assert_allclose(ts.forward(c), jax_vc.forward(c),
                                   atol=ATOL)


def _manifest(path):
    """(in dims, out dims) of a manifest, one ``(bytes, dims)`` per line."""
    ins, outs = [], []
    for line in path.read_text().splitlines()[1:]:
        kind, _, nbytes, rank, *dims = line.split()
        assert int(rank) == len(dims)
        (ins if kind == "in" else outs).append(
            (int(nbytes), tuple(int(d) for d in dims)))
    return ins, outs


def test_serialize_convert_pg_matches_live_and_jax(fork, jax_vc, tmp_path):
    ts = VoiceConverter(fork.cfg, fork.state, chunk_size=CHUNK,
                        speaker_table=TABLE, device="cpu")
    out = ts.serialize(str(tmp_path / "port"))
    jout = tmp_path / "jax"
    jax_vc.serialize(str(jout))
    for f in ("convert.pt2", "convert_pg.pt2", "convert_pg_manifest.txt",
              "convert_pg_cache_init.bin", "convert_meta.json"):
        assert (out / f).exists(), f
    meta = json.loads((out / "convert_meta.json").read_text())
    assert meta == json.loads((jout / "convert_meta.json").read_text())
    assert meta["pitch_embedding_size"] == 1 and meta["pitch_hop"] == 1024

    # the manifests: caches, the f0 tail, the chunk and the embedding in;
    # y, the caches and the tail out; the same leaf count and bytes
    n = len(ts.stream.init_caches)
    tin, tout = _manifest(out / "convert_pg_manifest.txt")
    jin, jout_ = _manifest(jout / "convert_pg_manifest.txt")
    assert len(tin) == len(jin) == n + 3 and len(tout) == len(jout_) == n + 2
    assert sum(b for b, _ in tin[:n]) == sum(b for b, _ in jin[:n])
    assert tin[n:] == jin[n:] == [(4096, (1, 1024)), (4 * CHUNK, (1, CHUNK, 1)),
                                  (1024, (256,))]
    assert tout[0] == jout_[0] and tout[-1] == jout_[-1]
    assert ((out / "convert_pg_cache_init.bin").stat().st_size
            == (jout / "convert_pg_cache_init.bin").stat().st_size)
    # convert.pt2 of a pitch config takes the feature as a fourth input
    cin, _ = _manifest(out / "convert_manifest.txt")
    assert cin[n + 2] == (4 * CHUNK // 64, (1, CHUNK // 64, 1))

    from jax import export as jexport
    jprog = jexport.deserialize((jout / "convert_pg.stablehlo").read_bytes())
    prog = torch.export.load(out / "convert_pg.pt2").module()
    # the carry: the caches, then the f0 tail, in and out
    carry = [*(torch.zeros_like(c) for c in ts.stream.init_caches),
             torch.zeros(1, 1024)]
    live = [c.clone() for c in carry]
    jcarry = {"cache": jax.tree.map(jnp.zeros_like, jax_vc.init_cache),
              "f0_tail": jnp.zeros((1, 1024), jnp.float32)}
    emb = torch.from_numpy(TABLE[2])
    x = voices(1, 4 * CHUNK, seed=4)[0].reshape(1, -1, 1)
    with torch.no_grad():
        for i in range(0, 4 * CHUNK, CHUNK):
            xc = torch.from_numpy(x[:, i:i + CHUNK])
            y, carry = prog(carry, xc, emb)
            yl, live = ts._convert_pg(live, xc, emb)
            np.testing.assert_allclose(y.numpy(), yl.numpy(), atol=1e-6)
            jy, jcarry = jprog.call(jcarry, jnp.asarray(xc.numpy()),
                                    jnp.asarray(TABLE[2]))
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
            np.testing.assert_array_equal(carry[-1].numpy(),
                                          np.asarray(jcarry["f0_tail"]))
            np.testing.assert_array_equal(live[-1].numpy(),
                                          carry[-1].numpy())


def test_streaming_rave_pitch_matches_jax(fork):
    """The pitch config's ``StreamingRAVE``: each chunk's encode appends
    the chunk's own normalised f0, as the JAX streaming model does."""
    ts = StreamingRAVE(fork.cfg, fork.state, chunk_size=CHUNK, device="cpu")
    js = JStreamingRAVE(fork.jcfg, fork.params, chunk_size=CHUNK,
                        model_state=fork.model_state)
    x = voices(1, 4 * CHUNK, seed=5)[0]
    for i in range(0, 4 * CHUNK, CHUNK):
        c = x[i:i + CHUNK].reshape(1, -1, 1)
        np.testing.assert_allclose(ts.forward(c).numpy(),
                                   np.asarray(js.forward(c)), atol=ATOL)
