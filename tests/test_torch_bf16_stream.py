"""``compute_dtype=bfloat16`` served in chunks, exported and fused: the
port's bf16 stream against its bf16 offline forward and the JAX
package's, the dtype of every carried cache, ``process_file_scan``,
``serialize``'s manifest and initial caches against the ones the JAX
package's serializer writes for the same config, the streamed voice
converter, and kernel B1's plain bf16 twin against the JAX package's
``_reference_impl`` in bf16.  No JAX ``StreamingRAVE`` is built: the JAX
side's caches are the avals of its streaming model's ``init`` (which is
what ``StreamingRAVE`` carries), taken under ``jax.eval_shape`` and
written by ``write_pjrt_artifacts``, the JAX package's own writer.

Tolerances: the stream against the offline forwards, past twice the
total delay, relative L2 and median relative error per sample 2.5e-3
(the bf16 stream reads 5.7e-4 and 0 against the port's offline run,
1.5e-3 against the JAX package's, which skips the trunk's last bf16
rounding, ROADMAP C); a float32 stream of the same weights reads more
than 3.7e-3 against either, and fails it.  B1's
twin: equal to the JAX reference bit for bit but for a few elements
(accumulation order, 1e-3 of them), where the float32 twin on the same
bf16 operands, rounded once at the end, differs in more than 10 %.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.config import build_config as jbuild
from rave_tpu.export.streaming import write_pjrt_artifacts
from rave_tpu.models.rave import RAVE as JRAVE
from rave_tpu.ops.pallas import residual_unit as jru
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import load_flax_params
from rave_tpu_torch.export.streaming import StreamingRAVE, load_cache_init
from rave_tpu_torch.export.voice_conversion import VoiceConverter
from rave_tpu_torch.models.rave import RAVE
from rave_tpu_torch.ops.kernels import residual_unit as ru

TINY = ["capacity=4", "ratios=[2,2]", "dilations=[[1,3],[1,3]]",
        "n_signal=8192", "compute_dtype=bfloat16"]
CHUNK = 2048
BF16 = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_init(stack, over, x, streaming=False):
    cfg = jbuild(stack, over)
    m = JRAVE(cfg=cfg, streaming=streaming, train_mode=False)
    rngs = {"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1),
            "noise": jax.random.PRNGKey(2)}
    if streaming:
        return m, jax.eval_shape(lambda r, a: m.init(r, a), rngs,
                                 jnp.asarray(x))
    v = jax.jit(lambda r, a: m.init(r, a, method=JRAVE.warmup))(
        rngs, jnp.asarray(x))
    return m, {k: dict(jax.tree.map(np.asarray, val))
               for k, val in v.items()}


MEL = ["mel_n_fft=512", "mel_hop=16", "encoder_ratios=[2,2]",
       "encoder_dilations=[[1],[1]]", "decoder_gru_layers=0"]
STACKS = {"v2": (["v2"], TINY), "hybrid": (["hybrid"], TINY + MEL)}


def _converted(name):
    stack, over = STACKS[name]
    x = (np.random.default_rng(3).standard_normal((1, 8 * CHUNK, 1)) * 0.3
         ).astype(np.float32)
    m, v = _jax_init(stack, over, x)
    want = np.asarray(jax.jit(lambda v, a: m.apply(v, a))(v, jnp.asarray(x)))
    model = RAVE(build_config(stack, over), device="cpu", train_mode=False)
    load_flax_params(model, v["params"])
    return types.SimpleNamespace(x=x, v=v, jax_y=want, model=model)


@pytest.fixture(scope="module")
def v2():
    return _converted("v2")


@pytest.mark.parametrize("name", sorted(STACKS))
def test_stream_matches_offline_bf16(name, v2):
    """The stream's caches: bf16 in the encoder and the decoder, float32
    in the PQMF and the mel front end; ``process_file_scan`` equal to the
    chunks; past twice the delay (and the mel front end's clip head, as
    ``tests/test_torch_hybrid.py`` skips it) the offline forwards, which
    a float32 stream misses."""
    run = v2 if name == "v2" else _converted(name)
    cfg = run.model.cfg
    sr = StreamingRAVE(cfg, run.model.state_dict(), chunk_size=CHUNK,
                       device="cpu", seed=None)
    trunk = {id(m) for part in (sr.model.encoder, sr.model.decoder)
             for m in part.modules()}
    for mod, c in zip(sr.cache_modules, sr.init_caches):
        assert c.dtype == (BF16 if id(mod) in trunk else torch.float32)
    assert {c.dtype for c in sr.init_caches} == {BF16, torch.float32}
    streamed = sr.process_file(run.x[0, :, 0])
    np.testing.assert_array_equal(sr.process_file_scan(run.x[0, :, 0]),
                                  streamed)
    assert streamed.dtype == np.float32
    with torch.no_grad():
        offline = run.model(torch.from_numpy(run.x)).numpy()[0, :, 0]
    f32 = build_config(*STACKS[name][:1], [
        o for o in STACKS[name][1] if not o.startswith("compute_dtype")])
    control = StreamingRAVE(f32, run.model.state_dict(), chunk_size=CHUNK,
                            device="cpu", seed=None).process_file(
                                run.x[0, :, 0])
    d, n = sr.total_delay_samples(), len(streamed)
    m = 2 * d + (cfg.mel_n_fft + 4096 if cfg.use_mel_encoder else 0)
    assert 0 < d and m < n // 2
    for ref in (offline, run.jax_y[0, :, 0]):
        a = ref[m - d:n - d]
        err = lambda b: (np.linalg.norm(a - b[m:]) / np.linalg.norm(a),  # noqa: E731
                         np.median(np.abs(a - b[m:])) / np.abs(a).mean())
        assert max(err(streamed)) <= 2.5e-3, err(streamed)
        assert err(control)[0] > 2.5e-3, err(control)


def _jax_manifest(stack, over, out):
    """The JAX package's ``io_manifest.txt`` and ``cache_init.bin`` of the
    streaming ``forward`` of this config, from the avals of its
    streaming model's ``init`` (its cache tree) and of one step."""
    x = np.zeros((1, CHUNK, 1), np.float32)
    m, v = _jax_init(stack, over, x, streaming=True)
    cache = v["cache"]

    def step(params, cache, a):
        y, upd = m.apply({"params": params, "cache": cache}, a,
                         rngs={"latent": jax.random.PRNGKey(4),
                               "noise": jax.random.PRNGKey(5)},
                         mutable=["cache"])
        return y, upd["cache"], {}

    out_avals = jax.eval_shape(step, v["params"], cache, jnp.asarray(x))
    exp = types.SimpleNamespace(in_avals=(cache, {}, jax.ShapeDtypeStruct(
        x.shape, x.dtype)), out_avals=out_avals,
        mlir_module_serialized=b"")
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), cache)
    write_pjrt_artifacts(out, exp, (zeros, {}), chunk=CHUNK,
                         sampling_rate=44100, batch=1)


def _lines(path):
    """``(dtype, bytes, dims)`` of each ``in`` and ``out`` line."""
    ins, outs = [], []
    for line in path.read_text().splitlines()[1:]:
        kind, dtype, nbytes, rank, *dims = line.split()
        assert int(rank) == len(dims)
        (ins if kind == "in" else outs).append(
            (dtype, int(nbytes), tuple(int(d) for d in dims)))
    return ins, outs


def _channels_last(line):
    dtype, nbytes, dims = line
    return dtype, nbytes, (dims[0], dims[2], dims[1]) if len(dims) == 3 \
        else dims


def test_serialize_bf16_matches_jax_manifest(v2, tmp_path):
    """The port's bf16 manifest lists the JAX package's caches (dtype,
    bytes, dims; the port's ``(B, C, T)`` read as ``(B, T, C)``, ROADMAP
    C), the chunk and ``y`` float32; ``cache_init.bin`` holds each cache
    raw in its dtype, ``cache_init.npz`` reads back to the live caches;
    the exported step runs from them as the live one does."""
    sr = StreamingRAVE(v2.model.cfg, v2.model.state_dict(), chunk_size=CHUNK,
                       device="cpu")
    out = sr.serialize(str(tmp_path / "port"))
    _jax_manifest(["v2"], TINY, tmp_path)
    tin, tout = _lines(out / "io_manifest.txt")
    jin, jout = _lines(tmp_path / "io_manifest.txt")
    n = len(tout) - 1
    assert (len(tin), len(tout)) == (len(jin), len(jout))
    assert tin[n:] == jin[n:] == [("float32", 4 * CHUNK, (1, CHUNK, 1))]
    assert tout[0] == jout[0] and tin[:n] == tout[1:]
    assert sorted(map(_channels_last, tin[:n])) == sorted(jin[:n])
    assert {d for d, _, _ in tin[:n]} == {"bfloat16", "float32"}
    assert ((out / "cache_init.bin").stat().st_size
            == (tmp_path / "cache_init.bin").stat().st_size
            == sum(b for _, b, _ in tin[:n]))
    caches = load_cache_init(out / "cache_init.npz")
    assert [(c.dtype, c.shape) for c in caches] == [
        (c.dtype, c.shape) for c in sr.init_caches]
    assert all(torch.equal(a, b) for a, b in zip(caches, sr.init_caches))
    raw = (out / "cache_init.bin").read_bytes()
    got, off = [], 0
    for c in sr.init_caches:
        nb = c.element_size() * c.numel()
        t = torch.frombuffer(bytearray(raw[off:off + nb]),
                             dtype=c.dtype).reshape(c.shape)
        got.append(t)
        off += nb
    assert all(torch.equal(a, b) for a, b in zip(got, sr.init_caches))
    prog = torch.export.load(str(out / "forward.pt2")).module()
    x = torch.from_numpy(v2.x[:, :CHUNK])
    with torch.no_grad():
        y, new = prog(caches, x)
    sr.reset()
    np.testing.assert_array_equal(y.numpy(), sr.forward(x).numpy())
    assert [c.dtype for c in new] == [c.dtype for c in sr.init_caches]


def test_voice_converter_streams_bf16(tmp_path):
    """``v2_fork``'s streamed conversion and learn-target step in bf16:
    finite, the trunk's caches bf16, the speaker encoder float32; its
    ``convert.pt2`` equals the live step on the same chunk."""
    torch.manual_seed(0)
    cfg = build_config(["v2_fork"], TINY)
    state = RAVE(cfg, device="cpu").state_dict()
    vc = VoiceConverter(cfg, state, chunk_size=CHUNK, device="cpu")
    x = (np.random.default_rng(5).standard_normal(4 * CHUNK) * 0.3
         ).astype(np.float32)
    vc.set_learn_target(True)
    vc.forward(x[:CHUNK])
    vc.set_learn_target(False)
    emb = vc.current_embedding()
    assert emb.dtype == np.float32 and np.isfinite(emb).all()
    ys = [vc.forward(x[i:i + CHUNK]) for i in range(CHUNK, 4 * CHUNK, CHUNK)]
    assert all(y.dtype == np.float32 and np.isfinite(y).all() for y in ys)
    assert BF16 in {c.dtype for c in vc.stream.caches}
    assert next(vc.model.speaker_encoder.parameters()).dtype == torch.float32
    out = vc.serialize(str(tmp_path))
    assert "bfloat16" in (out / "convert_manifest.txt").read_text()
    prog = torch.export.load(str(out / "convert.pt2")).module()
    caches = [torch.zeros_like(c) for c in vc.stream.init_caches]
    chunk = torch.from_numpy(x[:CHUNK]).reshape(1, -1, 1)
    e = torch.from_numpy(emb)
    with torch.no_grad():
        y, _ = prog(caches, chunk, e)
        want, _ = vc._convert(caches, chunk, e)
    np.testing.assert_array_equal(y.numpy(), want.numpy())


@pytest.mark.parametrize("C,k,d,T", [(128, 3, 1, 512), (256, 3, 9, 301),
                                     (128, 1, 1, 64)])
def test_residual_unit_twin_rounds_as_jax_bf16(C, k, d, T):
    """The plain twin of B1 in bf16 (the CPU path and the card's
    comparison) against the JAX package's ``_reference_impl`` in bf16, and
    the float32 composition of the same operands, rounded once, as the
    negative control; mixed dtypes raise."""
    r = np.random.default_rng(C + k + d)
    x = r.standard_normal((2, T, C)).astype(np.float32)
    w1 = (r.standard_normal((k, C, C)) / np.sqrt(k * C)).astype(np.float32)
    b1 = (r.standard_normal(C) * 0.1).astype(np.float32)
    w2 = (r.standard_normal((C, C)) / np.sqrt(C)).astype(np.float32)
    b2 = (r.standard_normal(C) * 0.1).astype(np.float32)
    pl = (k - 1) * d // 2
    pr = (k - 1) * d - pl
    bf = jnp.bfloat16
    # bf16 out of the program: a cast to float32 inside it would let XLA
    # skip the last bf16 rounding
    want = np.asarray(jax.jit(lambda *a: jru._reference_impl(
        *[t.astype(bf) for t in a], d, pl, pr))(
            x, w1, b1, w2, b2)).astype(np.float32).transpose(0, 2, 1)
    args = [torch.from_numpy(a).to(BF16) for a in (
        x.transpose(0, 2, 1).copy(), w1.transpose(2, 1, 0).copy(), b1,
        w2.T.copy(), b2)]
    got = ru.residual_unit(*args, d, pl, pr)
    assert got.dtype == BF16
    mismatch = float((got.float().numpy() != want).mean())
    assert mismatch <= 1e-3
    once = ru.residual_unit_reference(*[a.float() for a in args], d, pl,
                                      pr).to(BF16).float().numpy()
    assert float((once != want).mean()) > 0.1
    with pytest.raises(TypeError, match="bfloat16"):
        ru._check(args[0], args[1].float(), *args[2:], d, pl, pr)
