"""Voice-conversion serving of the tiny ``v2_fork``: the port against
rave_tpu on the same converted parameters, on the CPU in float32.

Two speaker encoders: the BatchNorm layout (random stored statistics)
and the cohort norm with the AAM head and the latent adversary; the
norms' scale and bias are drawn at random in both, so that the affine
path is exercised.  Tolerances: audio and latents atol 2e-5 (as
``tests/test_torch_streaming.py``); speaker embeddings atol 1e-5 times
their largest magnitude; head logits atol 1e-4 times theirs (float32
through ~15 convs, attentive pooling, two norms and a normalised
product).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.config import build_config as jbuild
from rave_tpu.data.audio_io import save_wav
from rave_tpu.export.streaming import StreamingRAVE as JStreamingRAVE
from rave_tpu.export.voice_conversion import VoiceConverter as JVoiceConverter
from rave_tpu.models.rave import RAVE as JRAVE
from rave_tpu.models.speaker import AAMSpeakerHead as JAAMSpeakerHead
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import load_flax_params
from rave_tpu_torch.export.streaming import StreamingRAVE
from rave_tpu_torch.export.voice_conversion import VoiceConverter
from rave_tpu_torch.models.rave import RAVE
from rave_tpu_torch.models.speaker import AAMSpeakerHead, CohortNorm

TINY = ["capacity=4", "n_signal=8192", "ratios=[2,2]",
        "dilations=[[1,3],[1,3]]"]
HEADS = ["speaker_classes=4", "latent_adversary_weight=0.1"]
OVERRIDES = {"batch": TINY, "cohort": TINY + ["speaker_norm=cohort"] + HEADS}
CHUNK = 2048
ATOL = 2e-5


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
    plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 44100
    out = []
    for f0 in 90.0 * 1.6 ** np.arange(n):
        x = sum(np.sin(2 * np.pi * h * f0 * t + rng.uniform(0, 6)) / h
                for h in range(1, 6))
        out.append(0.2 * x + 0.02 * rng.standard_normal(T))
    return np.stack(out).astype(np.float32)


def _randomise(params, stats, rng):
    """Random scale and bias for both norms and, for the BatchNorm
    layout, random stored statistics (positive variances)."""
    spk = params["speaker_encoder"]
    for name in ("attn_bn", "bn5"):
        n = spk[name]["scale"].shape
        spk[name]["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        spk[name]["bias"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
        if stats is not None:
            s = stats["speaker_encoder"][name]
            s["mean"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
            s["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)


def _build(norm):
    over = OVERRIDES[norm]
    jcfg = jbuild(["v2_fork"], over)
    m = JRAVE(cfg=jcfg, train_mode=False)
    v = jax.jit(lambda r, a: m.init(r, a, method=JRAVE.warmup))(
        {"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1),
         "noise": jax.random.PRNGKey(2)}, jnp.zeros((1, 8192, 1)))
    params = jax.tree.map(np.asarray, v["params"])
    stats = (jax.tree.map(np.asarray, v["batch_stats"])
             if "batch_stats" in v else None)
    _randomise(params, stats, np.random.default_rng(5))
    cfg = build_config(["v2_fork"], over)
    model = RAVE(cfg, device="cpu")
    load_flax_params(model, params, stats)
    return types.SimpleNamespace(
        jcfg=jcfg, m=m, params=params,
        variables={"params": params,
                   **({"batch_stats": stats} if stats else {})},
        model_state={"batch_stats": stats} if stats else None,
        cfg=cfg, model=model.eval(), state=model.state_dict())


@pytest.fixture(scope="module")
def fork():
    cache = {}

    def get(norm):
        if norm not in cache:
            cache[norm] = _build(norm)
        return cache[norm]

    return get


@pytest.fixture(scope="module")
def jax_vc(fork):
    """rave_tpu's VoiceConverter of each fork (its init compiles the
    streaming model), built once."""
    cache = {}

    def get(norm):
        if norm not in cache:
            f = fork(norm)
            cache[norm] = JVoiceConverter(f.jcfg, f.params, chunk_size=CHUNK,
                                          speaker_table=TABLE,
                                          model_state=f.model_state)
        return cache[norm]

    return get


TABLE = (0.3 * np.random.default_rng(9).standard_normal((3, 256))
         ).astype(np.float32)


def test_voice_converter_chunks_equal_jax(fork, jax_vc):
    """Convert chunks, learn-target chunks and convert chunks after them
    (the streamed PQMF's cache advances while learning), ``set_speaker``
    clearing the learned target, and ``reset``."""
    f = fork("batch")
    js = jax_vc("batch")
    ts = VoiceConverter(f.cfg, f.state, chunk_size=CHUNK, speaker_table=TABLE,
                        device="cpu")
    x = voices(1, 9 * CHUNK, seed=1)[0]
    chunks = [x[i * CHUNK:(i + 1) * CHUNK] for i in range(9)]

    def same(i):
        got, want = ts.forward(chunks[i]), js.forward(chunks[i])
        assert got.shape == want.shape == (CHUNK,)
        np.testing.assert_allclose(got, want, atol=ATOL)
        return got

    for vc in (js, ts):
        vc.set_speaker(1)
    same(0), same(1)
    for vc in (js, ts):
        vc.set_learn_target(True)
    for i in (2, 3, 4):
        assert not ts.forward(chunks[i]).any()
        assert not js.forward(chunks[i]).any()
    e_j, e_t = js.current_embedding(), ts.current_embedding()
    assert e_t.shape == (256,) and np.isfinite(e_t).all()
    np.testing.assert_allclose(e_t, e_j, atol=1e-5 * np.abs(e_j).max())
    assert not np.allclose(e_t, TABLE[1])
    for vc in (js, ts):
        vc.set_learn_target(False)
    assert np.abs(same(5)).max() > 0
    same(6)
    for vc in (js, ts):
        vc.set_speaker(2)
    np.testing.assert_array_equal(ts.current_embedding(), TABLE[2])
    same(7)
    for vc in (js, ts):
        vc.reset()
    same(0)
    # an index outside the table clips, as the JAX package's does
    ts.set_speaker(10)
    assert ts.speaker == len(TABLE) - 1


@pytest.mark.parametrize("norm", ["batch", "cohort"])
@pytest.mark.parametrize("with_cohort", [False, True],
                         ids=["alone", "cohort"])
def test_embed_speaker_audio_matches(fork, jax_vc, norm, with_cohort):
    f = fork(norm)
    ts = VoiceConverter(f.cfg, f.state, chunk_size=CHUNK, device="cpu")
    x = voices(2, 70000, seed=2)
    cohort = x[1] if with_cohort else None
    want = jax_vc(norm).embed_speaker_audio(x[0], cohort=cohort)
    got = ts.embed_speaker_audio(x[0], cohort=cohort)
    assert got.shape == want.shape == (256,)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_build_speaker_table_from_wavs(fork, tmp_path):
    f = fork("cohort")
    paths = []
    for i, clip in enumerate(voices(3, 40000, seed=3)):
        paths.append(str(tmp_path / f"speaker{i}.wav"))
        save_wav(paths[-1], clip, 44100)
    want = JVoiceConverter.build_speaker_table(f.jcfg, f.params, paths)
    got = VoiceConverter.build_speaker_table(f.cfg, f.state, paths,
                                             device="cpu")
    assert got.shape == want.shape == (3, 256)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    # the cohort keeps the speakers apart
    assert np.abs(got[0] - got[1]).max() > 1e-3 * np.abs(got).max()
    save_wav(str(tmp_path / "slow.wav"), voices(1, 40000)[0], 22050)
    with pytest.raises(ValueError, match="model sr"):
        VoiceConverter.build_speaker_table(
            f.cfg, f.state, [str(tmp_path / "slow.wav")], device="cpu")


@pytest.mark.parametrize("norm", ["batch", "cohort"])
def test_offline_convert_matches(fork, norm):
    f = fork(norm)
    v = voices(4, 8192, seed=4)[:, :, None]
    x, target = v[:2], v[2:]
    want = np.asarray(jax.jit(lambda v, a, b: f.m.apply(
        v, a, b, method=JRAVE.convert))(f.variables, x, target))
    with torch.no_grad():
        got = f.model.convert(torch.from_numpy(x),
                              torch.from_numpy(target)).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_fork_streaming_matches(fork):
    f = fork("batch")
    js = JStreamingRAVE(f.jcfg, f.params, chunk_size=CHUNK,
                        model_state=f.model_state)
    ts = StreamingRAVE(f.cfg, f.state, chunk_size=CHUNK, device="cpu")
    assert ts.total_delay_samples() == js.total_delay_samples()
    x = voices(1, 6 * CHUNK, seed=6)[:, :, None]
    for i in range(0, 3 * CHUNK, CHUNK):
        xc = x[:, i:i + CHUNK]
        np.testing.assert_allclose(ts.forward(xc).numpy(), js.forward(xc),
                                   atol=ATOL)
    js.reset()
    ts.reset()
    for i in range(0, 3 * CHUNK, CHUNK):
        xc = x[:, i:i + CHUNK]
        z_j, z_t = js.encode(xc), ts.encode(xc).numpy()
        assert z_t.shape == z_j.shape == (1, CHUNK // f.cfg.total_ratio(),
                                          64 + 256)
        np.testing.assert_allclose(z_t, z_j, atol=ATOL)
        np.testing.assert_allclose(ts.decode(z_j).numpy(), js.decode(z_j),
                                   atol=ATOL)


def test_heads_match(fork):
    """The AAM head with and without labels (and standardised), and the
    latent adversary's logits."""
    f = fork("cohort")
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((5, 256)).astype(np.float32)
    labels = np.array([0, 1, 2, 3, 1])
    z = rng.standard_normal((5, 37, 64)).astype(np.float32)
    m, v = f.m, f.variables
    want = [np.asarray(m.apply(v, emb, method=JRAVE.classify_speaker)),
            np.asarray(m.apply(v, emb, labels, method=JRAVE.classify_speaker)),
            np.asarray(m.apply(v, z, method=JRAVE.adversary_logits))]
    head = JAAMSpeakerHead(classes=4, standardize=True)
    hv = {"params": f.params["speaker_classifier"]}
    want.append(np.asarray(head.apply(hv, emb, labels)))
    port_head = AAMSpeakerHead(256, 4, standardize=True)
    port_head.load_state_dict(f.model.speaker_classifier.state_dict())
    with torch.no_grad():
        e, lab = torch.from_numpy(emb), torch.from_numpy(labels)
        got = [f.model.classify_speaker(e).numpy(),
               f.model.classify_speaker(e, lab).numpy(),
               f.model.adversary_logits(
                   torch.from_numpy(z.transpose(0, 2, 1).copy())).numpy(),
               port_head(e, lab).numpy()]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max())
    # the margin lowers exactly the target class's logit
    diff = got[0] - got[1]
    assert (diff[np.arange(5), labels] > 0).all()
    diff[np.arange(5), labels] = 0
    assert np.abs(diff).max() < 1e-5


def test_converter_fills_cohort_aam_adversary_fork(fork):
    """``load_flax_params`` uses every leaf of a cohort-norm fork with
    the AAM head and the adversary (no batch_stats); ``speaker_norm``
    "auto" with a trained encoder is the cohort norm, as in rave_tpu."""
    f = fork("cohort")
    assert isinstance(f.model.speaker_encoder.bn5, CohortNorm)
    stray = jax.tree.map(lambda a: a, f.params)
    stray["latent_adversary"]["layers_3"]["stray"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="unused"):
        load_flax_params(RAVE(f.cfg, device="cpu"), stray)
    missing = jax.tree.map(lambda a: a, f.params)
    del missing["speaker_classifier"]
    with pytest.raises(KeyError):
        load_flax_params(RAVE(f.cfg, device="cpu"), missing)
    auto = RAVE(build_config(["v2_fork"], TINY + ["train_speaker_encoder=true"]),
                device="cpu")
    assert isinstance(auto.speaker_encoder.attn_bn, CohortNorm)
    assert auto.latent_adversary is None and auto.speaker_classifier is None


@pytest.mark.parametrize("fault", ["short_cohort", "convert_seg_len"])
def test_enrollment_faults_reproduced(fork, jax_vc, fault):
    """The JAX package's enrollment faults (ROADMAP C), reproduced in the
    port, not repaired: both packages fail alike."""
    f = fork("batch")
    if fault == "short_cohort":
        # a segment of 32768 samples, a cohort of 20000: the cohort's one
        # short segment does not stack with the target's
        ts = VoiceConverter(f.cfg, f.state, chunk_size=CHUNK, device="cpu")
        x, c = voices(2, 131072, seed=8)
        with pytest.raises(ValueError):
            jax_vc("batch").embed_speaker_audio(x, cohort=c[:20000])
        with pytest.raises(ValueError):
            ts.embed_speaker_audio(x, cohort=c[:20000])
        return
    # min(T, T') = 4112 = 16 * 257: two segments of 2056 samples, not a
    # multiple of the 16 bands, so the cohort's PQMF reshape fails
    v = voices(2, 8192, seed=8)[:, :, None]
    x, target = v[:1], v[1:, :4112]
    with pytest.raises(TypeError):
        f.m.apply(f.variables, x, target, method=JRAVE.convert)
    with pytest.raises(RuntimeError):
        f.model.convert(torch.from_numpy(x), torch.from_numpy(target))


def test_serving_options_and_devices(fork):
    f = fork("batch")
    with pytest.raises(ValueError, match="speaker-conditioned"):
        VoiceConverter(build_config(["v2"], TINY), {}, device="cpu")
    # a pitch config's decoder takes one latent channel more: the fork's
    # weights do not fit it
    with pytest.raises(RuntimeError, match="size mismatch"):
        VoiceConverter(build_config(["v2_fork"], TINY + ["pitch_embedding_size=1"]),
                       f.state, device="cpu")
    with pytest.raises(ValueError, match="speaker-conditioned"):
        RAVE(build_config(["v2"], TINY), device="cpu").convert(
            torch.zeros(1, 4096, 1), torch.zeros(1, 4096, 1))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        VoiceConverter(f.cfg, f.state)
    with pytest.raises(RuntimeError, match="CUDA"):
        RAVE(f.cfg)
