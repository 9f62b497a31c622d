"""The frozen speaker encoder and the speaker-conditioned (``v2_fork``)
RAVE against rave_tpu's, on converted parameters and BatchNorm
statistics (drawn at random, so that the stored-statistics path is
exercised, not the identity of a fresh BatchNorm).

Tolerances: the embedding atol 1e-4 times its largest magnitude (float32
through ~15 convs, attentive pooling and two BatchNorms); the fork's
latent and audio atol 2e-5 (as ``tests/test_torch_model.py``), the unit
logits atol 1e-4 of their largest magnitude (about 10: a LayerNorm over
8 frames divides by their spread).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.config import build_config as jbuild
from rave_tpu.models.rave import RAVE as JRAVE
from rave_tpu.models.speaker import SpeakerRAVE as JSpeaker
from rave_tpu.train import loop as jloop
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import load_flax_params
from rave_tpu_torch.models.rave import RAVE
from rave_tpu_torch.models.speaker import SpeakerRAVE
from rave_tpu_torch.train.loop import TrainState, spk_group

TINY = ["capacity=4", "n_signal=8192", "ratios=[2,2]",
        "dilations=[[1,3],[1,3]]"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomise_stats(stats, seed):
    """Random BatchNorm statistics (positive variances)."""
    rng = np.random.default_rng(seed)
    return {name: {"mean": (0.1 * rng.standard_normal(s["mean"].shape)
                            ).astype(np.float32),
                   "var": rng.uniform(0.5, 2.0, s["var"].shape
                                      ).astype(np.float32)}
            for name, s in stats.items()}


def test_speaker_embedding_matches(jax_fork):
    rng = np.random.default_rng(0)
    bands = rng.standard_normal((2, 256, 16)).astype(np.float32)
    jspk = JSpeaker()
    v = jax.jit(jspk.init)(jax.random.PRNGKey(0), jnp.asarray(bands))
    params = jax.tree.map(np.asarray, v["params"])
    for name in ("attn_bn", "bn5"):
        n = params[name]["scale"].shape
        params[name]["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        params[name]["bias"] = (0.1 * rng.standard_normal(n)).astype(
            np.float32)
    stats = _randomise_stats(jax.tree.map(np.asarray, v["batch_stats"]), 1)
    # compiled once, the variables an argument (eagerly, every
    # operation compiles on its own)
    want = np.asarray(jax.jit(jspk.apply)(
        {"params": params, "batch_stats": stats}, jnp.asarray(bands)))

    # load through the RAVE converter: the speaker subtree of a fork model
    model = RAVE(build_config(["v2_fork"], TINY), device="cpu")
    jfork, fparams, fstats = jax_fork(0)
    fparams["speaker_encoder"] = params
    fstats["speaker_encoder"] = stats
    load_flax_params(model, fparams, fstats)
    spk: SpeakerRAVE = model.speaker_encoder
    spk.train()   # the BatchNorms stay on stored statistics regardless
    got = model.speaker_embedding(torch.from_numpy(
        bands.transpose(0, 2, 1).copy())).numpy()
    assert got.shape == want.shape == (2, 256)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    assert not any(p.requires_grad for p in spk.parameters())


@pytest.fixture(scope="module")
def jax_fork():
    """``get(seed)``: the tiny JAX fork and fresh numpy parameters and
    BatchNorm statistics from ``seed`` (its init compiled once for the
    module)."""
    cfg = jbuild(["v2_fork"], TINY)
    m = JRAVE(cfg=cfg, train_mode=False)
    init = jax.jit(lambda r, a: m.init(r, a, method=JRAVE.warmup))

    def get(seed, T=8192):
        v = init({"params": jax.random.PRNGKey(seed),
                  "latent": jax.random.PRNGKey(1),
                  "noise": jax.random.PRNGKey(2)},
                 jnp.zeros((1, T, 1), jnp.float32))
        return (m, jax.tree.map(np.asarray, v["params"]),
                jax.tree.map(np.asarray, v["batch_stats"]))

    return get


def test_fork_encode_forward_and_units_match(jax_fork):
    m, params, stats = jax_fork(3)
    stats["speaker_encoder"] = _randomise_stats(stats["speaker_encoder"], 2)
    v = {"params": params, "batch_stats": stats}
    x = (0.3 * np.random.default_rng(4).standard_normal((2, 8192, 1))
         ).astype(np.float32)
    # the variables are an argument, not constants of the programs
    z_j = np.asarray(jax.jit(lambda v, a: m.apply(v, a, method=JRAVE.encode))(
        v, jnp.asarray(x)))
    y_j = np.asarray(jax.jit(lambda v, a: m.apply(v, a))(v, jnp.asarray(x)))

    def units(v, a):
        bands = m.apply(v, a, method=JRAVE.pqmf_forward)
        z = m.apply(v, a, bands, method=JRAVE.encode_input)
        return m.apply(v, z, 37, method=JRAVE.project_units)

    u_j = np.asarray(jax.jit(units)(v, jnp.asarray(x)))

    model = RAVE(build_config(["v2_fork"], TINY), device="cpu")
    load_flax_params(model, params, stats)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        z_t = model.encode(xt).numpy()
        y_t = model(xt).numpy()
        u_t = model.project_units(model.encode_input(model.pqmf_forward(xt)),
                                  37).numpy()
    assert z_t.shape == z_j.shape == (2, 8192 // 64, 64 + 256)
    assert y_t.shape == y_j.shape == x.shape
    assert u_t.shape == u_j.shape == (2, 37, 100)
    np.testing.assert_allclose(z_t, z_j, atol=2e-5)
    np.testing.assert_allclose(y_t, y_j, atol=2e-5)
    np.testing.assert_allclose(u_t, u_j, atol=1e-4 * np.abs(u_j).max())


def test_fork_converter_needs_batch_stats_and_uses_every_leaf(jax_fork):
    _, params, stats = jax_fork(0)
    model = RAVE(build_config(["v2_fork"], TINY), device="cpu")
    with pytest.raises(ValueError, match="batch_stats"):
        load_flax_params(model, params)
    stats["speaker_encoder"]["bn5"]["stray"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="unused"):
        load_flax_params(model, params, stats)


@pytest.mark.parametrize("over", [["train_speaker_encoder=true"],
                                  ["speaker_classes=8"],
                                  ["speaker_norm=cohort"],
                                  ["speaker_classes=8",
                                   "latent_adversary_weight=0.1"]])
def test_speaker_training_options_raise(over):
    """(Named for the refusal it once pinned.)  The train state of each
    speaker-training option builds, and its SPK optimizer group holds the
    parameters of exactly the modules the JAX package's ``_spk_group``
    names."""
    cfg = build_config(["v2_fork"], TINY + over)
    state = TrainState(cfg, device="cpu")
    names = jloop._spk_group(jbuild(["v2_fork"], TINY + over))
    assert spk_group(cfg) == names
    want = [p for n in names for p in getattr(state.model, n).parameters()]
    assert [id(p) for p in state.spk_params] == [id(p) for p in want]
    assert (state.spk_opt is None) == (not names)
    if names:
        assert state.spk_opt.param_groups[0]["params"] == state.spk_params
    trained = "speaker_encoder" in names
    assert all(p.requires_grad == trained
               for p in state.model.speaker_encoder.parameters())
