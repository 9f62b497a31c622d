"""The ``v1`` family (``v1``, ``onnx``, ``raspberry``) in the port against
``rave_tpu``: EncoderV1 with its BatchNorm in training (batch statistics,
the running ones advanced at momentum 0.9) and serving (the running
ones), and with SampleNorm; GeneratorV1 at ``loud_stride`` 1 and 2 with
its noise branch; the offline presets, and their streams against the
port's own offline run; one D, G pair of the ``v1`` train step with
EncoderV1's running statistics; a checkpoint that resumes them.

The port takes the JAX package's draws as tensors: the noise branch's
``jax.random.uniform(key, ir.shape, f32, -1, 1)`` (``ir`` ``(B, T',
n_band, 64)``) and, in the train step, the latent noise
``normal(split(rng, 4)[0], (B, T_z, latent))`` and the noise branch's
``uniform(split(rng, 4)[1], ...)``.  No JAX stream is built: the stream
is held against the port's offline run (``tests/test_streaming.py``'s
idiom, median relative error < 0.02 after the delay, the noise branch's
draw zero in both: the deterministic path), the offline run against JAX.

Tolerances: the modules atol 2e-6 (BatchNorm and conv outputs of order
1, float32); the running statistics rtol 1e-4; whole models 2e-5 times
the mean magnitude (float32 through ~30 convs); the train pair rtol
1e-3 on the losses and the ENC/DEC gradient norms, the running
statistics after each step rtol 1e-4.  The pair runs at
``learning_rate=1e-6``: the hinge loss gives each score conv's bias a
gradient of rounding noise that Adam's first step turns into a move of
up to +-lr in a direction each framework draws differently (ROADMAP C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rave_tpu.config import build_config as jbuild
from rave_tpu.models import blocks as jblocks
from rave_tpu.models.rave import RAVE as JRAVE
from rave_tpu.train import loop as jloop
from rave_tpu.train import schedules as jsched
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import (_Loader, load_discriminator_params,
                                    load_flax_params)
from rave_tpu_torch.export.streaming import StreamingRAVE
from rave_tpu_torch.models.blocks import BatchNorm, EncoderV1, GeneratorV1
from rave_tpu_torch.models.rave import RAVE
from rave_tpu_torch.train import loop, schedules
from rave_tpu_torch.train.checkpoint import CheckpointManager

SMALL = ["ratios=[2,2]", "latent_size=8", "n_signal=4096", "batch_size=2"]
STACKS = {"v1": ["capacity=4"], "onnx": [], "raspberry": [],
          "v1+causal": ["capacity=4"]}
TRAIN = SMALL + ["capacity=4", "phase_1_duration=0",
                 "update_discriminator_every=2", "stft_scales=[512,256,128]",
                 "discriminator.capacity=4", "discriminator.n_layers=2",
                 "learning_rate=1e-6"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """oneDNN's threaded conv1d data gradient is wrong at some strided
    shapes (``tests/test_torch_train_v2.py``): one thread here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cf(a):
    """``(B, T, C)`` numpy -> ``(B, C, T)`` tensor."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1)))


def _stats(tree, seed=5):
    """Random running statistics in the shapes of a ``batch_stats`` tree
    (positive variances)."""
    r = np.random.default_rng(seed)

    def walk(t):
        if "mean" in t:
            return {"mean": r.normal(0, 0.3, t["mean"].shape).astype(
                        np.float32),
                    "var": r.uniform(0.5, 2.0, t["var"].shape).astype(
                        np.float32)}
        return {k: walk(v) for k, v in t.items()}
    return walk(_np(tree))


def _wn_params(shapes, seed=2):
    """Weight-normed conv parameters of the given shapes, as the JAX
    package's ``WNConv`` initialises them (``tests/test_torch_discrete.py``):
    ``v`` and ``bias`` uniform in +-1/sqrt(fan in), ``g`` the norm of
    ``v`` over all but its last axis."""
    rng = np.random.default_rng(seed)

    def conv(leaves):
        v_shape = leaves["v"].shape
        bound = 1.0 / np.sqrt(np.prod(v_shape[:-1]))
        v = rng.uniform(-bound, bound, v_shape).astype(np.float32)
        return {"v": v, "g": np.sqrt((v * v).sum(
                    tuple(range(len(v_shape) - 1)), keepdims=True)),
                "bias": rng.uniform(-bound, bound, leaves["bias"].shape)
                .astype(np.float32)}

    def walk(tree):
        return conv(tree) if "v" in tree else {k: walk(t) for k, t in
                                               tree.items()}
    return walk(dict(shapes))


def _noise(cfg, B, T, key):
    """The uniform draw of the v1 noise branch for ``T`` samples."""
    frames = T // cfg.n_band // 64
    return np.array(jax.random.uniform(key, (B, frames, cfg.n_band, 64),
                                       jnp.float32, -1.0, 1.0))


@pytest.mark.parametrize("mode", ["batch_train", "batch_serve",
                                  "sample_norm"])
def test_encoder_v1_matches(mode):
    sample_norm, train = mode == "sample_norm", mode == "batch_train"
    kw = dict(data_size=16, capacity=4, latent_size=8, ratios=(2, 2),
              n_out=2, sample_norm=sample_norm, repeat_layers=2)
    m = jblocks.EncoderV1(**kw, train_mode=train)
    x = np.random.default_rng(0).standard_normal((2, 64, 16)).astype(
        np.float32)
    v = _np(m.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    if "batch_stats" in v:
        v["batch_stats"] = _stats(v["batch_stats"])
    if train:
        want, upd = m.apply(v, jnp.asarray(x), mutable=["batch_stats"])
        want_stats = _np(upd["batch_stats"])
    else:
        want = m.apply(v, jnp.asarray(x))
    enc = EncoderV1(**kw)
    ld = _Loader()
    ld.named(enc, v["params"], "params/", v.get("batch_stats"),
             "batch_stats/")
    ld.check(v, [("params/" + k, p) for k, p in enc.named_parameters()])
    bns = [b for b in enc.modules() if isinstance(b, BatchNorm)]
    assert len(bns) == (0 if sample_norm else 4)
    for b in bns:
        assert b.momentum == 0.9 and b.eps == 1e-5
        b.train_bn = train
    with torch.no_grad():
        got = enc(_cf(x)).numpy().transpose(0, 2, 1)
    assert got.shape == want.shape == (2, 16, 16)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-6)
    if train:
        for i, b in enumerate(bns):
            st = want_stats[f"BatchNorm_{i}"]
            np.testing.assert_allclose(b.running_mean.numpy(), st["mean"],
                                       rtol=1e-4, atol=1e-7)
            np.testing.assert_allclose(b.running_var.numpy(), st["var"],
                                       rtol=1e-4)


@pytest.mark.parametrize("loud_stride", [1, 2])
def test_generator_v1_matches(loud_stride):
    kw = dict(latent_size=6, capacity=4, data_size=16, ratios=(2, 2),
              loud_stride=loud_stride)
    m = jblocks.GeneratorV1(**kw)
    z = np.random.default_rng(1).standard_normal((2, 64, 6)).astype(
        np.float32)
    key = jax.random.PRNGKey(4)
    v = _np(m.init(jax.random.PRNGKey(0), jnp.asarray(z), key))
    gen = GeneratorV1(**kw)
    ld = _Loader()
    ld.named(gen, v["params"], "")
    ld.check(v["params"], list(gen.named_parameters()))
    draw = np.array(jax.random.uniform(key, (2, 4, 16, 64), jnp.float32,
                                       -1.0, 1.0))
    for warm in (True, False):
        want = np.asarray(m.apply(v, jnp.asarray(z), key, warmed_up=warm))
        with torch.no_grad():
            got = gen(_cf(z), torch.from_numpy(draw), warmed_up=warm)
        assert got.shape == (2, 16, 256)
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), want,
                                   atol=2e-6)


@pytest.fixture(scope="module")
def family():
    """``get(name)``: the config, the JAX model and variables (random
    running statistics) of a ``v1``-family preset at ``SMALL`` widths,
    and a seeded input; each initialised once per module."""
    made = {}

    def get(name):
        if name not in made:
            stack = name.split("+")
            over = SMALL + STACKS[name]
            cfg = jbuild(stack, over)
            m = JRAVE(cfg=cfg, train_mode=False)
            x = (np.random.default_rng(3).standard_normal((2, 16384, 1))
                 * 0.3).astype(np.float32)
            v = _np(jax.jit(lambda r, a: m.init(r, a, method=JRAVE.warmup))(
                {"params": jax.random.PRNGKey(0),
                 "latent": jax.random.PRNGKey(1),
                 "noise": jax.random.PRNGKey(2)}, jnp.asarray(x)))
            v["batch_stats"] = _stats(v["batch_stats"])
            made[name] = (stack, over, cfg, m, v, x)
        return made[name]
    return get


@pytest.mark.parametrize("name", sorted(STACKS))
def test_v1_family_offline_and_stream(name, family, tmp_path):
    """Offline: the JAX forward from a key against the port's with the
    key's draw.  Stream (2048-sample chunks, zero draws) against the
    port's offline run with a zero draw; with seeded draws the stream
    runs, stays finite, repeats itself after ``reset`` and through
    ``process_file_scan``, and (``v1``) its exported ``forward`` equals
    the live step (1e-6)."""
    stack, over, jcfg, m, v, x = family(name)
    key = jax.random.PRNGKey(6)
    want = np.asarray(jax.jit(lambda v, a, k: m.apply(v, a, k))(
        v, jnp.asarray(x), key))
    cfg = build_config(stack, over)
    port = RAVE(cfg, device="cpu", train_mode=False)
    load_flax_params(port, v["params"], v["batch_stats"])
    draw = _noise(cfg, 2, x.shape[1], key) if cfg.v1_use_noise else None
    zero = None if draw is None else torch.zeros(draw.shape)
    with torch.no_grad():
        got = port(torch.from_numpy(x), noise=None if draw is None
                   else torch.from_numpy(draw)).numpy()
        quiet = port(torch.from_numpy(x[:1]), noise=zero if zero is None
                     else zero[:1]).numpy()[0, :, 0]
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).mean())

    sr = StreamingRAVE(cfg, port.state_dict(), chunk_size=2048,
                       device="cpu", seed=None)
    streamed = sr.process_file(x[0, :, 0])
    d, n = sr.total_delay_samples(), len(quiet)
    assert d < n // 2
    start = 2 * d + 256
    a, b = quiet[start - d:n - d - 256], streamed[start:n - 256]
    assert np.median(np.abs(a - b)) / (np.abs(a).mean() + 1e-9) < 0.02
    seeded = StreamingRAVE(cfg, port.state_dict(), chunk_size=2048,
                           device="cpu", seed=1)
    first = seeded.process_file(x[0, :8192, 0])
    assert np.isfinite(first).all()
    np.testing.assert_array_equal(seeded.process_file(x[0, :8192, 0]),
                                  first)
    if cfg.v1_use_noise:
        assert not np.array_equal(first, streamed[:8192])
    np.testing.assert_array_equal(
        seeded.process_file_scan(x[0, :8192, 0]), first)
    if name != "v1":
        return
    # the v1 stream's caches and draws through an exported program
    out = seeded.serialize(str(tmp_path))
    prog = torch.export.load(str(out / "forward.pt2")).module()
    carry = [c.clone() for c in seeded.init_caches]
    seeded.reset()
    for i in range(3):
        c = torch.from_numpy(x[:1, 2048 * i:2048 * (i + 1)])
        y, carry = prog(carry, c)
        np.testing.assert_allclose(y.detach().numpy(),
                                   seeded.forward(c).numpy(), atol=1e-6)


def _draws(jcfg, rng):
    """The latent noise and the noise branch's draw the JAX step makes
    from ``rng`` (``split(rng, 4)``), in the port's layouts."""
    r = jax.random.split(rng, 4)
    B, T = jcfg.batch_size, jcfg.n_signal
    eps = np.asarray(jax.random.normal(
        r[0], (B, T // jcfg.total_ratio(), jcfg.latent_size), jnp.float32))
    return (torch.from_numpy(eps.transpose(0, 2, 1).copy()),
            {"noise": torch.from_numpy(_noise(jcfg, B, T, r[1]))})


@pytest.fixture(scope="module")
def pair(family):
    """One D step then one G step of ``v1`` from one initial state in
    both frameworks, the JAX one as one jitted function (the D loss, its
    Adam update, the G loss and its gradient, each step's batch
    statistics); the discriminator's parameters drawn in numpy to the
    shapes of its init."""
    jcfg, cfg = jbuild(["v1"], TRAIN), build_config(["v1"], TRAIN)
    jmodel, jdisc = jloop.RAVE(cfg=jcfg), jloop.build_discriminator(jcfg)
    dis_tx = jloop.make_optimizers(jcfg)[2]
    x = (0.1 * np.random.default_rng(0).standard_normal(
        (cfg.batch_size, cfg.n_signal, 1))).astype(np.float32)
    rng = jax.random.PRNGKey(1)
    v = family("v1")[4]
    gen_params, stats = v["params"], {"batch_stats": v["batch_stats"]}
    dis_params = _wn_params(jax.eval_shape(
        jdisc.init, {"params": rng}, jnp.asarray(x))["params"])

    def jrun(gen_params, dis_params, dis_opt, model_state, x):
        def dloss(dp):
            out = jloop._forward_losses(jcfg, jmodel, jdisc, gen_params, dp,
                                        model_state, {"x": x}, rng, 0)
            ld, _, _ = jloop._gan_terms(jcfg, jdisc, dp, out["x"],
                                        jax.lax.stop_gradient(out["y"]))
            return ld, out["new_state"]

        (ld, ms1), gd = jax.value_and_grad(dloss, has_aux=True)(dis_params)
        upd, _ = dis_tx.update(gd, dis_opt, dis_params)
        dp1 = optax.apply_updates(dis_params, upd)

        def gloss(gp):
            out = jloop._forward_losses(jcfg, jmodel, jdisc, gp, dp1, ms1,
                                        {"x": x}, rng, 1)
            _, adv, fm = jloop._gan_terms(jcfg, jdisc, dp1, out["x"],
                                          out["y"])
            terms = {**out["dists"], "adversarial": adv,
                     "feature_matching": fm,
                     "regularization": out["reg"] * jsched.beta_factor(
                         1, jcfg)}
            return sum(v * jcfg.weights.get(k, 1.0)
                       for k, v in terms.items()), out["new_state"]

        (lg, ms2), gg = jax.value_and_grad(gloss, has_aux=True)(gen_params)
        return ld, lg, gg, ms1, ms2

    ld, lg, gg, ms1, ms2 = _np(jax.jit(jrun)(
        gen_params, dis_params, dis_tx.init(dis_params), stats,
        jnp.asarray(x)))
    state = loop.TrainState(cfg, device="cpu")
    load_flax_params(state.model, gen_params, v["batch_stats"])
    load_discriminator_params(state.disc, dis_params)
    eps, draws = _draws(jcfg, rng)
    step = loop.make_train_step(cfg)
    assert schedules.is_discriminator_step(0, cfg)
    bns = [b for b in state.model.encoder.modules()
           if isinstance(b, BatchNorm)]
    m_d = step(state, {"x": torch.from_numpy(x)}, eps, draws=draws)
    after_d = [(b.running_mean.clone(), b.running_var.clone()) for b in bns]
    m_g = step(state, {"x": torch.from_numpy(x)}, eps, draws=draws)
    grads = RAVE(cfg, device="cpu")
    load_flax_params(grads, gg, ms2["batch_stats"])
    return dict(cfg=cfg, state=state, m_d=m_d, m_g=m_g, ld=ld, lg=lg,
                want_grads=dict(grads.named_parameters()),
                stats=(after_d, [(b.running_mean, b.running_var)
                                 for b in bns]), want_stats=(ms1, ms2),
                x=x, eps=eps, draws=draws, init_stats=v["batch_stats"])


def test_v1_pair_matches(pair):
    m_d, m_g = pair["m_d"], pair["m_g"]
    assert float(m_d["loss_dis"]) == pytest.approx(float(pair["ld"]),
                                                   rel=1e-3)
    assert float(m_g["loss_gen_total"]) == pytest.approx(
        float(pair["lg"]), rel=1e-3)
    assert float(m_g["loss_regularization"]) > 0
    state, want = pair["state"], pair["want_grads"]
    for group in ("encoder.", "decoder."):
        names = [k for k, p in state.model.named_parameters()
                 if k.startswith(group)]
        got = torch.cat([dict(state.model.named_parameters())[k].grad
                         .flatten() for k in names])
        ref = torch.cat([want[k].detach().flatten() for k in names])
        assert float(got.norm()) == pytest.approx(float(ref.norm()),
                                                  rel=1e-3), group
    # the noise branch trained: its convs have a gradient
    assert float(state.model.decoder.noise.net[0].weight.grad.norm()) > 0
    for got, ms in zip(pair["stats"], pair["want_stats"]):
        for i, (mean, var) in enumerate(got):
            st = ms["batch_stats"]["encoder"][f"BatchNorm_{i}"]
            np.testing.assert_allclose(mean.numpy(), st["mean"], rtol=1e-4,
                                       atol=1e-7)
            np.testing.assert_allclose(var.numpy(), st["var"], rtol=1e-4)
    # the D step moved the statistics too
    before = pair["init_stats"]["encoder"]["BatchNorm_0"]["mean"]
    assert not np.allclose(pair["stats"][0][0][0].numpy(), before)


def test_v1_run_resumes_with_its_statistics(pair, tmp_path):
    """A checkpoint of the state after the pair restores EncoderV1's
    running statistics bit for bit, and the next step from it equals the
    next step of the live state."""
    state, cfg = pair["state"], pair["cfg"]
    CheckpointManager(str(tmp_path)).save(state)
    back = loop.TrainState(cfg, device="cpu")
    CheckpointManager(str(tmp_path)).restore(back)
    assert back.step == state.step == 2
    live = dict(state.model.encoder.named_buffers())
    restored = dict(back.model.encoder.named_buffers())
    assert sorted(live) == sorted(restored) and live
    for k, b in live.items():
        assert torch.equal(b, restored[k]), k
    fresh = loop.TrainState(cfg, device="cpu")
    assert not torch.equal(
        dict(fresh.model.encoder.named_buffers())[sorted(live)[0]],
        live[sorted(live)[0]])
    step = loop.make_train_step(cfg)
    batch = {"x": torch.from_numpy(pair["x"])}
    m_live = step(state, batch, pair["eps"], draws=pair["draws"])
    m_back = step(back, batch, pair["eps"], draws=pair["draws"])
    for k in m_live:
        assert float(m_live[k]) == float(m_back[k]), k
    for k, b in dict(state.model.encoder.named_buffers()).items():
        assert torch.equal(b, dict(back.model.encoder.named_buffers())[k])
