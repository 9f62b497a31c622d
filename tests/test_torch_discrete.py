"""The ``discrete`` preset in the port against ``rave_tpu``: the offline
forward, ``encode_indices`` / ``decode_indices``, the index stream, the
export of trained codebooks, one D, G pair of the train step and a
checkpoint round trip of the codebook buffers.

Codebooks are seeded random ones (a fresh model's are all zero, which
makes every index 0) or those a k-means-init train pass produced.  The
random rows of k-means and dead-code expiry follow one deterministic rule
in both frameworks (``_rows``: the JAX package's ``_sample_vectors``
monkeypatched in this process, the port's ``sampler`` argument).

Tolerances: audio and latents 1e-4 (float32 through ~30 convs and the
RVQ, sums in another order), indices equal (the codes are far apart:
the nearest-code gaps exceed 1e-3 of the distances).  The train step:
losses, the ENC and DEC gradient norms rtol 1e-3; the codebook buffers
after each step rtol 1e-4, atol 1e-6, except that ``embed`` is
``embed_avg / smoothed`` and an unused code's smoothed count is ~1e-5, so
its row carries ``embed_avg``'s atol divided by it (the encoder's float32
noise on a near-zero latent component, amplified 1e5 times).  The step
runs at ``learning_rate=1e-6``: the hinge loss gives each score conv's
bias a gradient of rounding noise only, which Adam's first step turns
into a move of +-lr in a direction each framework draws differently
(ROADMAP C); at the preset's 1e-4 the G step after the D step differs
from the JAX one by 6e-4 in its loss and 1-3e-3 in its gradients, at
1e-6 by 1e-5 and under 1e-3.  The D step itself is held at the preset's
rate too: its DIS gradient (which the first step computes before any
update) tensor by tensor rtol 1e-3 of the tensor's norm, and at least
99.9 % of the discriminator's parameters after one D step at 1e-4 within
1e-6 of JAX's (see ``test_discriminator_step_matches``).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rave_tpu.models.quantization as jq
from rave_tpu.config import build_config as jbuild
from rave_tpu.models.rave import RAVE as JRAVE
from rave_tpu.train import loop as jloop
from rave_tpu.train import schedules as jsched
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import (load_discriminator_params,
                                    load_flax_params)
from rave_tpu_torch.export.streaming import StreamingRAVE
from rave_tpu_torch.models.discriminators import build_discriminator
from rave_tpu_torch.models.rave import RAVE
from rave_tpu_torch.train import loop, schedules
from rave_tpu_torch.train.checkpoint import CheckpointManager

# one residual unit per stage (the preset's four strided stages): at
# 4096 samples 4 latent frames per item, so most of the 32 codes go
# unused and expire on every train pass
TINY = ["capacity=4", "latent_size=8", "num_quantizers=2",
        "codebook_size=32", "n_signal=4096", "batch_size=2",
        "dilations=[[1],[1],[1],[1]]"]
TRAIN_PRESET_LR = TINY + ["valid_signal_crop=false", "phase_1_duration=0",
                          "stft_scales=[512,256,128]",
                          "discriminator.capacity=4",
                          "discriminator.spectral_scales=[512,256]"]
TRAIN = TRAIN_PRESET_LR + ["learning_rate=1e-6"]


def _rows_idx(n: int, num: int) -> np.ndarray:
    return np.random.RandomState(1000 * n + num).randint(0, n, num)


def _rows(samples, num):
    return samples[torch.from_numpy(_rows_idx(samples.shape[0], num))
                   .to(samples.device)]


@pytest.fixture(scope="module", autouse=True)
def _same_draws():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jq, "_sample_vectors",
                   lambda rng, s, num: s[jnp.asarray(_rows_idx(s.shape[0],
                                                               num))])
        yield


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """oneDNN's threaded conv1d data gradient is wrong at some strided
    shapes of the MSD (ROADMAP C), as in ``test_torch_train_v2.py``."""
    threads = torch.get_num_threads()
    omp = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    # and in the subprocesses this module starts
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if omp is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = omp


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _wn_params(shapes, seed=2):
    """Weight-normed conv parameters of the given shapes, as the JAX
    package's ``WNConv`` initialises them: ``v`` and ``bias`` uniform in
    +-1/sqrt(fan in), ``g`` the norm of ``v`` over all but its last
    axis."""
    rng = np.random.default_rng(seed)

    def conv(leaves):
        v_shape = leaves["v"].shape
        bound = 1.0 / np.sqrt(np.prod(v_shape[:-1]))
        v = rng.uniform(-bound, bound, v_shape).astype(np.float32)
        axes = tuple(range(len(v_shape) - 1))
        return {"v": v,
                "g": np.sqrt((v * v).sum(axes, keepdims=True)),
                "bias": rng.uniform(-bound, bound, leaves["bias"].shape)
                .astype(np.float32)}

    def walk(tree):
        return conv(tree) if "v" in tree else {k: walk(t) for k, t in
                                               tree.items()}
    return walk(dict(shapes))


@pytest.fixture(scope="module")
def model():
    """A tiny JAX ``discrete`` model's params and random codebooks, the
    port loaded with both, and a clip."""
    cfg = jbuild(["discrete"], TINY)
    m = JRAVE(cfg=cfg, train_mode=False)
    x = (np.random.default_rng(0).standard_normal((2, 8192, 1)) * 0.3
         ).astype(np.float32)
    v = _np(jax.jit(m.init)({"params": jax.random.PRNGKey(0)},
                            jnp.asarray(x)))
    r = np.random.default_rng(1)
    quant = jax.tree.map(
        lambda a: (r.standard_normal(a.shape) * 0.5).astype(np.float32)
        if a.ndim else np.float32(1.0), v["quantizer"])
    port = RAVE(build_config(["discrete"], TINY), device="cpu",
                train_mode=False)
    load_flax_params(port, v["params"], model_state={"quantizer": quant})
    return dict(cfg=cfg, jm=m, params=v["params"], quant=quant, port=port,
                x=x, vars={"params": v["params"], "quantizer": quant})


def test_forward_and_indices_match(model):
    jm, v, x, port = model["jm"], model["vars"], model["x"], model["port"]
    run = jax.jit(lambda v, a: (jm.apply(v, a),
                                jm.apply(v, a, method=JRAVE.encode),
                                jm.apply(v, a, method=JRAVE.encode_indices)))
    y_j, z_j, i_j = (np.asarray(a) for a in run(v, jnp.asarray(x)))
    d_j = np.asarray(jax.jit(lambda v, i: jm.apply(
        v, i, method=JRAVE.decode_indices))(v, jnp.asarray(i_j)))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y_t, z_t = port(xt).numpy(), port.encode(xt).numpy()
        i_t = port.encode_indices(xt)
        d_t = port.decode_indices(i_t).numpy()
    assert i_t.dtype == torch.int64 and i_t.shape == (2, 2, 8)
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    for got, want in ((y_t, y_j), (z_t, z_j), (d_t, d_j)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4)
    # the forward decodes the codes it finds
    np.testing.assert_allclose(d_t, y_t, atol=1e-5)


def test_index_stream_matches(model):
    """Two 2048-sample chunks through ``encode_indices`` then
    ``decode_indices``: the port's stream against the JAX package's
    streaming model (the steps of its ``StreamingRAVE``, jitted here:
    that class initialises its model eagerly, tens of seconds on a
    CPU)."""
    cfg, x = model["cfg"], model["x"]
    jm = JRAVE(cfg=cfg, streaming=True, train_mode=False)
    c0 = jnp.asarray(x[:1, :2048])
    cache = jax.jit(jm.init)({"params": jax.random.PRNGKey(0)}, c0)["cache"]
    v = {"params": model["params"], "quantizer": model["quant"]}

    @jax.jit
    def jstep(v, cache, c):
        idx, upd = jm.apply({**v, "cache": cache}, c, mutable=["cache"],
                            method=JRAVE.encode_indices)
        y, upd = jm.apply({**v, "cache": upd["cache"]}, idx,
                          mutable=["cache"], method=JRAVE.decode_indices)
        return idx, y, upd["cache"]

    cache = jax.tree.map(jnp.zeros_like, cache)
    ts = StreamingRAVE(build_config(["discrete"], TINY),
                       model["port"].state_dict(), chunk_size=2048,
                       device="cpu")
    for i in range(2):
        c = x[:1, 2048 * i:2048 * (i + 1)]
        i_j, y_j, cache = jstep(v, cache, jnp.asarray(c))
        i_t = ts.encode_indices(c)
        assert i_t.shape == (1, 2, 2048 // cfg.total_ratio())
        assert i_t.dtype == torch.int64
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_allclose(ts.decode_indices(i_t).numpy(),
                                   np.asarray(y_j), atol=1e-4)


def test_export_carries_trained_codebooks(model, tmp_path):
    """The stream and its exported ``forward`` serve the trained
    codebooks, not a fresh init's zeros."""
    sd = model["port"].state_dict()
    cfg = build_config(["discrete"], TINY)
    ts = StreamingRAVE(cfg, sd, chunk_size=2048, device="cpu")
    for i, layer in enumerate(ts.model.latent.rvq.layers):
        np.testing.assert_array_equal(
            layer.codebook.embed.numpy(),
            model["quant"]["latent"]["rvq"][f"vq{i}"]["codebook"]["embed"])
    out = ts.serialize(str(tmp_path))
    prog = torch.export.load(str(out / "forward.pt2")).module()
    zero = {k: torch.zeros_like(v) if "codebook" in k else v
            for k, v in sd.items()}
    fresh = StreamingRAVE(cfg, zero, chunk_size=2048, device="cpu")
    caches = [torch.zeros_like(a) for a in ts.init_caches]
    # the first chunks come out of the delay line; the last one carries
    # the latent
    for i in range(4):
        c = torch.from_numpy(model["x"][:1, 2048 * i:2048 * (i + 1)])
        y, caches = prog(caches, c)
        np.testing.assert_allclose(y.detach().numpy(),
                                   ts.forward(c).numpy(), atol=1e-6)
        y_fresh = fresh.forward(c)
    assert (fresh.encode_indices(c) == 0).all()
    assert not torch.allclose(y_fresh, y, atol=1e-4)


def test_quantize_gate():
    cfg = build_config(["discrete"])
    assert cfg.warmup_quantize == -1 and schedules.quantize_enabled(0, cfg)
    cfg.warmup_quantize = None
    assert schedules.quantize_enabled(0, cfg)
    cfg.warmup_quantize = 5
    assert not schedules.quantize_enabled(4, cfg)
    assert schedules.quantize_enabled(5, cfg)
    for step in (0, 4, 5):
        assert schedules.quantize_enabled(step, cfg) == bool(
            jsched.quantize_enabled(step, cfg))


def test_gate_off_still_updates_codebooks(model):
    """With the gate off the latent passes unquantized and the loss is 0,
    but a train pass still moves the EMA (as in the JAX package)."""
    port = RAVE(build_config(["discrete"], TINY), device="cpu")
    port.load_state_dict(model["port"].state_dict())
    z = torch.randn(2, 8, 6)
    before = port.latent.rvq.layers[0].codebook.cluster_size.clone()
    zq, reg = port.reparametrize(z, train=True, enabled=False,
                                 sampler=_rows)
    assert torch.equal(zq, z) and float(reg) == 0.0
    assert not torch.equal(port.latent.rvq.layers[0].codebook.cluster_size,
                           before)


@pytest.fixture(scope="module")
def steps(model):
    """One D step then one G step from one initial state with zero
    codebooks (the D step's forward k-means-inits them) in both
    frameworks: the JAX one as one jitted function of the D loss, its
    Adam update and the G loss with its gradient.  The generator's
    parameters are the ``model`` fixture's (the same architecture); the
    discriminator's are drawn in numpy to the shapes of its init, as the
    JAX package initialises them (no compile of either init)."""
    jcfg, cfg = jbuild(["discrete"], TRAIN), build_config(["discrete"], TRAIN)
    jmodel, jdisc = jloop.RAVE(cfg=jcfg), jloop.build_discriminator(jcfg)
    dis_tx = jloop.make_optimizers(jcfg)[2]
    preset_tx = jloop.make_optimizers(jbuild(["discrete"],
                                             TRAIN_PRESET_LR))[2]
    x = (0.1 * np.random.default_rng(0).standard_normal(
        (cfg.batch_size, cfg.n_signal, 1))).astype(np.float32)
    rng = jax.random.PRNGKey(1)
    gen_params = model["params"]
    dis_params = _wn_params(jax.eval_shape(
        jdisc.init, {"params": rng}, jnp.asarray(x))["params"])
    quant0 = {"quantizer": jax.tree.map(np.zeros_like, model["quant"])}

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
        upd, _ = preset_tx.update(gd, preset_tx.init(dis_params), dis_params)
        dp1_preset = optax.apply_updates(dis_params, upd)

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
        return ld, lg, gg, ms1, ms2, gd, dp1_preset

    ld, lg, gg, ms1, ms2, gd, dp1_preset = _np(jax.jit(jrun)(
        gen_params, dis_params, dis_tx.init(dis_params), quant0,
        jnp.asarray(x)))
    state = loop.TrainState(cfg, device="cpu")
    load_flax_params(state.model, gen_params, model_state=quant0)
    load_discriminator_params(state.disc, dis_params)
    step = loop.make_train_step(cfg)
    books = lambda: [{k: v.clone() for k, v in  # noqa: E731
                      layer.codebook.state_dict().items()}
                     for layer in state.model.latent.rvq.layers]
    assert schedules.is_discriminator_step(0, cfg)
    m_d = step(state, {"x": torch.from_numpy(x)}, sampler=_rows)
    books_d = books()
    m_g = step(state, {"x": torch.from_numpy(x)}, sampler=_rows)
    grads = RAVE(cfg, device="cpu")
    load_flax_params(grads, gg)
    # one D step at the preset's rate from the same start
    pcfg = build_config(["discrete"], TRAIN_PRESET_LR)
    preset = loop.TrainState(pcfg, device="cpu")
    load_flax_params(preset.model, gen_params, model_state=quant0)
    load_discriminator_params(preset.disc, dis_params)
    loop.make_train_step(pcfg)(preset, {"x": torch.from_numpy(x)},
                               sampler=_rows)
    want_disc = build_discriminator(pcfg, "cpu")
    load_discriminator_params(want_disc, dp1_preset)
    want_dgrads = build_discriminator(cfg, "cpu")
    load_discriminator_params(want_dgrads, gd)
    return dict(cfg=cfg, state=state, m_d=m_d, m_g=m_g, ld=ld, lg=lg,
                want_grads=dict(grads.named_parameters()), ms=(ms1, ms2),
                books=(books_d, books()),
                want_dgrads=dict(want_dgrads.named_parameters()),
                preset_disc=(preset.disc, want_disc))


def test_step_losses_match(steps):
    m_d, m_g = steps["m_d"], steps["m_g"]
    assert float(m_d["loss_dis"]) == pytest.approx(float(steps["ld"]),
                                                   rel=1e-3)
    assert float(m_g["loss_gen_total"]) == pytest.approx(
        float(steps["lg"]), rel=1e-3)
    assert float(m_g["loss_regularization"]) > 0
    assert steps["state"].step == 2


def test_step_gradient_norms_match(steps):
    state, want = steps["state"], steps["want_grads"]
    for group in ("encoder.", "decoder."):
        got = torch.cat([p.grad.flatten() for k, p in
                         state.model.named_parameters()
                         if k.startswith(group)])
        ref = torch.cat([want[k].detach().flatten() for k, _ in
                         state.model.named_parameters()
                         if k.startswith(group)])
        assert float(got.norm()) == pytest.approx(float(ref.norm()),
                                                  rel=1e-3), group


def test_discriminator_step_matches(steps):
    """The D step's DIS gradient (left in the discriminator's ``.grad``
    by the pair) tensor by tensor and as a whole, and the discriminator
    after one D step at the preset's learning rate.  The score convs'
    biases (one element each) are left out of the gradient check: the
    hinge loss gives them a gradient of rounding noise.  Adam's first step
    moves each element by ``lr * g / (|g| + eps)``, so an element whose
    gradient is rounding noise on its tensor's scale moves by up to +-lr
    in a direction each framework draws differently; the step is held by
    the share of elements within 1e-6 (1 % of the rate)."""
    want = steps["want_dgrads"]
    for k, p in steps["state"].disc.named_parameters():
        if k.endswith("bias") and p.numel() == 1:
            continue
        ref = want[k].detach()
        assert float((p.grad - ref).norm()) <= 1e-3 * float(ref.norm()), k
    got = torch.cat([p.grad.flatten()
                     for p in steps["state"].disc.parameters()])
    ref = torch.cat([p.detach().flatten() for p in want.values()])
    assert float(got.norm()) == pytest.approx(float(ref.norm()), rel=1e-3)
    port, want = steps["preset_disc"]
    got = torch.cat([p.detach().flatten() for p in port.parameters()])
    ref = torch.cat([p.detach().flatten() for p in want.parameters()])
    share = float(((got - ref).abs() <= 1e-6).double().mean())
    assert share >= 0.999, share


def test_step_codebooks_match(steps):
    """After the D step (k-means init, expiry, EMA) and after the G step
    (another EMA)."""
    for books, ms in zip(steps["books"], steps["ms"]):
        for i, book in enumerate(books):
            want = ms["quantizer"]["latent"]["rvq"][f"vq{i}"]["codebook"]
            cs = want["cluster_size"].astype(np.float64)
            n, k_codes = cs.sum(), len(cs)
            smoothed = (cs + 1e-5) / (n + k_codes * 1e-5) * n
            for k, v in book.items():
                atol = 1e-6 / smoothed[:, None] if k == "embed" else 1e-6
                err = np.abs(v.numpy() - want[k]) - 1e-4 * np.abs(want[k])
                assert np.all(err <= atol), (i, k, float(np.max(err - atol)))
    assert all(float(b["inited"]) == 1.0 for b in steps["books"][0])


def test_checkpoint_restores_codebooks_bit_for_bit(steps, tmp_path):
    state = steps["state"]
    CheckpointManager(str(tmp_path)).save(state)
    back = loop.TrainState(steps["cfg"], device="cpu")
    assert not back.model.latent.rvq.layers[0].codebook.is_inited()
    CheckpointManager(str(tmp_path)).restore(back)
    assert back.step == state.step
    for a, b in zip(state.model.latent.rvq.layers,
                    back.model.latent.rvq.layers):
        for k, v in a.codebook.state_dict().items():
            assert torch.equal(v, b.codebook.state_dict()[k]), k
        assert b.codebook.is_inited()


def test_cli_trains_and_exports_discrete(tmp_path, capsys):
    """``python -m rave_tpu_torch.cli`` preprocess, train ``--config
    discrete`` past phase 1 (D and G steps) with validation, then
    ``export``: the run keeps inited codebooks in its checkpoint, writes
    no latent PCA (not a variational head), and its exported ``forward``
    serves them."""
    from rave_tpu_torch import cli
    from rave_tpu_torch.data.audio_io import save_wav

    rng = np.random.default_rng(0)
    t = np.arange(16384) / 44100
    for s in range(2):
        d = tmp_path / "audio" / f"spk{s}"
        d.mkdir(parents=True)
        save_wav(str(d / "0.wav"), 0.3 * np.sin(2 * np.pi * 150 * (s + 1) * t)
                 + 0.02 * rng.standard_normal(len(t)), 44100)
    db, runs = str(tmp_path / "db"), str(tmp_path / "runs")
    cli.main(["preprocess", "--input_path", str(tmp_path / "audio"),
              "--output_path", db, "--num_signal", "8192",
              "--num_workers", "1"])
    over = [a for o in TINY + ["n_signal=8192", "phase_1_duration=2",
                               "update_discriminator_every=2",
                               "valid_signal_crop=false",
                               "stft_scales=[512,256,128]",
                               "discriminator.capacity=4",
                               "discriminator.spectral_scales=[512,256]"]
            for a in ("--override", o)]
    cli.main(["train", "--config", "discrete", *over, "--db_path", db,
              "--out_path", runs, "--max_steps", "5", "--val_every", "3",
              "--device", "cpu"])
    assert "finished at step 5" in capsys.readouterr().out
    run = next((tmp_path / "runs").iterdir())
    recs = [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]
    assert recs[0]["loss_regularization"] >= 0
    assert np.isfinite(recs[0]["loss_gen_total"])
    assert any(np.isfinite(r.get("validation", np.nan)) for r in recs)
    assert not (run / "latent_stats.npz").exists()
    saved = torch.load(run / "checkpoints" / "ckpt_5.pt", weights_only=True)
    assert float(saved["model"]["latent.rvq.layers.0.codebook.inited"]) == 1
    cli.main(["export", "--run", str(run), "--chunk_size", "2048",
              "--device", "cpu"])
    out = run / "export"
    prog = torch.export.load(str(out / "forward.pt2")).module()
    caches = [torch.from_numpy(v) for v in
              np.load(out / "cache_init.npz").values()]
    y, _ = prog(caches, torch.zeros(1, 2048, 1))
    assert y.shape == (1, 2048, 1) and bool(torch.isfinite(y).all())
