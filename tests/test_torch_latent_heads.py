"""The Wasserstein, spherical and discrete heads with noise augmentation,
the spherical angles, ``decode``'s re-sampled augmentation channels and
the ``v2`` + ``noise`` + ``wasserstein`` train step in the port against
``rave_tpu``; the noise stream's fixed draws; the spherical stream's
``postprocess_latent`` / ``preprocess_latent``.

The port takes the JAX package's draws as tensors.  A head or ``decode``
given the key ``k``: the Wasserstein head's reference ``normal(split(k)[0],
(B * T, C))`` and augmentation ``normal(split(k)[1], (B, T, n))``; the
discrete head's augmentation ``normal(k, (B, T, n))``; ``decode``'s
re-sampled channels ``normal(k, ...)`` and its noise branch's
``uniform(k, ir.shape, -1, 1)`` (one key for both, ROADMAP C).  The train
step's from ``r = split(rng, 4)``: the head's from ``r[0]``, the noise
branch's from ``r[1]``.  Channels-last draws are transposed to the
port's channels-first layout.  No JAX stream is built: the port's stream
is held against its own offline run.

Tolerances: the heads and angles 1e-6 (elementwise float32; the MMD, a
difference of kernel means near 1e-2, rtol 1e-4), the angle round trip
1e-5 (``arccos`` is ill-conditioned near +-1); whole models 2e-5 times the mean
magnitude; the stream against the offline run a median relative error
< 0.02 after the delay (``tests/test_streaming.py``), its exported
program against the live step 1e-6; the train pair rtol 1e-3 on the
losses, the MMD and the ENC/DEC gradient norms.  The pair runs at
``log_epsilon=1e-3``: at the default 1e-7 the fullband distance's STFT of
the fresh decoder's output has near-empty bins, where ``log(|S| + eps)``
turns float32 rounding into most of the gradient (the value agrees to
2e-5, the gradient of the last conv by 40 %; at 1e-3 both to 1e-5, as
the card-vs-CPU checks run, ROADMAP C); and at ``learning_rate=1e-6``,
so that the hinge loss's rounding-noise gradient of each score conv's
bias moves the D step's Adam update by no more than the tolerance
(``tests/test_torch_discrete.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rave_tpu.config import build_config as jbuild
from rave_tpu.models import latent as jlatent
from rave_tpu.models.rave import RAVE as JRAVE
from rave_tpu.train import loop as jloop
from rave_tpu.train import schedules as jsched
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import (load_discriminator_params,
                                    load_flax_params)
from rave_tpu_torch.export.streaming import StreamingRAVE
from rave_tpu_torch.models import latent
from rave_tpu_torch.models.rave import RAVE
from rave_tpu_torch.ops.conv import StreamDraw
from rave_tpu_torch.train import loop
from test_torch_v1 import _wn_params

TINY = ["capacity=4", "ratios=[2,2]", "dilations=[[1,3],[1,3]]",
        "latent_size=4", "noise_augmentation=8", "n_signal=4096",
        "batch_size=2"]
TRAIN = TINY + ["log_epsilon=1e-3", "phase_1_duration=0",
                "update_discriminator_every=2", "stft_scales=[512,256,128]",
                "discriminator.kind=multi_scale",
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


def _normal(key, shape):
    return np.array(jax.random.normal(key, shape, jnp.float32))


def _ref_aug(key, B, T, C, n):
    """The Wasserstein head's reference and augmentation from ``key``,
    channels-first."""
    r1, r2 = jax.random.split(key)
    ref = _normal(r1, (B * T, C)).reshape(B, T, C)
    return _cf(ref), _cf(_normal(r2, (B, T, n)))


def test_wasserstein_and_spherical_heads_match():
    z = np.random.default_rng(0).standard_normal((2, 40, 6)).astype(
        np.float32)
    key = jax.random.PRNGKey(1)
    zw, mmd = jlatent.WassersteinHead(noise_augmentation=5).apply(
        {}, jnp.asarray(z), key)
    ref, aug = _ref_aug(key, 2, 40, 6, 5)
    head = latent.WassersteinHead(5)
    got, got_mmd = head(_cf(z), ref, aug)
    assert got.shape == (2, 11, 40)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1),
                               np.asarray(zw), atol=1e-6)
    assert float(got_mmd) == pytest.approx(float(mmd), rel=1e-4)
    drawn, _ = head(_cf(z), aug=aug, generator=torch.Generator())
    assert drawn.shape == got.shape
    with pytest.raises(ValueError, match="ref or a generator"):
        head(_cf(z))
    zs, reg = jlatent.SphericalHead().apply({}, jnp.asarray(z))
    got, got_reg = latent.SphericalHead()(_cf(z))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1),
                               np.asarray(zs), atol=1e-6)
    assert float(got_reg) == float(reg) == 0.0


def test_discrete_head_augmentation_matches():
    m = jlatent.DiscreteHead(num_quantizers=2, latent_size=6,
                             codebook_size=16, noise_augmentation=3)
    z = np.random.default_rng(2).standard_normal((2, 12, 6)).astype(
        np.float32)
    v = _np(m.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(z)))
    r = np.random.default_rng(3)
    v["quantizer"] = jax.tree.map(
        lambda a: (r.standard_normal(a.shape)).astype(np.float32)
        if a.ndim else np.float32(1.0), v["quantizer"])
    key = jax.random.PRNGKey(4)
    want, diff = m.apply(v, jnp.asarray(z), key)
    head = latent.DiscreteHead(2, 6, 16, noise_augmentation=3)
    for i, layer in enumerate(head.rvq.layers):
        book = v["quantizer"]["rvq"][f"vq{i}"]["codebook"]
        for name in ("embed", "embed_avg", "cluster_size", "inited"):
            getattr(layer.codebook, name).copy_(torch.from_numpy(
                np.array(book[name])))
        layer.codebook._inited_host = None
    aug = _cf(_normal(key, (2, 12, 3)))
    got, got_diff = head(_cf(z), aug=aug)
    assert got.shape == (2, 9, 12)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1),
                               np.asarray(want), atol=1e-6)
    assert float(got_diff) == pytest.approx(float(diff), rel=1e-5)


def test_angles_match_and_round_trip():
    x = np.random.default_rng(5).standard_normal((2, 30, 7)).astype(
        np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    want = np.asarray(jlatent.unit_norm_vector_to_angles(jnp.asarray(x)))
    got = latent.unit_norm_vector_to_angles(torch.from_numpy(x))
    assert got.shape == (2, 30, 6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert float(got.abs().max()) <= 1.0
    back = latent.angles_to_unit_norm_vector(got)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jlatent.angles_to_unit_norm_vector(
            jnp.asarray(want))), atol=1e-6)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)


def _jax_vars(stack, over, B=2, T=4096, seed=3):
    cfg = jbuild(stack, over)
    m = JRAVE(cfg=cfg, train_mode=False)
    x = (np.random.default_rng(seed).standard_normal((B, T, 1)) * 0.3
         ).astype(np.float32)
    v = _np(jax.jit(lambda r, a: m.init(r, a, method=JRAVE.warmup))(
        {"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1),
         "noise": jax.random.PRNGKey(2), "quantizer": jax.random.PRNGKey(3)},
        jnp.asarray(x)))
    return cfg, m, v, x


def _uniform(key, cfg, B, T):
    """The v2 noise branch's draw for ``T`` samples from ``key``."""
    n = 1
    for r in cfg.noise_ratios:
        n *= r
    return torch.from_numpy(np.array(jax.random.uniform(
        key, (B, T // cfg.n_band // n, cfg.n_band, n), jnp.float32,
        -1.0, 1.0)))


def test_decode_resamples_augmentation_before_trailing_channels():
    """``v2`` + ``noise`` + ``wasserstein`` + ``pitch``: ``encode`` gives
    the raw latent and the f0 channel; ``decode`` inserts the
    augmentation between them (JAX: one key for the normal and the noise
    branch's uniform draw)."""
    stack = ["v2", "noise", "wasserstein", "pitch"]
    cfg, m, v, x = _jax_vars(stack, TINY)
    key = jax.random.PRNGKey(8)
    run = jax.jit(lambda v, a, k: (m.apply(v, a, method=JRAVE.encode),
                                   m.apply(v, a, k)))
    z_j, y_j = (np.asarray(a) for a in run(v, jnp.asarray(x), key))
    port = RAVE(build_config(stack, TINY), device="cpu", train_mode=False)
    load_flax_params(port, v["params"])
    assert port.encoded_size() == 5
    aug = _cf(_normal(key, (2, z_j.shape[1], 8)))
    with torch.no_grad():
        z_t = port.encode(torch.from_numpy(x))
        y_t = port.decode(z_t, aug, _uniform(key, cfg, 2, x.shape[1]))
    assert z_t.shape == z_j.shape == (2, 64, 5)
    np.testing.assert_allclose(z_t.numpy(), z_j, atol=1e-5)
    np.testing.assert_allclose(y_t.numpy(), y_j,
                               atol=2e-5 * np.abs(y_j).mean())


def test_discrete_decode_indices_resamples_augmentation():
    over = [o for o in TINY if not o.startswith("latent_size")] + [
        "latent_size=6", "num_quantizers=2", "codebook_size=16"]
    cfg, m, v, x = _jax_vars(["discrete"], over)
    r = np.random.default_rng(6)
    v["quantizer"] = jax.tree.map(
        lambda a: (r.standard_normal(a.shape) * 0.5).astype(np.float32)
        if a.ndim else np.float32(1.0), v["quantizer"])
    key = jax.random.PRNGKey(9)
    run = jax.jit(lambda v, a, k: (
        m.apply(v, a, method=JRAVE.encode_indices),
        m.apply(v, m.apply(v, a, method=JRAVE.encode_indices), k,
                method=JRAVE.decode_indices)))
    idx_j, y_j = (np.asarray(a) for a in run(v, jnp.asarray(x), key))
    port = RAVE(build_config(["discrete"], over), device="cpu",
                train_mode=False)
    load_flax_params(port, v["params"], model_state={
        "quantizer": v["quantizer"]})
    assert port.encoded_size() == 14
    with torch.no_grad():
        idx = port.encode_indices(torch.from_numpy(x))
        y_t = port.decode_indices(idx, _cf(_normal(key, (2, 64, 8))))
        z = port.encode(torch.from_numpy(x), torch.zeros(2, 8, 64))
    np.testing.assert_array_equal(idx.numpy(), idx_j)
    np.testing.assert_allclose(y_t.numpy(), y_j,
                               atol=2e-5 * np.abs(y_j).mean())
    # encode appends the augmentation after the quantized latent
    assert z.shape == (2, 64, 14) and bool((z[..., 6:] == 0).all())


def test_noise_stream_draws_are_fixed_and_serialized(tmp_path):
    """``v2`` + ``noise`` + ``wasserstein``: with zero draws the stream
    follows the offline run with zero draws; with seeded ones it runs,
    stays finite, repeats after ``reset``, and its draws ride in the
    carry of the exported programs and ``cache_init``."""
    stack = ["v2", "noise", "wasserstein"]
    cfg = build_config(stack, TINY)
    torch.manual_seed(0)
    port = RAVE(cfg, device="cpu", train_mode=False)
    x = (np.random.default_rng(7).standard_normal((1, 16384, 1)) * 0.3
         ).astype(np.float32)
    T_z = x.shape[1] // cfg.total_ratio()
    with torch.no_grad():
        off = port(torch.from_numpy(x), torch.zeros(1, 8, T_z),
                   torch.zeros(1, x.shape[1] // 128, 16, 8)).numpy()[0, :, 0]
    quiet = StreamingRAVE(cfg, port.state_dict(), chunk_size=2048,
                          device="cpu", seed=None)
    streamed = quiet.process_file(x[0, :, 0])
    d, n = quiet.total_delay_samples(), len(off)
    start = 2 * d + 256
    a, b = off[start - d:n - d - 256], streamed[start:n - 256]
    assert np.median(np.abs(a - b)) / (np.abs(a).mean() + 1e-9) < 0.02

    sr = StreamingRAVE(cfg, port.state_dict(), chunk_size=2048,
                       device="cpu", seed=3)
    draws = [i for i, m in enumerate(sr.cache_modules)
             if isinstance(m, StreamDraw)]
    assert [sr.cache_modules[i].kind for i in draws] == ["normal", "uniform"]
    assert all(float(sr.init_caches[i].abs().max()) > 0 for i in draws)
    first = sr.process_file(x[0, :8192, 0])
    assert np.isfinite(first).all() and not np.allclose(first,
                                                        streamed[:8192])
    np.testing.assert_array_equal(sr.process_file(x[0, :8192, 0]), first)
    np.testing.assert_array_equal(sr.process_file_scan(x[0, :8192, 0]),
                                  first)
    out = sr.serialize(str(tmp_path))
    init = np.load(out / "cache_init.npz")
    for i in draws:
        np.testing.assert_array_equal(init[f"c{i}"],
                                      sr.init_caches[i].numpy())
    prog = torch.export.load(str(out / "forward.pt2")).module()
    carry = [c.clone() for c in sr.init_caches]
    sr.reset()
    for i in range(2):
        c = torch.from_numpy(x[:, 2048 * i:2048 * (i + 1)])
        y, carry = prog(carry, c)
        np.testing.assert_allclose(y.detach().numpy(), sr.forward(c).numpy(),
                                   atol=1e-6)
    for i in draws:
        assert torch.equal(carry[i], sr.init_caches[i])


def test_spherical_stream_latent_round_trip():
    """``v2`` + ``spherical``: the streamed latent is unit-norm; its angles
    equal the JAX function's, and ``preprocess_latent`` of them decodes
    as the latent itself does."""
    cfg = build_config(["v2", "spherical"], TINY)
    torch.manual_seed(1)
    sr = StreamingRAVE(cfg, RAVE(cfg, device="cpu").state_dict(),
                       chunk_size=2048, device="cpu")
    x = (np.random.default_rng(8).standard_normal((1, 8192, 1)) * 0.3
         ).astype(np.float32)
    for i in range(4):
        z = sr.encode(x[:, 2048 * i:2048 * (i + 1)]).numpy()
        np.testing.assert_allclose(np.linalg.norm(z, axis=-1), 1.0,
                                   atol=1e-5)
        ang = sr.postprocess_latent(z)
        assert ang.shape == (1, 32, 3)
        np.testing.assert_allclose(ang, np.asarray(
            jlatent.unit_norm_vector_to_angles(jnp.asarray(z))), atol=1e-6)
        back = sr.preprocess_latent(ang)
        np.testing.assert_allclose(back, z, atol=1e-5)
    # decode of the round-tripped latent continues the stream
    assert np.isfinite(sr.decode(back).numpy()).all()


def _draws(jcfg, rng):
    """The Wasserstein head's and the noise branch's draws the JAX step
    makes from ``rng``, channels-first."""
    r = jax.random.split(rng, 4)
    B, T_z = jcfg.batch_size, jcfg.n_signal // jcfg.total_ratio()
    ref, aug = _ref_aug(r[0], B, T_z, jcfg.latent_size,
                        jcfg.noise_augmentation)
    return {"ref": ref, "aug": aug,
            "noise": _uniform(r[1], jcfg, B, jcfg.n_signal)}


@pytest.fixture(scope="module")
def pair():
    """One D step then one G step of ``v2`` + ``noise`` + ``wasserstein``
    (``tests/test_train.py``'s config: the ``multi_scale`` discriminator
    at capacity 4, 2 layers) from one initial state in both frameworks,
    the JAX one as one jitted function (the D loss, its Adam update, the
    G loss and its gradient)."""
    stack = ["v2", "noise", "wasserstein"]
    jcfg, cfg = jbuild(stack, TRAIN), build_config(stack, TRAIN)
    jmodel, jdisc = jloop.RAVE(cfg=jcfg), jloop.build_discriminator(jcfg)
    dis_tx = jloop.make_optimizers(jcfg)[2]
    _, _, v, _ = _jax_vars(stack, TRAIN)
    x = (0.1 * np.random.default_rng(0).standard_normal(
        (cfg.batch_size, cfg.n_signal, 1))).astype(np.float32)
    rng = jax.random.PRNGKey(1)
    gen_params = v["params"]
    dis_params = _wn_params(jax.eval_shape(
        jdisc.init, {"params": rng}, jnp.asarray(x))["params"])

    def jrun(gen_params, dis_params, dis_opt, x):
        def dloss(dp):
            out = jloop._forward_losses(jcfg, jmodel, jdisc, gen_params, dp,
                                        {}, {"x": x}, rng, 0)
            ld, _, _ = jloop._gan_terms(jcfg, jdisc, dp, out["x"],
                                        jax.lax.stop_gradient(out["y"]))
            return ld

        ld, gd = jax.value_and_grad(dloss)(dis_params)
        upd, _ = dis_tx.update(gd, dis_opt, dis_params)
        dp1 = optax.apply_updates(dis_params, upd)

        def gloss(gp):
            out = jloop._forward_losses(jcfg, jmodel, jdisc, gp, dp1, {},
                                        {"x": x}, rng, 1)
            _, adv, fm = jloop._gan_terms(jcfg, jdisc, dp1, out["x"],
                                          out["y"])
            reg = out["reg"] * jsched.beta_factor(1, jcfg)
            terms = {**out["dists"], "adversarial": adv,
                     "feature_matching": fm, "regularization": reg}
            return sum(v * jcfg.weights.get(k, 1.0)
                       for k, v in terms.items()), reg

        (lg, reg), gg = jax.value_and_grad(gloss, has_aux=True)(gen_params)
        return ld, lg, reg, gg

    ld, lg, reg, gg = _np(jax.jit(jrun)(gen_params, dis_params,
                                        dis_tx.init(dis_params),
                                        jnp.asarray(x)))
    state = loop.TrainState(cfg, device="cpu")
    load_flax_params(state.model, gen_params)
    load_discriminator_params(state.disc, dis_params)
    draws = _draws(jcfg, rng)
    step = loop.make_train_step(cfg)
    m_d = step(state, {"x": torch.from_numpy(x)}, draws=draws)
    m_g = step(state, {"x": torch.from_numpy(x)}, draws=draws)
    grads = RAVE(cfg, device="cpu")
    load_flax_params(grads, gg)
    return dict(cfg=cfg, state=state, m_d=m_d, m_g=m_g, ld=ld, lg=lg,
                reg=reg, want_grads=dict(grads.named_parameters()), x=x,
                gen_params=gen_params)


def test_wasserstein_pair_matches(pair):
    m_d, m_g = pair["m_d"], pair["m_g"]
    assert float(m_d["loss_dis"]) == pytest.approx(float(pair["ld"]),
                                                   rel=1e-3)
    assert float(m_g["loss_gen_total"]) == pytest.approx(
        float(pair["lg"]), rel=1e-3)
    assert float(m_g["loss_regularization"]) == pytest.approx(
        float(pair["reg"]), rel=1e-3)
    assert float(m_g["loss_regularization"]) > 0
    state, want = pair["state"], pair["want_grads"]
    for group in ("encoder.", "decoder."):
        names = [k for k, _ in state.model.named_parameters()
                 if k.startswith(group)]
        params = dict(state.model.named_parameters())
        got = torch.cat([params[k].grad.flatten() for k in names])
        ref = torch.cat([want[k].detach().flatten() for k in names])
        assert float(got.norm()) == pytest.approx(float(ref.norm()),
                                                  rel=1e-3), group
    assert float(state.model.decoder.noise.net[0].weight.grad.norm()) > 0


def test_wasserstein_eval_step(pair):
    """The eval step of the new head: ``z_mean`` is the raw latent (JAX's
    ``encode_input``), the forward re-samples the augmentation."""
    cfg, state, x = pair["cfg"], pair["state"], pair["x"]
    jm = JRAVE(cfg=jbuild(["v2", "noise", "wasserstein"], TRAIN),
               train_mode=False)
    load_flax_params(state.model, pair["gen_params"])
    z_j = np.asarray(jax.jit(lambda p, a: jm.apply(
        {"params": p}, a, jm.apply({"params": p}, a,
                                   method=JRAVE.pqmf_forward),
        method=JRAVE.encode_input))(pair["gen_params"], jnp.asarray(x)))
    m, y, z = loop.make_eval_step(cfg)(state, {"x": torch.from_numpy(x)})
    assert sorted(m) == ["validation"] and np.isfinite(float(m["validation"]))
    assert y.shape == x.shape and z.shape == z_j.shape == (2, 64, 4)
    np.testing.assert_allclose(z.numpy(), z_j, atol=1e-5)


@pytest.mark.parametrize("stack", [["v1"], ["onnx"], ["raspberry"],
                                   ["v2", "noise"], ["v2", "wasserstein"],
                                   ["v2", "spherical"],
                                   ["discrete", "noise"]],
                         ids=lambda s: "+".join(s))
def test_presets_build(stack):
    """Every preset and toggle of this slice builds a port ``RAVE`` at its
    full width (the discrete one with ``noise_augmentation``)."""
    over = ["noise_augmentation=16"] if stack[0] == "discrete" else []
    model = RAVE(build_config(stack, over), device="cpu")
    assert model.encoded_size() == (
        model.cfg.decoder_latent_size()
        - (0 if stack[0] == "discrete" else model.cfg.noise_augmentation))
