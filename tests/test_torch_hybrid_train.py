"""The port's hybrid train step against rave_tpu's, the hybrid stream's
exported programs, and the port's CLI ``train --config hybrid`` then
``export``.

The pair: one D step then one G step of the tiny hybrid (mel encoder,
two GRU layers on the decoder's latent; ``tests/test_train.py``'s
``multi_scale`` discriminator at capacity 4, 2 layers) from one initial
state in both frameworks, the JAX one as one jitted function (the D
loss, its Adam update, the G loss and its gradient), the JAX step's
latent noise ``normal(split(rng, 4)[0], (B, T_z, latent))`` fed to the
port, as ``tests/test_torch_latent_heads.py`` runs its pair (one
thread: oneDNN's threaded conv1d data gradient; ``log_epsilon=1e-3``
and ``learning_rate=1e-6``, see there).  Tolerances: losses and the
ENC, DEC and GRU gradient norms rtol 1e-3, as there; the reloaded
``forward.pt2`` against the live step 1e-6 (one program, the same
float32 operations).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rave_tpu.config import build_config as jbuild
from rave_tpu.train import loop as jloop
from rave_tpu.train import schedules as jsched
from rave_tpu_torch import cli
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import (load_discriminator_params,
                                    load_flax_params)
from rave_tpu_torch.data.audio_io import save_wav
from rave_tpu_torch.export.streaming import StreamingRAVE
from rave_tpu_torch.models.rave import RAVE
from rave_tpu_torch.train import loop
from test_torch_hybrid import HYBRID_TINY
from test_torch_v1 import _wn_params

TRAIN = HYBRID_TINY + ["n_signal=4096", "batch_size=2", "log_epsilon=1e-3",
                       "phase_1_duration=0", "update_discriminator_every=2",
                       "stft_scales=[512,256,128]",
                       "discriminator.kind=multi_scale",
                       "discriminator.capacity=4",
                       "discriminator.n_layers=2", "learning_rate=1e-6"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """oneDNN's threaded conv1d data gradient is wrong at some strided
    shapes (``tests/test_torch_train_v2.py``): one thread here."""
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


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jbuild(["hybrid"], TRAIN), build_config(["hybrid"], TRAIN)
    jmodel, jdisc = jloop.RAVE(cfg=jcfg), jloop.build_discriminator(jcfg)
    dis_tx = jloop.make_optimizers(jcfg)[2]
    x = (0.1 * np.random.default_rng(0).standard_normal(
        (cfg.batch_size, cfg.n_signal, 1))).astype(np.float32)
    rng = jax.random.PRNGKey(1)
    gen_params = _np(jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0), "latent": rng,
         "noise": rng}, jnp.asarray(x))["params"])
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
    T_z = cfg.n_signal // cfg.total_ratio()
    eps = np.asarray(jax.random.normal(
        jax.random.split(rng, 4)[0], (cfg.batch_size, T_z, cfg.latent_size),
        jnp.float32))
    eps = torch.from_numpy(np.ascontiguousarray(eps.transpose(0, 2, 1)))
    state = loop.TrainState(cfg, device="cpu")
    load_flax_params(state.model, gen_params)
    load_discriminator_params(state.disc, dis_params)
    step = loop.make_train_step(cfg)
    m_d = step(state, {"x": torch.from_numpy(x)}, eps)
    m_g = step(state, {"x": torch.from_numpy(x)}, eps)
    grads = RAVE(cfg, device="cpu")
    load_flax_params(grads, gg)
    return dict(cfg=cfg, state=state, m_d=m_d, m_g=m_g, ld=ld, lg=lg,
                reg=reg, want_grads=dict(grads.named_parameters()))


def test_hybrid_pair_matches(pair):
    """The D loss, the G total and its KL term, and the gradient norms of
    the encoder, the decoder and the decoder's GRU."""
    m_d, m_g = pair["m_d"], pair["m_g"]
    assert float(m_d["loss_dis"]) == pytest.approx(float(pair["ld"]),
                                                   rel=1e-3)
    assert float(m_g["loss_gen_total"]) == pytest.approx(
        float(pair["lg"]), rel=1e-3)
    assert float(m_g["loss_regularization"]) == pytest.approx(
        float(pair["reg"]), rel=1e-3)
    state, want = pair["state"], pair["want_grads"]
    params = dict(state.model.named_parameters())
    for group in ("encoder.", "decoder.", "decoder.gru."):
        names = [k for k in params if k.startswith(group)]
        got = torch.cat([params[k].grad.flatten() for k in names])
        ref = torch.cat([want[k].detach().flatten() for k in names])
        assert float(ref.norm()) > 0, group
        assert float(got.norm()) == pytest.approx(float(ref.norm()),
                                                  rel=1e-3), group
    # the GRU keeps flax's cell: no hidden bias for the r and z gates
    assert not any("bias_hh" in k for k in params)


def test_hybrid_serialize_reloads(pair, tmp_path):
    """``serialize`` of the hybrid stream (the mel context and the GRU
    states among its caches) on the CPU: ``forward.pt2`` reloaded and
    run from ``cache_init`` against the live step over 4 chunks, the
    manifest's ranks those of the caches."""
    cfg = build_config(["hybrid"], HYBRID_TINY)
    sr = StreamingRAVE(cfg, pair["state"].model.state_dict(),
                       chunk_size=1024, device="cpu")
    out = sr.serialize(str(tmp_path))
    prog = torch.export.load(str(out / "forward.pt2")).module()
    init = np.load(out / "cache_init.npz")
    carry = [torch.from_numpy(init[f"c{i}"]) for i in range(len(init))]
    ranks = [line.split()[3] for line in
             (out / "io_manifest.txt").read_text().splitlines()[1:]
             if line.startswith("in ")]
    assert ranks[:-1] == [str(c.dim()) for c in sr.init_caches]
    assert {c.dim() for c in sr.init_caches} == {2, 3}
    x = (0.3 * np.random.default_rng(3).standard_normal((1, 4096, 1))
         ).astype(np.float32)
    sr.reset()
    for i in range(4):
        c = torch.from_numpy(x[:, 1024 * i:1024 * (i + 1)])
        y, carry = prog(carry, c)
        np.testing.assert_allclose(y.detach().numpy(), sr.forward(c).numpy(),
                                   atol=1e-6)
    for got, want in zip(carry, sr.caches):
        np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                                   atol=1e-6)
    # a chunk on the total stride (64) but off the mel hop
    with pytest.raises(ValueError, match="multiple of mel_hop 48"):
        StreamingRAVE(build_config(["hybrid"], HYBRID_TINY + ["mel_hop=48"]),
                      pair["state"].model.state_dict(), chunk_size=1024,
                      device="cpu")


def test_cli_trains_and_exports_hybrid(tmp_path, capsys):
    """``python -m rave_tpu_torch.cli`` preprocess, ``train --config
    hybrid`` for 3 steps, then ``export`` at chunk 1024, as
    ``tests/test_cli_e2e.py`` drives the JAX package; the exported
    ``forward`` runs from its initial caches."""
    rng = np.random.default_rng(0)
    t = np.arange(16384) / 44100
    for s in range(2):
        d = tmp_path / "audio" / f"spk{s}"
        d.mkdir(parents=True)
        save_wav(str(d / "0.wav"), 0.3 * np.sin(2 * np.pi * 150 * (s + 1) * t)
                 + 0.02 * rng.standard_normal(len(t)), 44100)
    db, runs = str(tmp_path / "db"), str(tmp_path / "runs")
    cli.main(["preprocess", "--input_path", str(tmp_path / "audio"),
              "--output_path", db, "--num_signal", "4096",
              "--num_workers", "1"])
    over = [a for o in HYBRID_TINY + [
        "n_signal=4096", "batch_size=2", "phase_1_duration=2",
        "update_discriminator_every=2", "valid_signal_crop=false",
        "stft_scales=[512,256]", "discriminator.kind=multi_scale",
        "discriminator.capacity=4", "discriminator.n_layers=2"]
        for a in ("--override", o)]
    cli.main(["train", "--config", "hybrid", *over, "--db_path", db,
              "--name", "hyb", "--out_path", runs, "--max_steps", "3",
              "--val_every", "0", "--ckpt_every", "0", "--device", "cpu"])
    assert "finished at step 3" in capsys.readouterr().out
    run = next((tmp_path / "runs").glob("hyb_*"))
    cli.main(["export", "--run", str(run), "--chunk_size", "1024",
              "--device", "cpu"])
    out = run / "export"
    meta = json.loads((out / "meta.json").read_text())
    assert meta["total_delay_samples"] > 0 and meta["config"] == "hybrid"
    for name in ("forward", "encode", "decode"):
        assert (out / f"{name}.pt2").exists()
    prog = torch.export.load(str(out / "forward.pt2")).module()
    init = np.load(out / "cache_init.npz")
    caches = [torch.from_numpy(init[f"c{i}"]) for i in range(len(init))]
    y, _ = prog(caches, torch.zeros(1, 1024, 1))
    assert y.shape == (1, 1024, 1) and bool(torch.isfinite(y).all())
