"""The f0-conditioned fork's train step (``v2_fork`` + ``pitch``) against
rave_tpu's, the speaker statistics, and the pitch recipe on the CLI.

One D step (at ``phase_1_duration``) and one G step (at the step after
it) of the tiny fork with a small multi-scale discriminator (the fork's
full-width ``univnet`` + ``melgan_stack`` pair judges each item alone,
never sees the pitch, and is held against the JAX package's train step
by ``tests/test_torch_train.py``), unit CE and the
valid-signal crop, each from the same converted initial state, through
both routes of the statistics: the batch's ``f0_median``/``f0_std``
(the trainer's per-speaker JSON) and per-utterance ones.  The JAX side
is the JAX package's own ``_forward_losses`` and ``_gan_terms`` under
``jax.value_and_grad``, both routes in one compiled function.
Tolerances, as ``tests/test_torch_speaker_train.py`` holds losses within
1e-4 and gradient norms are sums of them: losses and the 2-norms of the
ENC, DEC and DIS gradients rtol 1e-3.  ``compute_speaker_stats`` is
numpy in both packages: equal JSON (rtol 1e-12).  Then ``cli
speaker_stats``, ``cli train --config v2_fork --config pitch
--speaker_stats`` for two steps on the CPU, and ``cli export
--voice_conversion`` of the run.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.config import build_config as jbuild
from rave_tpu.data.pitch import compute_speaker_stats as jstats
from rave_tpu.train import loop as jloop
from rave_tpu_torch import cli
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import (load_discriminator_params,
                                    load_flax_params)
from rave_tpu_torch.data.audio_io import save_wav
from rave_tpu_torch.data.dataset import AudioDataset
from rave_tpu_torch.data.pitch import compute_speaker_stats
from rave_tpu_torch.train import loop, schedules

TINY = ["capacity=4", "n_signal=8192", "batch_size=2", "ratios=[2,2]",
        "dilations=[[1,3],[1,3]]", "discriminator.kind=multi_scale",
        "discriminator.capacity=4", "discriminator.n_layers=2"]
STACK = ["v2_fork", "pitch"]
RTOL = 1e-3
ROUTES = ("speaker_stats", "per_utterance")


@pytest.fixture(autouse=True)
def one_thread():
    """PyTorch on one CPU thread: beside the suite's other workers,
    several threads per process oversubscribe the cores."""
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


def tones(n, T, seed):
    """``n`` gliding harmonic tones ``(n, T)`` with a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 44100
    out = []
    for i in range(n):
        phase = 2 * np.pi * (100 + 70 * i) * (t + 0.8 * t * t)
        x = sum(np.sin(h * phase) / h for h in range(1, 5))
        out.append(0.2 * x + 0.02 * rng.standard_normal(T))
    return np.stack(out).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _norm(tree):
    return float(np.sqrt(sum(float(np.sum(np.square(a)))
                             for a in jax.tree.leaves(tree))))


@pytest.fixture(scope="module")
def parity():
    """Both routes' losses and gradient norms in both frameworks."""
    jcfg, cfg = jbuild(STACK, TINY), build_config(STACK, TINY)
    assert cfg.valid_signal_crop and cfg.pitch_embedding_size == 1
    start = cfg.phase_1_duration
    assert schedules.is_discriminator_step(start, cfg)
    assert not schedules.is_discriminator_step(start + 1, cfg)
    jstate = jloop.init_state(jcfg, jax.random.PRNGKey(0))
    x = tones(2, cfg.n_signal, seed=0)[..., None]
    units = np.random.default_rng(1).integers(0, cfg.hubert_units, (2, 148))
    stats = {"f0_median": np.log([130.0, 210.0]).astype(np.float32),
             "f0_std": np.array([0.25, 0.4], np.float32)}
    batches = {"speaker_stats": {"x": x, "units": units, **stats},
               "per_utterance": {"x": x, "units": units}}

    model, disc = jloop.RAVE(cfg=jcfg), jloop.build_discriminator(jcfg)
    rng = jax.random.PRNGKey(1)

    def forward(gen, dis, batch, step):
        return jloop._forward_losses(jcfg, model, disc, gen, dis,
                                     jstate.model_state, batch, rng, step)

    def g_loss(gen, dis, batch):
        out = forward(gen, dis, batch, start + 1)
        _, adv, fm = jloop._gan_terms(jcfg, disc, dis, out["x"], out["y"])
        terms = {**out["dists"], "adversarial": adv, "feature_matching": fm}
        total = sum(v * jcfg.weights.get(k, 1.0) for k, v in terms.items())
        return total + out["ce"], {"loss_audio": out["dists"]["audio"],
                                   "loss_adversarial": adv,
                                   "loss_feature_matching": fm,
                                   "loss_ce": out["ce"]}

    def d_loss(dis, gen, batch):
        out = forward(gen, dis, batch, start)
        return jloop._gan_terms(jcfg, disc, dis, out["x"],
                                jax.lax.stop_gradient(out["y"]))[0]

    @jax.jit
    def reference(gen, dis, batches):
        res = {}
        for route, batch in batches.items():
            (g_total, g_terms), g_grad = jax.value_and_grad(
                g_loss, has_aux=True)(gen, dis, batch)
            d_total, d_grad = jax.value_and_grad(d_loss)(dis, gen, batch)
            res[route] = dict(g_total=g_total, g_terms=g_terms,
                              g_grad=g_grad, d_total=d_total, d_grad=d_grad)
        return res

    ref = reference(jstate.gen_params, jstate.dis_params,
                    jax.tree.map(jnp.asarray, batches))
    out = {}
    for route, batch in batches.items():
        r = ref[route]
        want = {"loss_gen_total": float(r["g_total"]),
                "loss_dis": float(r["d_total"]),
                **{k: float(v) for k, v in r["g_terms"].items()},
                "enc": _norm([r["g_grad"]["encoder"],
                              r["g_grad"]["ce_projection"]]),
                "dec": _norm(r["g_grad"]["decoder"]),
                "dis": _norm(r["d_grad"])}
        tbatch = {k: torch.from_numpy(np.asarray(v))
                  for k, v in batch.items()}
        got = {}
        for step in (start, start + 1):
            state = loop.TrainState(cfg, device="cpu", step=step)
            load_flax_params(state.model, _np(jstate.gen_params),
                             _np(jstate.model_state["batch_stats"]))
            load_discriminator_params(state.disc, _np(jstate.dis_params))
            m = loop.make_train_step(cfg)(state, tbatch)
            if step == start:
                got["loss_dis"] = float(m["loss_dis"])
                got["dis"] = float(torch.sqrt(sum(
                    (p.grad ** 2).sum() for p in state.disc.parameters())))
            else:
                got.update({k: float(m[k]) for k in want
                            if k.startswith("loss_") and k != "loss_dis"})
                got["enc"] = float(torch.sqrt(sum(
                    (p.grad ** 2).sum() for p in state.enc_params)))
                got["dec"] = float(torch.sqrt(sum(
                    (p.grad ** 2).sum() for p in state.dec_params)))
        out[route] = (got, want)
    return out


@pytest.mark.parametrize("route", ROUTES)
def test_pitch_d_and_g_steps_match_jax(parity, route):
    got, want = parity[route]
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.isfinite(got[k]), k
        assert got[k] == pytest.approx(want[k], rel=RTOL, abs=1e-7), (
            k, got[k], want[k])
    assert want["loss_adversarial"] != 0 and want["dec"] > 0


def test_the_routes_differ(parity):
    """The speaker statistics reach the decoder: the routes' losses and
    decoder gradients differ."""
    a, b = parity["speaker_stats"][0], parity["per_utterance"][0]
    assert a["loss_audio"] != b["loss_audio"] and a["dec"] != b["dec"]


def _corpus(root, speakers=3, clips=2, T=16384):
    """``audio/spk<s>/<k>.wav``: gliding tones, a register per speaker,
    and noise."""
    rng = np.random.default_rng(2)
    for s in range(speakers):
        d = root / "audio" / f"spk{s}"
        d.mkdir(parents=True)
        for k in range(clips):
            x = tones(1, T, seed=10 * s + k)[0] * (0.8 + 0.2 * k)
            x = np.interp(np.arange(T) * (1 + 0.5 * s), np.arange(T), x,
                          period=T).astype(np.float32)
            save_wav(str(d / f"{k}.wav"),
                     x + 0.01 * rng.standard_normal(T), 44100)
    db = root / "db"
    cli.main(["preprocess", "--input_path", str(root / "audio"),
              "--output_path", str(db), "--num_signal", "8192",
              "--num_workers", "1"])
    return db


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return _corpus(tmp_path_factory.mktemp("pitch_db"))


def test_compute_speaker_stats_equals_jax(db, tmp_path):
    from rave_tpu.data.dataset import AudioDataset as JAudioDataset
    got = compute_speaker_stats(AudioDataset(str(db)), str(tmp_path / "t.json"),
                                max_items_per_speaker=3)
    want = jstats(JAudioDataset(str(db)), str(tmp_path / "j.json"),
                  max_items_per_speaker=3)
    assert sorted(got) == sorted(want) == ["spk0", "spk1", "spk2"]
    for name in want:
        for k in ("mean", "std"):
            assert got[name][k] == pytest.approx(want[name][k], rel=1e-12)
    assert json.loads((tmp_path / "t.json").read_text()) == got
    assert len({round(v["mean"], 3) for v in got.values()}) == 3


def test_cli_pitch_recipe_trains(db, tmp_path, capsys):
    """``speaker_stats``, then ``train --config v2_fork --config pitch
    --speaker_stats`` for two steps on the CPU, reading the statistics,
    then ``export --voice_conversion`` of the run."""
    stats = tmp_path / "stats.json"
    cli.main(["speaker_stats", "--db_path", str(db), "--out", str(stats)])
    assert len(json.loads(stats.read_text())) == 3
    over = [a for o in TINY + ["phase_1_duration=1"]
            for a in ("--override", o)]
    cli.main(["train", "--config", "v2_fork", "--config", "pitch", *over,
              "--db_path", str(db), "--out_path", str(tmp_path / "runs"),
              "--speaker_stats", str(stats), "--max_steps", "2",
              "--val_every", "0", "--ckpt_every", "0", "--no_perturb",
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"pitch stats: {stats} (3 speakers)" in out
    assert "finished at step 2" in out
    run = next((tmp_path / "runs").iterdir())
    rec = json.loads((run / "metrics.jsonl").read_text().splitlines()[0])
    assert rec["step"] == 0 and np.isfinite(rec["loss_gen_total"])
    assert json.loads((run / "config.json").read_text())[
        "pitch_embedding_size"] == 1
    wavs = sorted(str(p) for p in (db.parent / "audio").glob("*/0.wav"))
    cli.main(["export", "--run", str(run), "--voice_conversion",
              "--speaker_wavs", *wavs, "--device", "cpu"])
    out = run / "export"
    for f in ("forward.pt2", "convert.pt2", "convert_pg.pt2",
              "convert_pg_manifest.txt", "speaker_table.npy"):
        assert (out / f).exists(), f
    meta = json.loads((out / "convert_meta.json").read_text())
    assert meta["pitch_embedding_size"] == 1 and meta["n_speakers"] == 3
