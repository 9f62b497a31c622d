"""The port's checkpoints, trainer and CLI on the CPU, at a tiny fork
(capacity 4, 8192-sample records, batch 4): exact resume of the full
train state, and ``python -m rave_tpu_torch.cli`` preprocess, perturb,
units and train past ``phase_1_duration`` with validation, conversion
metrics, ``last`` and ``best`` checkpoints and ``--resume``.  No JAX:
the step itself is held against the JAX package by
``tests/test_torch_speaker_train*.py``.
"""
import json
import os

import numpy as np
import pytest
import torch

from rave_tpu_torch import cli
from rave_tpu_torch.config import build_config
from rave_tpu_torch.data.audio_io import save_wav
from rave_tpu_torch.train import checkpoint, loop, trainer


@pytest.fixture(autouse=True)
def one_thread():
    """PyTorch on one CPU thread: the tiny steps gain nothing from more,
    and beside the suite's other workers several threads per process
    oversubscribe the cores (a step then takes seconds instead of tens
    of milliseconds)."""
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


# a small multi-scale discriminator: the fork's full-width univnet and
# MelGAN stack (138 MB, twice that again in Adam's moments) would only
# make every step and checkpoint here slower
TINY = ["capacity=4", "n_signal=8192", "batch_size=4", "ratios=[2,2]",
        "dilations=[[1,3],[1,3]]", "discriminator.kind=multi_scale",
        "discriminator.capacity=4", "discriminator.n_layers=2"]
SPK = ["train_speaker_encoder=true", "speaker_classes=4"]
OVERRIDES = [a for o in TINY + SPK + ["phase_1_duration=4"]
             for a in ("--override", o)]


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    x = torch.tensor(0.1 * rng.standard_normal((4, cfg.n_signal, 1)),
                     dtype=torch.float32)
    return {"x": x, "x_perturbed": 0.9 * x,
            "units": torch.tensor(rng.integers(0, 100, (4, 9))),
            "speaker": torch.arange(4)}


def _flat(sd, prefix=""):
    """Every tensor and number of a nested state dict, by path."""
    out = {}
    if torch.is_tensor(sd) or not isinstance(sd, (dict, list, tuple)):
        return {prefix: sd}
    items = sd.items() if isinstance(sd, dict) else enumerate(sd)
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def _assert_same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        if torch.is_tensor(fa[k]):
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


@pytest.mark.parametrize("extra", [[], ["speaker_norm=batch",
                                        "ema_decay=0.9"]])
def test_checkpoint_restores_the_state_exactly(tmp_path, extra):
    """Saved after a D and a G step (the BatchNorm copy with an EMA),
    restored into a fresh state: equal bit for bit, and the next step
    from either equal bit for bit."""
    cfg = build_config(["v2_fork"], TINY + SPK + extra)
    torch.manual_seed(0)
    state = loop.TrainState(cfg, device="cpu", step=cfg.phase_1_duration)
    step = loop.make_train_step(cfg)
    for i in range(2):
        step(state, _batch(cfg, i))
    mgr = checkpoint.CheckpointManager(tmp_path)
    mgr.save(state, {"validation": 1.5})
    torch.manual_seed(1)
    fresh = loop.TrainState(cfg, device="cpu", seed=7)
    mgr.restore(fresh)
    _assert_same(checkpoint.state_dict(fresh), checkpoint.state_dict(state))
    assert fresh.step == cfg.phase_1_duration + 2
    assert fresh.model.speaker_encoder.train_bn == ("speaker_norm=batch"
                                                    in extra)
    batch = _batch(cfg, 9)
    m1, m2 = step(state, batch), step(fresh, batch)
    assert {k: float(v) for k, v in m1.items()} == {
        k: float(v) for k, v in m2.items()}
    _assert_same(checkpoint.state_dict(fresh), checkpoint.state_dict(state))
    # the best copy of that step sits in its own directory
    best = loop.TrainState(cfg, device="cpu")
    mgr.restore_best(best)
    assert best.step == cfg.phase_1_duration + 2


def test_checkpoint_manager_keeps_the_last_and_the_best(tmp_path):
    cfg = build_config(["v2_fork"], TINY)
    state = loop.TrainState(cfg, device="cpu")
    mgr = checkpoint.CheckpointManager(tmp_path, keep=2)
    for step, v in ((1, 3.0), (2, 1.0), (3, 2.0), (4, float("nan"))):
        state.step = step
        mgr.save(state, {"validation": v})
        mgr.save(state)   # a second save of one step is a no-op
    ck = tmp_path / "checkpoints"
    assert sorted(p.name for p in ck.glob("ckpt_*.pt")) == [
        "ckpt_3.pt", "ckpt_4.pt"]
    assert [p.name for p in (ck / "best").glob("*.pt")] == ["ckpt_2.pt"]
    assert json.loads((ck / "best_metric.json").read_text()) == {
        "best": 1.0, "step": 2}
    assert checkpoint.CheckpointManager(tmp_path).latest_step() == 4
    with pytest.raises(FileNotFoundError):
        checkpoint.CheckpointManager(tmp_path / "none").restore(state)


def test_put_and_ema_view():
    put = trainer.make_put(torch.device("cpu"))
    b = put({"x": np.zeros((2, 8, 1), np.float32),
             "speaker": np.array([0, 1], np.int32)})
    assert b["x"].dtype == torch.float32 and b["speaker"].dtype == torch.int64
    cfg = build_config(["v2_fork"], TINY + ["ema_decay=0.5"])
    state = loop.TrainState(cfg, device="cpu")
    w = state.model.decoder.layers[0].v
    before = w.detach().clone()
    state.ema = {k: v + 1 for k, v in state.ema.items()}
    with trainer.ema_eval_view(cfg, state):
        assert torch.equal(w, before + 1)
    assert torch.equal(w, before)


def test_cli_refusals(tmp_path):
    # every command is ported; those that were not parse their flags
    assert cli.NOT_PORTED == {}
    parser = cli.build_parser()
    for argv in (["speaker_stats", "--db_path", "db", "--pitch_ckpt", "f"],
                 ["validate_assets", "--out", "r.md"],
                 ["remote_dataset", "--db_path", "db", "--port", "0"]):
        assert parser.parse_args(argv).command == argv[0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["train", "--db_path", str(tmp_path)])
    # --multihost joins the ranks torchrun starts: without its
    # environment it raises (tests/test_torch_parallel.py runs it)
    with pytest.raises(RuntimeError, match="start the ranks with torchrun"):
        cli.main(["train", "--db_path", str(tmp_path), "--multihost",
                  "--device", "cpu"])


def test_cli_trains_validates_and_resumes(tmp_path, capsys):
    rng = np.random.default_rng(0)
    t = np.arange(16384) / 44100
    for s in range(4):
        d = tmp_path / "audio" / f"spk{s}"
        d.mkdir(parents=True)
        for k in range(2):
            f0 = 90 * 1.6 ** s * (1 + 0.02 * k)
            x = sum(np.sin(2 * np.pi * h * f0 * t) / h for h in range(1, 6))
            save_wav(str(d / f"{k}.wav"),
                     0.2 * x + 0.02 * rng.standard_normal(len(t)), 44100)
    db, runs = str(tmp_path / "db"), str(tmp_path / "runs")
    cli.main(["preprocess", "--input_path", str(tmp_path / "audio"),
              "--output_path", db, "--num_signal", "8192",
              "--num_workers", "1"])
    cli.main(["perturb", "--db_path", db, "--variants", "2",
              "--num_workers", "1"])
    cli.main(["units", "--db_path", db])
    train = ["train", "--config", "v2_fork", *OVERRIDES, "--db_path", db,
             "--out_path", runs, "--val_every", "6", "--ckpt_every", "6",
             "--device", "cpu"]
    cli.main(train + ["--max_steps", "8", "--num_workers", "2",
                      "--profile"])
    out = capsys.readouterr().out
    assert "using 2 precomputed perturbation variants" in out
    assert "finished at step 8" in out and "load: total" in out
    run = next((tmp_path / "runs").iterdir())
    recs = [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]
    assert recs[0]["step"] == 0 and recs[0]["loss_speaker_ce"] > 0
    val = next(r for r in recs if "validation" in r)
    assert np.isfinite(val["validation"]) and "val_unit_ce" in val
    assert {"conversion_spk_cos_target", "conversion_spk_cos_source",
            "conversion_spk_cos_pair"} <= set(val)
    ck = run / "checkpoints"
    assert sorted(p.name for p in ck.glob("ckpt_*.pt")) == [
        "ckpt_7.pt", "ckpt_8.pt"]
    assert [p.name for p in (ck / "best").glob("*.pt")] == ["ckpt_7.pt"]
    assert (run / "latent_stats.npz").exists()
    assert (run / "audio" / "step6_conversion.wav").exists()
    saved = torch.load(ck / "ckpt_8.pt", weights_only=True)

    cli.main(train + ["--max_steps", "10", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 8" in out and "finished at step 10" in out
    cfg = build_config(["v2_fork"], TINY + SPK + ["phase_1_duration=4"])
    restored = loop.TrainState(cfg, device="cpu")
    checkpoint.CheckpointManager(run).restore(restored, step=8)
    _assert_same(checkpoint.state_dict(restored), saved)
