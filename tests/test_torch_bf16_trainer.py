"""The ``train`` command with ``compute_dtype=bfloat16`` on the CPU, for
the upstream presets whose data a plain preprocessed db holds: three
steps from ``phase_1_duration`` with a validation, finite records, the
run's last checkpoint holding float32 tensors only, and ``load_run``
restoring it into float32 parameters under the bf16 config.

Each preset's bf16 step is held against the JAX package's by
``tests/test_torch_bf16_presets_*.py`` and
``tests/test_torch_bf16_train.py``; this holds the command around it.  The fork's bf16 command (HuBERT units
and perturbation variants in its db) runs on the card, ``chip_smoke.py``
18(e).  No JAX.
"""
import json
import math
import os

import numpy as np
import pytest
import torch

from rave_tpu_torch import cli
from rave_tpu_torch.data.audio_io import save_wav
from rave_tpu_torch.export.streaming import load_run

TINY = ["capacity=4", "n_signal=8192", "batch_size=2", "ratios=[2,2]",
        "phase_1_duration=0", "discriminator.kind=multi_scale",
        "discriminator.capacity=4", "discriminator.n_layers=2",
        "compute_dtype=bfloat16"]
PRESETS = {
    "v1": ["latent_size=8"],
    "v2": ["dilations=[[1,3],[1,3]]"],
    "v3": ["dilations=[[1,3],[1,3]]", "latent_size=8"],
    "discrete": ["dilations=[[1,3],[1,3]]", "latent_size=8",
                 "num_quantizers=2", "codebook_size=32",
                 "valid_signal_crop=false", "stft_scales=[512,256,128]"],
}
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """PyTorch on one CPU thread here and in the loader's workers: beside
    the suite's other workers, more oversubscribe the cores."""
    threads = torch.get_num_threads()
    omp = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if omp is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = omp


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """Eight clips of harmonic tones, preprocessed into 8192-sample
    records."""
    root = tmp_path_factory.mktemp("bf16_trainer")
    (root / "audio").mkdir()
    rng = np.random.default_rng(0)
    t = np.arange(16384) / 44100
    for k in range(8):
        f0 = 90 * 1.3 ** k
        x = sum(np.sin(2 * np.pi * h * f0 * t) / h for h in range(1, 6))
        save_wav(str(root / "audio" / f"{k}.wav"),
                 0.2 * x + 0.02 * rng.standard_normal(len(t)), 44100)
    out = str(root / "db")
    cli.main(["preprocess", "--input_path", str(root / "audio"),
              "--output_path", out, "--num_signal", "8192",
              "--num_workers", "1"])
    return out


def _floats(tree) -> set:
    """The dtypes of every floating tensor in a nested checkpoint."""
    if torch.is_tensor(tree):
        return {tree.dtype} if tree.is_floating_point() else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_floats(v) for v in tree))
    return set()


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_cli_trains_in_bf16(db, tmp_path, capsys, preset):
    over = [a for o in TINY + PRESETS[preset] for a in ("--override", o)]
    cli.main(["train", "--config", preset, *over, "--db_path", db,
              "--out_path", str(tmp_path), "--max_steps", str(STEPS),
              "--val_every", "2", "--ckpt_every", "0", "--num_workers",
              "1", "--device", "cpu"])
    assert f"finished at step {STEPS}" in capsys.readouterr().out
    run = next(tmp_path.iterdir())
    recs = [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]
    assert any("validation" in r for r in recs)
    assert all(math.isfinite(v) for r in recs for v in r.values()
               if isinstance(v, float)), recs
    saved = torch.load(run / "checkpoints" / f"ckpt_{STEPS}.pt",
                       weights_only=True)
    assert _floats(saved) == {torch.float32}
    cfg, state = load_run(str(run), device="cpu")
    assert cfg.compute_dtype == "bfloat16" and state.step == STEPS
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
