"""The port's realtime host, the export and eval commands on a run dir,
and the speaker-embedding evaluation, on the CPU in float32.

``NativeRing`` is built with g++ from ``rave_tpu_torch/csrc/
ringbuffer.cpp`` and takes the JAX package's wraparound case;
``RealtimeHost`` passes audio through (an identity model, then a tiny v2
stream, equal to ``process_file`` bit for bit), waiting on
``blocks_processed`` with a 60 s deadline.  A tiny ``v2_fork`` run
directory is written directly with the port's ``CheckpointManager``,
``save_config`` and ``save_latent_stats`` on converted parameters (no
training): ``compute_speaker_embeddings`` of its db equals the JAX
model's ``pqmf_forward`` + ``speaker_embedding`` of the same items (atol
1e-5 times their largest magnitude, as
``tests/test_torch_voice_conversion.py``); ``project_2d`` equals the JAX
function; ``export`` (with and without ``--voice_conversion``) and
``eval`` run through ``python -m rave_tpu_torch.cli``'s ``main``, and the
exported ``forward.pt2`` equals the run's live stream bit for bit.
"""
import json
import os
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from rave_tpu.config import build_config as jbuild
from rave_tpu.models.rave import RAVE as JRAVE
from rave_tpu.train.eval_viz import project_2d as jproject_2d
from rave_tpu_torch import cli
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import load_flax_params
from rave_tpu_torch.data.audio_io import save_wav
from rave_tpu_torch.data.dataset import AudioDataset, preprocess
from rave_tpu_torch.export.realtime import NativeRing, RealtimeHost
from rave_tpu_torch.export.streaming import (StreamingRAVE, load_run,
                                             run_params)
from rave_tpu_torch.models.rave import RAVE
from rave_tpu_torch.ops.kernels.build import BUILD_DIR
from rave_tpu_torch.train import checkpoint, loop
from rave_tpu_torch.train.eval_viz import (compute_speaker_embeddings,
                                           project_2d)
from rave_tpu_torch.train.latent_stats import (fit_latent_pca,
                                               save_latent_stats)

FORK = ["capacity=4", "n_signal=8192", "ratios=[2,2]",
        "dilations=[[1,3],[1,3]]"]
CHUNK = 2048
DEADLINE_S = 60.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread and one OpenMP thread (sklearn's t-SNE): beside
    the suite's other workers, more threads oversubscribe the cores and a
    tiny step or a 20-point t-SNE takes minutes."""
    threads = torch.get_num_threads()
    omp = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    # and in the subprocesses this module starts
    os.environ["OMP_NUM_THREADS"] = "1"
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)
    if omp is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = omp


def _wait(cond):
    deadline = time.monotonic() + DEADLINE_S
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.002)
    assert cond(), "timed out"


def test_native_ring_buffer_wraparound():
    rb = NativeRing(1024)
    assert any(BUILD_DIR.glob("libringbuffer-*.so"))
    x = np.arange(300, dtype=np.float32)
    assert rb.write(x) == 300
    assert rb.readable() == 300
    np.testing.assert_array_equal(rb.read(200), x[:200])
    y = np.arange(900, dtype=np.float32)
    assert rb.write(y) == 900
    np.testing.assert_array_equal(rb.read(1000),
                                  np.concatenate([x[200:], y]))
    assert rb.write(np.zeros(2000, np.float32)) == 1024


def test_realtime_host_passthrough():
    class Identity:
        def forward(self, x):
            return x

    host = RealtimeHost(Identity(), chunk=256, ring_seconds=0.5, sr=16000)
    host.start()
    try:
        x = np.random.default_rng(0).standard_normal(1024).astype(np.float32)
        assert host.push(x) == 1024
        _wait(lambda: host.blocks_processed == 4)
    finally:
        host.stop()
    np.testing.assert_array_equal(host.pull(1024), x)
    assert host.underruns == 0 and len(host.block_ms) == 4
    assert len(host.pull(1)) == 1 and host.underruns == 1


def test_realtime_host_streams_like_process_file():
    cfg = build_config(["v2"], FORK)
    ts = StreamingRAVE(cfg, RAVE(cfg, device="cpu").state_dict(),
                       chunk_size=CHUNK, device="cpu")
    x = (np.random.default_rng(1).standard_normal(4 * CHUNK) * 0.3
         ).astype(np.float32)
    want = ts.process_file(x)
    ts.reset()
    host = RealtimeHost(ts, chunk=CHUNK)
    host.start()
    try:
        host.push(x)
        _wait(lambda: host.blocks_processed == 4)
    finally:
        host.stop()
    np.testing.assert_array_equal(host.pull(4 * CHUNK), want)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A tiny fork run dir (config, one checkpoint, latent stats) on
    converted parameters, its db of 2 speakers x 2 records, and the JAX
    variables."""
    root = tmp_path_factory.mktemp("run")
    jcfg = jbuild(["v2_fork"], FORK)
    m = JRAVE(cfg=jcfg, train_mode=False)
    v = jax.jit(lambda r, a: m.init(r, a, method=JRAVE.warmup))(
        {"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1),
         "noise": jax.random.PRNGKey(2)}, jnp.zeros((1, 8192, 1)))
    v = jax.tree.map(np.asarray, v)
    cfg = build_config(["v2_fork"], FORK)
    state = loop.TrainState(cfg, device="cpu")
    load_flax_params(state.model, v["params"], v["batch_stats"])
    state.step = 3
    rdir = root / "runs" / "fork"
    checkpoint.save_config(rdir, cfg)
    checkpoint.CheckpointManager(rdir).save(state)
    save_latent_stats(rdir, fit_latent_pca(
        np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)))
    rng = np.random.default_rng(2)
    t = np.arange(16384) / 44100
    wavs = []
    for s, f0 in enumerate((110.0, 230.0)):
        d = root / "audio" / f"spk{s}"
        d.mkdir(parents=True)
        x = sum(np.sin(2 * np.pi * h * f0 * t) / h for h in range(1, 5))
        wavs.append(str(d / "0.wav"))
        save_wav(wavs[-1], 0.2 * x + 0.02 * rng.standard_normal(len(t)),
                 44100)
    db = root / "db"
    preprocess(str(root / "audio"), str(db), n_signal=8192, num_workers=1)
    return types.SimpleNamespace(
        dir=rdir, db=db, wavs=wavs, cfg=cfg, model=m,
        variables={"params": v["params"], "batch_stats": v["batch_stats"]})


def test_project_2d_matches_jax():
    embs = np.random.default_rng(3).standard_normal((20, 16)).astype(
        np.float32)
    np.testing.assert_allclose(project_2d(embs), jproject_2d(embs),
                               atol=1e-4)


def test_compute_speaker_embeddings_matches_jax(run):
    embs, spks = compute_speaker_embeddings(str(run.dir), str(run.db),
                                            device="cpu")
    assert embs.shape == (4, 256) and spks.tolist() == [0, 0, 1, 1]
    ds = AudioDataset(str(run.db), n_signal=8192)
    x = np.stack([np.asarray(ds[i]["x"], np.float32) for i in range(4)])
    x = x[..., None] if x.ndim == 2 else x
    bands = run.model.apply(run.variables, jnp.asarray(x),
                            method=JRAVE.pqmf_forward)
    want = np.asarray(run.model.apply(run.variables, bands,
                                      method=JRAVE.speaker_embedding))
    np.testing.assert_allclose(embs, want, atol=1e-5 * np.abs(want).max())


def test_export_and_eval_commands(run):
    out = run.dir / "export"
    cli.main(["export", "--run", str(run.dir), "--device", "cpu"])
    names = {p.name for p in out.iterdir()}
    assert {"forward.pt2", "encode.pt2", "decode.pt2", "cache_init.npz",
            "cache_init.bin", "io_manifest.txt", "meta.json"} == names
    cli.main(["export", "--run", str(run.dir), "--voice_conversion",
              "--speaker_wavs", *run.wavs, "--device", "cpu"])
    assert {"convert.pt2", "spk_embed.pt2", "convert_manifest.txt",
            "convert_cache_init.bin", "convert_meta.json",
            "speaker_table.npy"} <= {p.name for p in out.iterdir()}
    assert np.load(out / "speaker_table.npy").shape == (2, 256)

    # the exported forward step is the run's live stream
    cfg, state = load_run(str(run.dir), device="cpu")
    assert state.step == 3
    live = StreamingRAVE(cfg, run_params(state), chunk_size=CHUNK,
                         device="cpu")
    fwd = torch.export.load(out / "forward.pt2").module()
    with np.load(out / "cache_init.npz") as f:
        caches = [torch.from_numpy(f[f"c{i}"]) for i in range(len(f.files))]
    x = (np.random.default_rng(4).standard_normal((1, 2 * CHUNK, 1)) * 0.3
         ).astype(np.float32)
    with torch.no_grad():
        for i in range(0, 2 * CHUNK, CHUNK):
            xc = torch.from_numpy(x[:, i:i + CHUNK])
            y, caches = fwd(caches, xc)
            assert torch.equal(y, live.forward(xc))

    cli.main(["eval", "--run", str(run.dir), "--db_path", str(run.db),
              "--device", "cpu"])
    res = json.loads((run.dir / "speaker_embeddings.json").read_text())
    assert np.asarray(res["points"]).shape == (4, 2)
    assert res["speakers"] == [0, 0, 1, 1]
