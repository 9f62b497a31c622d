"""The port CLI's last commands and the receptive-field probe, against
rave_tpu, on the CPU.

``remote_dataset`` serves a tiny db on a free localhost port (the CLI
in a subprocess, and ``serve_dataset`` in the process), read back by the
port's client and the JAX package's; ``validate_assets`` writes its
report under ``tmp_path`` only and gives the JAX package's per-asset
statuses; ``measure_receptive_field`` on tiny ``v2`` equals the JAX
probe's (integers: exactly); every JAX subcommand and flag parses in the
port.
"""
import os
import re
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu import cli as jcli
from rave_tpu.config import build_config as jbuild
from rave_tpu.data.remote import HTTPAudioDataset as JHTTPAudioDataset
from rave_tpu.models.rave import RAVE as JRAVE
from rave_tpu.models.latent import VariationalHead as JVariationalHead
from rave_tpu.utils import assets as jassets
from rave_tpu.utils.receptive_field import (
    measure_receptive_field as jmeasure)
from rave_tpu_torch import cli
from rave_tpu_torch.config import build_config
from rave_tpu_torch.convert import load_flax_params
from rave_tpu_torch.data.audio_io import save_wav
from rave_tpu_torch.data.dataset import AudioDataset
from rave_tpu_torch.data.remote import HTTPAudioDataset, serve_dataset
from rave_tpu_torch.models.rave import RAVE
from rave_tpu_torch.train.loop import receptive_field_frames
from rave_tpu_torch.utils import assets
from rave_tpu_torch.utils.receptive_field import measure_receptive_field

REPO = Path(__file__).resolve().parent.parent
TINY = ["capacity=4", "n_signal=8192", "ratios=[2,2]",
        "dilations=[[1,3],[1,3]]"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch thread: beside the suite's other workers, more
    oversubscribe the cores (ROADMAP A, Tier-1 room)."""
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


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """Two speakers x one 16384-sample clip: four 8192-sample items."""
    root = tmp_path_factory.mktemp("remote")
    rng = np.random.default_rng(0)
    for s in range(2):
        d = root / "audio" / f"spk{s}"
        d.mkdir(parents=True)
        save_wav(str(d / "0.wav"),
                 (0.3 * rng.standard_normal(16384)).astype(np.float32), 44100)
    cli.main(["preprocess", "--input_path", str(root / "audio"),
              "--output_path", str(root / "db"), "--num_signal", "8192",
              "--num_workers", "1"])
    return root / "db"


def _same_items(remote, ds):
    """Items 0..3 read once each, in order, against ``ds``'s: the server's
    dataset draws its augmentation from a generator seeded as ``ds``'s,
    so the same requests in the same order give the same items, as int16
    samples."""
    assert len(remote) == len(ds) == 4
    assert (remote.n_signal, remote.sr) == (ds.n_signal, ds.sr)
    speakers = set()
    for i in range(4):
        got, want = remote[i], ds[i]
        q = (np.clip(want["x"], -1, 1) * 32767).astype(np.int16) / 32768.0
        np.testing.assert_array_equal(got["x"], q.astype(np.float32))
        assert got["speaker"] == want["speaker"]
        speakers.add(int(got["speaker"]))
    assert speakers == {0, 1}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_remote_dataset_command_serves_the_db(db):
    """``python -m rave_tpu_torch.cli remote_dataset`` on a free localhost
    port: the port's and the JAX package's clients read the db's items."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "rave_tpu_torch.cli", "remote_dataset",
         "--db_path", str(db), "--host", "127.0.0.1", "--port", str(port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, text=True)
    try:
        assert "serving 4 items" in proc.stdout.readline()
        url = f"http://127.0.0.1:{port}"
        ds = AudioDataset(str(db))   # seeded as the command's
        _same_items(HTTPAudioDataset(url), ds)
        _same_items(JHTTPAudioDataset(url), ds)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()


def test_serve_dataset_in_process_and_404(db):
    import urllib.error
    import urllib.request
    server = serve_dataset(AudioDataset(str(db)), host="127.0.0.1", port=0)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        _same_items(HTTPAudioDataset(url), AudioDataset(str(db)))
        for path in ("/get/x", "/nothing"):
            with pytest.raises(urllib.error.HTTPError, match="404"):
                urllib.request.urlopen(url + path, timeout=10)
    finally:
        server.shutdown()
        server.server_close()


def _no_env(monkeypatch):
    for k in ("RAVE_TPU_FCPE_CKPT", "RAVE_TPU_HUBERT_CKPT"):
        monkeypatch.delenv(k, raising=False)


def test_validate_assets_absent_report_under_tmp(monkeypatch, tmp_path,
                                                 capsys):
    """No assets: every row ``absent``, as the JAX package's; the report
    goes to ``--out``, and the repository's report is left as it is."""
    _no_env(monkeypatch)
    repo_report = REPO / assets.DEFAULT_REPORT
    before = repo_report.read_bytes() if repo_report.exists() else None
    out = tmp_path / "report.md"
    cli.main(["validate_assets", "--out", str(out), "--device", "cpu"])
    text = out.read_text()
    assert "validate_assets" in text and text.count("**absent**") == 3
    assert "report: " + str(out) in capsys.readouterr().out
    want = jassets.validate_assets_main(SimpleNamespace(
        fcpe_ckpt=None, hubert_ckpt=None, speaker_ckpt=None, db_path=None,
        out=str(tmp_path / "jax.md")))
    got = [assets.validate_fcpe(None), assets.validate_hubert(None, None),
           assets.validate_speaker(None)]
    assert [(r["asset"], r["status"]) for r in got] == \
        [(r["asset"], r["status"]) for r in want]
    after = repo_report.read_bytes() if repo_report.exists() else None
    assert after == before


def test_validate_assets_checkpoints_match_jax(db, tmp_path):
    """A random-weight FCPE checkpoint in torchfcpe's layout (read, but
    not tracking pitch), an unreadable file, and a TorchScript stand-in
    for HuBERT beside the mel units: the statuses the JAX package gives,
    and the same f0 median."""
    from test_torch_fcpe import torchfcpe_mirror
    ck = tmp_path / "fcpe.pt"
    torch.save({"model": torchfcpe_mirror().state_dict()}, ck)
    got, want = assets.validate_fcpe(str(ck), "cpu"), \
        jassets.validate_fcpe(str(ck))
    assert got["status"] == want["status"]
    assert "strict read ok" in got["detail"]
    assert got["f0_median"] == pytest.approx(want["f0_median"], rel=1e-4)
    bad = tmp_path / "bad.pt"
    bad.write_bytes(b"not a checkpoint")
    assert assets.validate_fcpe(str(bad), "cpu")["status"] == \
        jassets.validate_fcpe(str(bad))["status"] == "FAIL"
    assert assets.validate_hubert(str(bad), None)["status"] == \
        jassets.validate_hubert(str(bad), None)["status"] == "skipped"

    class Frames(torch.nn.Module):
        def forward(self, x):   # (1, T) -> (1, T // 320, 8)
            T = x.shape[1] - x.shape[1] % 320
            return x[:, :T].reshape(1, -1, 8, 40).abs().mean(-1)

    hub = tmp_path / "hubert.pt"
    torch.jit.script(Frames()).save(str(hub))
    got = assets.validate_hubert(str(hub), str(db), num_units=4, max_items=4)
    want = jassets.validate_hubert(str(hub), str(db), num_units=4,
                                   max_items=4)
    assert got["status"] == want["status"] == "pass", got["detail"]
    text = Path(assets.write_report([got], str(tmp_path / "r.md"))
                ).read_text()
    assert "| perplexity |" in text


def test_receptive_field_matches_jax():
    """The probe on tiny ``v2`` (encode, the variational mean, decode) on
    the same weights: the same integers, inside the analytic crop."""
    jcfg, cfg = jbuild(["v2"], TINY), build_config(["v2"], TINY)
    m = JRAVE(cfg=jcfg, train_mode=False)
    v = m.init({"params": jax.random.PRNGKey(0),
                "latent": jax.random.PRNGKey(1),
                "noise": jax.random.PRNGKey(2)}, jnp.zeros((1, 4096, 1)))
    model = RAVE(cfg, device="cpu").eval()
    load_flax_params(model, jax.tree.map(np.asarray, v["params"]))

    def japply(inp):
        bands = m.apply(v, inp, method=JRAVE.pqmf_forward)
        z = m.apply(v, inp, bands, method=JRAVE.encode_input)
        mean, _ = JVariationalHead.mean_scale(z)
        y = m.apply(v, mean, None, False, method=JRAVE.decode_bands)
        return m.apply(v, y, method=JRAVE.pqmf_inverse)

    got = measure_receptive_field(model, T=4096, device="cpu")
    want = jmeasure(japply, T=4096)
    assert got == want and min(got) > 0
    lc, rc = receptive_field_frames(cfg)
    assert lc >= got[0] // cfg.n_band + 1 and rc >= got[1] // cfg.n_band + 1


def _help(main, argv, capsys):
    with pytest.raises(SystemExit):
        main(argv)
    return capsys.readouterr().out


def test_every_jax_command_and_flag_parses_in_the_port(capsys):
    top = _help(jcli.main, ["--help"], capsys)
    commands = re.search(r"\{([a-z_,]+)\}", top).group(1).split(",")
    assert {"speaker_stats", "validate_assets", "remote_dataset"} <= \
        set(commands)
    port_top = _help(cli.main, ["--help"], capsys)
    assert set(commands) <= set(
        re.search(r"\{([a-z_,]+)\}", port_top).group(1).split(","))
    for c in commands:
        flags = set(re.findall(r"--[a-z_]+", _help(jcli.main, [c, "--help"],
                                                   capsys)))
        port = set(re.findall(r"--[a-z_]+", _help(cli.main, [c, "--help"],
                                                  capsys)))
        assert flags <= port, (c, sorted(flags - port))
