"""The port's data pipeline against rave_tpu's numpy code, same inputs and
seeds: ``preprocess`` writes the same bytes, datasets give equal items,
the loaders equal batches (the port's the same with 0 and 2 workers), and
the split, the units, the perturbation variants and ``Perturb`` agree.
Everything is numpy on both sides; ``Perturb`` is held to 1e-6, the rest
to equality.
"""
import json

import numpy as np
import pytest

from rave_tpu.data import audio_io as jaudio
from rave_tpu.data import dataset as jdata
from rave_tpu.data import noise_corpus as jnoise
from rave_tpu.data import perturbation as jpert
from rave_tpu.data import pitch as jpitch
from rave_tpu.data import units as junits
from rave_tpu.ops.stft import mel_filterbank as jmel
from rave_tpu_torch.data import audio_io, dataset, noise_corpus, perturbation
from rave_tpu_torch.data import pitch, units
from rave_tpu_torch.ops.stft import mel_filterbank

SR, N = 16000, 4096


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three speakers, two harmonic clips each, plus a short and an
    undecodable file (both skipped)."""
    root = tmp_path_factory.mktemp("audio")
    rng = np.random.default_rng(0)
    t = np.arange(3 * N + 123) / SR
    for s in range(3):
        d = root / f"spk{s}"
        d.mkdir()
        for i in range(2):
            f0 = 110 * 1.5 ** s * (1 + 0.1 * i)
            x = sum(np.sin(2 * np.pi * h * f0 * t) / h for h in range(1, 5))
            x = 0.2 * x + 0.01 * rng.standard_normal(len(t))
            audio_io.save_wav(str(d / f"{i}.wav"), x.astype(np.float32), SR)
    audio_io.save_wav(str(root / "spk0" / "short.wav"),
                      np.zeros(100, np.float32), SR)
    (root / "spk1" / "bad.wav").write_bytes(b"not a wav")
    return root


@pytest.fixture(scope="module")
def dbs(corpus, tmp_path_factory):
    """The same corpus preprocessed and perturbed by both packages, the
    port's with two worker processes."""
    out = {}
    for name, mod, workers in (("jax", jdata, 1), ("torch", dataset, 2)):
        d = tmp_path_factory.mktemp(f"db_{name}")
        mod.preprocess(str(corpus), str(d), n_signal=N, sample_rate=SR,
                       num_workers=workers)
        mod.precompute_perturbed(str(d), n_variants=2, num_workers=workers,
                                 seed=3)
        out[name] = d
    return out


def test_preprocess_and_perturbed_store_are_byte_identical(dbs):
    for f in ("data.bin", "meta.json", "speakers.npy", "perturbed.bin"):
        assert ((dbs["torch"] / f).read_bytes()
                == (dbs["jax"] / f).read_bytes()), f
    meta = json.loads((dbs["torch"] / "meta.json").read_text())
    assert meta["count"] == 18 and meta["speakers"] == ["spk0", "spk1", "spk2"]
    assert perturbation.PERTURB_VERSION == jpert.PERTURB_VERSION
    assert meta["perturb_version"] == jpert.PERTURB_VERSION


def test_lazy_preprocess_matches(corpus, tmp_path):
    for name, mod in (("jax", jdata), ("torch", dataset)):
        mod.preprocess(str(corpus), str(tmp_path / name), n_signal=N,
                       sample_rate=SR, num_workers=1, lazy=True)
    assert ((tmp_path / "torch" / "meta.json").read_text()
            == (tmp_path / "jax" / "meta.json").read_text())
    kw = dict(perturb=None, seed=0)
    jd = jdata.make_dataset(str(tmp_path / "jax"), **kw)
    td = dataset.make_dataset(str(tmp_path / "torch"), **kw)
    assert isinstance(td, dataset.LazyAudioDataset) and len(td) == len(jd)
    for i in (0, 5, len(td) - 1):
        _equal_items(td.get(i, np.random.default_rng(i)),
                     jd.get(i, np.random.default_rng(i)))
    # the lazy dataset in a loader's worker processes
    loaders = [dataset.DataLoader(td, 3, seed=1, num_workers=w)
               for w in (0, 2)]
    for a, b in zip(*map(list, loaders)):
        _equal_items(a, b)
    loaders[1].close()


def _equal_items(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("opts", [
    dict(), dict(n_signal=N // 2, normalize=True, derivative=True),
    dict(perturb="stored"), dict(perturb="live", phase_mangle_p=0.0)])
def test_dataset_items_equal(dbs, opts):
    opts = dict(opts)
    mode = opts.pop("perturb", None)
    datasets = []
    for name, mod, pert in (("jax", jdata, jpert), ("torch", dataset,
                                                    perturbation)):
        ds = mod.AudioDataset(str(dbs[name]), perturb=pert.Perturb(SR)
                              if mode else None, **opts)
        if mode == "live":   # without the stored variants Perturb runs
            ds.perturbed = None
        datasets.append(ds)
    jd, td = datasets
    assert (td.perturbed is not None) == (mode == "stored")
    for i in (0, 7, 17):
        _equal_items(td.get(i, np.random.default_rng(i)),
                     jd.get(i, np.random.default_rng(i)))


def test_loader_batches_equal_across_packages_and_workers(dbs):
    def batches(mod, d, workers):
        ds = mod.AudioDataset(str(d), n_signal=N // 2)
        dl = mod.DataLoader(ds, 4, shuffle=True, seed=3, num_workers=workers)
        out = [b for _ in range(2) for b in dl]   # two epochs
        if hasattr(dl, "close"):
            dl.close()
        return out

    want = batches(jdata, dbs["jax"], 0)
    for workers in (0, 2):
        got = batches(dataset, dbs["torch"], workers)
        assert len(got) == len(want) == 8
        for a, b in zip(got, want):
            _equal_items(a, b)
        assert got[0]["x"].shape == (4, N // 2, 1)


def test_loader_abandoned_mid_epoch_stops_its_workers(dbs):
    ds = dataset.AudioDataset(str(dbs["torch"]))
    dl = dataset.DataLoader(ds, 2, num_workers=2)
    it = iter(dl)
    next(it)
    it.close()
    procs = dl._pool._pool
    dl.close()
    for p in procs:
        p.join(timeout=10)
        assert not p.is_alive()
    assert dl._pool is None


def test_split_dataset_matches():
    for n in (1, 2, 50, 5000, 100_000):
        for a, b in zip(dataset.split_dataset(n), jdata.split_dataset(n)):
            np.testing.assert_array_equal(a, b)


def test_perturb_matches():
    rng = np.random.default_rng(4)
    t = np.arange(2 * N) / SR
    x = (0.3 * np.sin(2 * np.pi * 180 * t * (1 + 0.05 * np.sin(3 * t)))
         + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
    for seed in range(4):
        got = perturbation.Perturb(SR)(x.copy(), np.random.default_rng(seed))
        want = jpert.Perturb(SR)(x.copy(), np.random.default_rng(seed))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    for ratio in (0.7, 1.3):
        np.testing.assert_allclose(
            perturbation.pitch_shift_native(x, SR, ratio, 1.2),
            jpert.pitch_shift_native(x, SR, ratio, 1.2), atol=1e-6, rtol=0)
        np.testing.assert_allclose(
            perturbation.formant_shift_native(x, SR, ratio),
            jpert.formant_shift_native(x, SR, ratio), atol=1e-6, rtol=0)


def test_units_match(dbs, tmp_path):
    jd = jdata.AudioDataset(str(dbs["jax"]))
    td = dataset.AudioDataset(str(dbs["torch"]))
    np.testing.assert_array_equal(mel_filterbank(SR, 1024, 40),
                                  jmel(SR, 1024, 40))
    tp = units.MelKMeansUnitProvider(num_units=8, sr=SR, hop=320).fit(
        td, max_items=10, iters=4)
    jp = junits.MelKMeansUnitProvider(num_units=8, sr=SR, hop=320).fit(
        jd, max_items=10, iters=4)
    np.testing.assert_array_equal(tp.codebook, jp.codebook)
    for name, p, ds, mod in (("torch", tp, td, units),
                             ("jax", jp, jd, junits)):
        (tmp_path / name).mkdir()
        mod.precompute_units(ds, p, str(tmp_path / name))
    got = np.load(tmp_path / "torch" / "units.npy")
    np.testing.assert_array_equal(got, np.load(tmp_path / "jax" / "units.npy"))
    assert got.shape[0] == len(td)
    np.testing.assert_array_equal(
        units.HubertUnitProvider(str(tmp_path / "torch")).for_record(3),
        got[3])
    assert units.unit_stats(got, 8) == junits.unit_stats(got, 8)
    with pytest.raises(FileNotFoundError, match="mel provider"):
        units.TorchHubertUnitProvider(str(tmp_path / "absent"))


def test_torch_hubert_units_match(dbs, tmp_path):
    """A tiny local ``transformers`` HuBERT through both packages'
    providers (``transformers`` is optional: the test needs it)."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.HubertConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, conv_dim=(16,) * 7,
        do_stable_layer_norm=False, feat_extract_norm="group")
    ckpt = tmp_path / "hubert_tiny"
    transformers.HubertModel(cfg).eval().save_pretrained(str(ckpt))
    # a dataset each: ``ds[i]`` draws its augmentations from the
    # dataset's own generator
    td = dataset.AudioDataset(str(dbs["torch"]))
    tp = units.TorchHubertUnitProvider(str(ckpt), sr=SR, layer=2,
                                       num_units=4).fit(td, max_items=6,
                                                        iters=3)
    jp = junits.TorchHubertUnitProvider(str(ckpt), sr=SR, layer=2,
                                        num_units=4).fit(
        jdata.AudioDataset(str(dbs["jax"])), max_items=6, iters=3)
    np.testing.assert_array_equal(tp.codebook, jp.codebook)
    np.testing.assert_array_equal(tp(td[0]["x"]), jp(td[0]["x"]))


def test_audio_io_and_pitch_match(corpus, tmp_path):
    files = audio_io.search_for_audios(str(corpus))
    assert files == jaudio.search_for_audios(str(corpus))
    f = str(files[0])
    for sr in (SR, 22050):
        np.testing.assert_array_equal(audio_io.load_audio(f, sr),
                                      jaudio.load_audio(f, sr))
        assert audio_io.audio_length(f, sr) == jaudio.audio_length(f, sr)
    x = audio_io.load_audio(f, SR)
    f0 = pitch.yin_f0(x, SR)
    np.testing.assert_array_equal(f0, jpitch.yin_f0(x, SR))
    assert (f0 > 0).any()
    np.testing.assert_array_equal(pitch.f0_norm(f0, 5.0, 0.3),
                                  jpitch.f0_norm(f0, 5.0, 0.3))


def test_noise_corpus_and_background_noise_match(corpus, tmp_path):
    for name, mod in (("torch", noise_corpus), ("jax", jnoise)):
        mod.decode_noise_corpus(str(corpus / "spk2"), str(tmp_path / name),
                                sample_rate=SR, num_workers=1)
    for f in ("0.npy", "1.npy"):
        assert ((tmp_path / "torch" / f).read_bytes()
                == (tmp_path / "jax" / f).read_bytes()), f
    csv = {n: (tmp_path / n / "dataset.csv").read_text().replace(
        str(tmp_path / n), "") for n in ("torch", "jax")}
    assert csv["torch"] == csv["jax"] and csv["torch"].count("\n") == 3
    x = np.random.default_rng(0).standard_normal(N).astype(np.float32)
    got = dataset.RandomBackgroundNoise(str(tmp_path / "torch"), SR, p=1.0)(
        x, np.random.default_rng(1))
    want = jdata.RandomBackgroundNoise(str(tmp_path / "jax"), SR, p=1.0)(
        x, np.random.default_rng(1))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, x)
