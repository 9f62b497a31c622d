"""Preprocessing and the dataset pipeline, in numpy.

The port's copy of ``rave_tpu/data/dataset.py`` (the port imports
nothing of the JAX package); it writes and reads the same db layout,
byte for byte: audio preprocessed once into a fixed-record int16 memmap
(``data.bin`` + ``meta.json`` + ``speakers.npy``), batches assembled in
numpy up to the one host-to-device copy, which the trainer makes.

* ``preprocess``            <- reference scripts/preprocess.py:56-233
* ``precompute_perturbed``  the perturbation variants, ``perturbed.bin``
* ``AudioDataset``          <- rave/dataset.py:155-197
* ``LazyAudioDataset``      <- rave/dataset.py:200-289
* transforms                <- rave/dataset.py:325-362 (random crop,
  phase mangle p=.8, 16-bit dequantize)
* ``split_dataset``         <- rave/dataset.py:366-379 (98/2, cap 1000,
  seed 42)
* ``RandomBackgroundNoise`` <- rave/dataset.py:65-144
* ``DataLoader``            a prefetch thread, or a persistent worker
  pool whose task feed is bounded by a semaphore and stopped by an event.

Every pool here starts its workers by ``spawn``: the JAX package forks
them, and a fork of a process with threads (a trainer's CUDA and
intra-op threads, a test runner's) can leave a lock held in the child,
which then hangs (seen in this package's tests).  A spawned worker
imports this module afresh, receives the dataset by pickle (which
reopens its memmaps by path) and runs numpy only; the batch crosses to
the card in the parent.
"""

from __future__ import annotations

import functools
import json
import multiprocessing as mp
import threading
import queue as queue_mod
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np
from scipy.signal import lfilter

from .audio_io import audio_length, load_audio, search_for_audios


# ----------------------------------------------------------------------
# preprocessing: audio files -> fixed-record int16 memmap
# ----------------------------------------------------------------------

def _decode_one(args):
    path, sr, n_signal = args
    try:
        x = load_audio(str(path), sr)
    except Exception as e:  # undecodable file: skip, like the reference
        print(f"skip {path}: {e}")
        return None, path
    n = (len(x) // n_signal) * n_signal
    if n == 0:
        return None, path
    chunks = (np.clip(x[:n], -1, 1) * 32767).astype("<i2")
    return chunks.reshape(-1, n_signal), path


def preprocess(input_path: str, output_path: str, n_signal: int = 131072,
               sample_rate: int = 44100, num_workers: int = 8,
               speaker_from: str = "parent", lazy: bool = False) -> dict:
    """Decode every audio file under ``input_path`` into ``n_signal``
    chunks, concatenated in one int16 memmap.  ``speaker_from='parent'``
    labels each chunk with its parent directory name (VCTK layout), as the
    reference's lazy dataset derives speaker ids from paths
    (``rave/dataset.py:244-256``).

    ``lazy=True`` mirrors the reference's ``--lazy`` mode
    (``scripts/preprocess.py:214-225``): only ``{path, length}`` records
    are stored and items decode on demand via :class:`LazyAudioDataset`.
    """
    out = Path(output_path)
    out.mkdir(parents=True, exist_ok=True)
    audios = search_for_audios(input_path)
    if not audios:
        raise FileNotFoundError(f"no audio under {input_path}")

    if lazy:
        files = []
        for p in audios:
            try:
                length = audio_length(str(p), sample_rate)
            except Exception as e:
                print(f"skip {p}: {e}")
                continue
            if length >= n_signal:
                files.append(dict(path=str(p.absolute()), length=length))
        count = sum(f["length"] // n_signal for f in files)
        meta = dict(n_signal=n_signal, sample_rate=sample_rate,
                    count=count, files=files, format="lazy_v1")
        (out / "meta.json").write_text(json.dumps(meta))
        return meta

    jobs = [(p, sample_rate, n_signal) for p in audios]
    speakers: list[str] = []
    count = 0
    # stream records straight to the flat memmap store instead of
    # accumulating the whole corpus in RAM (the on-disk format is an
    # append-only int16 block file)
    with open(out / "data.bin", "wb") as f:
        def consume(chunks, path):
            nonlocal count
            if chunks is None:
                return
            spk = path.parent.name if speaker_from == "parent" else "0"
            f.write(np.ascontiguousarray(chunks, np.int16).tobytes())
            speakers.extend([spk] * len(chunks))
            count += len(chunks)

        if num_workers > 1:
            with mp.get_context("spawn").Pool(num_workers) as pool:
                for chunks, path in pool.imap(_decode_one, jobs):
                    consume(chunks, path)
        else:
            for job in jobs:
                consume(*_decode_one(job))

    spk_names = sorted(set(speakers))
    spk_ids = np.asarray([spk_names.index(s) for s in speakers], np.int32)
    np.save(out / "speakers.npy", spk_ids)
    meta = dict(n_signal=n_signal, sample_rate=sample_rate,
                count=count, speakers=spk_names,
                format="int16_records_v1")
    (out / "meta.json").write_text(json.dumps(meta))
    return meta


# ----------------------------------------------------------------------
# precomputed perturbation variants
# ----------------------------------------------------------------------

def _open_records(root, count: int, record_len: int) -> np.memmap:
    return np.memmap(Path(root) / "data.bin", dtype="<i2", mode="r",
                     shape=(count, record_len))


def _perturb_record(data, perturb, i: int, n_variants: int, seed: int):
    x = data[i].astype(np.float32) / 32768.0
    out = np.empty((n_variants, data.shape[1]), "<i2")
    for v in range(n_variants):
        rng = np.random.default_rng((seed, int(i), v))
        y = perturb(x.copy(), rng)
        out[v] = (np.clip(y, -1, 1) * 32767).astype("<i2")
    return i, out


# (records, Perturb) of a perturbation worker process
_PERTURB_WORKER = None


def _init_perturb_worker(root, count, record_len, sr):
    global _PERTURB_WORKER
    from .perturbation import Perturb
    _PERTURB_WORKER = (_open_records(root, count, record_len), Perturb(sr))


def _perturb_one(args):
    return _perturb_record(*_PERTURB_WORKER, *args)


def precompute_perturbed(db_path: str, n_variants: int = 8,
                         num_workers: int = 0, seed: int = 0) -> str:
    """Precompute ``n_variants`` perturbed views (full EQ -> formant/
    pitch-shift pipeline, reference ``perturbation.py:312-318``) of every
    record into ``perturbed.bin`` (int16, shape (count, N, record_len)).

    Rationale: the native PSOLA+EQ costs ~150 ms per item on one host
    core, more than the device's whole step takes for a batch, so the
    train-time loader would starve the device.  Precomputing moves that
    cost into a one-off parallel pass; at train time the loader samples
    one stored variant (plus cheap background noise and peak norm).  The
    reference eats the cost in its 8 DataLoader workers
    (``scripts/train.py:143-149``)."""
    import os
    from .perturbation import Perturb

    root = Path(db_path)
    meta = json.loads((root / "meta.json").read_text())
    if meta.get("format") != "int16_records_v1":
        raise ValueError("perturb_variants needs a record-store db "
                         "(non-lazy preprocess)")
    count, record_len = meta["count"], meta["n_signal"]

    out = np.memmap(root / "perturbed.bin", dtype="<i2", mode="w+",
                    shape=(count, n_variants, record_len))
    jobs = [(i, n_variants, seed) for i in range(count)]
    workers = num_workers or max(1, (os.cpu_count() or 2))
    if workers > 1 and count > 1:
        with mp.get_context("spawn").Pool(
                workers, initializer=_init_perturb_worker,
                initargs=(root, count, record_len,
                          meta["sample_rate"])) as pool:
            for i, arr in pool.imap_unordered(_perturb_one, jobs,
                                              chunksize=1):
                out[i] = arr
    else:
        data = _open_records(root, count, record_len)
        perturb = Perturb(meta["sample_rate"])
        for job in jobs:
            i, arr = _perturb_record(data, perturb, *job)
            out[i] = arr
    out.flush()
    from .perturbation import PERTURB_VERSION
    meta["perturb_variants"] = int(n_variants)
    meta["perturb_version"] = PERTURB_VERSION
    (root / "meta.json").write_text(json.dumps(meta))
    return str(root / "perturbed.bin")


# ----------------------------------------------------------------------
# transforms (reference rave/dataset.py:325-362, rave/core.py:70-92)
# ----------------------------------------------------------------------

def random_phase_mangle(x: np.ndarray, rng: np.random.Generator,
                        min_f: float = 20.0, max_f: float = 2000.0,
                        amp: float = 0.99, sr: int = 44100) -> np.ndarray:
    """Random all-pass filter (reference ``random_phase_mangle``,
    ``rave/core.py:89-92``)."""
    f = np.exp(rng.uniform(np.log(min_f), np.log(max_f)))
    omega = 2 * np.pi * f / sr
    z0 = amp * np.exp(1j * omega)
    a = [1, -2 * np.real(z0), abs(z0) ** 2]
    b = [abs(z0) ** 2, -2 * np.real(z0), 1]
    return lfilter(b, a, x).astype(np.float32)


def dequantize(x: np.ndarray, rng: np.random.Generator,
               bit_depth: int = 16) -> np.ndarray:
    """16-bit dither (reference ``Dequantize``)."""
    return (x + rng.uniform(-0.5, 0.5, x.shape).astype(np.float32)
            / 2 ** (bit_depth - 1)).astype(np.float32)


def get_derivator_integrator(sr: int):
    """First-difference derivator and its leaky-integrator inverse
    (reference ``get_derivator_integrator``, ``rave/dataset.py:147-152``):
    train on the derivative signal, integrate reconstructions back."""
    alpha = 1 / (1 + 1 / sr * 2 * np.pi * 10)
    derivator = ([0.5, -0.5], [1])
    integrator = ([alpha ** 2, -alpha ** 2], [1, -2 * alpha, alpha ** 2])
    return (lambda x: lfilter(*derivator, x).astype(np.float32),
            lambda x: lfilter(*integrator, x).astype(np.float32))


def normalize_signal(x: np.ndarray, max_gain_db: float = 30.0) -> np.ndarray:
    """Peak-normalise with bounded gain (reference ``normalize_signal``,
    ``rave/dataset.py:314-322``): gain = min(1/peak, +30 dB)."""
    peak = np.abs(x).max()
    if peak == 0:
        return x
    gain = min(1.0 / peak, 10 ** (max_gain_db / 20))
    return (x * gain).astype(np.float32)


class RandomBackgroundNoise:
    """Mix pre-decoded noise at random SNR (reference
    ``rave/dataset.py:65-144``; noise corpus pre-decoded to ``.npy`` by
    ``scripts/decode.py``)."""

    def __init__(self, noise_dir: str, sr: int,
                 min_snr_db: float = 3.0, max_snr_db: float = 30.0,
                 p: float = 0.5):
        self.files = sorted(Path(noise_dir).rglob("*.npy")) if noise_dir else []
        self.sr = sr
        self.min_snr_db = min_snr_db
        self.max_snr_db = max_snr_db
        self.p = p

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if not self.files or rng.uniform() > self.p:
            return x
        f = self.files[rng.integers(len(self.files))]
        noise = np.load(f, mmap_mode="r")
        if len(noise) < len(x):
            reps = int(np.ceil(len(x) / len(noise)))
            noise = np.tile(noise, reps)
        start = rng.integers(0, len(noise) - len(x) + 1)
        noise = np.asarray(noise[start:start + len(x)], np.float32)
        snr = rng.uniform(self.min_snr_db, self.max_snr_db)
        xp = np.mean(x ** 2) + 1e-9
        np_ = np.mean(noise ** 2) + 1e-9
        scale = np.sqrt(xp / (np_ * 10 ** (snr / 10)))
        return (x + scale * noise).astype(np.float32)


def _apply_perturbation(x: np.ndarray, perturb, noise,
                        rng: np.random.Generator) -> np.ndarray:
    """Perturbed-view assembly for the voice-conversion fork (reference
    ``LazyAudioDataset.__getitem__``, ``rave/dataset.py:280-287``):
    formant/pitch shift + EQ, then background noise, then a 0.8 peak
    normalisation (the reference divides by the positive max; abs-max
    here so a negative-peaked chunk can't flip sign or blow up)."""
    xp = x
    if perturb is not None:
        xp = perturb(x.copy(), rng)
    if noise is not None:
        xp = noise(xp, rng)
    peak = float(np.abs(xp).max())
    if peak > 1e-6:
        xp = xp / peak * 0.8
    return xp.astype(np.float32)


# ----------------------------------------------------------------------
# datasets
# ----------------------------------------------------------------------

class AudioDataset:
    """Fixed-record memmap dataset (reference ``AudioDataset``,
    ``rave/dataset.py:155-197``)."""

    def __init__(self, db_path: str, n_signal: Optional[int] = None,
                 phase_mangle_p: float = 0.8, use_dequantize: bool = True,
                 perturb=None, noise=None, seed: int = 0,
                 normalize: bool = False, derivative: bool = False):
        self._kwargs = dict(
            db_path=db_path, n_signal=n_signal, phase_mangle_p=phase_mangle_p,
            use_dequantize=use_dequantize, perturb=perturb, noise=noise,
            seed=seed, normalize=normalize, derivative=derivative)
        self.root = Path(db_path)
        meta = json.loads((self.root / "meta.json").read_text())
        self.meta = meta
        self.record_len = meta["n_signal"]
        self.sr = meta["sample_rate"]
        self.count = meta["count"]
        self.n_signal = n_signal or self.record_len
        self.data = np.memmap(self.root / "data.bin", dtype="<i2", mode="r",
                              shape=(self.count, self.record_len))
        spk = self.root / "speakers.npy"
        self.speakers = np.load(spk) if spk.exists() else \
            np.zeros(self.count, np.int32)
        units = self.root / "units.npy"  # precomputed discrete-unit targets
        self.units = (np.load(units, mmap_mode="r")
                      if units.exists() and self.n_signal == self.record_len
                      else None)
        # precomputed perturbation variants (precompute_perturbed):
        # consumed only when perturbation is actually requested
        nv = meta.get("perturb_variants", 0)
        pbin = self.root / "perturbed.bin"
        self.perturbed = (np.memmap(pbin, dtype="<i2", mode="r",
                                    shape=(self.count, nv, self.record_len))
                          if nv and pbin.exists() and perturb is not None
                          else None)
        if self.perturbed is not None:
            from .perturbation import PERTURB_VERSION
            stored = meta.get("perturb_version")
            if stored != PERTURB_VERSION:
                import warnings
                warnings.warn(
                    f"{pbin} was precomputed by perturbation version "
                    f"{stored!r} but the code is {PERTURB_VERSION!r}: the "
                    "stored variants follow the OLD augmentation "
                    "distribution. Re-run the `perturb` command (falling "
                    "back to on-the-fly perturbation for now).",
                    stacklevel=2)
                self.perturbed = None
        if units.exists() and self.units is None:
            # a smaller random crop can't be aligned with the per-record
            # unit frames -- the CE loss would silently disappear
            import warnings
            warnings.warn(
                f"{units} exists but n_signal={self.n_signal} != record "
                f"length {self.record_len}: unit targets are DROPPED and "
                "the CE loss will be zero. Train with the full record "
                "length to keep them.", stacklevel=2)
        self.speaker_names = meta.get("speakers", ["0"])
        self.phase_mangle_p = phase_mangle_p
        self.use_dequantize = use_dequantize
        self.perturb = perturb
        self.noise = noise
        self.normalize = normalize
        # derivative training (reference get_dataset(derivative=True),
        # rave/dataset.py:329,349-350): items are derivator-filtered; the
        # paired integrator reverses it on generated audio
        self.derivator, self.integrator = (
            get_derivator_integrator(self.sr) if derivative else (None, None))
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.count

    def __reduce__(self):
        # a worker process opens the memmaps itself instead of receiving
        # copies of them
        return functools.partial(type(self), **self._kwargs), ()

    def __getitem__(self, i: int):
        return self.get(i, self._rng)

    def get(self, i: int, rng: np.random.Generator):
        """Fetch item ``i`` with an explicit generator -- parallel loader
        workers pass a per-(epoch, index) rng so augmentation draws are
        reproducible regardless of worker scheduling."""
        x = self.data[i].astype(np.float32) / 32768.0
        # random crop to n_signal (reference RandomCrop)
        start = 0
        if self.n_signal < self.record_len:
            start = int(rng.integers(0, self.record_len - self.n_signal + 1))
            x = x[start:start + self.n_signal]
        if self.phase_mangle_p > 0 and rng.uniform() < self.phase_mangle_p:
            x = random_phase_mangle(x, rng, sr=self.sr)
        if self.use_dequantize:
            x = dequantize(x, rng)
        if self.normalize:
            x = normalize_signal(x)
        if self.derivator is not None:
            x = self.derivator(x)
        item = dict(x=x.astype(np.float32),
                    speaker=np.int32(self.speakers[i]))
        if self.perturbed is not None:
            # precomputed variant (same crop window as the clean view);
            # only the cheap train-time augmentations remain: background
            # noise + the 0.8 peak norm
            v = int(rng.integers(self.perturbed.shape[1]))
            xp = self.perturbed[i, v, start:start + self.n_signal] \
                .astype(np.float32) / 32768.0
            if self.normalize:
                xp = normalize_signal(xp)
            if self.derivator is not None:
                xp = self.derivator(xp)
            item["x_perturbed"] = _apply_perturbation(
                xp, None, self.noise, rng)
        elif self.perturb is not None or self.noise is not None:
            item["x_perturbed"] = _apply_perturbation(
                x, self.perturb, self.noise, rng)
        if self.units is not None:
            item["units"] = np.asarray(self.units[i], np.int32)
        return item


class LazyAudioDataset:
    """Per-item decode of raw files (reference ``LazyAudioDataset``,
    ``rave/dataset.py:200-289``): index = cumulative chunk map over file
    durations; items decode on demand.

    Construct from a raw audio tree, or from a ``preprocess --lazy`` db
    via :func:`make_dataset` (meta format ``lazy_v1`` stores the
    reference-style ``{path, length}`` records)."""

    def __init__(self, audio_root: Optional[str] = None,
                 n_signal: int = 131072, sr: int = 44100,
                 files: Optional[Sequence] = None,
                 perturb=None, noise=None, seed: int = 0,
                 phase_mangle_p: float = 0.8, use_dequantize: bool = True,
                 normalize: bool = False, derivative: bool = False):
        self._kwargs = dict(
            audio_root=audio_root, n_signal=n_signal, sr=sr, files=files,
            perturb=perturb, noise=noise, seed=seed,
            phase_mangle_p=phase_mangle_p, use_dequantize=use_dequantize,
            normalize=normalize, derivative=derivative)
        if files is not None:
            # (path, length) records from a lazy preprocess db: index
            # without touching the audio
            self.files = [Path(f["path"]) for f in files]
            lengths = [int(f["length"]) for f in files]
        else:
            self.files = search_for_audios(audio_root)
            lengths = []
            for f in list(self.files):
                try:
                    lengths.append(audio_length(str(f), sr))
                except Exception:
                    self.files.remove(f)
        self.n_signal = n_signal
        self.sr = sr
        self.perturb = perturb
        self.noise = noise
        # full transform chain, like the non-lazy path (the reference's
        # lazy dataset still applies the augmentation chain,
        # rave/dataset.py:258-289)
        self.phase_mangle_p = phase_mangle_p
        self.use_dequantize = use_dequantize
        self.normalize = normalize
        self.derivator, self.integrator = (
            get_derivator_integrator(sr) if derivative else (None, None))
        self.units = None
        self._rng = np.random.default_rng(seed)
        self._index = []
        self.speaker_names = sorted({f.parent.name for f in self.files})
        for f, length in zip(self.files, lengths):
            for c in range(length // n_signal):
                self._index.append((f, c))
        self._cache: dict = {}

    def __len__(self):
        return len(self._index)

    def __reduce__(self):
        return functools.partial(type(self), **self._kwargs), ()

    def __getitem__(self, i: int):
        return self.get(i, self._rng)

    def get(self, i: int, rng: np.random.Generator):
        f, c = self._index[i]
        if f not in self._cache:
            if len(self._cache) > 4:
                self._cache.clear()
            self._cache[f] = load_audio(str(f), self.sr)
        x = self._cache[f][c * self.n_signal:(c + 1) * self.n_signal].copy()
        if len(x) < self.n_signal:  # header/probe length over-estimate
            x = np.pad(x, (0, self.n_signal - len(x)))
        if self.phase_mangle_p > 0 and rng.uniform() < self.phase_mangle_p:
            x = random_phase_mangle(x, rng, sr=self.sr)
        if self.use_dequantize:
            x = dequantize(x, rng)
        if self.normalize:
            x = normalize_signal(x)
        if self.derivator is not None:
            x = self.derivator(x)
        spk = self.speaker_names.index(f.parent.name)
        item = dict(x=x.astype(np.float32), speaker=np.int32(spk))
        if self.perturb is not None or self.noise is not None:
            item["x_perturbed"] = _apply_perturbation(
                x, self.perturb, self.noise, rng)
        return item


def make_dataset(db_path: str, n_signal: Optional[int] = None, **kw):
    """Open a preprocessed db, dispatching on its storage format: the
    record-store :class:`AudioDataset` or, for ``preprocess --lazy`` dbs,
    the per-item-decode :class:`LazyAudioDataset` (reference
    ``get_dataset``, ``rave/dataset.py:325-344``, branches on
    ``metadata.yaml``'s lazy flag)."""
    meta = json.loads((Path(db_path) / "meta.json").read_text())
    if meta.get("format") == "lazy_v1":
        return LazyAudioDataset(n_signal=n_signal or meta["n_signal"],
                                sr=meta["sample_rate"], files=meta["files"],
                                **kw)
    return AudioDataset(db_path, n_signal=n_signal, **kw)


def split_dataset(n: int, percent: float = 98.0, max_residual: int = 1000,
                  seed: int = 42) -> tuple[np.ndarray, np.ndarray]:
    """98/2 split with capped validation set (reference
    ``rave/dataset.py:366-379``)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_val = min(int(n * (100 - percent) / 100), max_residual)
    n_val = max(n_val, 1) if n > 1 else 0
    return perm[n_val:], perm[:n_val]


# ----------------------------------------------------------------------
# batching
# ----------------------------------------------------------------------

class DataLoader:
    """Thread-prefetched batch iterator producing numpy batches.

    Host-side (CPU) work -- decode, perturbation, augmentation -- overlaps
    with device compute via a bounded queue (the reference leans on torch
    DataLoader workers, ``scripts/train.py:143-149``)."""

    def __init__(self, dataset, batch_size: int, indices=None,
                 shuffle: bool = True, seed: int = 0, prefetch: int = 4,
                 drop_last: bool = True, num_workers: int = 0):
        self.ds = dataset
        self.bs = batch_size
        self.indices = np.asarray(indices if indices is not None
                                  else np.arange(len(dataset)))
        self.shuffle = shuffle
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.num_workers = num_workers
        self._epoch = 0
        self._pool = None
        if num_workers > 0:
            # started now, so that the workers' start-up overlaps the
            # caller's own (a trainer builds its model meanwhile)
            self._pool = mp.get_context("spawn").Pool(
                num_workers, initializer=_init_loader_worker,
                initargs=(dataset, seed))

    @staticmethod
    def _shape(items: list) -> dict:
        batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
        batch["x"] = batch["x"][..., None]              # (B, T, 1)
        if "x_perturbed" in batch:
            batch["x_perturbed"] = batch["x_perturbed"][..., None]
        return batch

    def _epoch_index_chunks(self):
        idx = self.indices.copy()
        if self.shuffle:
            self.rng.shuffle(idx)
        stop = len(idx) - len(idx) % self.bs if self.drop_last else len(idx)
        for i in range(0, stop, self.bs):
            yield idx[i:i + self.bs]

    def _epoch_batches(self) -> Iterator[dict]:
        for chunk in self._epoch_index_chunks():
            yield _batch(self.ds, self.seed, self._epoch, chunk)

    def __iter__(self) -> Iterator[dict]:
        self._epoch += 1
        if self.num_workers > 0:
            # a process pool (the reference trains with num_workers=8
            # torch DataLoader workers, scripts/train.py:143-149); each
            # worker holds the dataset (reopened by path, see the module
            # docstring) and per-item rngs make draws order-independent.
            # The pool is created ONCE (per-epoch pools started hundreds
            # of workers over a long run) and the task feed is gated by
            # a semaphore released as the consumer takes batches:
            # pool.imap alone has NO result-side backpressure, so
            # workers outrunning the train loop grew the parent's
            # result cache without bound (measured on the JAX package: ~8 MB/step
            # retained -> 130 GB RSS -> oom-kill at step ~14.9k).
            # The epoch rides in the task tuple so persistent workers
            # still draw per-(seed, epoch, index) augmentations.
            if self._pool is None:
                raise RuntimeError("the loader was closed")
            sem = threading.Semaphore(self.prefetch + self.num_workers)
            stop = threading.Event()
            epoch = self._epoch

            def gated():
                # runs inside the pool's task-handler thread: never
                # block it indefinitely -- multiprocessing joins that
                # thread at interpreter exit, so an un-released
                # semaphore wait there deadlocks process shutdown
                # (measured on the JAX package: 20-min hang after the final
                # checkpoint when the train loop stops mid-epoch)
                for c in self._epoch_index_chunks():
                    while not sem.acquire(timeout=0.5):
                        if stop.is_set():
                            return
                    if stop.is_set():
                        return
                    yield (epoch, c)

            try:
                for batch in self._pool.imap(_pool_batch, gated(),
                                             chunksize=1):
                    sem.release()
                    yield batch
            finally:
                # normal exhaustion or consumer abandonment
                # (GeneratorExit): unblock the feeder
                stop.set()
                sem.release()
            return

        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        SENTINEL = object()

        def worker():
            for b in self._epoch_batches():
                q.put(b)
            q.put(SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            b = q.get()
            if b is SENTINEL:
                break
            yield b

    def __len__(self):
        return len(self.indices) // self.bs

    def close(self) -> None:
        """Terminate the worker pool, if one was started."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None


def _batch(ds, seed: int, epoch: int, chunk) -> dict:
    """The batch of the indices ``chunk``.  Each item draws from its own
    ``(seed, epoch, index)`` generator, so that a batch does not depend on
    which process assembles it."""
    items = [ds.get(int(j), np.random.default_rng((seed, epoch, int(j))))
             if hasattr(ds, "get") else ds[int(j)] for j in chunk]
    return DataLoader._shape(items)


# (dataset, seed) of a loader worker process
_LOADER_WORKER = None


def _init_loader_worker(ds, seed: int) -> None:
    global _LOADER_WORKER
    _LOADER_WORKER = (ds, seed)


def _pool_batch(task) -> dict:
    epoch, chunk = task
    return _batch(*_LOADER_WORKER, epoch, chunk)
