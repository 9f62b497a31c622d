"""Noise-corpus pre-decoding (the port's copy of
``rave_tpu/data/noise_corpus.py``, reference ``scripts/decode.py:50-109``):
decode a background-noise corpus (e.g. DEMAND) to raw ``.npy`` files and
a ``dataset.csv``, so that :class:`~rave_tpu_torch.data.dataset.RandomBackgroundNoise`
reads windows without decoding at train time."""

from __future__ import annotations

import csv
import multiprocessing as mp
from pathlib import Path

import numpy as np

from .audio_io import load_audio, search_for_audios


def _decode_one(args):
    path, out_dir, sr = args
    try:
        x = load_audio(str(path), sr)
    except Exception as e:
        print(f"skip {path}: {e}")
        return None
    out = Path(out_dir) / (Path(path).stem + ".npy")
    np.save(out, x.astype(np.float32))
    return str(out), len(x) / sr


def decode_noise_corpus(input_path: str, output_path: str,
                        sample_rate: int = 44100,
                        num_workers: int = 4) -> list:
    out = Path(output_path)
    out.mkdir(parents=True, exist_ok=True)
    audios = search_for_audios(input_path)
    jobs = [(p, out, sample_rate) for p in audios]
    if num_workers > 1:
        # spawned, not forked: see rave_tpu_torch.data.dataset
        with mp.get_context("spawn").Pool(num_workers) as pool:
            results = [r for r in pool.imap(_decode_one, jobs) if r]
    else:
        results = [r for r in map(_decode_one, jobs) if r]
    with open(out / "dataset.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["path", "duration_s"])
        w.writerows(results)
    return results
