"""Audio decoding and encoding with numpy (WAV natively, anything else
through ffmpeg where it is installed).

The port's copy of ``rave_tpu/data/audio_io.py`` (the port imports
nothing of the JAX package): ``load_wav`` (resampling with scipy's
``resample_poly`` when asked for another rate), ``save_wav``,
``load_audio``, ``audio_length`` and ``search_for_audios``.
"""

from __future__ import annotations

import shutil
import subprocess
import wave
from pathlib import Path
from typing import Optional

import numpy as np

AUDIO_EXTS = (".wav", ".flac", ".mp3", ".ogg", ".aif", ".aiff", ".opus")


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def load_wav(path: str, sr: Optional[int] = None) -> tuple[np.ndarray, int]:
    """Decode a PCM WAV to float32 mono in [-1, 1]."""
    with wave.open(str(path), "rb") as w:
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = ((b[:, 0].astype(np.int32)) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    if sr is not None and sr != rate:
        x = resample_poly(x, sr, rate)
        rate = sr
    return x, rate


def save_wav(path: str, x: np.ndarray, sr: int) -> None:
    x = np.clip(x, -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def resample_poly(x: np.ndarray, up_sr: int, down_sr: int) -> np.ndarray:
    from scipy.signal import resample_poly as rp
    from math import gcd
    g = gcd(up_sr, down_sr)
    return rp(x, up_sr // g, down_sr // g).astype(np.float32)


def load_audio(path: str, sr: int) -> np.ndarray:
    """Decode any supported file to float32 mono at ``sr``."""
    p = Path(path)
    if p.suffix.lower() == ".wav":
        x, _ = load_wav(path, sr)
        return x
    if have_ffmpeg():
        cmd = ["ffmpeg", "-v", "error", "-i", str(path), "-f", "s16le",
               "-ac", "1", "-ar", str(sr), "-"]
        out = subprocess.run(cmd, capture_output=True, check=True).stdout
        return np.frombuffer(out, dtype="<i2").astype(np.float32) / 32768.0
    raise RuntimeError(
        f"cannot decode {path}: not a WAV and ffmpeg unavailable")


def audio_length(path: str, sr: int) -> int:
    """Number of samples the file decodes to at ``sr``, without decoding
    (the reference's lazy preprocess stores only ``{path, length}`` from
    ffprobe durations, ``scripts/preprocess.py:214-225``).  WAV lengths
    come from the header; other containers use ffprobe when available and
    fall back to a full decode."""
    p = Path(path)
    if p.suffix.lower() == ".wav":
        with wave.open(str(p), "rb") as w:
            return w.getnframes() * sr // w.getframerate()
    if shutil.which("ffprobe") is not None:
        cmd = ["ffprobe", "-v", "error", "-show_entries", "format=duration",
               "-of", "csv=p=0", str(p)]
        out = subprocess.run(cmd, capture_output=True, check=True).stdout
        return int(float(out.strip()) * sr)
    return len(load_audio(str(p), sr))


def search_for_audios(root: str, exts=AUDIO_EXTS) -> list[Path]:
    """Recursive audio search (reference ``preprocess.py:161-168``)."""
    root = Path(root)
    out = []
    for e in exts:
        out.extend(root.rglob(f"*{e}"))
        out.extend(root.rglob(f"*{e.upper()}"))
    return sorted(set(out))
