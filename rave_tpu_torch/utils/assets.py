"""One-command validation of the frozen-teacher assets.

Port of ``rave_tpu/utils/assets.py``.  The reference depends on three
pretrained checkpoints that this repository does not hold:

* the torchfcpe pitch model (``fcpe_c_v001``), read by the port's strict
  reader :func:`~rave_tpu_torch.models.pitch_fcpe.load_fcpe_checkpoint`;
* the HuBERT unit teacher, run by
  :class:`~rave_tpu_torch.data.units.TorchHubertUnitProvider` from a local
  checkpoint (the mel-k-means stand-in is the default);
* the VoxCeleb ECAPA speaker encoder, read by
  :mod:`~rave_tpu_torch.models.speaker_convert`.

The ``validate_assets`` command runs every check the present assets
allow and writes a markdown report (by default
``docs/assets_validation.md``: pass ``--out`` to write elsewhere): on a
host with the assets it closes the gap; on one without them it says what
stays unverified.  The checks that run a network run on ``device``.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np

DEFAULT_REPORT = "docs/assets_validation.md"


def _result(name: str, status: str, detail: str, **extra) -> dict:
    return {"asset": name, "status": status, "detail": detail, **extra}


def validate_fcpe(ckpt: str | None, device="cuda") -> dict:
    """The strict reader, then a behavioural check: a 220 Hz sine must
    decode to a median voiced f0 within 10 Hz of 220."""
    name = "fcpe (pitch teacher)"
    if not ckpt:
        return _result(
            name, "absent",
            "no checkpoint ($RAVE_TPU_FCPE_CKPT / --fcpe_ckpt unset); the "
            "port's CFNaiveMelPE remains validated against a torchfcpe-"
            "layout module with random weights only "
            "(tests/test_torch_fcpe.py) -- a semantically different but "
            "layout-compatible real checkpoint would not be caught")
    try:
        import torch
        from .. import resolve_device
        from ..models import pitch_fcpe as F
        dev = resolve_device(device)
        model = F.FCPE()
        model.load_state_dict(F.load_fcpe_checkpoint(ckpt))
        model.to(dev).eval()
        sr = 16000
        t = np.arange(sr) / sr
        x = torch.tensor(np.sin(2 * np.pi * 220 * t)[None],
                         dtype=torch.float32, device=dev)
        with torch.inference_mode():
            f0 = F.fcpe_f0(model, x, sr).cpu().numpy()
        voiced = f0[f0 > 0]
        med = float(np.median(voiced)) if len(voiced) else float("nan")
        ok = len(voiced) > 10 and abs(med - 220) < 10
        return _result(
            name, "pass" if ok else "FAIL",
            f"strict read ok; 220 Hz sine -> median voiced f0 "
            f"{med:.1f} Hz over {len(voiced)} voiced frames "
            f"(tolerance +-10 Hz)", ckpt=ckpt, f0_median=med)
    except Exception as e:   # every failure is a row of the report
        return _result(name, "FAIL", f"{type(e).__name__}: {e}", ckpt=ckpt)


def validate_hubert(ckpt: str | None, db_path: str | None,
                    num_units: int = 100, max_items: int = 64) -> dict:
    """The HuBERT provider beside the mel-k-means stand-in on the same
    records, both streams' ``unit_stats`` reported."""
    name = "hubert (CE unit teacher)"
    if not ckpt:
        return _result(
            name, "absent",
            "no checkpoint ($RAVE_TPU_HUBERT_CKPT / --hubert_ckpt unset); "
            "the default CE teacher remains mel-kmeans with a corpus-fit "
            "codebook -- different unit semantics than bshall's pretrained "
            "layer-7 codebook")
    if not db_path:
        return _result(
            name, "skipped",
            "checkpoint present but no --db_path to run the mel-vs-HuBERT "
            "comparison on; pass a preprocessed dataset")
    try:
        from ..data.dataset import AudioDataset
        from ..data.units import (MelKMeansUnitProvider,
                                  TorchHubertUnitProvider, unit_stats)
        ds = AudioDataset(db_path)
        n = min(len(ds), max_items)
        hub = TorchHubertUnitProvider(ckpt, sr=ds.sr, num_units=num_units)
        if hub.codebook is None:
            hub.fit(ds, max_items=n)
        mel = MelKMeansUnitProvider(num_units=num_units, sr=ds.sr) \
            .fit(ds, max_items=n)
        hu, mu = [], []
        for i in range(n):
            x = np.asarray(ds[i]["x"]).reshape(-1)
            hu.append(hub(x))
            mu.append(mel(x))
        return _result(
            name, "pass",
            f"provider ran on {n} records; stats below quantify the mel "
            "stand-in against the real teacher", ckpt=ckpt,
            hubert_stats=unit_stats(np.stack(hu), num_units),
            mel_stats=unit_stats(np.stack(mu), num_units))
    except Exception as e:   # every failure is a row of the report
        return _result(name, "FAIL", f"{type(e).__name__}: {e}", ckpt=ckpt)


def validate_speaker(ckpt: str | None, device="cuda") -> dict:
    """The pretrained speaker encoder installed in a small ``v2_fork``:
    embeddings finite, and two different signals' not the same."""
    name = "speaker (VoxCeleb ECAPA)"
    if not ckpt:
        return _result(
            name, "absent",
            "no checkpoint (--speaker_ckpt unset); "
            "train_speaker_encoder=true (+ speaker_classes for a "
            "discriminative embedding) is the from-scratch fallback")
    try:
        import torch
        from ..config import build_config
        from ..models.rave import RAVE
        from ..models.speaker_convert import (install_speaker_weights,
                                              load_speaker_checkpoint)
        cfg = build_config(["v2_fork"], ["capacity=4", "n_signal=32768",
                                        "batch_size=2"])
        model = RAVE(cfg, device=device, train_mode=False).eval()
        install_speaker_weights(model, load_speaker_checkpoint(ckpt))
        rng = np.random.default_rng(0)
        t = np.arange(cfg.n_signal) / cfg.sampling_rate
        a = np.sin(2 * np.pi * 120 * t) * 0.5
        b = rng.standard_normal(cfg.n_signal) * 0.1
        x = torch.tensor(np.stack([a, b])[..., None], dtype=torch.float32,
                         device=next(model.parameters()).device)
        with torch.inference_mode():
            e = model.speaker_embedding(model.pqmf_forward(x)).cpu().numpy()
        cos = float(np.dot(e[0], e[1]) /
                    (np.linalg.norm(e[0]) * np.linalg.norm(e[1]) + 1e-9))
        ok = bool(np.isfinite(e).all()) and cos < 0.999
        return _result(
            name, "pass" if ok else "FAIL",
            f"weights installed; embeddings finite, cross-signal cosine "
            f"{cos:.3f} (must be < 0.999 -- a degenerate constant "
            "embedding would sit at 1.0)", ckpt=ckpt, cross_cos=cos)
    except Exception as e:   # every failure is a row of the report
        return _result(name, "FAIL", f"{type(e).__name__}: {e}", ckpt=ckpt)


def _stats_table(hs: dict, ms: dict) -> list[str]:
    keys = ["perplexity", "entropy_bits", "usage", "change_rate",
            "mean_run_length"]
    lines = ["| metric | real HuBERT | mel-kmeans stand-in |",
             "|---|---|---|"]
    for k in keys:
        lines.append(f"| {k} | {hs.get(k, float('nan')):.3f} "
                     f"| {ms.get(k, float('nan')):.3f} |")
    return lines


def write_report(results: list[dict], out_path: str) -> str:
    """The markdown report of ``results`` at ``out_path``; returns it."""
    lines = [
        "# Frozen-teacher asset validation",
        "",
        f"Generated by `python -m rave_tpu_torch.cli validate_assets` on "
        f"{time.strftime('%Y-%m-%d %H:%M')} "
        f"(host {os.uname().nodename}).",
        "",
        "The reference's three pretrained checkpoints and what this host "
        "could verify about the PyTorch port's readers and "
        "re-implementations of them. `absent` rows are the gaps that "
        "remain on hosts without the assets (see each detail).",
        "",
        "| asset | status | detail |",
        "|---|---|---|",
    ]
    for r in results:
        lines.append(f"| {r['asset']} | **{r['status']}** | "
                     f"{r['detail']} |")
    for r in results:
        if "hubert_stats" in r:
            lines += ["", "## mel-vs-HuBERT unit statistics", ""]
            lines += _stats_table(r["hubert_stats"], r["mel_stats"])
            lines += ["",
                      "Interpretation: similar perplexity/usage with a "
                      "LOWER change-rate (longer runs) for real HuBERT "
                      "indicates phone-like units; large gaps mean CE "
                      "targets trained on the stand-in differ "
                      "semantically from the reference's."]
    lines += ["", "Raw results:", "", "```json",
              json.dumps(results, indent=2, default=str), "```", ""]
    p = Path(out_path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text("\n".join(lines))
    return str(p)


def validate_assets_main(args) -> list[dict]:
    """The ``validate_assets`` command: every check, the report, a line
    per asset; exits non-zero if any check FAILed."""
    device = getattr(args, "device", "cuda")
    fcpe = getattr(args, "fcpe_ckpt", None) \
        or os.environ.get("RAVE_TPU_FCPE_CKPT")
    hub = getattr(args, "hubert_ckpt", None) \
        or os.environ.get("RAVE_TPU_HUBERT_CKPT")
    results = [validate_fcpe(fcpe, device),
               validate_hubert(hub, getattr(args, "db_path", None)),
               validate_speaker(getattr(args, "speaker_ckpt", None), device)]
    out = write_report(results, getattr(args, "out", None) or DEFAULT_REPORT)
    for r in results:
        print(f"{r['asset']}: {r['status']} -- {r['detail']}")
    print(f"report: {out}")
    bad = [r for r in results if r["status"] == "FAIL"]
    if bad:
        raise SystemExit(f"{len(bad)} asset validation(s) FAILED")
    return results
