"""The trainer: data loading, the train step, validation, checkpoints.

The port's counterpart of ``rave_tpu/train/trainer.py`` (reference
``scripts/train.py:112-230`` minus Lightning), on one device: a plain
loop around :func:`~rave_tpu_torch.train.loop.make_train_step`, metric
logging (jsonl, TensorBoard when importable), EMA weights for
validation, audio and conversion demos with objective conversion
metrics, the latent PCA, and best/last checkpoints with ``--resume``.
A pitch config reads the per-speaker log-f0 statistics
(``--speaker_stats``, default ``<db>/speaker_stats.json``) and adds each
item's speaker's to its batch; without the file the step takes each
item's own.

Batches cross to the device as pinned, non-blocking copies, and the host
reads the metrics only every 50 steps, so the loop does not wait for the
device on every step.

``--multihost`` trains data-parallel under ``torchrun``, one process per
device (:mod:`rave_tpu_torch.parallel.mesh`: NCCL on ``cuda:LOCAL_RANK``,
gloo with ``--device cpu``), as the JAX package's ``--multihost`` trains
over a mesh that spans processes.  Each rank loads ``batch_size`` rows
with the JAX loader's ``seed=0``, so every rank loads the same items in
the same order, as every JAX process does (reproduced, not repaired;
ROADMAP C); the global batch is ``world * batch_size`` rows.  The train
step takes its batch-coupled statistics and its gradients over the
global batch, so every rank's state stays equal (checked after the
build and after ``--resume``).  Rank 0 logs, prints and writes each
checkpoint, after a barrier; every rank restores it on ``--resume``.  The
validation metric spans the ranks; the audio demos, the conversion demo
and the latent PCA run only in a single-process run, as in the JAX
package.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..config import build_config
from ..data.dataset import DataLoader, make_dataset, split_dataset
from ..models.rave import serving_mode
from ..parallel import mesh
from .checkpoint import CheckpointManager, save_config
from .loop import TrainState, make_eval_step, make_train_step

LOG_EVERY = 50


class MetricLogger:
    """``metrics.jsonl`` plus TensorBoard when it imports (the reference
    logs to TensorBoard and wandb, ``scripts/train.py:205-208``)."""

    def __init__(self, run_dir: str):
        self.path = Path(run_dir) / "metrics.jsonl"
        self.f = open(self.path, "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.tb = SummaryWriter(log_dir=str(Path(run_dir) / "tb"))
        except ImportError:
            self.tb = None

    def log(self, step: int, metrics: dict) -> None:
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()
        if self.tb is not None:
            for k, v in rec.items():
                if k != "step":
                    self.tb.add_scalar(k, v, step)

    def status(self, step: int, metrics: dict) -> None:
        """Atomic ``status.json`` for external monitors (the reference's
        status db, ``core.py:502-544``)."""
        rec = {"step": step, "time": time.time(),
               **{k: float(v) for k, v in metrics.items()}}
        tmp = self.path.parent / "status.json.tmp"
        tmp.write_text(json.dumps(rec))
        tmp.replace(self.path.parent / "status.json")

    def close(self) -> None:
        self.f.close()
        if self.tb is not None:
            self.tb.close()


class NullLogger:
    """The logger of a rank other than 0: writes nothing."""

    def log(self, step: int, metrics: dict) -> None:
        pass

    def status(self, step: int, metrics: dict) -> None:
        pass

    def close(self) -> None:
        pass


def make_put(device: torch.device):
    """Host batch (numpy) -> tensors on ``device``: integer arrays as
    int64, through pinned memory and non-blocking copies on CUDA."""
    pin = device.type == "cuda"

    def put(batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if not t.is_floating_point():
                t = t.long()
            if pin:
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=pin)
        return out

    return put


@contextlib.contextmanager
def ema_eval_view(cfg, state: TrainState):
    """The generator on its EMA weights inside the block (validation,
    best-checkpoint selection and the demos run on them, as the
    reference's EMA callback swaps them in, ``scripts/train.py:64-103``),
    its own weights restored after it."""
    if not (cfg.ema_decay and state.ema is not None):
        yield state
        return
    params = dict(state.model.named_parameters())
    saved = {k: p.detach().clone() for k, p in params.items()}
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(state.ema[k])
    try:
        yield state
    finally:
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(saved[k])


def conversion_quality(spk_emb_fn, conv_pair, yc, sr: int,
                       ref_x=None) -> dict:
    """Objective quality of one conversion demo (the reference logs the
    audio only, ``model.py:713-731``):

    * ``conversion_spk_cos_target`` / ``_source``: cosine of the converted
      audio's speaker embedding (the model's own encoder) to the target's
      and the source's; ``_pair``: source against target, the ceiling on
      any gap;
    * ``conversion_f0_rmse_log``: RMSE of the converted audio's voiced
      log-f0 against the target's log-f0 median.

    ``spk_emb_fn`` maps audio ``(N, T, 1)`` (numpy) to embeddings.  With
    ``ref_x`` the trio is embedded together with it, so that a cohort-norm
    encoder has a cohort."""
    src, tgt = conv_pair
    t = min(yc.shape[1], src.shape[1], tgt.shape[1])
    batch = [np.asarray(yc)[:, :t], np.asarray(src)[:, :t],
             np.asarray(tgt)[:, :t]]
    if ref_x is not None:
        batch.append(np.asarray(ref_x)[:, :t])
    e = np.asarray(spk_emb_fn(np.concatenate(batch, axis=0)))
    e = e.reshape(e.shape[0], -1)[:3]

    def cos(a, b):
        return float(np.dot(a, b)
                     / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))

    out = {"conversion_spk_cos_target": cos(e[0], e[2]),
           "conversion_spk_cos_source": cos(e[0], e[1]),
           "conversion_spk_cos_pair": cos(e[1], e[2])}
    from ..data.pitch import yin_f0
    f0c = yin_f0(np.asarray(yc)[0, :t, 0], sr)
    f0t = yin_f0(np.asarray(tgt)[0, :t, 0], sr)
    vc, vt = f0c[f0c > 0], f0t[f0t > 0]
    if len(vc) and len(vt):
        out["conversion_f0_rmse_log"] = float(np.sqrt(np.mean(
            (np.log(vc) - np.log(np.median(vt))) ** 2)))
    return out


def _validate(cfg, state, eval_fn, val_loader, put, ds, run_dir, step,
              logger) -> float:
    """One pass over the validation split on the EMA view: metrics, the
    audio demos, a conversion demo with its quality metrics, the latent
    PCA; returns the mean ``validation``."""
    from ..data.audio_io import save_wav
    from .latent_stats import fit_latent_pca, save_latent_stats
    model = state.model
    vals, zs = {}, []
    demo = conv_pair = None
    # the demos and the latent PCA need every row on one process, as in
    # the JAX package: a multi-rank run skips them
    single = mesh.world() == 1
    with ema_eval_view(cfg, state), torch.no_grad(), serving_mode(model):
        for vb in val_loader:
            m, y, z = eval_fn(state, put(vb))
            for k in m:
                vals.setdefault(k, []).append(float(m[k]))
            if not single:
                continue
            zs.append(z.cpu().numpy().reshape(-1, z.shape[-1]))
            if demo is None:
                demo = (np.asarray(vb["x"][0, :, 0]), y[0, :, 0].cpu().numpy())
            if (model.speaker_encoder is not None and conv_pair is None
                    and "speaker" in vb):
                # item 0 against another speaker's item
                spk = np.asarray(vb["speaker"])
                js = np.flatnonzero(spk != spk[0])
                j = int(js[0]) if len(js) else min(1, len(spk) - 1)
                conv_pair = (np.asarray(vb["x"][:1]),
                             np.asarray(vb["x"][j:j + 1]))
                ref_x = np.asarray(vb["x"])
        if demo is not None:
            adir = Path(run_dir) / "audio"
            adir.mkdir(exist_ok=True)
            orig, rec = demo
            if ds.integrator is not None:
                orig, rec = ds.integrator(orig), ds.integrator(rec)
            save_wav(str(adir / f"step{step}_original.wav"),
                     np.clip(orig, -1, 1), cfg.sampling_rate)
            save_wav(str(adir / f"step{step}_reconstruction.wav"),
                     np.clip(rec, -1, 1), cfg.sampling_rate)
        if conv_pair is not None:
            dev = next(model.parameters()).device
            yc_arr = model.convert(
                torch.from_numpy(conv_pair[0]).to(dev),
                torch.from_numpy(conv_pair[1]).to(dev)).cpu().numpy()
            yc = yc_arr[0, :, 0]
            if ds.integrator is not None:
                yc = ds.integrator(yc)
            save_wav(str(adir / f"step{step}_conversion.wav"),
                     np.clip(yc, -1, 1), cfg.sampling_rate)

            def spk_emb_fn(x):
                bands = model.pqmf_forward(torch.from_numpy(x).to(dev))
                return model.speaker_embedding(bands).cpu().numpy()

            cm = conversion_quality(spk_emb_fn, conv_pair, yc_arr,
                                    cfg.sampling_rate, ref_x=ref_x)
            for k in cm:
                vals.setdefault(k, []).append(cm[k])
    logger.log(step, {k: float(np.mean(vs)) for k, vs in vals.items() if vs})
    if zs and cfg.latent_head == "variational":
        save_latent_stats(run_dir, fit_latent_pca(np.concatenate(zs)))
    return (float(np.mean(vals["validation"])) if vals.get("validation")
            else float("nan"))


def train_main(args) -> None:
    """Train from the parsed ``train`` arguments of the CLI."""
    if getattr(args, "multihost", False):
        device = mesh.init_from_env(getattr(args, "device", "cuda"))
        print(f"rank {mesh.rank()} of {mesh.world()} on {device} "
              f"({torch.distributed.get_backend()})", flush=True)
    else:
        device = resolve_device(getattr(args, "device", "cuda"))
    try:
        _train_main(args, device)
    finally:
        if mesh.initialized():
            torch.distributed.destroy_process_group()


def _train_main(args, device) -> None:
    cfg = build_config(args.config or ["v2"], args.override)
    if args.batch:
        cfg.batch_size = args.batch
    if args.max_steps:
        cfg.max_steps = args.max_steps
    if getattr(args, "ema", None):
        cfg.ema_decay = args.ema

    run_dir = Path(args.out_path) / f"{args.name}_{cfg.hash()}"
    if mesh.rank() == 0:
        run_dir.mkdir(parents=True, exist_ok=True)
        save_config(run_dir, cfg)
    mesh.barrier()

    # the fork's encoder reads a perturbed view while the losses compare
    # against the clean signal (reference rave/dataset.py:258-289)
    want_perturb = cfg.perturb_inputs
    if getattr(args, "perturb", None) is not None:
        want_perturb = args.perturb
    perturb = noise = None
    if want_perturb:
        from ..data.perturbation import Perturb
        perturb = Perturb(cfg.sampling_rate)
    if getattr(args, "noise_path", None):
        from ..data.dataset import RandomBackgroundNoise
        noise = RandomBackgroundNoise(args.noise_path, cfg.sampling_rate,
                                      min_snr_db=14.0, max_snr_db=15.0,
                                      p=1.0)
    ds = make_dataset(args.db_path, n_signal=cfg.n_signal,
                      normalize=getattr(args, "normalize", False),
                      derivative=getattr(args, "derivative", False),
                      perturb=perturb, noise=noise)
    if perturb is not None:
        if getattr(ds, "perturbed", None) is not None:
            print(f"using {ds.perturbed.shape[1]} precomputed perturbation "
                  "variants/record (perturbed.bin)")
        elif getattr(args, "num_workers", 0) == 0:
            print("note: input perturbation is CPU-heavy (~150 ms/item); "
                  "run the `perturb` command once to precompute variants, "
                  "or use --num_workers 8")
    f0_stats = speaker_f0_stats(cfg, args, ds)
    n_speakers = len(getattr(ds, "speaker_names", []))
    if cfg.speaker_embedding_size and 0 < cfg.speaker_classes < n_speakers:
        raise ValueError(
            f"speaker_classes={cfg.speaker_classes} but the db holds "
            f"{n_speakers} speakers")

    train_idx, val_idx = split_dataset(len(ds))
    if len(val_idx) == 0:
        val_idx = train_idx[:1]
    if len(train_idx) < cfg.batch_size:
        raise ValueError(
            f"training split has {len(train_idx)} records < batch_size "
            f"{cfg.batch_size}: the loader would yield no batches "
            "(preprocess more audio or lower batch_size)")
    # one process per device; the loader's worker processes (numpy
    # only) start now and get ready while the model is built.  Every rank
    # builds its loader with seed 0, as every JAX process does, so the
    # ranks load the same items (ROADMAP C)
    train_loader = DataLoader(ds, cfg.batch_size, train_idx, shuffle=True,
                              seed=0,
                              num_workers=getattr(args, "num_workers", 0))
    # the JAX trainer's rule: at least one validation row per device, the
    # batch a whole number of devices
    n_dev = mesh.world()
    if len(val_idx) < n_dev:
        val_idx = (list(val_idx) * n_dev)[:n_dev]
    val_loader = DataLoader(
        ds, min(cfg.batch_size, (len(val_idx) // n_dev) * n_dev), val_idx,
        shuffle=False)
    try:
        _train(args, cfg, device, run_dir, ds, train_loader, val_loader,
               f0_stats)
    finally:
        train_loader.close()


def speaker_f0_stats(cfg, args, ds):
    """A pitch config's per-speaker ``(median, std)`` arrays, indexed by
    speaker id, from the ``--speaker_stats`` JSON (default
    ``<db_path>/speaker_stats.json``): a speaker the file lacks gets
    ``log 160`` and 0.5, a std below 1e-3 is raised to it.  None for
    another config, or where the file is missing (the step then takes
    each item's own statistics)."""
    if not cfg.pitch_embedding_size:
        return None
    path = Path(getattr(args, "speaker_stats", None)
                or Path(args.db_path) / "speaker_stats.json")
    if not path.exists():
        print("pitch stats: none found, using per-utterance stats")
        return None
    stats = json.loads(path.read_text())
    names = getattr(ds, "speaker_names", [])
    med = np.array([stats.get(n, {}).get("mean", np.log(160.0))
                    for n in names], np.float32)
    std = np.array([max(stats.get(n, {}).get("std", 0.5), 1e-3)
                    for n in names], np.float32)
    print(f"pitch stats: {path} ({len(stats)} speakers)")
    return med, std


def make_enrich(f0_stats):
    """``batch -> batch`` adding each item's speaker's ``f0_median`` and
    ``f0_std`` where there are statistics and speaker ids."""
    def enrich(batch: dict) -> dict:
        if f0_stats is None or "speaker" not in batch:
            return batch
        sid = np.asarray(batch["speaker"])
        return {**batch, "f0_median": f0_stats[0][sid],
                "f0_std": f0_stats[1][sid]}
    return enrich


def _train(args, cfg, device, run_dir, ds, train_loader, val_loader,
           f0_stats=None):
    """The state, the checkpoints and the loop of :func:`train_main`."""
    torch.manual_seed(0)
    state = TrainState(cfg, device=device, seed=0)
    if getattr(args, "speaker_ckpt", None):
        # the reference's VoxCeleb encoder (model.py:165-174)
        from ..models.speaker_convert import (install_speaker_weights,
                                              load_speaker_checkpoint)
        if cfg.speaker_norm == "auto" and cfg.train_speaker_encoder:
            raise SystemExit(
                "train_speaker_encoder=true resolves speaker_norm=auto to "
                "the cohort norm, which cannot load a BatchNorm-layout "
                "checkpoint; add --override speaker_norm=batch to "
                "fine-tune the pretrained encoder")
        install_speaker_weights(state.model,
                                load_speaker_checkpoint(args.speaker_ckpt))
        state.reset_ema()
        print(f"loaded pretrained speaker encoder: {args.speaker_ckpt}")
        if cfg.train_speaker_encoder:
            print("note: train_speaker_encoder=true -- the pretrained "
                  "speaker encoder will be fine-tuned, not frozen")
    main = mesh.rank() == 0
    ckpt = CheckpointManager(run_dir)
    if args.resume and ckpt.latest_step() is not None:
        ckpt.restore(state)
        if main:
            print(f"resumed from step {state.step}")
    mesh.check_replicated(state.model, state.disc)

    def save(metrics=None) -> None:
        mesh.barrier()
        if main:
            ckpt.save(state, metrics)

    step_fn = make_train_step(cfg)
    eval_fn = make_eval_step(cfg)
    to_device, enrich = make_put(device), make_enrich(f0_stats)

    def put(batch: dict) -> dict:
        return to_device(enrich(batch))

    logger = MetricLogger(run_dir) if main else NullLogger()

    # --profile: section times (load, put, step), each ending in a
    # device synchronise, and a torch.profiler trace of steps 10-15
    # under <run>/profile (rank 0's)
    prof = None
    if getattr(args, "profile", False) and main:
        from ..utils.profiler import Sections, trace
        prof = Sections()
    sec = prof if prof is not None else (lambda name: contextlib.nullcontext())

    t0 = last = time.time()
    step = first = state.step
    # the stack closes a trace that the run ends inside
    with contextlib.ExitStack() as tracing:
        batches = iter(train_loader)
        while step < cfg.max_steps:
            with sec("load"):
                batch = next(batches, None)
            if batch is None:   # the epoch ended
                batches = iter(train_loader)
                continue
            if prof is not None and step == 10:
                tracing.enter_context(trace(str(run_dir / "profile")))
            with sec("put"):
                dbatch = put(batch)
            if mesh.world() > 1 and step == first:
                # the ranks' first batches: equal, as the JAX package's
                # processes' are (ROADMAP C)
                print(f"rank {mesh.rank()}: first batch crc32 "
                      f"{mesh.checksums([dbatch['x']])[0]:08x}", flush=True)
            with sec("step"):
                metrics = step_fn(state, dbatch)
            if prof is not None and step == 15:
                tracing.close()
                print(f"device trace: {run_dir / 'profile'}")

            if step % LOG_EVERY == 0 and main:
                values = {k: float(v) for k, v in metrics.items()}
                now = time.time()
                sps = LOG_EVERY / (now - last) if step else 0.0
                last = now
                logger.log(step, {**values, "steps_per_s": sps})
                logger.status(step, {"steps_per_s": sps})
                print(f"step {step} " + " ".join(
                    f"{k}={v:.4f}" for k, v in values.items()), flush=True)
                if prof is not None and step:
                    print(prof)

            if args.val_every and step and step % args.val_every == 0:
                v = _validate(cfg, state, eval_fn, val_loader, put, ds,
                              run_dir, step, logger)
                save({"validation": v})
            if args.ckpt_every and step and step % args.ckpt_every == 0:
                save()
            step += 1
    if prof is not None:
        print(prof)
    if mesh.world() > 1:
        crc = mesh.check_replicated(state.model, state.disc)
        print(f"rank {mesh.rank()}: state equal on every rank, crc32 "
              f"{crc:08x}", flush=True)
    save()
    logger.status(state.step, {"finished": 1.0})
    logger.close()
    mesh.barrier()
    if main:
        print(f"finished at step {state.step} ({time.time() - t0:.0f}s)")
