#!/usr/bin/env python3
"""Drive the PyTorch port ``rave_tpu_torch`` on one CUDA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero before
the last line:

0. device: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; TF32 off for matmuls and cuDNN convs (the port's reference
   numbers are float32).
1. build: every kernel of the port compiled from ``rave_tpu_torch/csrc``
   with ``nvcc`` (one process per source, in parallel).
2. kernels: each kernel against its plain PyTorch version on the card,
   over a grid of shapes (B1: atol 1e-4, rtol 1e-3, k in {1, 3, 5},
   T from 1 to 65535 * 64 + 1, C up to 512 with C=384, every GEMM-1
   chunk width; B2/B3: atol 1e-5, rtol 1e-4, odd T, unaligned window
   starts, co up to 64), gradients through each ``autograd.Function``;
   then, at the shapes the main path gives it, the same check, the launch
   configuration (CTAs, cluster, registers, shared memory), the
   CUDA-event time of a call through the wrapper (``ms``) and the summed
   device time of every kernel that call launches (``device_ms``,
   ``torch.profiler``), each beside the plain version's, and its bounds.
3. offline: the full-width v2 codec (``fused_kernels=true``, random
   weights from seed 0) serves a batch of 4 requests of 131072 samples;
   the output is finite, has the input's shape, agrees with the plain
   path on the card and with the CPU on a short input, and kernel B1 was
   launched exactly 16 times.  CUDA-event median batch time and RTF.
4. streaming: ``StreamingRAVE`` over one request in 2048-sample chunks,
   held against the offline output shifted by ``total_delay_samples()``
   (median relative error < 0.02).  Median chunk latency and RTF.
5. profile: ``torch.profiler`` over one offline batch and 16 streamed
   chunks: kernel time on the card against wall time, and the top kernels.
6. train: the full-width ``v2_fork`` preset (random weights from seed 0,
   batch 8 x 131072 and unit ids from the seed), its step counter at
   ``phase_1_duration`` so that the discriminators run: one D, G, G, G
   cycle as warm-up, then timed cycles.  Every metric finite with the
   JAX package's names; kernels B2/B3 launched exactly 3/0 times per D
   step and 3/3 per G step; D parameters move only on D steps, ENC/DEC
   only on G steps, the speaker encoder never; one G step on a short
   input (1 x 65536) equals the CPU's losses and per-group gradient norms
   (rtol 1e-3).  CUDA-event median D and G step times, audio seconds
   trained per second, peak memory and a profile of one G step.
7. train_v2: the full-width upstream ``v2`` preset with
   ``fused_kernels=true`` (random weights from seed 0, batch 8 x 131072),
   its step counter at ``phase_1_duration - 2``: G, G in phase 1, then D,
   G, G, G.  On every step: the JAX package's metric names, every value
   finite, the KL term positive on G steps, the GAN terms zero in phase 1
   and non-zero after, D parameters moving only on D steps and ENC/DEC
   only on G steps, kernel B1 launched exactly 16 times (a D step
   recomputes the generator's forward) and B2/B3 never.  Then three
   timed D, G, G, G cycles of the fused state and of a
   ``fused_kernels=false`` copy with the same weights and optimizer
   state, in turns: median D and G step times, audio seconds trained per
   second and peak memory of each.  One G step on a short input
   (1 x 65536, ``log_epsilon=1e-3``) with the same latent noise equals
   the CPU's losses and ENC/DEC gradient norms (rtol 1e-3); the eval
   step's ``validation`` is finite; a profile of one fused G step gives
   B1's share.
8. voice_conversion: the full-width ``v2_fork`` preset with
   ``fused_kernels=true`` (random weights from seed 0) and four synthetic
   speakers (harmonic tones at distinct f0 plus noise, 262144 samples
   each).  Offline ``RAVE.convert`` of 4 sources x 131072 samples
   against 4 targets: finite, shaped like the input, kernel B1 launched
   exactly 16 times, equal to a ``fused_kernels=false`` copy and to the
   CPU (1 x 65536) within 2e-4; CUDA-event median of 10 calls, RTF, peak
   memory and a profile.  Speaker tables (``embed_speaker_audio`` of each
   speaker with the other three as its cohort) of the BatchNorm encoder
   and of a ``speaker_norm=cohort`` copy: finite, equal to the CPU's
   within 1e-4 of their largest magnitude, the cohort rows distinct.
   ``VoiceConverter`` over one 131072-sample request in 4096-sample
   chunks against table row 1: against the offline conversion shifted by
   the streaming delay (median relative error < 0.02), no B1 launch,
   chunk latency median and p80; then 8 learn-target chunks (zeros out)
   whose mean embedding equals the CPU converter's; ``set_speaker``
   clears it.  The fork's ``StreamingRAVE`` over 8 chunks of 2048: card
   against CPU chunk by chunk within 2e-4.
9. train_vc: training a voice-conversion fork from scratch.  (a) The
   full-width ``v2_fork`` preset with ``fused_kernels=true
   train_speaker_encoder=true speaker_classes=8
   latent_adversary_weight=0.5`` (cohort norm), batch 8 x 131072 of the
   synthetic speakers (one per class), a seeded gain/EQ perturbed view
   and seeded unit ids, from ``phase_1_duration``: one D, G, G, G cycle
   (kernels B1/B2/B3 launched 16/3/0 times per D step and 16/3/3 per G
   step; every metric finite with the JAX package's names, the speaker
   terms non-zero on G steps only; DIS moves only on D steps, ENC, DEC
   and SPK only on G steps), three timed cycles, then a D, G pair at
   4 x 65536 against the CPU (one thread): losses and ENC/DEC/SPK
   gradient norms rtol 1e-3.  The same for a ``speaker_norm=batch``
   copy, whose running statistics advance on every step and equal the
   CPU's after the D and the G step (rtol 1e-4).  A profile of one G
   step and the speaker encoder's share of it.  (b) ``python -m
   rave_tpu_torch.cli`` preprocess, perturb (2 variants), units and
   train (12 steps, ``phase_1_duration=4``, validation and checkpoints
   at step 8, two loader workers, ``--profile``) on 8 speakers x 4 clips
   of 131072 samples written under ``_smoke/``: the speaker CE,
   validation and conversion metrics logged, the last and best
   checkpoints written, the last one restoring bit for bit on the card;
   then ``--resume`` to step 16.  Steps per second and the loader's
   share from the section times.
10. export: the serving surface of a trained run.  (a) The offline
   phase's v2 weights in a ``StreamingRAVE`` of 2048-sample chunks, batch
   1: ``process_file_scan`` (the chunk step captured once in a CUDA
   graph, replayed per chunk) against ``process_file`` over 64 chunks
   (max abs difference <= 2e-4; ms per chunk of each, median of 5 runs;
   host launch calls and device kernels per chunk by ``torch.profiler``;
   no B1 launch); ``serialize``, then ``forward.pt2``, and ``encode.pt2``
   then ``decode.pt2``, reloaded and run from ``cache_init`` over 8 chunks
   against the live stream (<= 2e-4), the manifest's cache bytes equal
   to ``cache_init.bin``'s size and the live caches'; a host rate of
   88200 Hz (``host_chunk`` 4096, outputs ``(1, 4096, 1)``) against the
   CPU's host-rate stream on one thread over 8 host chunks (<= 2e-4);
   fake stereo ``(1, 2048, 2)`` with equal channels; the latent PCA of
   the offline batch's latents, every direction kept, round trip <= 1e-4.
   (c) ``RealtimeHost`` over that stream: 32 blocks pushed, pulled until
   all are back, equal to ``process_file`` (<= 2e-4); blocks processed,
   underruns, median block time against the 46.4 ms a block lasts.
   (b) ``python -m rave_tpu_torch.cli export --voice_conversion`` of phase
   9(b)'s run with 4 speakers' clips, chunk 4096, as a subprocess: every
   artifact present; the reloaded ``convert.pt2`` over 8 chunks against
   table row 1 equal to a live ``VoiceConverter`` of the same checkpoint,
   and ``forward.pt2`` to the live stream (<= 2e-4); ``cli eval`` writes
   32 points from 8 speakers.  ``_smoke/`` is removed after it.
11. pitch: the fork's f0-conditioned preset (``v2_fork`` + ``pitch``,
   ``fused_kernels=true``, random weights from seed 0) on four synthetic
   speakers whose f0 rises and falls by 10 %.  (a) ``RAVE.convert`` of
   4 sources x 131072 against 4 targets with YIN f0: B1 16 launches,
   fused vs plain and card vs CPU (1 x 65536) within 2e-4; YIN f0 card
   vs CPU (the same voiced frames, f0 rtol 1e-4) and the f0 feature
   (1e-5 in log-f0 units); CUDA-event median of 10 calls, peak memory,
   a profile and the f0 feature's share of the call's device time.  (b)
   A random-weight FCPE checkpoint in torchfcpe's layout under
   ``_smoke/`` (its output bias a bump at 220 Hz): ``fcpe_f0`` card vs
   CPU, a ``convert`` with ``pitch_estimator=fcpe`` (B1 16), ``cli
   speaker_stats --pitch_ckpt`` over 4 speakers x 2 clips on the card
   and on the CPU (JSON rtol 1e-4), ``cli validate_assets --fcpe_ckpt
   --out _smoke/assets.md`` whose FCPE row passes.  (c) One D and three
   G steps at batch 8 x 131072 with the batch's speaker statistics: B1,
   B2, B3 launched 16, 3, 0 times per D step and 16, 3, 3 per G step,
   the metric names, finite values; D and G ms, peak memory; one G step
   at 4 x 65536 card vs CPU (one thread): losses and ENC/DEC gradient
   norms rtol 1e-3.  (d) ``VoiceConverter`` with f0 over 32 chunks of
   4096 (median and p80 against the 92.9 ms a chunk lasts, no B1), card
   vs CPU over 8 chunks within 2e-4; ``serialize``, and the reloaded
   ``convert_pg.pt2`` over 8 chunks against the live in-graph step
   within 2e-4.  (e) ``measure_receptive_field`` of the conv stacks on
   the card equal to the CPU's, inside ``receptive_field_frames``' crop.
12. discrete_v3: the residual-VQ and v3 presets at full width.  (a)
   ``discrete`` with ``fused_kernels=true`` (16 quantizers x 1024 codes,
   latent 128, capacity 96; random weights from seed 0), its codebooks
   from one k-means-init train pass over 4 synthetic voices x 131072:
   the offline forward of that batch (kernel B1 exactly 6 launches, its
   384-channel units), fused vs plain (audio 2e-4; RVQ indices: at least
   99.9 % equal, each that differs between two codes equally near within
   1e-4), card vs CPU on 8192 samples (the same), CUDA-event median batch
   time, RTF, peak memory and a profile (B1's share and count); request 0
   streamed in 2048-sample chunks through ``encode_indices`` then
   ``decode_indices`` (no B1), against the offline output shifted by the
   streaming delay (median relative error < 0.02), chunk latency median
   and p80; ``serialize`` and the reloaded ``forward.pt2`` against the
   live stream over 4 chunks (2e-4).  D, G, G, G at 8 x 131072 from
   ``phase_1_duration`` (B1 6 launches per D and per G step, metrics
   finite), three timed cycles, the codebooks finite; a D, G pair at
   4 x 65536 from zero codebooks, card vs CPU (one thread, the same
   random rows on both, ``learning_rate=1e-6``): losses, ENC/DEC
   gradient norms and the D step's DIS gradient norm rtol 1e-3, the
   codebook buffers after each step rtol 1e-4; one D step at the
   preset's rate on 1 x 65536, card vs CPU, 99.9 % of the
   discriminator's parameters within 1 % of the rate.  (b) ``v3``
   (Snake, AdaIN, Descript discriminator; no B1): the offline forward
   of 4 x 131072, card vs CPU on 8192 samples
   (2e-4), batch time; the AdaIN controls workflow (a plain stream,
   target statistics from a louder voice, source statistics, the
   transfer from fresh caches; 16 chunks of 2048 each) card vs CPU
   chunk by chunk and in the final AdaIN state (2e-4), the transfer
   differing from the plain stream; the same workflow through
   ``process_file_scan``'s CUDA graph (which starts from and updates
   the live AdaIN state) against the eager one (2e-4).  D, G, G, G at
   8 x 131072, three timed cycles, a profile of one G step and the
   Descript discriminator's device time (forward
   and data gradient on the cropped batch, frozen, as a G step runs it)
   against it; one G step at
   1 x 65536 (``log_epsilon=1e-3``) card vs CPU, rtol 1e-3.  (c)
   ``discrete_v3``: a D, G pair card vs CPU as in (a).
13. native: the exported steps served by the C++ host
   (``csrc/aoti_host.cpp``, built once with ``g++`` against libtorch) from
   AOTInductor packages (``export/native.py``), one CUDA graph replay per
   block, no Python.  (a) The offline phase's v2 weights, ``serialize``
   at chunk 2048, ``forward`` compiled and served over 64 blocks of
   request 0: every block and the last caches equal to
   ``StreamingRAVE.forward`` over the same chunks (<= 2e-4); compile
   seconds, package size, pipelined and blocking RTF, p50/p80 block ms,
   beside the same call's ``process_file_scan`` and ``process_file`` ms
   per chunk; the kernels of one block of the package (loaded in Python,
   ``torch.profiler``) against the eager step's.  (b) Run while phase
   10(b)'s run exists: its ``convert.pt2`` over 32 blocks of 4096 of a
   speaker's clip against the reloaded program with a zero embedding
   (<= 2e-4).  (c) Phase 11's ``convert_pg.pt2`` over 32 blocks of 4096
   of a gliding voice (YIN voiced) against the reloaded program (<= 2e-4,
   the carried f0 tail equal); the operators each package runs through
   the proxy executor.  (d) The host exits 1 with its message on a
   package compiled for the CPU (a tiny v2, compiled in a subprocess
   meanwhile), a missing package, and a manifest whose ``out`` lines are
   rotated by one.  B1 runs in no package block and is launched by no
   Python call of the phase.  ``_smoke/`` is removed after phase 10 and
   after this one.

Before the last line it prints the ``nvidia-smi`` line and one JSON
object ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout that holds ``rave_tpu_torch``, it exits non-zero with no result.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time

SEED = 0
BATCH, SAMPLES, CHUNK = 4, 131072, 2048
TRAIN_BATCH = 8
PEAK_F32_FLOPS = 67e12   # H100 SXM, float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM, dense TF32 on the tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
KERNEL_TOL = dict(atol=1e-4, rtol=1e-3)
GRAD_TOL = dict(atol=1e-3, rtol=1e-3)
# B2/B3: sums of 15 float32 products; the JAX package's own tests use
# atol 1e-5 and rtol 1e-4 for these kernels
CI1_TOL = dict(atol=1e-5, rtol=1e-4)
TRAIN_RTOL = 1e-3        # card vs CPU losses and gradient norms, TF32 off
# the JAX package's _metric_names for v2_fork (tests/test_torch_train.py
# holds the port's equal to them), plus the schedule values
TRAIN_METRICS = sorted([
    "loss_adversarial", "loss_audio", "loss_ce", "loss_dis",
    "loss_feature_matching", "loss_gen_total", "loss_regularization",
    "beta", "warmed_up"])
# the JAX package's _metric_names for v2 (tests/test_torch_train.py holds
# the port's equal to them), plus the schedule values
TRAIN_V2_METRICS = sorted([
    "loss_adversarial", "loss_ce", "loss_dis", "loss_feature_matching",
    "loss_fullband_spectral_distance", "loss_gen_total",
    "loss_multiband_spectral_distance", "loss_regularization", "beta",
    "warmed_up"])
OFFLINE_TOL = 2e-4       # max |fused - plain| on tanh-bounded audio
CPU_TOL = 2e-4           # max |card - cpu| on tanh-bounded audio
# voice conversion: 262144 samples per speaker, so that enrollment's
# segments (max(32768, len // 4) = 65536) are a multiple of the 16 bands
VC_SPEAKERS, VC_SAMPLES, VC_CHUNK = 4, 262144, 4096
EMB_TOL = 1e-4           # max |card - cpu| / max |e| of speaker embeddings


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events over ``iters``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20) -> float:
    """Device time of ``fn`` in ms: the summed time of every CUDA kernel
    it runs, by ``torch.profiler`` over ``iters`` calls, per call.  Host
    work and gaps between kernels are not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / iters


def unit_inputs(torch, B, C, T, k=3, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    return (r(B, C, T), r(C, C, k) / (C * k) ** 0.5, r(C) * 0.1,
            r(C, C) / C ** 0.5, r(C) * 0.1)


def pads(k, d):
    p = (k - 1) * d
    return (p + 1) // 2, p // 2


def phase_kernels(torch, ru, launches_per_shape):
    """Kernel B1 vs its plain twin, then timings at the shapes each path
    gives it: ``launches_per_shape`` maps ``(path, B, T, C, d)`` to the
    launches per call of that path (a forward, a train step)."""
    max_err = 0.0
    n = 0
    grid = [(3, C, d, T, B) for C in (128, 256, 512) for d in (1, 3, 9)
            for T in (1, 64, 333, 2048) for B in (1, 4)]
    # other tap counts (1: no halo; 5: an 18- to 36-step halo) and the
    # six-CTA cluster of C = 384
    grid += [(k, C, d, T, 2) for k in (1, 5) for C in (128, 256, 384, 512)
             for d in (1, 9) for T in (1, 333)]
    # windows too wide for GEMM 1's chunks of 32 input channels: d = 300
    # takes chunks of 16, d = 700 chunks of 8
    for d, chunk in ((300, 16), (700, 8)):
        got = ru.launch_info(1, 128, 333, 3, d)["chunk"]
        check(got == chunk, f"B1 d={d}: chunk {got}, expected {chunk}")
        grid.append((3, 128, d, 333, 1))
    # more time tiles than grid.y or grid.z could hold (65535)
    grid.append((3, 128, 1, 65535 * 64 + 1, 1))
    for k, C, d, T, B in grid:
        args = unit_inputs(torch, B, C, T, k=k, seed=n)
        pl, pr = pads(k, d)
        got = ru.residual_unit_cuda(*args, d, pl, pr)
        want = ru.residual_unit_reference(*args, d, pl, pr)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, **KERNEL_TOL),
              f"B1 k={k} C={C} d={d} T={T} B={B}: max err {err}")
        max_err = max(max_err, err)
        n += 1
    del args, got, want
    torch.cuda.empty_cache()

    # one gradient through the autograd.Function
    args = [a.clone().requires_grad_(True)
            for a in unit_inputs(torch, 2, 256, 333, seed=99)]
    ref = [a.detach().clone().requires_grad_(True) for a in args]
    pl, pr = pads(3, 3)
    (ru.residual_unit(*args, 3, pl, pr) ** 2).sum().backward()
    (ru.residual_unit_reference(*ref, 3, pl, pr) ** 2).sum().backward()
    grad_err = max((a.grad - r.grad).abs().max().item()
                   for a, r in zip(args, ref))
    check(all(torch.allclose(a.grad, r.grad, **GRAD_TOL)
              for a, r in zip(args, ref)), f"B1 gradient: max err {grad_err}")
    emit({"phase": "kernels", "name": "residual_unit", "cases": n,
          "max_abs_err": max_err, "grad_max_abs_err": grad_err,
          "tolerance": KERNEL_TOL})

    shapes = []
    for (path, B, T, C, d), count in launches_per_shape.items():
        args = unit_inputs(torch, B, C, T, seed=C + d)
        pl, pr = pads(3, d)
        kernel = lambda: ru.residual_unit_cuda(*args, d, pl, pr)  # noqa: E731
        plain = lambda: ru.residual_unit_reference(  # noqa: E731
            *args, d, pl, pr)
        with torch.inference_mode():
            got, want = kernel(), plain()
            err = (got - want).abs().max().item()
            check(torch.allclose(got, want, **KERNEL_TOL),
                  f"B1 main-path shape {(B, T, C)} d={d}: max err {err}")
            max_err = max(max_err, err)
            # call times: plain, kernel, kernel, plain; best of each pair
            plain_ms = cuda_ms(torch, plain)
            ms = cuda_ms(torch, kernel)
            ms2 = cuda_ms(torch, kernel)
            plain_ms2 = cuda_ms(torch, plain)
            dev_ms, plain_dev_ms = device_ms(torch, kernel), device_ms(
                torch, plain)
        k = 3
        info = ru.launch_info(B, C, T, k, d)
        check(info["ctas"] >= 128, f"B1 {(B, T, C)}: {info['ctas']} CTAs")
        flops = 2 * B * T * C * C * (k + 1)
        nbytes = 4 * (2 * B * T * C + (k + 1) * C * C + 2 * C)
        # the kernel runs on the tensor cores in 3xTF32: three products
        # per term; the float32-FMA bound is kept beside it
        t_f32 = flops / PEAK_F32_FLOPS * 1e3
        t_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        shapes.append({
            "shape": [B, T, C], "dilation": d, "path": path,
            "launches_per_call": count,
            "max_abs_err": err, "launch": info,
            "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2),
            "device_ms": dev_ms, "plain_device_ms": plain_dev_ms,
            "bound_ms": max(t_ops, t_bytes), "ops_ms": t_ops,
            "ops_ms_f32": t_f32, "bound_ms_f32": max(t_f32, t_bytes),
            "bytes_ms": t_bytes,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6})
    emit({"phase": "kernel_times", "name": "residual_unit", "shapes": shapes})
    return max_err, shapes


def ci1_inputs(torch, B, T, k, co=16, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    return r(B, 1, T), r(co, 1, k) * 0.3, r(B, co, T)


def ci1_bound(B, T, co, k):
    """(ms bound by operations, ms bound by bytes) of B2 or B3: each
    input read once, each output written once."""
    flops = 2 * B * T * co * k
    nbytes = 4 * (B * T + B * T * co + k * co)
    return flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def phase_ci1_kernels(torch, ci, main_shapes):
    """Kernels B2 (forward) and B3 (data gradient) vs their plain twins
    on a grid, gradients through the autograd.Function, then times at
    the main path's shapes."""
    err = {"fwd": 0.0, "dx": 0.0}
    n = 0
    for T in (777, 1000, 4096, 8192, 91232):
        for k in (5, 15):
            for pad in (((k - 1) // 2, k // 2), (k - 1, 0)):
                for B in (1, 16):
                    x, w, gy = ci1_inputs(torch, B, T, k, seed=n)
                    pairs = (
                        ("fwd", ci.conv1d_ci1_cuda(x, w, pad),
                         ci.conv1d_ci1_reference(x, w, pad)),
                        ("dx", ci.conv1d_ci1_dx_cuda(gy, w, pad),
                         ci.conv1d_ci1_dx_reference(gy, w, pad)))
                    torch.cuda.synchronize()
                    for name, got, want in pairs:
                        e = (got - want).abs().max().item()
                        check(got.shape == want.shape and torch.allclose(
                            got, want, **CI1_TOL),
                            f"B2/B3 {name} T={T} k={k} pad={pad} B={B}: "
                            f"max err {e}")
                        err[name] = max(err[name], e)
                    n += 1

    # odd T, windows that start off a 16-byte boundary, co other than 16
    # (B3 stages 16 channel rows at a time)
    for T in (1, 31, 1001, 8193):
        for k in (2, 8, 16):
            for pad in (((k - 1) // 2, k // 2), (0, k - 1)):
                co = (1, 24, 64)[n % 3]
                x, w, gy = ci1_inputs(torch, 3, T, k, co=co, seed=n)
                pairs = (
                    ("fwd", ci.conv1d_ci1_cuda(x, w, pad),
                     ci.conv1d_ci1_reference(x, w, pad)),
                    ("dx", ci.conv1d_ci1_dx_cuda(gy, w, pad),
                     ci.conv1d_ci1_dx_reference(gy, w, pad)))
                torch.cuda.synchronize()
                for name, got, want in pairs:
                    e = (got - want).abs().max().item()
                    check(got.shape == want.shape and torch.allclose(
                        got, want, **CI1_TOL),
                        f"B2/B3 {name} T={T} k={k} pad={pad} co={co}: "
                        f"max err {e}")
                    err[name] = max(err[name], e)
                n += 1

    # dx and dw through the autograd.Function vs autograd of the plain
    # composition (dw is the library rule in both)
    x, w, gy = ci1_inputs(torch, 4, 8192, 15, seed=99)
    args = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    ref = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    (ci.conv1d_ci1(*args, (7, 7)) * gy).sum().backward()
    (ci.conv1d_ci1_reference(*ref, (7, 7)) * gy).sum().backward()
    grad_err = [(a.grad - r.grad).abs().max().item() for a, r in zip(args, ref)]
    check(torch.allclose(args[0].grad, ref[0].grad, **CI1_TOL)
          and torch.allclose(args[1].grad, ref[1].grad, **GRAD_TOL),
          f"B2/B3 autograd: max err dx {grad_err[0]} dw {grad_err[1]}")
    emit({"phase": "kernels", "name": "ci1_conv", "cases": n,
          "max_abs_err_fwd": err["fwd"], "max_abs_err_dx": err["dx"],
          "grad_max_abs_err_dx": grad_err[0],
          "grad_max_abs_err_dw": grad_err[1], "tolerance": CI1_TOL})

    shapes = []
    for B, T in main_shapes:
        x, w, gy = ci1_inputs(torch, B, T, 15, seed=T)
        row = {"shape": [B, T, 16], "k": 15, "pad": [7, 7],
               "dx_launch": ci.dx_launch_info(B, 16, 15, T)}
        with torch.no_grad():
            for name, cuda_fn, plain_fn, arg in (
                    ("fwd", ci.conv1d_ci1_cuda, ci.conv1d_ci1_reference, x),
                    ("dx", ci.conv1d_ci1_dx_cuda, ci.conv1d_ci1_dx_reference,
                     gy)):
                kernel = lambda: cuda_fn(arg, w, (7, 7))  # noqa: E731
                plain = lambda: plain_fn(arg, w, (7, 7))  # noqa: E731
                got, want = kernel(), plain()
                e = (got - want).abs().max().item()
                check(torch.allclose(got, want, **CI1_TOL),
                      f"B2/B3 {name} main-path shape {(B, T)}: max err {e}")
                err[name] = max(err[name], e)
                # call times: plain, kernel, kernel, plain; best of each pair
                plain_ms = cuda_ms(torch, plain)
                ms = cuda_ms(torch, kernel)
                ms2 = cuda_ms(torch, kernel)
                plain_ms2 = cuda_ms(torch, plain)
                t_ops, t_bytes = ci1_bound(B, T, 16, 15)
                row[name] = {"max_abs_err": e, "ms": min(ms, ms2),
                             "plain_ms": min(plain_ms, plain_ms2),
                             "device_ms": device_ms(torch, kernel),
                             "plain_device_ms": device_ms(torch, plain),
                             "bound_ms": max(t_ops, t_bytes),
                             "ops_ms": t_ops, "bytes_ms": t_bytes}
        shapes.append(row)
    emit({"phase": "kernel_times", "name": "ci1_conv", "shapes": shapes})
    return err, shapes


def device_profile(torch, fn, names=()) -> dict:
    """One run of ``fn`` under ``torch.profiler``: wall time, the summed
    time of the kernels on the card, the idle share, the top kernels and
    the summed time of the kernels whose name holds each of ``names``.
    The profiler's own host cost inflates the wall time, so the idle share
    is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1 - device_ms / wall_ms if device_ms else None,
            "kernel_count": sum(e.count for e in kernels),
            "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                    for e in top],
            "named_ms": {n: sum(e.self_device_time_total for e in kernels
                                if n in e.key) / 1e3 for n in names},
            "named_count": {n: sum(e.count for e in kernels if n in e.key)
                            for n in names}}


def train_batch(torch, np, B, T, frames, seed=SEED):
    """Audio (B, T, 1): sines at seeded pitches plus noise; unit ids
    (B, frames) in [0, 100)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 44100
    audio = np.stack([0.3 * np.sin(2 * np.pi * f * t)
                      + 0.05 * rng.standard_normal(T)
                      for f in rng.uniform(80, 800, B)])
    units = rng.integers(0, 100, (B, frames))
    return {"x": torch.tensor(audio[:, :, None], dtype=torch.float32,
                              device="cuda"),
            "units": torch.tensor(units, device="cuda")}


def phase_train(torch, np, KERNELS):
    """The full-width v2_fork train step on the card (see the module
    docstring, phase 6)."""
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.train import loop, schedules

    counts = lambda: {k.name: k.launches for k in KERNELS}  # noqa: E731

    def reset():
        for k in KERNELS:
            k.launches = 0

    cfg = build_config(["v2_fork"])
    torch.manual_seed(SEED)
    state = loop.TrainState(cfg, device="cuda", step=cfg.phase_1_duration)
    step_fn = loop.make_train_step(cfg)
    batch = train_batch(torch, np, cfg.batch_size, cfg.n_signal, 148)
    groups = {"dis": list(state.disc.parameters()),
              "enc": state.enc_params, "dec": state.dec_params,
              "speaker": list(state.model.speaker_encoder.parameters())}
    expect_launches = {"D": {"residual_unit": 0, "ci1_conv_forward": 3,
                             "ci1_conv_dx": 0},
                       "G": {"residual_unit": 0, "ci1_conv_forward": 3,
                             "ci1_conv_dx": 3}}

    # warm-up cycle D, G, G, G: launches, metrics, which groups move
    cycle = []
    for _ in range(4):
        kind = "D" if schedules.is_discriminator_step(state.step, cfg) \
            else "G"
        before = {g: [p.detach().clone() for p in ps]
                  for g, ps in groups.items()}
        reset()
        metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        launches = counts()
        check(launches == expect_launches[kind],
              f"{kind} step launches {launches}")
        values = {k: float(v) for k, v in metrics.items()}
        check(sorted(values) == TRAIN_METRICS, f"metric names {sorted(values)}")
        check(all(np.isfinite(v) for v in values.values()),
              f"{kind} step metrics not finite: {values}")
        moved = {g: any(not torch.equal(p, q) for p, q in zip(ps, before[g]))
                 for g, ps in groups.items()}
        want = {"dis": kind == "D", "enc": kind == "G", "dec": kind == "G",
                "speaker": False}
        check(moved == want, f"{kind} step moved {moved}, expected {want}")
        cycle.append({"kind": kind, "launches": launches, "metrics": values})
    check([c["kind"] for c in cycle] == ["D", "G", "G", "G"],
          f"cycle {[c['kind'] for c in cycle]}")

    # timed cycles
    torch.cuda.reset_peak_memory_stats()
    times = {"D": [], "G": []}
    for _ in range(3 * 4):
        kind = "D" if schedules.is_discriminator_step(state.step, cfg) \
            else "G"
        times[kind].append(cuda_ms(torch, lambda: step_fn(state, batch),
                                   iters=1, warmup=0))
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    d_ms, g_ms = statistics.median(times["D"]), statistics.median(times["G"])
    audio_s = cfg.batch_size * cfg.n_signal / cfg.sampling_rate

    # one G step on the card vs the CPU, on a short input
    short = build_config(["v2_fork"], ["n_signal=65536", "batch_size=1"])
    g_step = short.phase_1_duration + 1
    torch.manual_seed(SEED + 1)
    card = loop.TrainState(short, device="cuda", step=g_step)
    cpu = loop.TrainState(short, device="cpu", step=g_step)
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               card.model.state_dict().items()})
    cpu.disc.load_state_dict({k: v.cpu() for k, v in
                              card.disc.state_dict().items()})
    sb = {"x": batch["x"][:1, :65536], "units": batch["units"][:1, :74]}
    reset()
    step_fn_short = loop.make_train_step(short)
    m_card = {k: float(v) for k, v in step_fn_short(card, sb).items()}
    short_launches = counts()
    m_cpu = {k: float(v) for k, v in step_fn_short(
        cpu, {k: v.cpu() for k, v in sb.items()}).items()}

    def norms(st):
        return {g: float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                        for p in ps)))
                for g, ps in (("enc", st.enc_params), ("dec", st.dec_params))}

    n_card, n_cpu = norms(card), norms(cpu)
    rel = {k: abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12)
           for k in m_cpu}
    rel.update({f"grad_norm_{g}": abs(n_card[g] - n_cpu[g]) / n_cpu[g]
                for g in n_cpu})
    check(max(rel.values()) <= TRAIN_RTOL, f"card vs cpu G step: {rel}")
    check(short_launches["ci1_conv_forward"] == 2
          and short_launches["ci1_conv_dx"] == 2,
          f"short G step launches {short_launches}")
    del card, cpu

    # where the time of one G step goes
    def one_g_step():
        state.step = cfg.phase_1_duration + 4 * 10 + 1
        step_fn(state, batch)

    prof = device_profile(torch, one_g_step,
                          names=("ci1_fwd_kernel", "ci1_dx_kernel"))
    prof["share"] = {n: ms / prof["device_ms"]
                     for n, ms in prof["named_ms"].items()}
    emit({"phase": "train", "config": "v2_fork",
          "params": {g: sum(p.numel() for p in ps)
                     for g, ps in groups.items()},
          "batch": [cfg.batch_size, cfg.n_signal, 1],
          "start_step": cfg.phase_1_duration, "warmup_cycle": cycle,
          "d_step_ms": d_ms, "g_step_ms": g_ms,
          "d_step_ms_all": times["D"], "g_step_ms_all": times["G"],
          "audio_s_per_step": audio_s,
          "audio_s_per_s": 4 * audio_s / ((d_ms + 3 * g_ms) / 1e3),
          "peak_mem_mb": peak_mb,
          "card_vs_cpu": {"rel_err": rel, "card": m_card,
                          "grad_norms_card": n_card,
                          "grad_norms_cpu": n_cpu,
                          "launches": short_launches},
          "g_step_profile": prof})
    return cycle[1]["launches"]


def phase_train_v2(torch, np, KERNELS):
    """The full-width upstream v2 train step with kernel B1 (see the
    module docstring, phase 7).  Returns B1's launches per step."""
    import copy
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.train import loop, schedules

    counts = lambda: {k.name: k.launches for k in KERNELS}  # noqa: E731

    def reset():
        for k in KERNELS:
            k.launches = 0

    def kind_of(st):
        return "D" if schedules.is_discriminator_step(st.step, st.cfg) else "G"

    cfg = build_config(["v2"], ["fused_kernels=true"])
    torch.manual_seed(SEED)
    state = loop.TrainState(cfg, device="cuda",
                            step=cfg.phase_1_duration - 2, seed=SEED)
    step_fn = loop.make_train_step(cfg)
    batch = {"x": train_batch(torch, np, TRAIN_BATCH, cfg.n_signal, 1)["x"]}
    groups = {"dis": list(state.disc.parameters()),
              "enc": state.enc_params, "dec": state.dec_params}
    expect = {"residual_unit": 16, "ci1_conv_forward": 0, "ci1_conv_dx": 0}

    # warm-up: G, G in phase 1, then D, G, G, G
    warmup = []
    for _ in range(6):
        kind, warm = kind_of(state), schedules.warmed_up(state.step, cfg)
        before = {g: [p.detach().clone() for p in ps]
                  for g, ps in groups.items()}
        reset()
        metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        launches = counts()
        check(launches == expect, f"v2 {kind} step launches {launches}")
        values = {k: float(v) for k, v in metrics.items()}
        check(sorted(values) == TRAIN_V2_METRICS,
              f"v2 metric names {sorted(values)}")
        check(all(np.isfinite(v) for v in values.values()),
              f"v2 {kind} step metrics not finite: {values}")
        if kind == "G":
            # the hinge generator term -mean(score) takes either sign
            check(values["loss_regularization"] > 0
                  and (values["loss_adversarial"] != 0) == warm
                  and (values["loss_feature_matching"] > 0) == warm,
                  f"v2 G step (warmed up: {warm}) terms {values}")
        moved = {g: any(not torch.equal(p, q) for p, q in zip(ps, before[g]))
                 for g, ps in groups.items()}
        want = {"dis": kind == "D", "enc": kind == "G", "dec": kind == "G"}
        check(moved == want, f"v2 {kind} step moved {moved}, expected {want}")
        warmup.append({"kind": kind, "warmed_up": warm, "launches": launches,
                       "metrics": values})
    check([(c["kind"], c["warmed_up"]) for c in warmup]
          == [("G", False), ("G", False), ("D", True), ("G", True),
              ("G", True), ("G", True)], f"v2 warm-up {warmup}")
    del before

    # a copy on the plain path with the same weights and optimizer state
    plain = loop.TrainState(build_config(["v2"], ["fused_kernels=false"]),
                            device="cuda", step=state.step, seed=SEED)
    plain.model.load_state_dict(state.model.state_dict())
    plain.disc.load_state_dict(state.disc.state_dict())
    for name in ("enc_opt", "dec_opt", "dis_opt"):
        getattr(plain, name).load_state_dict(
            copy.deepcopy(getattr(state, name).state_dict()))
    plain_fn = loop.make_train_step(plain.cfg)

    # timed: D, G, G, G cycles, fused and plain in turns
    runs = {"fused": (state, step_fn, 16), "plain": (plain, plain_fn, 0)}
    times = {r: {"D": [], "G": []} for r in runs}
    peak = {r: 0.0 for r in runs}
    for _ in range(3):
        for name, (st, fn, b1) in runs.items():
            torch.cuda.reset_peak_memory_stats()
            for _ in range(4):
                kind = kind_of(st)
                reset()
                times[name][kind].append(cuda_ms(
                    torch, lambda: fn(st, batch), iters=1, warmup=0))
                check(counts()["residual_unit"] == b1,
                      f"v2 {name} {kind} step: B1 launches {counts()}")
            peak[name] = max(peak[name],
                             torch.cuda.max_memory_allocated() / 2 ** 20)
    audio_s = TRAIN_BATCH * cfg.n_signal / cfg.sampling_rate
    timing = {}
    for name in runs:
        d_ms = statistics.median(times[name]["D"])
        g_ms = statistics.median(times[name]["G"])
        timing[name] = {"d_step_ms": d_ms, "g_step_ms": g_ms,
                        "d_step_ms_all": times[name]["D"],
                        "g_step_ms_all": times[name]["G"],
                        "audio_s_per_s": 4 * audio_s / ((d_ms + 3 * g_ms) / 1e3),
                        "peak_mem_mb": peak[name]}
    del plain, plain_fn, runs
    torch.cuda.empty_cache()

    # one G step on the card vs the CPU, on a short input, same noise.
    # log_epsilon 1e-3 (v2: 1e-7): at random init a few STFT bins of the
    # fake audio are near zero, and log(|S| + 1e-7) divides their float32
    # rounding by 1e-7, so the gradient of the very same step depends on
    # the rounding (on the CPU alone its float32 and float64 gradients
    # differ by more than this check's bound); 1e-3 bounds that gain
    # and leaves every code path of the step as it is
    short = build_config(["v2"], ["fused_kernels=true", "n_signal=65536",
                                  "batch_size=1", "log_epsilon=1e-3"])
    g_step = short.phase_1_duration + 1
    torch.manual_seed(SEED + 1)
    card = loop.TrainState(short, device="cuda", step=g_step)
    cpu = loop.TrainState(short, device="cpu", step=g_step)
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               card.model.state_dict().items()})
    cpu.disc.load_state_dict({k: v.cpu() for k, v in
                              card.disc.state_dict().items()})
    eps = torch.tensor(np.random.default_rng(SEED).standard_normal(
        (1, short.latent_size, short.n_signal // short.total_ratio())),
        dtype=torch.float32)
    sb = {"x": batch["x"][:1, :short.n_signal]}
    short_fn = loop.make_train_step(short)
    reset()
    m_card = {k: float(v) for k, v in short_fn(card, sb, eps.cuda()).items()}
    short_launches = counts()
    # one CPU thread: PyTorch's threaded oneDNN conv1d data gradient is
    # wrong at some strided shapes of the MSD (tests/test_torch_train_v2.py)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        m_cpu = {k: float(v) for k, v in short_fn(
            cpu, {"x": sb["x"].cpu()}, eps).items()}
    finally:
        torch.set_num_threads(threads)

    def norms(st):
        return {g: float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                        for p in ps)))
                for g, ps in (("enc", st.enc_params), ("dec", st.dec_params))}

    n_card, n_cpu = norms(card), norms(cpu)
    rel = {k: abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12)
           for k in m_cpu}
    rel.update({f"grad_norm_{g}": abs(n_card[g] - n_cpu[g]) / n_cpu[g]
                for g in n_cpu})
    check(max(rel.values()) <= TRAIN_RTOL, f"v2 card vs cpu G step: {rel}")
    check(short_launches == expect, f"v2 short G step launches {short_launches}")
    del card, cpu

    # the eval step on the card
    reset()
    ev_metrics, y, z_mean = loop.make_eval_step(cfg)(state, batch)
    torch.cuda.synchronize()
    ev = {"validation": float(ev_metrics["validation"]), "y": list(y.shape),
          "z_mean": list(z_mean.shape), "launches": counts()}
    T_z = cfg.n_signal // cfg.total_ratio()
    check(np.isfinite(ev["validation"]) and ev["y"] == list(batch["x"].shape)
          and ev["z_mean"] == [TRAIN_BATCH, T_z, cfg.latent_size]
          and ev["launches"]["residual_unit"] == 16, f"v2 eval step {ev}")

    # where the time of one fused G step goes
    def one_g_step():
        state.step = cfg.phase_1_duration + 4 * 10 + 1
        step_fn(state, batch)

    prof = device_profile(torch, one_g_step, names=("residual_unit_kernel",))
    prof["share"] = {n: ms / prof["device_ms"]
                     for n, ms in prof["named_ms"].items()}
    emit({"phase": "train_v2", "config": "v2",
          "params": {g: sum(p.numel() for p in ps)
                     for g, ps in groups.items()},
          "batch": [TRAIN_BATCH, cfg.n_signal, 1],
          "start_step": cfg.phase_1_duration - 2, "warmup": warmup,
          **timing, "audio_s_per_step": audio_s,
          "card_vs_cpu": {"rel_err": rel, "card": m_card,
                          "grad_norms_card": n_card, "grad_norms_cpu": n_cpu,
                          "launches": short_launches},
          "eval": ev, "g_step_profile": prof})
    return warmup[-1]["launches"]["residual_unit"]


def voices(np, n, T, seed=SEED):
    """``n`` synthetic speakers ``(n, T)``: five harmonics of distinct
    f0 at seeded phases, plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 44100
    out = []
    for i in range(n):
        f0 = 90.0 * 1.6 ** i * rng.uniform(0.97, 1.03)
        x = sum(np.sin(2 * np.pi * h * f0 * t + rng.uniform(0, 6)) / h
                for h in range(1, 6))
        out.append(0.2 * x + 0.02 * rng.standard_normal(T))
    return np.stack(out).astype(np.float32)


def phase_voice_conversion(torch, np, KERNELS):
    """Voice-conversion serving of the full-width v2_fork (see the module
    docstring, phase 8).  Returns B1's launches per offline convert."""
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.export.streaming import StreamingRAVE
    from rave_tpu_torch.export.voice_conversion import VoiceConverter
    from rave_tpu_torch.models.rave import RAVE

    counts = lambda: {k.name: k.launches for k in KERNELS}  # noqa: E731

    def reset():
        for k in KERNELS:
            k.launches = 0

    cfg = build_config(["v2_fork"], ["fused_kernels=true"])
    torch.manual_seed(SEED)
    model = RAVE(cfg, device="cuda").eval()
    state = model.state_dict()
    plain = RAVE(build_config(["v2_fork"], ["fused_kernels=false"]),
                 device="cuda").eval()
    plain.load_state_dict(state)
    cpu_state = {k: v.cpu() for k, v in state.items()}
    cpu = RAVE(cfg, device="cpu").eval()
    cpu.load_state_dict(cpu_state)
    speakers = voices(np, VC_SPEAKERS, VC_SAMPLES)
    half = VC_SAMPLES // 2
    # speaker i's first half in the voice of speaker i + 1's second half
    src = torch.tensor(speakers[:, :half, None], device="cuda")
    tgt = torch.tensor(np.roll(speakers, -1, axis=0)[:, half:, None],
                       device="cuda")

    # offline convert: launches, checks, times
    with torch.inference_mode():
        reset()
        y = model.convert(src, tgt)
        torch.cuda.synchronize()
        launches = counts()
        check(launches == {"residual_unit": 16, "ci1_conv_forward": 0,
                           "ci1_conv_dx": 0},
              f"convert launches {launches}")
        check(tuple(y.shape) == tuple(src.shape), f"convert shape {y.shape}")
        check(bool(torch.isfinite(y).all()), "convert output not finite")
        plain_err = (y - plain.convert(src, tgt)).abs().max().item()
        check(plain_err <= OFFLINE_TOL, f"convert fused vs plain: {plain_err}")
        xs, ts = src[:1, :65536], tgt[:1, :65536]
        cpu_err = (model.convert(xs, ts).cpu()
                   - cpu.convert(xs.cpu(), ts.cpu())).abs().max().item()
        check(cpu_err <= CPU_TOL, f"convert card vs cpu: {cpu_err}")
        torch.cuda.reset_peak_memory_stats()
        times, times_plain = [], []
        for _ in range(10):
            times.append(cuda_ms(torch, lambda: model.convert(src, tgt),
                                 iters=1, warmup=0))
            times_plain.append(cuda_ms(torch, lambda: plain.convert(src, tgt),
                                       iters=1, warmup=0))
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        prof = device_profile(torch, lambda: model.convert(src, tgt),
                              names=("residual_unit_kernel",))
    prof["share"] = {n: ms / prof["device_ms"]
                     for n, ms in prof["named_ms"].items()}
    audio_s = VC_SPEAKERS * half / cfg.sampling_rate
    convert_ms = statistics.median(times)
    emit({"phase": "voice_conversion", "step": "convert",
          "config": "v2_fork", "params": sum(p.numel()
                                             for p in model.parameters()),
          "batch": [VC_SPEAKERS, half, 1], "launches": launches,
          "max_abs_err_vs_plain": plain_err, "max_abs_err_vs_cpu": cpu_err,
          "batch_ms": convert_ms, "rtf": convert_ms / 1e3 / audio_s,
          "plain_batch_ms": statistics.median(times_plain),
          "batch_ms_all": times, "peak_mem_mb": peak_mb, "profile": prof})
    del plain, y

    # speaker tables, BatchNorm and cohort-norm encoders, card and CPU
    cohort_cfg = build_config(["v2_fork"], ["fused_kernels=true",
                                            "speaker_norm=cohort"])
    clips = list(speakers)
    tables, vcs = {}, {}
    for norm, c in (("batch", cfg), ("cohort", cohort_cfg)):
        # the same weights; the cohort norm keeps no running statistics
        keep = lambda sd: {k: v for k, v in sd.items()  # noqa: E731
                           if norm == "batch" or ".running_" not in k}
        vcs[norm] = VoiceConverter(c, keep(state), chunk_size=VC_CHUNK,
                                   device="cuda")
        rows = vcs[norm].table_from_clips(clips)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = vcs[norm].table_from_clips(clips)
        table_ms = (time.perf_counter() - t0) * 1e3
        rows_cpu = VoiceConverter(c, keep(cpu_state), chunk_size=VC_CHUNK,
                                  device="cpu").table_from_clips(clips)
        scale = float(np.abs(rows_cpu).max())
        err = float(np.abs(rows - rows_cpu).max()) / scale
        spread = float(max(np.abs(rows[i] - rows[j]).max()
                           for i in range(len(rows))
                           for j in range(i))) / scale
        check(bool(np.isfinite(rows).all()), f"{norm} table not finite")
        check(err <= EMB_TOL, f"{norm} table card vs cpu: {err}")
        if norm == "cohort":
            check(spread > EMB_TOL, f"cohort table rows equal: {spread}")
        tables[norm] = rows
        emit({"phase": "voice_conversion", "step": "speaker_table",
              "norm": norm, "rows": list(rows.shape), "table_ms": table_ms,
              "rel_err_vs_cpu": err, "max_row_spread": spread})
    vc = vcs["batch"]
    del vcs

    # streamed conversion of request 0 against table row 1
    vc.speaker_table = tables["batch"]
    vc.set_speaker(1)
    request = speakers[0, :half]
    chunks = [request[i:i + VC_CHUNK] for i in range(0, half, VC_CHUNK)]
    for c in chunks[:8]:   # warm-up
        vc.forward(c)
    vc.reset()
    reset()
    chunk_ms, outs = [], []
    for c in chunks:
        t0 = time.perf_counter()
        outs.append(vc.forward(c))   # returns numpy: synchronised
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
    stream_launches = counts()
    check(stream_launches["residual_unit"] == 0,
          f"streamed convert launches {stream_launches}")
    y_str = np.concatenate(outs)
    with torch.inference_mode():
        x1 = src[:1]
        emb = torch.tensor(vc.current_embedding(), device="cuda")[None]
        bands = model.pqmf_forward(x1)
        y_off = model.pqmf_inverse(model.decode_bands(model.condition(
            model.encode_input(bands), emb)))[0, :, 0].cpu().numpy()
    d = vc.stream.total_delay_samples()
    check(d < half // 2, f"delay {d} >= half the request")
    m = 2 * d + 256
    a, b = y_off[m - d: half - d - 256], y_str[m: half - 256]
    rel = float(np.median(np.abs(a - b)) / (np.abs(a).mean() + 1e-9))
    check(bool(np.isfinite(y_str).all()), "streamed conversion not finite")
    check(rel < 0.02, f"streamed vs offline convert median rel err {rel}")

    # learn a target from 8 chunks of speaker 2, on the card and the CPU
    target = speakers[2, :8 * VC_CHUNK]
    cpu_vc = VoiceConverter(cfg, cpu_state, chunk_size=VC_CHUNK, device="cpu")
    learned = []
    for conv in (vc, cpu_vc):
        conv.reset()
        conv.set_learn_target(True)
        for i in range(0, len(target), VC_CHUNK):
            out = conv.forward(target[i:i + VC_CHUNK])
            check(not out.any(), "a learn-target chunk returned sound")
        conv.set_learn_target(False)
        learned.append(conv.current_embedding().copy())
    e_err = float(np.abs(learned[0] - learned[1]).max()
                  / np.abs(learned[1]).max())
    check(bool(np.isfinite(learned[0]).all()), "learned embedding not finite")
    check(e_err <= EMB_TOL, f"learned embedding card vs cpu: {e_err}")
    vc.set_speaker(2)
    check(np.array_equal(vc.current_embedding(), tables["batch"][2]),
          "set_speaker did not clear the learned target")
    emit({"phase": "voice_conversion", "step": "stream",
          "chunk": VC_CHUNK, "chunks": len(chunk_ms), "delay_samples": d,
          "median_rel_err": rel, "launches": stream_launches,
          "chunk_ms_median": statistics.median(chunk_ms),
          "chunk_ms_p80": float(np.percentile(chunk_ms, 80)),
          "chunk_ms_max": max(chunk_ms),
          "chunk_ms_limit": VC_CHUNK / cfg.sampling_rate * 1e3 / 2,
          "learned_rel_err_vs_cpu": e_err})
    del vc, cpu_vc

    # the fork's StreamingRAVE, card against CPU chunk by chunk
    streams = [StreamingRAVE(cfg, sd, chunk_size=CHUNK, device=dev)
               for sd, dev in ((state, "cuda"), (cpu_state, "cpu"))]
    reset()
    fork_err = 0.0
    for i in range(0, 8 * CHUNK, CHUNK):
        xc = request[i:i + CHUNK].reshape(1, -1, 1)
        got, want = (s.forward(xc).cpu() for s in streams)
        fork_err = max(fork_err, (got - want).abs().max().item())
    check(fork_err <= CPU_TOL, f"fork stream card vs cpu: {fork_err}")
    check(counts()["residual_unit"] == 0, f"fork stream launches {counts()}")
    emit({"phase": "voice_conversion", "step": "fork_streaming",
          "chunk": CHUNK, "chunks": 8, "max_abs_err_vs_cpu": fork_err})
    return launches["residual_unit"]


# train_vc: the from-scratch fork step (8 synthetic speakers, one per
# class) and a CLI run on a corpus of 8 speakers x 4 clips
VC_TRAIN = ["fused_kernels=true", "train_speaker_encoder=true",
            "speaker_classes=8", "latent_adversary_weight=0.5"]
TRAIN_VC_METRICS = sorted(TRAIN_METRICS + [
    "loss_speaker_ce", "speaker_accuracy", "loss_latent_adversary",
    "latent_adversary_accuracy"])
BN_RTOL = 1e-4           # card vs cpu running statistics of the BatchNorms
SMOKE_DIR = "_smoke"     # git-ignored; the CLI run's corpus, db and runs


def vc_batch(torch, np, B, T, frames, device="cuda", seed=SEED):
    """``voices`` as a train batch: speaker ``i`` is class ``i``; the
    perturbed view is a seeded gain and one-tap EQ of the clean one."""
    rng = np.random.default_rng(seed + 1)
    x = voices(np, B, T, seed)
    g = rng.uniform(0.5, 1.0, (B, 1))
    a = rng.uniform(-0.5, 0.5, (B, 1))
    xp = (g * (x + a * np.roll(x, 1, axis=1))).astype(np.float32)
    return {"x": torch.tensor(x[:, :, None], device=device),
            "x_perturbed": torch.tensor(xp[:, :, None], device=device),
            "units": torch.tensor(rng.integers(0, 100, (B, frames)),
                                  device=device),
            "speaker": torch.arange(B, device=device)}


def bn_stats(torch, model):
    spk = model.speaker_encoder
    return torch.cat([getattr(getattr(spk, n), f"running_{leaf}").cpu()
                      for n in ("attn_bn", "bn5") for leaf in ("mean", "var")])


def phase_train_vc_step(torch, np, KERNELS, norm, device="cuda"):
    """(a) of phase 9: the full-width from-scratch v2_fork step with the
    ``norm`` speaker encoder: launches and moved groups per step, timed
    D, G, G, G cycles, and a short D, G pair against the CPU."""
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.train import loop, schedules

    counts = lambda: {k.name: k.launches for k in KERNELS}  # noqa: E731

    def reset():
        for k in KERNELS:
            k.launches = 0

    def kind_of(st):
        return "D" if schedules.is_discriminator_step(st.step, st.cfg) else "G"

    t_phase = time.perf_counter()
    over = VC_TRAIN + [f"speaker_norm={norm}"]
    cfg = build_config(["v2_fork"], over)
    torch.manual_seed(SEED)
    state = loop.TrainState(cfg, device=device, step=cfg.phase_1_duration)
    check(state.model.speaker_encoder.train_bn == (norm == "batch"),
          f"{norm}: train_bn {state.model.speaker_encoder.train_bn}")
    step_fn = loop.make_train_step(cfg)
    batch = vc_batch(torch, np, TRAIN_BATCH, cfg.n_signal, 148, device)
    groups = {"dis": list(state.disc.parameters()),
              "enc": state.enc_params, "dec": state.dec_params,
              "spk": state.spk_params}
    check(loop.spk_group(cfg) == ("speaker_classifier", "latent_adversary",
                                  "speaker_encoder"),
          f"SPK group {loop.spk_group(cfg)}")

    # warm-up cycle D, G, G, G
    cycle = []
    for _ in range(4):
        kind = kind_of(state)
        before = {g: [p.detach().clone() for p in ps]
                  for g, ps in groups.items()}
        stats = bn_stats(torch, state.model) if norm == "batch" else None
        reset()
        metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        launches = counts()
        want = {"residual_unit": 16, "ci1_conv_forward": 3,
                "ci1_conv_dx": 3 if kind == "G" else 0}
        check(launches == want, f"train_vc {norm} {kind} launches {launches}")
        values = {k: float(v) for k, v in metrics.items()}
        check(sorted(values) == TRAIN_VC_METRICS,
              f"train_vc metric names {sorted(values)}")
        check(all(np.isfinite(v) for v in values.values()),
              f"train_vc {norm} {kind} metrics not finite: {values}")
        check((values["loss_speaker_ce"] > 0) == (kind == "G")
              and (values["loss_latent_adversary"] > 0) == (kind == "G"),
              f"train_vc {norm} {kind} speaker terms {values}")
        moved = {g: any(not torch.equal(p, q) for p, q in zip(ps, before[g]))
                 for g, ps in groups.items()}
        want = {"dis": kind == "D", "enc": kind == "G", "dec": kind == "G",
                "spk": kind == "G"}
        check(moved == want, f"train_vc {kind} moved {moved}, expected {want}")
        if stats is not None:
            check(not torch.equal(stats, bn_stats(torch, state.model)),
                  f"train_vc {kind} step left the running statistics")
        cycle.append({"kind": kind, "launches": launches, "metrics": values})
    check([c["kind"] for c in cycle] == ["D", "G", "G", "G"],
          f"train_vc cycle {[c['kind'] for c in cycle]}")
    del before

    # timed cycles
    torch.cuda.reset_peak_memory_stats()
    times = {"D": [], "G": []}
    for _ in range(3 * 4):
        kind = kind_of(state)
        times[kind].append(cuda_ms(torch, lambda: step_fn(state, batch),
                                   iters=1, warmup=0))
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    d_ms, g_ms = statistics.median(times["D"]), statistics.median(times["G"])
    audio_s = TRAIN_BATCH * cfg.n_signal / cfg.sampling_rate

    # a short D, G pair on the card and on the CPU (one thread: PyTorch's
    # threaded oneDNN conv1d data gradient is wrong at some strided
    # shapes); four items, four speakers, so that the cohort norm sees a
    # cohort
    short = build_config(["v2_fork"], over + ["n_signal=65536",
                                              "batch_size=4"])
    torch.manual_seed(SEED + 1)
    card = loop.TrainState(short, device=device, step=short.phase_1_duration)
    cpu = loop.TrainState(short, device="cpu", step=short.phase_1_duration)
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               card.model.state_dict().items()})
    cpu.disc.load_state_dict({k: v.cpu() for k, v in
                              card.disc.state_dict().items()})
    sb = vc_batch(torch, np, 4, short.n_signal, 74, device, seed=SEED + 2)
    sb_cpu = {k: v.cpu() for k, v in sb.items()}
    short_fn = loop.make_train_step(short)
    threads = torch.get_num_threads()
    rel, stats_err, short_launches = {}, {}, {}
    for kind in ("D", "G"):
        check(kind_of(card) == kind, f"short step {kind_of(card)} != {kind}")
        reset()
        m_card = {k: float(v) for k, v in short_fn(card, sb).items()}
        short_launches[kind] = counts()
        torch.set_num_threads(1)
        try:
            m_cpu = {k: float(v) for k, v in short_fn(cpu, sb_cpu).items()}
        finally:
            torch.set_num_threads(threads)
        rel.update({f"{kind}/{k}": abs(m_card[k] - m_cpu[k])
                    / max(abs(m_cpu[k]), 1e-12) for k in m_cpu})
        if norm == "batch":
            a, b = bn_stats(torch, card.model), bn_stats(torch, cpu.model)
            stats_err[kind] = float(((a - b).abs() / b.abs().clamp_min(
                1e-6)).max())
            check(torch.allclose(a, b, rtol=BN_RTOL, atol=1e-7),
                  f"train_vc batch norm stats after {kind}: {stats_err}")

    def norms(st):
        return {g: float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                        for p in ps)))
                for g, ps in (("enc", st.enc_params), ("dec", st.dec_params),
                              ("spk", st.spk_params))}

    n_card, n_cpu = norms(card), norms(cpu)
    rel.update({f"grad_norm_{g}": abs(n_card[g] - n_cpu[g]) / n_cpu[g]
                for g in n_cpu})
    check(max(rel.values()) <= TRAIN_RTOL, f"train_vc card vs cpu: {rel}")
    del card, cpu

    out = {"phase": "train_vc", "step": "full_width", "norm": norm,
           "config": "v2_fork", "overrides": over,
           "params": {g: sum(p.numel() for p in ps)
                      for g, ps in groups.items()},
           "batch": [TRAIN_BATCH, cfg.n_signal, 1],
           "start_step": cfg.phase_1_duration, "warmup_cycle": cycle,
           "d_step_ms": d_ms, "g_step_ms": g_ms,
           "d_step_ms_all": times["D"], "g_step_ms_all": times["G"],
           "audio_s_per_s": 4 * audio_s / ((d_ms + 3 * g_ms) / 1e3),
           "peak_mem_mb": peak_mb,
           "card_vs_cpu": {"rel_err": rel, "grad_norms_card": n_card,
                           "grad_norms_cpu": n_cpu,
                           "bn_stats_rel_err": stats_err,
                           "launches": short_launches}}
    if norm == "cohort":
        # where the time of one G step goes, and the speaker encoder's
        # share: its forward and parameter gradient on the step's bands
        def one_g_step():
            state.step = cfg.phase_1_duration + 4 * 10 + 1
            step_fn(state, batch)

        prof = device_profile(torch, one_g_step,
                              names=("residual_unit_kernel",
                                     "ci1_fwd_kernel", "ci1_dx_kernel"))
        spk = state.model.speaker_encoder
        bands = state.model.pqmf_forward(batch["x"]).detach()
        spk_params = list(spk.parameters())

        def spk_fwd_bwd():
            torch.autograd.grad(spk(bands).square().sum(), spk_params)

        spk_ms = device_ms(torch, spk_fwd_bwd, iters=5)
        prof["share"] = {n: ms / prof["device_ms"]
                         for n, ms in prof["named_ms"].items()}
        prof["speaker_encoder_ms"] = spk_ms
        prof["share"]["speaker_encoder"] = spk_ms / prof["device_ms"]
        out["g_step_profile"] = prof
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return cycle[0]["launches"], cycle[1]["launches"]


def _sections(text: str) -> dict:
    """The last ``Sections`` print of a ``--profile`` run:
    ``{name: (total ms, count)}``."""
    import re
    found = {}
    for line in text.splitlines():
        m = re.match(r"^(\w+): total ([\d.]+)ms avg [\d.]+ms x(\d+)$",
                     line.strip())
        if m:
            found[m.group(1)] = (float(m.group(2)), int(m.group(3)))
    return found


def phase_train_vc_cli(torch, np, device="cuda"):
    """(b) of phase 9: ``python -m rave_tpu_torch.cli`` preprocess,
    perturb, units and train on a corpus of 8 synthetic speakers, then
    ``--resume``; the checkpoint restores bit for bit.  Returns the run
    directory, the db and the first clip of each speaker (phase 10 exports
    the run; ``main`` removes ``_smoke/`` after it)."""
    from pathlib import Path
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.data.audio_io import save_wav
    from rave_tpu_torch.train import checkpoint, loop

    t_phase = time.perf_counter()
    root = Path(SMOKE_DIR)
    shutil.rmtree(root, ignore_errors=True)
    clips = voices(np, 8, 4 * SAMPLES, seed=SEED + 3)
    for s in range(8):
        d = root / "audio" / f"spk{s}"
        d.mkdir(parents=True)
        for k in range(4):
            save_wav(str(d / f"{k}.wav"), clips[s, k * SAMPLES:
                                                (k + 1) * SAMPLES], 44100)
    db, runs = str(root / "db"), str(root / "runs")

    def cli(*args, timeout=600):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "rave_tpu_torch.cli",
                            *args], capture_output=True, text=True,
                           timeout=timeout)
        check(r.returncode == 0, f"cli {args[0]} exited {r.returncode}: "
              f"{r.stderr[-2000:]}")
        return r.stdout, time.perf_counter() - t0

    seconds = {}
    _, seconds["preprocess"] = cli("preprocess", "--input_path",
                                   str(root / "audio"), "--output_path", db,
                                   "--num_workers", "4")
    _, seconds["perturb"] = cli("perturb", "--db_path", db, "--variants", "2",
                                "--num_workers", "8")
    _, seconds["units"] = cli("units", "--db_path", db)
    over = ["fused_kernels=true", "train_speaker_encoder=true",
            "speaker_classes=8", "phase_1_duration=4"]
    train = ["train", "--config", "v2_fork",
             *[a for o in over for a in ("--override", o)],
             "--db_path", db, "--out_path", runs, "--val_every", "8",
             "--ckpt_every", "8", "--num_workers", "2", "--profile",
             "--device", device]
    out, seconds["train"] = cli(*train, "--max_steps", "12")
    check("finished at step 12" in out, f"train did not finish: {out[-2000:]}")
    run = next(Path(runs).iterdir())
    recs = [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]
    val = [r for r in recs if "validation" in r]
    check(recs[0].get("loss_speaker_ce", 0) > 0, f"step 0 metrics {recs[0]}")
    check(len(val) == 1 and np.isfinite(val[0]["validation"])
          and all(f"conversion_spk_cos_{k}" in val[0]
                  for k in ("target", "source", "pair")),
          f"validation records {val}")
    ck = run / "checkpoints"
    names = sorted(p.name for p in ck.glob("ckpt_*.pt"))
    check(names == ["ckpt_12.pt", "ckpt_9.pt"]
          and [p.name for p in (ck / "best").glob("*.pt")] == ["ckpt_9.pt"],
          f"checkpoints {names}")
    sec = _sections(out)
    check({"load", "put", "step"} <= set(sec), f"profile sections {sec}")
    wall = sum(sec[k][0] for k in ("load", "put", "step"))

    # the last checkpoint, restored into a fresh state on the card
    saved = torch.load(ck / "ckpt_12.pt", weights_only=True)
    cfg = build_config(["v2_fork"], over)
    restored = loop.TrainState(cfg, device=device)
    checkpoint.CheckpointManager(run).restore(restored, step=12)
    got = checkpoint.state_dict(restored)

    def same(a, b):
        if torch.is_tensor(a):
            return a.dtype == b.dtype and torch.equal(a, b)
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        return a == b

    check(same(got, saved), "restored state differs from the checkpoint")
    del restored, got, saved

    out2, seconds["resume"] = cli(*train, "--max_steps", "16", "--resume")
    check("resumed from step 12" in out2 and "finished at step 16" in out2,
          f"resume: {out2[-2000:]}")
    emit({"phase": "train_vc", "step": "cli", "overrides": over,
          "records": json.loads((Path(db) / "meta.json").read_text())["count"],
          "seconds": seconds, "sections_ms": sec,
          "steps_per_s": sec["step"][1] / (wall / 1e3),
          "loader_share": (sec["load"][0] + sec["put"][0]) / wall,
          "validation": val[0], "checkpoints": names,
          "restored_bit_exact": True,
          "phase_seconds": time.perf_counter() - t_phase})
    return run, db, [str(root / "audio" / f"spk{s}" / "0.wav")
                     for s in range(8)]


# export: the streaming and conversion steps as torch.export programs,
# the CUDA-graph file path, the host rate, stereo, the latent PCA and the
# realtime ring-buffer host
EXPORT_TOL = 2e-4        # max |a - b| on tanh-bounded audio
PCA_TOL = 1e-4           # the latent PCA round trip, every direction kept
HOST_SR = 88200          # a host at twice the model's rate
FILE_CHUNKS = 64         # chunks of the CUDA-graph file path (131072)
HOST_CHUNKS = 32         # blocks pushed through the realtime host
EXPORT_TIMEOUT = 600     # s, each export / eval subprocess
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaGraphLaunch")


def launches_per_chunk(torch, fn, n: int) -> dict:
    """Per chunk of ``fn`` (which streams ``n`` chunks), by
    ``torch.profiler`` over one call after a warm-up: the host's launch
    calls (kernel launches and graph launches), its memcpy calls, the
    kernels the card ran, their summed time and the wall time (the
    profiler's host cost inflates the latter)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    dev = [e for e in ev if e.device_type == DeviceType.CUDA]
    return {"wall_ms": wall_ms / n,
            "device_ms": sum(e.self_device_time_total for e in dev) / 1e3 / n,
            "host_launches": sum(e.count for e in ev
                                 if e.key in LAUNCH_APIS) / n,
            "graph_launches": sum(e.count for e in ev
                                  if e.key == "cudaGraphLaunch") / n,
            "host_memcpys": sum(e.count for e in ev
                                if e.key.startswith("cudaMemcpy")) / n,
            "device_kernels": sum(
                e.count for e in dev if not e.key.startswith("Memcpy")
                and not e.key.startswith("Memset")) / n}


def manifest_caches(torch, np, manifest, binary, n: int, device="cuda"):
    """The first ``n`` inputs of an exported step's manifest (its
    caches), read from the raw little-endian initial-cache file, and the
    total bytes the manifest gives them."""
    lines = [ln.split() for ln in manifest.read_text().splitlines()[1:]]
    ins = [ln for ln in lines if ln[0] == "in"][:n]
    raw, caches, at = binary.read_bytes(), [], 0
    for _, _, nbytes, rank, *dims in ins:
        check(int(rank) == len(dims), f"manifest line {dims}")
        a = np.frombuffer(raw, "<f4", int(nbytes) // 4, at)
        caches.append(torch.tensor(a.reshape([int(d) for d in dims]),
                                   device=device))
        at += int(nbytes)
    check(at == len(raw), f"{binary.name}: {len(raw)} bytes, manifest {at}")
    return caches, at


def phase_export_stream(torch, np, KERNELS, state, audio, model, x_batch,
                        card, device="cuda"):
    """(a) and (c) of phase 10 on the offline phase's weights (see the
    module docstring); ``card`` is the ``nvidia-smi`` name and power
    limit, printed beside the times."""
    from pathlib import Path
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.export.realtime import RealtimeHost
    from rave_tpu_torch.export.streaming import StreamingRAVE
    from rave_tpu_torch.train.latent_stats import fit_latent_pca

    t_phase = time.perf_counter()
    counts = lambda: {k.name: k.launches for k in KERNELS}  # noqa: E731
    cfg = build_config(["v2"], ["fused_kernels=true"])
    sr = StreamingRAVE(cfg, state, chunk_size=CHUNK, device=device)
    signal = audio[0, :FILE_CHUNKS * CHUNK].astype(np.float32)
    chunk_s = CHUNK / cfg.sampling_rate
    out = {"phase": "export", "step": "stream", "card": card,
           "config": "v2", "chunk": CHUNK,
           "chunk_ms_of_audio": chunk_s * 1e3}

    # the CUDA-graph file path against the eager one
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    y_graph = sr.process_file_scan(signal)    # captures the chunk step
    out["graph_first_call_s"] = time.perf_counter() - t0
    y_eager = sr.process_file(signal)
    check(counts()["residual_unit"] == 0, f"B1 in the stream: {counts()}")
    check(y_graph.shape == y_eager.shape == signal.shape,
          f"file shapes {y_graph.shape} {y_eager.shape}")
    check(bool(np.isfinite(y_graph).all()), "graph output not finite")
    err = float(np.abs(y_graph - y_eager).max())
    check(err <= EXPORT_TOL, f"graph vs eager file: {err}")
    per = {"graph": [], "eager": []}
    for _ in range(5):
        for name, fn in (("graph", sr.process_file_scan),
                         ("eager", sr.process_file)):
            t0 = time.perf_counter()
            fn(signal)
            per[name].append((time.perf_counter() - t0) * 1e3 / FILE_CHUNKS)
    out["file"] = {
        "chunks": FILE_CHUNKS, "max_abs_err_graph_vs_eager": err,
        "bit_identical": bool(np.array_equal(y_graph, y_eager)),
        "graph_ms_per_chunk": statistics.median(per["graph"]),
        "eager_ms_per_chunk": statistics.median(per["eager"]),
        "graph_ms_per_chunk_runs": per["graph"],
        "eager_ms_per_chunk_runs": per["eager"],
        "launches_per_chunk": {
            "graph": launches_per_chunk(
                torch, lambda: sr.process_file_scan(signal), FILE_CHUNKS),
            "eager": launches_per_chunk(
                torch, lambda: sr.process_file(signal), FILE_CHUNKS)}}

    # the exported programs against the live stream
    exp_dir = Path(SMOKE_DIR) / "export_v2"
    shutil.rmtree(exp_dir, ignore_errors=True)
    t0 = time.perf_counter()
    sr.serialize(exp_dir)
    serialize_s = time.perf_counter() - t0
    n = len(sr.init_caches)
    with np.load(exp_dir / "cache_init.npz") as f:
        npz = [torch.tensor(f[f"c{i}"], device=device) for i in range(n)]
    caches, man_bytes = manifest_caches(torch, np, exp_dir / "io_manifest.txt",
                                        exp_dir / "cache_init.bin", n, device)
    live_bytes = sum(c.numel() * c.element_size() for c in sr.caches)
    check(man_bytes == live_bytes == (exp_dir / "cache_init.bin").stat(
          ).st_size, f"cache bytes {man_bytes} {live_bytes}")
    check(all(torch.equal(a, b) for a, b in zip(npz, caches)),
          "cache_init.npz != cache_init.bin")
    t0 = time.perf_counter()
    fwd, enc, dec = (torch.export.load(exp_dir / f"{s}.pt2").module()
                     for s in ("forward", "encode", "decode"))
    load_s = time.perf_counter() - t0
    sr.reset()
    fwd_err = enc_err = dec_err = 0.0
    with torch.no_grad():
        for i in range(0, 8 * CHUNK, CHUNK):
            xc = torch.tensor(signal[i:i + CHUNK].reshape(1, -1, 1),
                              device=device)
            y, caches = fwd(caches, xc)
            fwd_err = max(fwd_err, (y - sr.forward(xc)).abs().max().item())
        caches = [torch.zeros_like(c) for c in npz]
        sr.reset()
        for i in range(0, 8 * CHUNK, CHUNK):
            xc = torch.tensor(signal[i:i + CHUNK].reshape(1, -1, 1),
                              device=device)
            z, caches = enc(caches, xc)
            y, caches = dec(caches, z)
            z_live = sr.encode(xc)
            enc_err = max(enc_err, (z - z_live).abs().max().item())
            dec_err = max(dec_err, (y - sr.decode(z)).abs().max().item())
    check(max(fwd_err, dec_err) <= EXPORT_TOL and enc_err <= EXPORT_TOL,
          f"exported vs live: forward {fwd_err} encode {enc_err} "
          f"decode {dec_err}")
    out["exported"] = {"serialize_s": serialize_s, "load_s": load_s,
                       "cache_leaves": n, "cache_bytes": man_bytes,
                       "forward_max_abs_err": fwd_err,
                       "encode_max_abs_err": enc_err,
                       "decode_max_abs_err": dec_err}

    # host rate: the card's stream against the CPU's, chunk by chunk
    hs = StreamingRAVE(cfg, state, chunk_size=CHUNK, target_sr=HOST_SR,
                       device=device)
    check(hs.host_chunk == 2 * CHUNK, f"host chunk {hs.host_chunk}")
    cpu_hs = StreamingRAVE(cfg, {k: v.cpu() for k, v in state.items()},
                           chunk_size=CHUNK, target_sr=HOST_SR, device="cpu")
    hc = hs.host_chunk
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        host_err = 0.0
        for i in range(0, 8 * hc, hc):
            xc = signal[i:i + hc].reshape(1, -1, 1)
            got = hs.forward(xc)
            check(tuple(got.shape) == (1, hc, 1), f"host-rate {got.shape}")
            host_err = max(host_err, (got.cpu() - cpu_hs.forward(xc))
                           .abs().max().item())
    finally:
        torch.set_num_threads(threads)
    check(host_err <= EXPORT_TOL, f"host rate card vs cpu: {host_err}")

    # fake stereo
    st = StreamingRAVE(cfg, state, chunk_size=CHUNK, stereo=True,
                       device=device)
    ys = st.forward(signal[:CHUNK].reshape(1, -1, 1))
    check(tuple(ys.shape) == (1, CHUNK, 2), f"stereo shape {ys.shape}")
    check(torch.equal(ys[..., 0], ys[..., 1]), "stereo channels differ")
    out["host_rate"] = {"target_sr": HOST_SR, "host_chunk": hc,
                        "chunks": 8, "max_abs_err_vs_cpu": host_err}
    out["stereo"] = {"shape": list(ys.shape), "channels_equal": True}

    # latent PCA of the offline batch's latents
    with torch.inference_mode():
        zs = model.encode(x_batch).reshape(-1, cfg.latent_size).cpu().numpy()
    stats = fit_latent_pca(zs)
    # fidelity 1.0 in effect: the target just below the cumulative share's
    # first maximum keeps every direction whose variance float32 can tell
    # from zero (a target of exactly 1.0 keeps one in both packages, since
    # the rule asks for a share above the target; ROADMAP C)
    fid = stats["fidelity"]
    keep = int(np.argmax(fid == fid.max())) + 1
    sr.set_latent_stats(stats, float(fid[keep - 2]) if keep > 1 else -1.0)
    post = sr.postprocess_latent(zs)
    check(post.shape[-1] == keep, f"PCA kept {post.shape[-1]} of {keep}")
    pca_err = float(np.abs(sr.preprocess_latent(post) - zs).max())
    check(pca_err <= PCA_TOL, f"latent PCA round trip: {pca_err}")
    sr.set_latent_stats(stats)
    out["latent_pca"] = {"latents": list(zs.shape), "dims_kept": keep,
                         "round_trip_err": pca_err,
                         "dims_at_0.95": sr.postprocess_latent(zs).shape[-1]}
    del hs, cpu_hs, st

    # the realtime host over the card's stream
    sr.reset()
    host = RealtimeHost(sr, chunk=CHUNK)
    host.start()
    blocks, leading = [], 0
    try:
        check(host.push(signal[:HOST_CHUNKS * CHUNK]) == HOST_CHUNKS * CHUNK,
              "ring full")
        deadline = time.monotonic() + 60
        while len(blocks) < HOST_CHUNKS and time.monotonic() < deadline:
            before = host.underruns
            b = host.pull(CHUNK)
            if host.underruns == before:
                blocks.append(b)
            else:
                leading += not blocks
                time.sleep(0.001)
    finally:
        host.stop()
    check(len(blocks) == HOST_CHUNKS, f"host returned {len(blocks)} blocks")
    want = sr.process_file(signal[:HOST_CHUNKS * CHUNK])
    rt_err = float(np.abs(np.concatenate(blocks) - want).max())
    check(rt_err <= EXPORT_TOL, f"realtime host vs process_file: {rt_err}")
    out["realtime"] = {"blocks_processed": host.blocks_processed,
                       "underruns": host.underruns,
                       "leading_empty_pulls": leading,
                       "block_ms_median": statistics.median(host.block_ms),
                       "block_ms_max": max(host.block_ms),
                       "chunk_ms_of_audio": chunk_s * 1e3,
                       "max_abs_err_vs_process_file": rt_err}
    out["phase_seconds"] = time.perf_counter() - t_phase
    emit(out)


def phase_export_run(torch, np, run, db, wavs, card, device="cuda"):
    """(b) of phase 10: ``python -m rave_tpu_torch.cli export`` and
    ``eval`` of the run phase 9(b) trained; the reloaded programs against
    the live converter and stream built from the same checkpoint
    (``card`` as in :func:`phase_export_stream`)."""
    from rave_tpu_torch.data.audio_io import load_wav
    from rave_tpu_torch.export.streaming import (StreamingRAVE, load_run,
                                                 run_params)
    from rave_tpu_torch.export.voice_conversion import VoiceConverter

    t_phase = time.perf_counter()

    def cli(*args):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "rave_tpu_torch.cli",
                            *args, "--device", device], capture_output=True,
                           text=True, timeout=EXPORT_TIMEOUT)
        check(r.returncode == 0, f"cli {args[0]} exited {r.returncode}: "
              f"{r.stderr[-2000:]}")
        return time.perf_counter() - t0

    seconds = {"export": cli("export", "--run", str(run), "--chunk_size",
                             str(VC_CHUNK), "--voice_conversion",
                             "--speaker_wavs", *wavs[:VC_SPEAKERS])}
    out = run / "export"
    names = sorted(p.name for p in out.iterdir())
    want = sorted(["cache_init.bin", "cache_init.npz", "convert.pt2",
                   "convert_cache_init.bin", "convert_manifest.txt",
                   "convert_meta.json", "decode.pt2", "encode.pt2",
                   "forward.pt2", "io_manifest.txt", "meta.json",
                   "spk_embed.pt2", "speaker_table.npy"])
    check(names == want, f"export wrote {names}")
    table = np.load(out / "speaker_table.npy")
    check(table.shape == (VC_SPEAKERS, 256) and np.isfinite(table).all(),
          f"speaker table {table.shape}")

    cfg, state = load_run(str(run), device=device)
    params = run_params(state)
    del state
    vc = VoiceConverter(cfg, params, chunk_size=VC_CHUNK,
                        speaker_table=table, device=device)
    vc.set_speaker(1)
    n = len(vc.stream.init_caches)
    caches, _ = manifest_caches(torch, np, out / "convert_manifest.txt",
                                out / "convert_cache_init.bin", n, device)
    conv = torch.export.load(out / "convert.pt2").module()
    source = load_wav(wavs[VC_SPEAKERS])[0].astype(np.float32)
    emb = torch.tensor(table[1], device=device)
    conv_err = 0.0
    with torch.no_grad():
        for i in range(0, 8 * VC_CHUNK, VC_CHUNK):
            xc = source[i:i + VC_CHUNK]
            y, caches = conv(caches, torch.tensor(xc.reshape(1, -1, 1),
                                                  device=device), emb)
            conv_err = max(conv_err, float(np.abs(
                y[0, :, 0].cpu().numpy() - vc.forward(xc)).max()))
    check(conv_err <= EXPORT_TOL, f"convert.pt2 vs live: {conv_err}")
    del vc, conv

    live = StreamingRAVE(cfg, params, chunk_size=VC_CHUNK, device=device)
    caches, _ = manifest_caches(torch, np, out / "io_manifest.txt",
                                out / "cache_init.bin",
                                len(live.init_caches), device)
    fwd = torch.export.load(out / "forward.pt2").module()
    fwd_err = 0.0
    with torch.no_grad():
        for i in range(0, 8 * VC_CHUNK, VC_CHUNK):
            xc = torch.tensor(source[i:i + VC_CHUNK].reshape(1, -1, 1),
                              device=device)
            y, caches = fwd(caches, xc)
            fwd_err = max(fwd_err, (y - live.forward(xc)).abs().max().item())
    check(fwd_err <= EXPORT_TOL, f"forward.pt2 vs live fork stream: {fwd_err}")
    del live, fwd

    seconds["eval"] = cli("eval", "--run", str(run), "--db_path", str(db))
    res = json.loads((run / "speaker_embeddings.json").read_text())
    pts = np.asarray(res["points"])
    check(pts.shape == (32, 2) and np.isfinite(pts).all()
          and len(set(res["speakers"])) == 8,
          f"eval: {pts.shape}, speakers {sorted(set(res['speakers']))}")
    emit({"phase": "export", "step": "run", "card": card,
          "config": "v2_fork", "chunk": VC_CHUNK, "artifacts": names,
          "seconds": seconds,
          "convert_max_abs_err": conv_err, "forward_max_abs_err": fwd_err,
          "eval_points": list(pts.shape),
          "eval_speakers": len(set(res["speakers"])),
          "phase_seconds": time.perf_counter() - t_phase})


# pitch: the fork's f0-conditioned preset (v2_fork + pitch) at full width
PITCH_STACK = ["v2_fork", "pitch"]
PITCH_SPEAKERS, PITCH_CLIP = 4, 131072
F0_RTOL = 1e-4           # f0 card vs CPU where both are voiced
LOG_F0_TOL = 1e-5        # the f0 feature card vs CPU, in log-f0 units
STATS_RTOL = 1e-4        # the speaker_stats JSON card vs CPU


def glides(np, n, T, seed=SEED):
    """``n`` synthetic speakers ``(n, T)``: five harmonics of an f0 that
    rises and falls by 10 % every 2 s (a speaker's intonation), distinct
    registers, plus noise.  A steady tone would give per-utterance
    log-f0 statistics a std near 1e-3, which the feature divides by."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 44100
    out = []
    for i in range(n):
        f0 = 90.0 * 1.6 ** i * rng.uniform(0.97, 1.03)
        phase = 2 * np.pi * f0 * (t + 0.1 * np.sin(np.pi * t) / np.pi)
        x = sum(np.sin(h * phase + rng.uniform(0, 6)) / h for h in range(1, 6))
        out.append(0.2 * x + 0.02 * rng.standard_normal(T))
    return np.stack(out).astype(np.float32)


def f0_stats(np, x, sr):
    """Per-item log-f0 median and std of ``x`` ``(B, T)`` by the numpy
    YIN: what ``speaker_stats`` writes for a speaker of one item."""
    from rave_tpu_torch.data.pitch import yin_f0
    med, std = [], []
    for item in x:
        f0 = yin_f0(item, sr)
        v = np.log(f0[f0 > 0])
        med.append(np.median(v))
        std.append(max(np.std(v), 1e-3))
    return np.asarray(med, np.float32), np.asarray(std, np.float32)


def hold_f0(np, got, want, what):
    """f0 card vs CPU: the voiced masks equal, f0 within ``F0_RTOL`` where
    voiced; returns the largest relative difference."""
    check(np.array_equal(got > 0, want > 0),
          f"{what}: voicing card vs cpu differs in "
          f"{int(((got > 0) != (want > 0)).sum())} frames")
    v = want > 0
    check(v.any(), f"{what}: no voiced frame")
    rel = float((np.abs(got[v] - want[v]) / want[v]).max())
    check(rel <= F0_RTOL, f"{what}: f0 card vs cpu rel {rel}")
    return rel


def fcpe_checkpoint(torch, np, path):
    """A random-weight FCPE checkpoint in torchfcpe's layout (``model``:
    ``input_stack.*``, ``net.encoder_layers.*.conformer.net.*``, the
    weight-normed ``output_proj``).  The output layer's weights are
    scaled by 0.4 and its bias is a bump over the bins around 220 Hz, so
    that the decode is well posed (neighbouring bins) and
    ``validate_assets``' 220 Hz check has something to find: it shows
    the reader, the network and the check run, not that FCPE tracks
    pitch."""
    from rave_tpu_torch.models import pitch_fcpe as F
    torch.manual_seed(SEED)
    m = F.FCPE()
    k = torch.arange(F.OUT_DIMS, dtype=torch.float32)
    k0 = int(np.argmin(np.abs(F.cent_table() - F.f0_to_cent(220.0))))
    with torch.no_grad():
        m.out.weight.mul_(0.4)
        m.out.bias.copy_(8 * torch.exp(-0.5 * ((k - k0) / 8) ** 2) - 4)
    p = m.state_dict()
    sd = {"input_stack.0.weight": p["in0.weight"],
          "input_stack.0.bias": p["in0.bias"],
          "input_stack.1.weight": p["in_gn.weight"],
          "input_stack.1.bias": p["in_gn.bias"],
          "input_stack.3.weight": p["in1.weight"],
          "input_stack.3.bias": p["in1.bias"],
          "norm.weight": p["norm.weight"], "norm.bias": p["norm.bias"],
          "output_proj.weight_v": p["out.weight"],
          "output_proj.weight_g": p["out.weight"].norm(dim=1, keepdim=True),
          "output_proj.bias": p["out.bias"]}
    for i in range(F.N_LAYERS):
        base, src = f"net.encoder_layers.{i}.conformer.net", f"layers.{i}"
        sd.update({f"{base}.0.weight": p[f"{src}.ln.weight"],
                   f"{base}.0.bias": p[f"{src}.ln.bias"],
                   f"{base}.2.weight": p[f"{src}.pw1.weight"][..., None],
                   f"{base}.2.bias": p[f"{src}.pw1.bias"],
                   f"{base}.4.conv.weight": p[f"{src}.dw.weight"],
                   f"{base}.4.conv.bias": p[f"{src}.dw.bias"],
                   f"{base}.6.weight": p[f"{src}.pw2.weight"][..., None],
                   f"{base}.6.bias": p[f"{src}.pw2.bias"]})
    torch.save({"model": sd}, path)
    return m


# the port's CLI in a subprocess with TF32 off, as in this script
CLI_TF32_OFF = ("import sys, torch; "
                "torch.backends.cuda.matmul.allow_tf32 = False; "
                "torch.backends.cudnn.allow_tf32 = False; "
                "from rave_tpu_torch.cli import main; main(sys.argv[1:])")


def run_cli(*args, timeout=600):
    """The port's CLI (``rave_tpu_torch.cli.main``) in a subprocess with
    TF32 off, so that a card run compares with a CPU run in float32;
    fails the run on a non-zero exit.  Returns its stdout and seconds."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", CLI_TF32_OFF, *args],
                       capture_output=True, text=True, timeout=timeout)
    check(r.returncode == 0, f"cli {args[0]} exited {r.returncode}: "
          f"{r.stdout[-1000:]} {r.stderr[-2000:]}")
    return r.stdout, time.perf_counter() - t0


def phase_pitch(torch, np, KERNELS, device="cuda"):
    """The f0-conditioned fork (see the module docstring, phase 11).
    Returns B1's launches per ``convert``, each kernel's per D and G step
    and the directory of the serialized converter (under ``_smoke/``,
    which the caller removes)."""
    from pathlib import Path
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.data.audio_io import save_wav
    from rave_tpu_torch.export.voice_conversion import VoiceConverter
    from rave_tpu_torch.models import pitch_fcpe as F
    from rave_tpu_torch.models.rave import RAVE
    from rave_tpu_torch.ops.pitch import pitch_feature, yin_f0
    from rave_tpu_torch.train import loop, schedules
    from rave_tpu_torch.utils.receptive_field import measure_receptive_field

    counts = lambda: {k.name: k.launches for k in KERNELS}  # noqa: E731

    def reset():
        for k in KERNELS:
            k.launches = 0

    t_phase = time.perf_counter()
    root = Path(SMOKE_DIR)
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir()
    cfg = build_config(PITCH_STACK, ["fused_kernels=true"])
    sr = cfg.sampling_rate
    torch.manual_seed(SEED)
    model = RAVE(cfg, device=device).eval()
    state = model.state_dict()
    cpu_state = {k: v.cpu() for k, v in state.items()}
    cpu = RAVE(cfg, device="cpu").eval()
    cpu.load_state_dict(cpu_state)
    speakers = glides(np, PITCH_SPEAKERS, 2 * PITCH_CLIP)
    src = torch.tensor(speakers[:, :PITCH_CLIP, None], device=device)
    tgt = torch.tensor(np.roll(speakers, -1, axis=0)[:, PITCH_CLIP:, None],
                       device=device)
    frames = PITCH_CLIP // cfg.total_ratio()

    # (a) offline conversion, YIN f0
    with torch.inference_mode():
        plain = RAVE(build_config(PITCH_STACK, ["fused_kernels=false"]),
                     device=device).eval()
        plain.load_state_dict(state)
        reset()
        y = model.convert(src, tgt)
        torch.cuda.synchronize()
        launches = counts()
        check(launches == {"residual_unit": 16, "ci1_conv_forward": 0,
                           "ci1_conv_dx": 0},
              f"pitch convert launches {launches}")
        check(tuple(y.shape) == tuple(src.shape), f"pitch convert {y.shape}")
        check(bool(torch.isfinite(y).all()), "pitch convert not finite")
        plain_err = (y - plain.convert(src, tgt)).abs().max().item()
        check(plain_err <= OFFLINE_TOL, f"pitch convert fused vs plain: "
              f"{plain_err}")
        del plain
        f0_card = yin_f0(src[..., 0], sr).cpu().numpy()
        f0_cpu = yin_f0(src[..., 0].cpu(), sr).numpy()
        f0_rel = hold_f0(np, f0_card, f0_cpu, "yin")
        feat = pitch_feature(src, frames, sr).cpu().numpy()
        feat_cpu = pitch_feature(src.cpu(), frames, sr).numpy()
        std = f0_stats(np, speakers[:, :PITCH_CLIP], sr)[1]
        feat_err = float((np.abs(feat - feat_cpu)
                          * std[:, None, None]).max())
        check(feat_err <= LOG_F0_TOL, f"pitch feature card vs cpu: "
              f"{feat_err} (log-f0 units)")
        check(np.abs(feat).max() > 0.5, "pitch feature is flat")
        xs, ts = src[:1, :65536], tgt[:1, :65536]
        cpu_err = (model.convert(xs, ts).cpu()
                   - cpu.convert(xs.cpu(), ts.cpu())).abs().max().item()
        check(cpu_err <= CPU_TOL, f"pitch convert card vs cpu: {cpu_err}")
        torch.cuda.reset_peak_memory_stats()
        times = [cuda_ms(torch, lambda: model.convert(src, tgt), iters=1,
                         warmup=0) for _ in range(10)]
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        prof = device_profile(torch, lambda: model.convert(src, tgt),
                              names=("residual_unit_kernel",))
        feat_ms = device_ms(torch, lambda: pitch_feature(src, frames, sr))
    prof["share"] = {n: ms / prof["device_ms"]
                     for n, ms in prof["named_ms"].items()}
    prof["share"]["pitch_feature"] = feat_ms / prof["device_ms"]
    convert_ms = statistics.median(times)
    audio_s = PITCH_SPEAKERS * PITCH_CLIP / sr
    emit({"phase": "pitch", "step": "convert", "config": "v2_fork+pitch",
          "batch": [PITCH_SPEAKERS, PITCH_CLIP, 1], "launches": launches,
          "max_abs_err_vs_plain": plain_err, "max_abs_err_vs_cpu": cpu_err,
          "f0_rel_err_vs_cpu": f0_rel, "f0_frames": list(f0_card.shape),
          "voiced_share": float((f0_card > 0).mean()),
          "feature_err_vs_cpu_log_f0": feat_err,
          "batch_ms": convert_ms, "rtf": convert_ms / 1e3 / audio_s,
          "batch_ms_all": times, "peak_mem_mb": peak_mb,
          "pitch_feature_device_ms": feat_ms, "profile": prof})
    convert_launches = launches["residual_unit"]

    # (b) FCPE from a random-weight checkpoint in torchfcpe's layout
    ckpt = str(root / "fcpe_random.pt")
    fcpe_checkpoint(torch, np, ckpt)
    fc, fc_cpu = F.get_fcpe(ckpt, device), F.get_fcpe(ckpt, "cpu")
    with torch.inference_mode():
        ff_card = F.fcpe_f0(fc, src[..., 0], sr, out_frames=frames)
        ff_cpu = F.fcpe_f0(fc_cpu, src[..., 0].cpu(), sr, out_frames=frames)
        fcpe_ms = device_ms(torch, lambda: F.fcpe_f0(fc, src[..., 0], sr),
                            iters=5)
    fcpe_rel = hold_f0(np, ff_card.cpu().numpy(), ff_cpu.numpy(), "fcpe")
    fcfg = build_config(PITCH_STACK, ["fused_kernels=true",
                                      "pitch_estimator=fcpe",
                                      f"pitch_ckpt={ckpt}"])
    fmodel = RAVE(fcfg, device=device).eval()
    fmodel.load_state_dict(state)
    with torch.inference_mode():
        reset()
        yf = fmodel.convert(src, tgt)
        torch.cuda.synchronize()
        check(counts()["residual_unit"] == 16, f"fcpe convert {counts()}")
        check(bool(torch.isfinite(yf).all()), "fcpe convert not finite")
        fcpe_vs_yin = (yf - y).abs().max().item()
        check(fcpe_vs_yin > 0, "fcpe convert equals the YIN one")
        fcpe_convert_ms = statistics.median(
            [cuda_ms(torch, lambda: fmodel.convert(src, tgt), iters=1,
                     warmup=0) for _ in range(5)])
    del fmodel, yf, y
    corpus = glides(np, PITCH_SPEAKERS, 2 * PITCH_CLIP, seed=SEED + 5)
    for s in range(PITCH_SPEAKERS):
        d = root / "audio" / f"spk{s}"
        d.mkdir(parents=True)
        for k in range(2):
            save_wav(str(d / f"{k}.wav"),
                     corpus[s, k * PITCH_CLIP:(k + 1) * PITCH_CLIP], sr)
    db = str(root / "db")
    seconds = {}
    _, seconds["preprocess"] = run_cli(
        "preprocess", "--input_path", str(root / "audio"), "--output_path",
        db, "--num_workers", "4")
    stats = {}
    for dev in (device, "cpu"):
        out = root / f"stats_{dev}.json"
        _, seconds[f"speaker_stats_{dev}"] = run_cli(
            "speaker_stats", "--db_path", db, "--pitch_ckpt", ckpt,
            "--out", str(out), "--device", dev)
        stats[dev] = json.loads(out.read_text())
    check(sorted(stats[device]) == [f"spk{s}" for s in range(PITCH_SPEAKERS)],
          f"speaker_stats speakers {sorted(stats[device])}")
    stats_rel = max(abs(stats[device][n][k] - stats["cpu"][n][k])
                    / max(abs(stats["cpu"][n][k]), 1e-12)
                    for n in stats["cpu"] for k in ("mean", "std"))
    check(stats_rel <= STATS_RTOL, f"speaker_stats card vs cpu: {stats_rel}")
    out, seconds["validate_assets"] = run_cli(
        "validate_assets", "--fcpe_ckpt", ckpt, "--out",
        str(root / "assets.md"), "--device", device)
    check("fcpe (pitch teacher): pass" in out,
          f"validate_assets: {out[-1500:]}")
    emit({"phase": "pitch", "step": "fcpe", "f0_rel_err_vs_cpu": fcpe_rel,
          "voiced_share": float((ff_cpu.numpy() > 0).mean()),
          "fcpe_f0_device_ms": fcpe_ms, "convert_batch_ms": fcpe_convert_ms,
          "fcpe_vs_yin_max_abs": fcpe_vs_yin, "speaker_stats": stats[device],
          "speaker_stats_rel_err_vs_cpu": stats_rel,
          "validate_assets": [ln for ln in out.splitlines()
                              if ln.startswith("fcpe")],
          "seconds": seconds})

    # (c) training through the speaker-statistics route
    torch.manual_seed(SEED)
    tstate = loop.TrainState(cfg, device=device, step=cfg.phase_1_duration)
    step_fn = loop.make_train_step(cfg)
    x8 = glides(np, TRAIN_BATCH, cfg.n_signal, seed=SEED + 6)
    med, std = f0_stats(np, x8, sr)
    units = np.random.default_rng(SEED + 7).integers(0, 100,
                                                     (TRAIN_BATCH, 148))
    batch = {"x": torch.tensor(x8[:, :, None], device=device),
             "units": torch.tensor(units, device=device),
             "f0_median": torch.tensor(med, device=device),
             "f0_std": torch.tensor(std, device=device)}
    torch.cuda.reset_peak_memory_stats()
    cycle, step_ms = [], {"D": [], "G": []}
    for _ in range(4):
        kind = "D" if schedules.is_discriminator_step(tstate.step, cfg) \
            else "G"
        reset()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        metrics = step_fn(tstate, batch)
        t1.record()
        t1.synchronize()
        step_ms[kind].append(t0.elapsed_time(t1))
        got = counts()
        want = {"residual_unit": 16, "ci1_conv_forward": 3,
                "ci1_conv_dx": 3 if kind == "G" else 0}
        check(got == want, f"pitch train {kind} launches {got}")
        values = {k: float(v) for k, v in metrics.items()}
        check(sorted(values) == TRAIN_METRICS,
              f"pitch train metric names {sorted(values)}")
        check(all(np.isfinite(v) for v in values.values()),
              f"pitch train {kind} metrics not finite: {values}")
        cycle.append({"kind": kind, "launches": got, "metrics": values})
    check([c["kind"] for c in cycle] == ["D", "G", "G", "G"],
          f"pitch train cycle {[c['kind'] for c in cycle]}")
    # a timed cycle after the checked one (which warmed cuDNN up)
    for _ in range(4):
        kind = "D" if schedules.is_discriminator_step(tstate.step, cfg) \
            else "G"
        step_ms[kind].append(cuda_ms(torch, lambda: step_fn(tstate, batch),
                                     iters=1, warmup=0))
    train_peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    del tstate, batch
    # one G step at 4 x 65536 on the card and on the CPU (one thread)
    short = build_config(PITCH_STACK, ["fused_kernels=true",
                                       "n_signal=65536", "batch_size=4"])
    g_step = short.phase_1_duration + 1
    torch.manual_seed(SEED + 1)
    card = loop.TrainState(short, device=device, step=g_step)
    cpu_t = loop.TrainState(short, device="cpu", step=g_step)
    cpu_t.model.load_state_dict({k: v.cpu() for k, v in
                                 card.model.state_dict().items()})
    cpu_t.disc.load_state_dict({k: v.cpu() for k, v in
                                card.disc.state_dict().items()})
    xs4 = glides(np, 4, short.n_signal, seed=SEED + 8)
    m4, s4 = f0_stats(np, xs4, sr)
    sb = {"x": torch.tensor(xs4[:, :, None]),
          "units": torch.tensor(np.random.default_rng(SEED + 9).integers(
              0, 100, (4, 74))),
          "f0_median": torch.tensor(m4), "f0_std": torch.tensor(s4)}
    short_fn = loop.make_train_step(short)
    m_card = {k: float(v) for k, v in short_fn(
        card, {k: v.to(device) for k, v in sb.items()}).items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        m_cpu = {k: float(v) for k, v in short_fn(cpu_t, sb).items()}
    finally:
        torch.set_num_threads(threads)
    rel = {k: abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12)
           for k in m_cpu}

    def norms(st):
        return {g: float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                        for p in ps)))
                for g, ps in (("enc", st.enc_params), ("dec", st.dec_params))}

    n_card, n_cpu = norms(card), norms(cpu_t)
    rel.update({f"grad_norm_{g}": abs(n_card[g] - n_cpu[g]) / n_cpu[g]
                for g in n_cpu})
    check(max(rel.values()) <= TRAIN_RTOL, f"pitch train card vs cpu: {rel}")
    del card, cpu_t
    d_ms, g_ms = step_ms["D"][-1], statistics.median(step_ms["G"][3:])
    emit({"phase": "pitch", "step": "train", "config": "v2_fork+pitch",
          "batch": [TRAIN_BATCH, cfg.n_signal, 1], "route": "speaker_stats",
          "cycle": cycle, "d_step_ms": d_ms, "g_step_ms": g_ms,
          "step_ms_all": step_ms,
          "audio_s_per_s": 4 * TRAIN_BATCH * cfg.n_signal / sr
          / ((d_ms + 3 * g_ms) / 1e3),
          "peak_mem_mb": train_peak_mb,
          "card_vs_cpu": {"rel_err": rel, "grad_norms_card": n_card,
                          "grad_norms_cpu": n_cpu}})
    train_launches = {"D": cycle[0]["launches"], "G": cycle[1]["launches"]}

    # (d) streamed conversion with f0, live and exported
    vc = VoiceConverter(cfg, state, chunk_size=VC_CHUNK, device=device)
    vc.speaker_table = vc.table_from_clips(list(speakers))
    vc.set_speaker(1)
    request = speakers[0]
    chunks = [request[i:i + VC_CHUNK]
              for i in range(0, 32 * VC_CHUNK, VC_CHUNK)]
    for c in chunks[:4]:   # warm-up
        vc.forward(c)
    vc.reset()
    reset()
    chunk_ms, outs = [], []
    for c in chunks:
        t0 = time.perf_counter()
        outs.append(vc.forward(c))   # returns numpy: synchronised
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
    stream_launches = counts()
    check(stream_launches["residual_unit"] == 0,
          f"pitch stream launches {stream_launches}")
    check(bool(np.isfinite(np.concatenate(outs)).all()),
          "pitch stream not finite")
    cpu_vc = VoiceConverter(cfg, cpu_state, chunk_size=VC_CHUNK,
                            speaker_table=vc.speaker_table, device="cpu")
    cpu_vc.set_speaker(1)
    vc.reset()
    stream_err = 0.0
    for c in chunks[:8]:
        stream_err = max(stream_err,
                         float(np.abs(vc.forward(c) - cpu_vc.forward(c)).max()))
    check(stream_err <= CPU_TOL, f"pitch stream card vs cpu: {stream_err}")
    check(len(vc._logf0) == len(cpu_vc._logf0) > 0,
          "pitch stream reservoirs differ")
    del cpu_vc
    t0 = time.perf_counter()
    out_dir = vc.serialize(str(root / "export"))
    serialize_s = time.perf_counter() - t0
    n = len(vc.stream.init_caches)
    carry, _ = manifest_caches(torch, np, out_dir / "convert_pg_manifest.txt",
                               out_dir / "convert_pg_cache_init.bin", n + 1,
                               device)
    prog = torch.export.load(out_dir / "convert_pg.pt2").module()
    # the carry: the caches, then the f0 tail, in and out
    live = [c.clone() for c in carry]
    emb = torch.tensor(vc.current_embedding(), device=device)
    pg_err = 0.0
    with torch.no_grad():
        for c in chunks[:8]:
            xc = torch.tensor(c.reshape(1, -1, 1), device=device)
            yp, carry = prog(carry, xc, emb)
            yl, live = vc._convert_pg(live, xc, emb)
            pg_err = max(pg_err, (yp - yl).abs().max().item())
            check(bool(torch.isfinite(yp).all()), "convert_pg not finite")
    check(pg_err <= EXPORT_TOL and torch.equal(carry[-1], live[-1]),
          f"convert_pg.pt2 vs live: {pg_err}")
    emit({"phase": "pitch", "step": "stream", "chunk": VC_CHUNK,
          "chunks": len(chunk_ms), "launches": stream_launches,
          "chunk_ms_median": statistics.median(chunk_ms),
          "chunk_ms_p80": float(np.percentile(chunk_ms, 80)),
          "chunk_ms_max": max(chunk_ms),
          "chunk_ms_limit": VC_CHUNK / sr * 1e3 / 2,
          "chunk_duration_ms": VC_CHUNK / sr * 1e3,
          "max_abs_err_vs_cpu": stream_err, "serialize_s": serialize_s,
          "convert_pg_max_abs_err_vs_live": pg_err})
    del vc

    # (e) the receptive field of the conv stacks, card and CPU
    lc, rc = loop.receptive_field_frames(cfg)

    def rf_fn(m):
        extra = cfg.decoder_latent_size() - cfg.latent_size

        def apply(x):
            z = m.encode_input(m.pqmf_forward(x))
            z = torch.cat([z, z.new_zeros(z.shape[0], extra, z.shape[2])], 1)
            return m.pqmf_inverse(m.decode_bands(z))
        return apply

    t0 = time.perf_counter()
    rf_card = measure_receptive_field(rf_fn(model), device=device)
    rf_card_s = time.perf_counter() - t0
    rf_cpu = measure_receptive_field(rf_fn(cpu), device="cpu")
    check(rf_card == rf_cpu, f"receptive field card {rf_card} cpu {rf_cpu}")
    check(lc >= rf_card[0] // cfg.n_band + 1
          and rc >= rf_card[1] // cfg.n_band + 1,
          f"receptive field {rf_card} outside the crop {lc}, {rc}")
    emit({"phase": "pitch", "step": "receptive_field",
          "samples": list(rf_card), "band_frames_crop": [lc, rc],
          "card_s": rf_card_s, "seconds": time.perf_counter() - t_phase})
    return convert_launches, train_launches, out_dir


# discrete_v3: the residual-VQ and v3 presets at full width; kernel B1 at
# C = 384 inside the discrete forward and train steps
INDEX_SHARE = 0.999      # card vs cpu: the share of equal RVQ indices
INDEX_GAP = 1e-4         # a differing index: its two codes' distances
                         # from the residual within this share
BOOK_RTOL = 1e-4         # card vs cpu codebook buffers after a step
STREAM_CHUNKS = 16       # 2048-sample chunks per stage of the AdaIN workflow
# the card-vs-CPU D, G pairs run at learning_rate 1e-6: the hinge loss
# gives each score conv's bias a gradient of rounding noise only, which
# Adam's first step turns into a move of +-lr in a direction each device
# draws differently; at 1e-4 the following G step's GAN terms differ by
# ~1e-3 (ROADMAP C; tests/test_torch_discrete.py)
PAIR_OVER = ["n_signal=65536", "batch_size=4", "learning_rate=1e-6"]
D_STEP_SHARE = 0.999     # of the discriminator's parameters, card vs CPU,
                         # after one D step at the preset's rate


def rows_sampler(torch, np):
    """The RVQ's random rows (k-means seeds, fresh codes) by a rule of
    the row counts alone, so that the card and the CPU draw the same."""
    def sampler(samples, num):
        n = samples.shape[0]
        idx = np.random.RandomState(1000 * n + num).randint(0, n, num)
        return samples[torch.from_numpy(idx).to(samples.device)]
    return sampler


def index_gaps(torch, model, z, got, want) -> dict:
    """RVQ indices ``got`` against ``want`` (``(B, N, T)``) for the
    pre-quantization latent ``z`` ``(B, D, T)`` of ``model``: the share
    that agree and, over those that differ, the largest gap between the
    two codes' squared distances from ``want``'s residual at that stage
    (float64, relative to ``want``'s distance)."""
    residual = z.double()
    worst, same = 0.0, (got == want)
    for i, layer in enumerate(model.latent.rvq.layers):
        e = layer.codebook.embed.double()
        r = residual.transpose(1, 2).reshape(-1, e.shape[1])
        dist = ((r * r).sum(-1, keepdim=True) - 2 * r @ e.T
                + (e * e).sum(-1)[None])
        g, w = got[:, i].reshape(-1), want[:, i].reshape(-1)
        n = torch.arange(len(g), device=g.device)
        diff = g != w
        if bool(diff.any()):
            gap = ((dist[n, g] - dist[n, w]).abs()
                   / dist[n, w].abs().clamp_min(1e-30))[diff]
            worst = max(worst, float(gap.max()))
        residual = residual - layer.decode(want[:, i]).double()
    return {"share_equal": float(same.double().mean()),
            "differing": int((~same).sum()), "max_rel_gap": worst}


def check_indices(res, what) -> None:
    check(res["share_equal"] >= INDEX_SHARE
          and res["max_rel_gap"] <= INDEX_GAP, f"{what} indices: {res}")


def codebooks(model) -> list:
    return [{k: v.detach().clone() for k, v in
             layer.codebook.state_dict().items()}
            for layer in model.latent.rvq.layers]


def codebook_err(torch, got, want) -> float:
    """The largest excess of ``|got - want|`` over ``BOOK_RTOL`` of
    ``want`` plus 1e-6, ``embed``'s atol divided by each code's smoothed
    count (an unused code's ``embed`` is ``embed_avg`` over ~1e-5)."""
    worst = 0.0
    for g, w in zip(got, want):
        cs = w["cluster_size"].double().cpu()
        n = cs.sum()
        smoothed = (cs + 1e-5) / (n + len(cs) * 1e-5) * n
        for k in g:
            a, b = g[k].double().cpu(), w[k].double().cpu()
            atol = 1e-6 / smoothed[:, None] if k == "embed" else 1e-6
            worst = max(worst, float(((a - b).abs() - BOOK_RTOL * b.abs()
                                      - atol).max()))
    return worst


def grad_norms(torch, st) -> dict:
    return {g: float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                    for p in ps)))
            for g, ps in (("enc", st.enc_params), ("dec", st.dec_params))}


def dis_grad_norm(torch, st) -> float:
    """The norm of the discriminator's gradient, which a D step leaves in
    ``.grad`` (a G step differentiates the generator only)."""
    return float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                for p in st.disc.parameters())))


def card_vs_cpu_pair(torch, np, stack, over, counts, reset, device="cuda"):
    """A D, G pair of ``stack`` with ``over`` at 4 x 65536 (``PAIR_OVER``)
    from one seeded state with zero codebooks on the card and on the CPU
    (one thread), the same rows drawn on both: losses, ENC/DEC gradient
    norms and the D step's DIS gradient norm within ``TRAIN_RTOL``,
    codebook buffers after each step within :func:`codebook_err`.
    Then one D step at the preset's learning rate
    from the same start on 1 x 65536: at least ``D_STEP_SHARE`` of the
    discriminator's parameters after it within 1 % of the rate (Adam's
    first step moves an element whose gradient is rounding noise by up to
    +-lr, in a direction each device draws differently).  Returns the
    numbers."""
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.train import loop, schedules

    short = build_config(stack, over + PAIR_OVER)
    torch.manual_seed(SEED + 1)
    card = loop.TrainState(short, device=device, step=short.phase_1_duration)
    cpu = loop.TrainState(short, device="cpu", step=short.phase_1_duration)
    start = ({k: v.cpu() for k, v in card.model.state_dict().items()},
             {k: v.cpu() for k, v in card.disc.state_dict().items()})
    cpu.model.load_state_dict(start[0])
    cpu.disc.load_state_dict(start[1])
    audio = voices(np, 4, short.n_signal, SEED + 2)
    sb = {"x": torch.tensor(audio[:, :, None], dtype=torch.float32,
                            device=device)}
    fn, sampler = loop.make_train_step(short), rows_sampler(torch, np)
    threads = torch.get_num_threads()
    rel, book, launches = {}, {}, {}
    for kind in ("D", "G"):
        is_d = schedules.is_discriminator_step(card.step, short)
        check(is_d == (kind == "D"), f"{stack} pair: step {card.step}")
        reset()
        m_card = {k: float(v) for k, v in fn(card, sb,
                                             sampler=sampler).items()}
        launches[kind] = counts()
        torch.set_num_threads(1)
        try:
            m_cpu = {k: float(v) for k, v in fn(
                cpu, {"x": sb["x"].cpu()}, sampler=sampler).items()}
        finally:
            torch.set_num_threads(threads)
        rel.update({f"{kind}/{k}": abs(m_card[k] - m_cpu[k])
                    / max(abs(m_cpu[k]), 1e-12) for k in m_cpu})
        book[kind] = codebook_err(torch, codebooks(card.model),
                                  codebooks(cpu.model))
        check(book[kind] <= 0, f"{stack} pair codebooks after {kind}: "
              f"{book[kind]}")
    n_card, n_cpu = grad_norms(torch, card), grad_norms(torch, cpu)
    rel.update({f"grad_norm_{g}": abs(n_card[g] - n_cpu[g]) / n_cpu[g]
                for g in n_cpu})
    n_card["dis"], n_cpu["dis"] = dis_grad_norm(torch, card), \
        dis_grad_norm(torch, cpu)
    rel["D/grad_norm_dis"] = abs(n_card["dis"] - n_cpu["dis"]) / n_cpu["dis"]
    check(max(rel.values()) <= TRAIN_RTOL, f"{stack} card vs cpu: {rel}")
    del card, cpu

    # one D step at the preset's learning rate from the same start
    preset = build_config(stack, over + PAIR_OVER[:-1])
    d_after = []
    for dev in (device, "cpu"):
        st = loop.TrainState(preset, device=dev, step=preset.phase_1_duration)
        st.model.load_state_dict(start[0])
        st.disc.load_state_dict(start[1])
        check(schedules.is_discriminator_step(st.step, preset),
              f"{stack} preset-rate step {st.step}")
        torch.set_num_threads(1 if dev == "cpu" else threads)
        try:
            loop.make_train_step(preset)(st, {"x": sb["x"][:1].to(dev)},
                                         sampler=sampler)
        finally:
            torch.set_num_threads(threads)
        d_after.append(torch.cat([p.detach().cpu().flatten()
                                  for p in st.disc.parameters()]))
        del st
    share = float(((d_after[0] - d_after[1]).abs()
                   <= 0.01 * preset.learning_rate).double().mean())
    check(share >= D_STEP_SHARE, f"{stack} D step at the preset's rate: "
          f"{share} of the discriminator within 1 % of the rate")
    return {"overrides": over + PAIR_OVER, "rel_err": rel,
            "grad_norms_card": n_card, "grad_norms_cpu": n_cpu,
            "codebook_excess": book, "launches": launches,
            "preset_rate_d_step": {"learning_rate": preset.learning_rate,
                                   "batch": [1, preset.n_signal, 1],
                                   "share_within_1pct_of_rate": share}}


def train_cycles(torch, np, st, fn, batch, expect, counts, reset, what,
                 cycles=3):
    """One D, G, G, G cycle from the state's step with ``expect``
    launches on every step and finite metrics, then ``cycles`` timed ones:
    median D and G ms, audio seconds per second and peak memory."""
    from rave_tpu_torch.train import schedules
    kind_of = lambda: ("D" if schedules.is_discriminator_step(  # noqa: E731
        st.step, st.cfg) else "G")
    warm = []
    for _ in range(4):
        kind = kind_of()
        reset()
        values = {k: float(v) for k, v in fn(st, batch).items()}
        torch.cuda.synchronize()
        check(counts() == expect, f"{what} {kind} step launches {counts()}")
        check(all(np.isfinite(v) for v in values.values()),
              f"{what} {kind} step metrics {values}")
        warm.append({"kind": kind, "metrics": values})
    check([c["kind"] for c in warm] == list("DGGG"), f"{what} cycle {warm}")
    times = {"D": [], "G": []}
    torch.cuda.reset_peak_memory_stats()
    for _ in range(cycles * 4):
        kind = kind_of()
        times[kind].append(cuda_ms(torch, lambda: fn(st, batch), iters=1,
                                   warmup=0))
    d_ms, g_ms = statistics.median(times["D"]), statistics.median(times["G"])
    audio_s = batch["x"].shape[0] * batch["x"].shape[1] / 44100
    return {"warmup_cycle": warm, "d_step_ms": d_ms, "g_step_ms": g_ms,
            "d_step_ms_all": times["D"], "g_step_ms_all": times["G"],
            "audio_s_per_s": 4 * audio_s / ((d_ms + 3 * g_ms) / 1e3),
            "peak_mem_mb": torch.cuda.max_memory_allocated() / 2 ** 20}


def phase_discrete(torch, np, KERNELS, card, device="cuda"):
    """(a) of phase discrete_v3 (see the module docstring).  Returns the
    launches of each kernel per offline forward and per D and G step."""
    from pathlib import Path
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.export.streaming import StreamingRAVE
    from rave_tpu_torch.models.rave import RAVE
    from rave_tpu_torch.train import loop

    counts = lambda: {k.name: k.launches for k in KERNELS}  # noqa: E731

    def reset():
        for k in KERNELS:
            k.launches = 0

    t_phase = time.perf_counter()
    cfg = build_config(["discrete"], ["fused_kernels=true"])
    torch.manual_seed(SEED)
    state = loop.TrainState(cfg, device=device, step=cfg.phase_1_duration,
                            seed=SEED)
    model = state.model
    audio = voices(np, BATCH, SAMPLES)
    x = torch.tensor(audio[:, :, None], dtype=torch.float32, device=device)
    # codebooks: one k-means-init train pass over the batch's latents
    with torch.no_grad():
        z_pre = model.encode_input(model.pqmf_forward(x))
        model.reparametrize(z_pre, generator=state.generator, train=True)
    books = codebooks(model)
    check(all(float(b["inited"]) == 1.0 and all(
        bool(torch.isfinite(v).all()) for v in b.values()) for b in books),
        "discrete k-means init: codebooks not inited or not finite")
    plain = RAVE(build_config(["discrete"], ["fused_kernels=false"]),
                 device=device)
    plain.load_state_dict(model.state_dict())
    cpu = RAVE(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})

    with torch.inference_mode():
        reset()
        y = model(x)
        torch.cuda.synchronize()
        launches = counts()
        check(launches == {"residual_unit": 6, "ci1_conv_forward": 0,
                           "ci1_conv_dx": 0},
              f"discrete forward launches {launches}")
        check(tuple(y.shape) == tuple(x.shape) and bool(
            torch.isfinite(y).all()), "discrete forward shape or values")
        idx, idx_plain = model.encode_indices(x), plain.encode_indices(x)
        fused_idx = index_gaps(torch, model, z_pre, idx_plain, idx)
        check_indices(fused_idx, "discrete fused vs plain")
        plain_err = (y - plain(x)).abs().max().item()
        check(plain_err <= OFFLINE_TOL, f"discrete fused vs plain {plain_err}")
        xs = x[:1, :8192]
        cpu_err = (model(xs).cpu() - cpu(xs.cpu())).abs().max().item()
        check(cpu_err <= CPU_TOL, f"discrete card vs cpu {cpu_err}")
        cpu_idx = index_gaps(torch, cpu,
                             cpu.encode_input(cpu.pqmf_forward(xs.cpu())),
                             model.encode_indices(xs).cpu(),
                             cpu.encode_indices(xs.cpu()))
        check_indices(cpu_idx, "discrete card vs cpu")
        torch.cuda.reset_peak_memory_stats()
        times = [cuda_ms(torch, lambda: model(x), iters=1, warmup=0)
                 for _ in range(10)]
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        prof = device_profile(torch, lambda: model(x),
                              names=("residual_unit_kernel",))
    prof["share"] = {n: ms / prof["device_ms"]
                     for n, ms in prof["named_ms"].items()}
    check(prof["named_count"]["residual_unit_kernel"] == 6,
          f"discrete profile B1 kernels {prof['named_count']}")
    audio_s = BATCH * SAMPLES / cfg.sampling_rate
    batch_ms = statistics.median(times)
    emit({"phase": "discrete_v3", "step": "discrete_offline", "card": card,
          "config": "discrete", "overrides": ["fused_kernels=true"],
          "params": sum(p.numel() for p in model.parameters()),
          "batch": [BATCH, SAMPLES, 1], "launches": launches,
          "indices": list(idx.shape), "max_abs_err_vs_plain": plain_err,
          "indices_vs_plain": fused_idx, "max_abs_err_vs_cpu": cpu_err,
          "indices_vs_cpu": cpu_idx, "batch_ms": batch_ms,
          "batch_ms_all": times, "rtf": batch_ms / 1e3 / audio_s,
          "peak_mem_mb": peak_mb, "profile": prof})

    # the index stream of request 0, then serialize and reload
    sr = StreamingRAVE(cfg, model.state_dict(), chunk_size=CHUNK,
                       device=device)
    signal = audio[0].astype(np.float32)
    for i in range(0, 4 * CHUNK, CHUNK):    # warm-up
        sr.decode_indices(sr.encode_indices(
            signal[i:i + CHUNK].reshape(1, -1, 1)))
    sr.reset()
    reset()
    chunk_ms, outs = [], []
    for i in range(0, SAMPLES, CHUNK):
        t0 = time.perf_counter()
        code = sr.encode_indices(signal[i:i + CHUNK].reshape(1, -1, 1))
        out = sr.decode_indices(code)
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out[0, :, 0])
    check(tuple(code.shape) == (1, cfg.num_quantizers,
                                CHUNK // cfg.total_ratio())
          and code.dtype == torch.int64, f"index chunk {tuple(code.shape)}")
    stream_launches = counts()
    check(not any(stream_launches.values()),
          f"index stream launches {stream_launches}")
    y_str = torch.cat(outs).cpu().numpy()
    d = sr.total_delay_samples()
    a = y[0, :, 0].cpu().numpy()
    m = 2 * d + 256
    a_cmp, b_cmp = a[m - d: SAMPLES - d - 256], y_str[m: SAMPLES - 256]
    rel = float(np.median(np.abs(a_cmp - b_cmp))
                / (np.abs(a_cmp).mean() + 1e-9))
    check(bool(np.isfinite(y_str).all()) and rel < 0.02,
          f"index stream vs offline median rel err {rel}")
    out_dir = Path(SMOKE_DIR) / "discrete_export"
    t0 = time.perf_counter()
    sr.serialize(out_dir)
    serialize_s = time.perf_counter() - t0
    sr.reset()
    caches = [c.clone() for c in sr.init_caches]
    export_err = 0.0
    prog = torch.export.load(out_dir / "forward.pt2").module()
    with torch.no_grad():
        for i in range(0, 4 * CHUNK, CHUNK):
            c = torch.tensor(signal[i:i + CHUNK].reshape(1, -1, 1),
                             device=device)
            got, caches = prog(caches, c)
            export_err = max(export_err, (got - sr.forward(c)).abs().max()
                             .item())
    check(export_err <= EXPORT_TOL, f"discrete forward.pt2 {export_err}")
    shutil.rmtree(out_dir)
    med = statistics.median(chunk_ms)
    emit({"phase": "discrete_v3", "step": "discrete_index_stream",
          "card": card, "chunk": CHUNK, "chunks": len(chunk_ms),
          "delay_samples": d, "median_rel_err": rel,
          "launches": stream_launches, "chunk_ms_median": med,
          "chunk_ms_p80": float(np.percentile(chunk_ms, 80)),
          "chunk_ms_max": max(chunk_ms),
          "rtf": med / 1e3 / (CHUNK / cfg.sampling_rate),
          "serialize_s": serialize_s,
          "forward_pt2_max_abs_err_4_chunks": export_err})
    del sr, prog, plain, cpu

    # D, G, G, G at 8 x 131072 from phase_1_duration, B1 in every step
    batch = {"x": torch.tensor(voices(np, TRAIN_BATCH, cfg.n_signal,
                                      SEED + 3)[:, :, None],
                               dtype=torch.float32, device=device)}
    expect = {"residual_unit": 6, "ci1_conv_forward": 0, "ci1_conv_dx": 0}
    train = train_cycles(torch, np, state, loop.make_train_step(cfg), batch,
                         expect, counts, reset, "discrete")
    books = codebooks(state.model)
    check(all(float(b["inited"]) == 1.0 and all(
        bool(torch.isfinite(v).all()) for v in b.values()) for b in books),
        "discrete codebooks after training")
    pair = card_vs_cpu_pair(torch, np, ["discrete"], ["fused_kernels=true"],
                            counts, reset, device)
    check(all(v == expect for v in pair["launches"].values()),
          f"discrete pair launches {pair['launches']}")
    emit({"phase": "discrete_v3", "step": "discrete_train", "card": card,
          "batch": [TRAIN_BATCH, cfg.n_signal, 1],
          "start_step": cfg.phase_1_duration, **train,
          "codebook_cluster_size_sum": [float(b["cluster_size"].sum())
                                        for b in books],
          "card_vs_cpu": pair,
          "phase_seconds": time.perf_counter() - t_phase})
    return launches, {c["kind"]: expect for c in train["warmup_cycle"]}


def adain_workflow(np, sr, voice, loud, n):
    """The AdaIN controls workflow over ``n`` chunks per stage, each
    stage from fresh conv caches (as ``process_file_scan`` runs it):
    plain, target statistics from ``loud``, source statistics from
    ``voice``, then the transfer.  Returns each stage's output
    ``(n * chunk,)`` and the AdaIN states after."""
    c = sr.chunk

    def run(sig):
        return np.concatenate([sr.forward(sig[i * c:(i + 1) * c].reshape(
            1, -1, 1))[0, :, 0].cpu().numpy() for i in range(n)])

    def fresh_conv_caches():
        # the conv caches back to zeros, the AdaIN states (the carry's
        # tail) kept, as the JAX package's workflow test resets ``cache``
        k = len(sr.caches) - sr.n_adain
        sr.caches[:k] = [t.clone() for t in sr.init_caches[:k]]

    sr.reset()
    out = {"plain": run(voice)}
    sr.reset()
    sr.set_learn_target(True)
    out["learn_target"] = run(loud)
    sr.set_learn_target(False)
    sr.set_learn_source(True)
    fresh_conv_caches()
    out["learn_source"] = run(voice)
    sr.set_learn_source(False)
    fresh_conv_caches()
    out["transfer"] = run(voice)
    return out, [a.cpu() for a in sr.adain]


def phase_v3(torch, np, KERNELS, card, device="cuda"):
    """(b) of phase discrete_v3 (see the module docstring).  Returns the
    launches of each kernel per offline forward and per D and G step."""
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.export.streaming import StreamingRAVE
    from rave_tpu_torch.models.rave import RAVE, serving_mode
    from rave_tpu_torch.train import loop

    counts = lambda: {k.name: k.launches for k in KERNELS}  # noqa: E731

    def reset():
        for k in KERNELS:
            k.launches = 0

    t_phase = time.perf_counter()
    cfg = build_config(["v3"])
    torch.manual_seed(SEED)
    state = loop.TrainState(cfg, device=device, step=cfg.phase_1_duration,
                            seed=SEED)
    model = state.model
    audio = voices(np, BATCH, SAMPLES, SEED + 4)
    x = torch.tensor(audio[:, :, None], dtype=torch.float32, device=device)
    cpu = RAVE(cfg, device="cpu", train_mode=False)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.inference_mode(), serving_mode(model):
        reset()
        y = model(x)
        torch.cuda.synchronize()
        launches = counts()
        check(not any(launches.values()), f"v3 forward launches {launches}")
        check(tuple(y.shape) == tuple(x.shape) and bool(
            torch.isfinite(y).all()), "v3 forward shape or values")
        xs = x[:1, :8192]
        cpu_err = (model(xs).cpu() - cpu(xs.cpu())).abs().max().item()
        check(cpu_err <= CPU_TOL, f"v3 card vs cpu {cpu_err}")
        times = [cuda_ms(torch, lambda: model(x), iters=1, warmup=0)
                 for _ in range(5)]
    batch_ms = statistics.median(times)

    # the AdaIN controls, card against CPU chunk by chunk, then the same
    # workflow through process_file_scan's CUDA graph
    sd = model.state_dict()
    n = STREAM_CHUNKS
    voice = audio[0, :n * CHUNK].astype(np.float32)
    loud = 3.0 * audio[-1, :n * CHUNK].astype(np.float32)
    sr = StreamingRAVE(cfg, sd, chunk_size=CHUNK, device=device)
    sr_cpu = StreamingRAVE(cfg, {k: v.cpu() for k, v in sd.items()},
                           chunk_size=CHUNK, device="cpu")
    reset()
    got, got_adain = adain_workflow(np, sr, voice, loud, n)
    stream_launches = counts()
    want, want_adain = adain_workflow(np, sr_cpu, voice, loud, n)
    errs = {k: float(np.abs(got[k] - want[k]).max()) for k in got}
    errs["adain_state"] = max(float((a - b).abs().max())
                              for a, b in zip(got_adain, want_adain))
    check(max(errs.values()) <= CPU_TOL, f"v3 AdaIN workflow card vs cpu "
          f"{errs}")
    transfer_diff = float(np.abs(got["transfer"] - got["plain"]).max())
    check(transfer_diff > 1e-3, f"v3 transfer equals the plain stream "
          f"({transfer_diff})")
    check(not any(stream_launches.values()),
          f"v3 stream launches {stream_launches}")
    del sr_cpu
    sr.reset()
    sr.set_learn_target(True)
    sr.process_file_scan(loud)
    sr.set_learn_target(False)
    sr.set_learn_source(True)
    sr.process_file_scan(voice)
    sr.set_learn_source(False)
    scan = sr.process_file_scan(voice)
    scan_err = float(np.abs(scan - got["transfer"]).max())
    scan_state_err = max(float((a.cpu() - b).abs().max())
                         for a, b in zip(sr.adain, got_adain))
    check(max(scan_err, scan_state_err) <= EXPORT_TOL,
          f"v3 CUDA-graph workflow vs eager {scan_err} {scan_state_err}")
    emit({"phase": "discrete_v3", "step": "v3_serve", "card": card,
          "config": "v3", "params": sum(p.numel() for p in model.parameters()),
          "batch": [BATCH, SAMPLES, 1], "launches": launches,
          "max_abs_err_vs_cpu": cpu_err, "batch_ms": batch_ms,
          "rtf": batch_ms / 1e3 / (BATCH * SAMPLES / cfg.sampling_rate),
          "adain_modules": sr.n_adain, "workflow_chunks_per_stage": n,
          "workflow_max_abs_err_vs_cpu": errs,
          "transfer_vs_plain_max_abs_diff": transfer_diff,
          "cuda_graph_vs_eager": {"audio": scan_err,
                                  "adain_state": scan_state_err},
          "stream_launches": stream_launches})
    del sr

    # D, G, G, G at 8 x 131072; the Descript discriminator's share of a G
    # step; one G step at 1 x 65536 card vs CPU
    batch = {"x": torch.tensor(voices(np, TRAIN_BATCH, cfg.n_signal,
                                      SEED + 5)[:, :, None],
                               dtype=torch.float32, device=device)}
    expect = {"residual_unit": 0, "ci1_conv_forward": 0, "ci1_conv_dx": 0}
    step_fn = loop.make_train_step(cfg)
    train = train_cycles(torch, np, state, step_fn, batch, expect, counts,
                         reset, "v3")

    def one_g_step():
        state.step = cfg.phase_1_duration + 4 * 10 + 1
        step_fn(state, batch)

    prof = device_profile(torch, one_g_step)
    # the discriminator as a G step runs it: frozen, on real and fake
    # after the valid-signal crop, with the data gradient only
    lc, rc = loop.receptive_field_frames(cfg)
    T = cfg.n_signal - (lc + rc) * cfg.n_band
    both = torch.cat([batch["x"], batch["x"]])[:, :T].transpose(1, 2) \
        .contiguous().requires_grad_(True)

    def disc_fwd_bwd():
        feats = state.disc(both)
        torch.autograd.grad(sum(f.square().mean() for chain in feats
                                for f in chain), both)

    state.disc.requires_grad_(False)
    try:
        disc_ms = device_ms(torch, disc_fwd_bwd, iters=3)
    finally:
        state.disc.requires_grad_(True)
    prof["descript_ms"] = disc_ms
    prof["descript_share"] = disc_ms / prof["device_ms"]

    short = build_config(["v3"], ["n_signal=65536", "batch_size=1",
                                  "log_epsilon=1e-3"])
    g_step = short.phase_1_duration + 1
    torch.manual_seed(SEED + 1)
    card_st = loop.TrainState(short, device=device, step=g_step)
    cpu_st = loop.TrainState(short, device="cpu", step=g_step)
    cpu_st.model.load_state_dict({k: v.cpu() for k, v in
                                  card_st.model.state_dict().items()})
    cpu_st.disc.load_state_dict({k: v.cpu() for k, v in
                                 card_st.disc.state_dict().items()})
    eps = torch.tensor(np.random.default_rng(SEED).standard_normal(
        (1, short.latent_size, short.n_signal // short.total_ratio())),
        dtype=torch.float32)
    sb = {"x": batch["x"][:1, :short.n_signal]}
    short_fn = loop.make_train_step(short)
    m_card = {k: float(v) for k, v in short_fn(card_st, sb,
                                               eps.to(device)).items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        m_cpu = {k: float(v) for k, v in short_fn(
            cpu_st, {"x": sb["x"].cpu()}, eps).items()}
    finally:
        torch.set_num_threads(threads)
    n_card, n_cpu = grad_norms(torch, card_st), grad_norms(torch, cpu_st)
    rel = {k: abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12)
           for k in m_cpu}
    rel.update({f"grad_norm_{g}": abs(n_card[g] - n_cpu[g]) / n_cpu[g]
                for g in n_cpu})
    check(max(rel.values()) <= TRAIN_RTOL, f"v3 card vs cpu G step {rel}")
    emit({"phase": "discrete_v3", "step": "v3_train", "card": card,
          "batch": [TRAIN_BATCH, cfg.n_signal, 1],
          "start_step": cfg.phase_1_duration, **train,
          "g_step_profile": prof,
          "card_vs_cpu": {"overrides": ["n_signal=65536", "batch_size=1",
                                        "log_epsilon=1e-3"],
                          "rel_err": rel, "grad_norms_card": n_card,
                          "grad_norms_cpu": n_cpu},
          "phase_seconds": time.perf_counter() - t_phase})
    return launches, {c["kind"]: expect for c in train["warmup_cycle"]}


def phase_discrete_v3(torch, np, KERNELS, card, device="cuda"):
    """Phase discrete_v3 (see the module docstring): (a) ``discrete``,
    (b) ``v3``, (c) a ``discrete_v3`` D, G pair card vs CPU.  Returns
    the launch counts for the summary."""
    t_phase = time.perf_counter()
    counts = lambda: {k.name: k.launches for k in KERNELS}  # noqa: E731

    def reset():
        for k in KERNELS:
            k.launches = 0

    d_fwd, d_train = phase_discrete(torch, np, KERNELS, card, device)
    v3_fwd, v3_train = phase_v3(torch, np, KERNELS, card, device)
    pair = card_vs_cpu_pair(torch, np, ["discrete_v3"], [], counts, reset,
                            device)
    check(not any(v for c in pair["launches"].values() for v in c.values()),
          f"discrete_v3 pair launches {pair['launches']}")
    emit({"phase": "discrete_v3", "step": "discrete_v3_pair", "card": card,
          "config": "discrete_v3", "card_vs_cpu": pair,
          "phase_seconds": time.perf_counter() - t_phase})
    return {"discrete_forward": d_fwd, "discrete_train_step": d_train,
            "v3_forward": v3_fwd, "v3_train_step": v3_train}


# native: the exported steps served by the C++ host, with no Python
NATIVE_BLOCKS = 64       # 2048-sample blocks of full-width v2 (131072)
NATIVE_VC_BLOCKS = 32    # 4096-sample blocks of the fork's converters
# (d)'s package compiled for the CPU: any program will do, so a tiny v2
NATIVE_CPU_TINY = ["capacity=4", "ratios=[2,2]", "dilations=[[1,3],[1,3]]"]
NATIVE_TIMEOUT = 600     # s, the CPU package's compile in a subprocess


def n_caches(manifest) -> int:
    """The cache count of a manifest: its outputs but ``y``."""
    return sum(ln.startswith("out ")
               for ln in manifest.read_text().splitlines()) - 1


def serve_native(torch, np, export_dir, prefix, x, host, device="cuda"):
    """``<export_dir>/<prefix>.pt2`` compiled into its AOTInductor package
    and served by the host over the blocks ``x`` ``(n, chunk)``: the
    host's JSON line with the compile seconds, the package's size and the
    operators it runs through the proxy executor; the blocking loop's
    outputs ``(n, chunk)``; the last caches, flat; the package's path."""
    from rave_tpu_torch.export import native
    pkg, compile_s = native.compile_package(export_dir, prefix, device)
    files = {k: export_dir / f"{prefix}_{k}.bin" for k in ("x", "y", "c")}
    np.ascontiguousarray(x, np.float32).tofile(files["x"])
    res = native.run_host(export_dir, len(x), prefix, device,
                          x_in=str(files["x"]), y_out=str(files["y"]),
                          carry_out=str(files["c"]), host=host)
    y = np.fromfile(files["y"], np.float32).reshape(x.shape)
    check(res["cuda_graph"] and res["blocks"] == len(x),
          f"host {prefix}: {res}")
    check(bool(np.isfinite(y).all()), f"host {prefix}: output not finite")
    res.update(compile_s=compile_s, package_mb=pkg.stat().st_size / 2 ** 20,
               proxy_ops=native.proxy_ops(pkg))
    return res, y, np.fromfile(files["c"], np.float32), pkg


def program_blocks(torch, np, prog, carry, x, extra, device="cuda"):
    """The reloaded program over the blocks ``x`` from ``carry`` (with the
    inputs ``extra`` after the chunk): its outputs ``(n, chunk)`` and the
    last caches, flat."""
    ys = []
    with torch.no_grad():
        for xc in x:
            y, carry = prog(carry, torch.tensor(xc.reshape(1, -1, 1),
                                                device=device), *extra)
            ys.append(y.reshape(-1).cpu().numpy())
    return np.stack(ys), np.concatenate([c.reshape(-1).cpu().numpy()
                                         for c in carry])


def package_profile(torch, pkg, args) -> dict:
    """One block of the package, loaded in Python and called on ``args``
    (contiguous caches, as the host passes them), by ``torch.profiler``:
    its kernels on the card, their time and B1's count among them."""
    aot = torch._inductor.aoti_load_package(str(pkg))
    with torch.no_grad():
        return device_profile(torch, lambda: aot(*args),
                              names=("residual_unit",))


def hold_host(np, what, y, want, carry, want_carry) -> dict:
    """The host's outputs and last caches against the program's: the
    largest differences, each within ``EXPORT_TOL``."""
    err = float(np.abs(y - want).max())
    carry_err = float(np.abs(carry - want_carry).max())
    check(carry.shape == want_carry.shape,
          f"{what}: {carry.shape} cache values, the program {want_carry.shape}")
    check(max(err, carry_err) <= EXPORT_TOL,
          f"{what}: host vs program {err}, caches {carry_err}")
    return {"max_abs_err_vs_program": err, "caches_max_abs_err": carry_err}


def phase_native_convert(torch, np, run, wavs, card, device="cuda"):
    """(b) of the native phase, while phase 10(b)'s trained run exists:
    its ``convert.pt2`` served by the host over 32 blocks of 4096 of a
    speaker's clip, against the reloaded program with the same zero
    embedding.  Returns the host's numbers."""
    from rave_tpu_torch.data.audio_io import load_wav
    from rave_tpu_torch.export import native

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    host = native.build_host(device)
    build_s = time.perf_counter() - t0
    out = run / "export"
    x = load_wav(wavs[VC_SPEAKERS])[0].astype(np.float32)[
        :NATIVE_VC_BLOCKS * VC_CHUNK].reshape(NATIVE_VC_BLOCKS, VC_CHUNK)
    res, y, carry, pkg = serve_native(torch, np, out, "convert", x, host,
                                      device)
    n = n_caches(out / "convert_manifest.txt")
    caches, _ = manifest_caches(torch, np, out / "convert_manifest.txt",
                                out / "convert_cache_init.bin", n, device)
    emb = torch.zeros(256, device=device)
    prog = torch.export.load(out / "convert.pt2").module()
    want, want_carry = program_blocks(torch, np, prog, caches, x, (emb,),
                                      device)
    res.update(hold_host(np, "convert", y, want, carry, want_carry))
    x0 = torch.tensor(x[0].reshape(1, -1, 1), device=device)
    res["profile"] = package_profile(torch, pkg, (caches, x0, emb))
    res.update(host_build_s=build_s,
               phase_seconds=time.perf_counter() - t_phase)
    emit({"phase": "native", "step": "convert", "card": card,
          "config": "v2_fork (phase 9's trained run)", "chunk": VC_CHUNK,
          "chunk_ms_of_audio": VC_CHUNK / 44.1, **res})
    return res


def _refused(native, what, export_dir, prefix, host, want, device) -> str:
    """The host on a step it must refuse: it exits 1 naming ``want``;
    returns its message."""
    try:
        native.run_host(export_dir, 2, prefix, device, host=host)
    except RuntimeError as e:
        msg = str(e)
        check(msg.startswith("aoti_host exited 1:") and want in msg,
              f"{what}: {msg}")
        return msg.splitlines()[-1]
    check(False, f"{what}: the host served it")


def _export_copy(src, dst, prefix, package=True):
    """The manifests and initial caches of ``src`` under ``dst``, and its
    ``prefix`` package linked there with ``package``."""
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    for p in src.iterdir():
        if p.name.endswith(("_manifest.txt", "io_manifest.txt",
                            "cache_init.bin")):
            shutil.copy(p, dst / p.name)
    if package:
        (dst / f"{prefix}.aoti.pt2").symlink_to(
            (src / f"{prefix}.aoti.pt2").resolve())


def phase_native(torch, np, KERNELS, state, audio, pitch_dir, convert_res,
                 card, device="cuda"):
    """(a), (c) and (d) of the native phase (see the module docstring),
    then its summary line beside (b)'s numbers ``convert_res``."""
    from pathlib import Path
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.export import native
    from rave_tpu_torch.export.streaming import StreamingRAVE
    from rave_tpu_torch.models.rave import RAVE
    from rave_tpu_torch.ops.pitch import yin_f0

    t_phase = time.perf_counter()
    for k in KERNELS:
        k.launches = 0
    root = Path(SMOKE_DIR)
    host = native.build_host(device)
    # (d)'s CPU package: a tiny v2 exported on the CPU, compiled in a
    # subprocess while the card's packages compile here
    tiny = root / "native_cpu"
    tcfg = build_config(["v2"], NATIVE_CPU_TINY)
    torch.manual_seed(SEED)
    StreamingRAVE(tcfg, RAVE(tcfg, device="cpu").state_dict(),
                  chunk_size=CHUNK, device="cpu").serialize(tiny)
    cpu_compile = subprocess.Popen(
        [sys.executable, "-c", "import sys; from rave_tpu_torch.export."
         "native import compile_package; compile_package(sys.argv[1], "
         "'forward', 'cpu')", str(tiny)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        # (a) forward of full-width v2, 64 blocks of 2048
        cfg = build_config(["v2"], ["fused_kernels=true"])
        sr = StreamingRAVE(cfg, state, chunk_size=CHUNK, device=device)
        exp = root / "native_v2"
        t0 = time.perf_counter()
        sr.serialize(exp)
        serialize_s = time.perf_counter() - t0
        signal = audio[0, :NATIVE_BLOCKS * CHUNK].astype(np.float32)
        x = signal.reshape(NATIVE_BLOCKS, CHUNK)
        fwd, y, carry, fwd_pkg = serve_native(torch, np, exp, "forward", x,
                                              host, device)
        want = sr.process_file(signal).reshape(NATIVE_BLOCKS, CHUNK)
        live = np.concatenate([c.reshape(-1).cpu().numpy()
                               for c in sr.caches])
        fwd.update(hold_host(np, "forward", y, want, carry, live))
        fwd["serialize_s"] = serialize_s
        per = {"graph": [], "eager": []}
        sr.process_file_scan(signal)    # captures the chunk step
        for _ in range(3):
            for name, fn in (("graph", sr.process_file_scan),
                             ("eager", sr.process_file)):
                t0 = time.perf_counter()
                fn(signal)
                per[name].append((time.perf_counter() - t0) * 1e3
                                 / NATIVE_BLOCKS)
        fwd["same_call_python_ms_per_chunk"] = {
            "process_file_scan": statistics.median(per["graph"]),
            "process_file": statistics.median(per["eager"]), "runs": per}
        caches, _ = manifest_caches(torch, np, exp / "io_manifest.txt",
                                    exp / "cache_init.bin",
                                    len(sr.init_caches), device)
        x0 = torch.tensor(x[:1, :, None], device=device)
        fwd["profile"] = package_profile(torch, fwd_pkg, (caches, x0))
        with torch.no_grad():
            fwd["eager_step_profile"] = device_profile(
                torch, lambda: sr._forward(caches, x0))
        emit({"phase": "native", "step": "forward", "card": card,
              "config": "v2", "chunk": CHUNK,
              "chunk_ms_of_audio": CHUNK / cfg.sampling_rate * 1e3, **fwd})
        del sr

        # (c) convert_pg of the full-width pitch fork (phase 11's
        # converter) on a gliding voice, 32 blocks of 4096
        voice = glides(np, PITCH_SPEAKERS, 2 * PITCH_CLIP)[0]
        x = voice[:NATIVE_VC_BLOCKS * VC_CHUNK].reshape(NATIVE_VC_BLOCKS,
                                                        VC_CHUNK)
        f0 = yin_f0(torch.tensor(x.reshape(1, -1), device=device),
                    44100).cpu().numpy()
        pg, y, carry, pg_pkg = serve_native(torch, np, pitch_dir,
                                            "convert_pg", x, host, device)
        manifest = pitch_dir / "convert_pg_manifest.txt"
        carry0, _ = manifest_caches(torch, np, manifest,
                                    pitch_dir / "convert_pg_cache_init.bin",
                                    n_caches(manifest), device)
        emb = torch.zeros(256, device=device)
        prog = torch.export.load(pitch_dir / "convert_pg.pt2").module()
        want, want_carry = program_blocks(torch, np, prog, carry0, x, (emb,),
                                          device)
        pg.update(hold_host(np, "convert_pg", y, want, carry, want_carry))
        tail = carry0[-1].numel()
        check(np.array_equal(carry[-tail:], want_carry[-tail:])
              and np.array_equal(carry[-tail:], x[-1, -tail:]),
              "convert_pg: the host's f0 tail is not the program's")
        pg["voiced_share"] = float((f0 > 0).mean())
        check(pg["voiced_share"] > 0.5, f"convert_pg: voiced {f0}")
        x0 = torch.tensor(x[:1, :, None], device=device)
        pg["profile"] = package_profile(torch, pg_pkg, (carry0, x0, emb))
        emit({"phase": "native", "step": "convert_pg", "card": card,
              "config": "v2_fork+pitch", "chunk": VC_CHUNK,
              "chunk_ms_of_audio": VC_CHUNK / 44.1, "f0_tail_equal": True,
              **pg})

        # (d) what the host must refuse
        check(cpu_compile.wait(timeout=NATIVE_TIMEOUT) == 0,
              f"CPU package: {cpu_compile.stdout.read()[-2000:]}")
        refusals = {"cpu_package_on_cuda": _refused(
            native, "a CPU package on the card", tiny, "forward", host,
            "compiled for cpu, not for device=cuda", device)}
        _export_copy(exp, root / "native_missing", "forward", package=False)
        refusals["missing_package"] = _refused(
            native, "a missing package", root / "native_missing", "forward",
            host, "cannot open", device)
        perm = root / "native_permuted"
        _export_copy(exp, perm, "forward")
        lines = (perm / "io_manifest.txt").read_text().splitlines()
        outs = [ln for ln in lines if ln.startswith("out ")]
        (perm / "io_manifest.txt").write_text("\n".join(
            [ln for ln in lines if not ln.startswith("out ")]
            + outs[1:] + outs[:1]) + "\n")
        refusals["permuted_out_lines"] = _refused(
            native, "a permuted manifest", perm, "forward", host,
            "output 0 has shape", device)
    finally:
        if cpu_compile.poll() is None:
            cpu_compile.kill()
            cpu_compile.wait()
    emit({"phase": "native", "step": "refusals", "card": card, **refusals})

    launches = {k.name: k.launches for k in KERNELS}
    check(not any(launches.values()), f"native phase launched {launches}")
    b1 = {s: r["profile"]["named_count"]["residual_unit"]
          for s, r in (("forward", fwd), ("convert", convert_res),
                       ("convert_pg", pg))}
    check(not any(b1.values()), f"B1 in a package: {b1}")
    keys = ("compile_s", "package_mb", "loaded_s", "pipelined_rtf",
            "blocking_rtf", "block_ms_p50", "block_ms_p80",
            "max_abs_err_vs_program", "proxy_ops")
    emit({"phase": "native", "card": card, "b1_launches_per_block": 0,
          "b1_kernels_per_package_block": b1, "python_launches": launches,
          "steps": {s: {**{k: r[k] for k in keys},
                        "kernels_per_block": r["profile"]["kernel_count"],
                        "device_ms_per_block": r["profile"]["device_ms"]}
                    for s, r in (("forward", fwd), ("convert", convert_res),
                                 ("convert_pg", pg))},
          "eager_step_kernels": fwd["eager_step_profile"]["kernel_count"],
          "phase_seconds": time.perf_counter() - t_phase})


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    # the port, imported only now: a directory without it fails here
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.export.streaming import StreamingRAVE
    from rave_tpu_torch.models.rave import RAVE
    from rave_tpu_torch.ops.kernels import KERNELS, ci1_conv as ci
    from rave_tpu_torch.ops.kernels import residual_unit as ru
    from rave_tpu_torch.ops.kernels.build import build_all

    # 0. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count(),
          "capability": list(torch.cuda.get_device_capability(0))})

    # 1. build every kernel from the checkout's sources
    seconds = build_all(KERNELS)
    ptxas = [line.strip()
             for lib in dict.fromkeys(k.library_path for k in KERNELS)
             for line in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": seconds,
          "kernels": [k.name for k in KERNELS], "ptxas": ptxas})

    # shapes the paths give B1: 131072 samples = 8192 band frames per
    # item; C=128 at T=2048, 256 at 512, 512 at 256; each (C, d) once in
    # the encoder and once in the generator, per offline forward (batch
    # 4) and per v2 train step, D or G (batch 8)
    T0 = SAMPLES // 16
    per_shape = {}
    for path, B in (("offline_v2", BATCH), ("train_v2", TRAIN_BATCH)):
        for C, T, dils in ((128, T0 // 4, (1, 3, 9)),
                           (256, T0 // 16, (1, 3, 9)), (512, T0 // 32, (1, 3))):
            for d in dils:
                per_shape[(path, B, T, C, d)] = 2
    # discrete (capacity 96): only its 384-channel units pass B1's gate,
    # at T0 / 16 with dilations 1, 3, 9, once in the encoder and once in
    # the generator
    for path, B in (("offline_discrete", BATCH),
                    ("train_discrete", TRAIN_BATCH)):
        for d in (1, 3, 9):
            per_shape[(path, B, T0 // 16, 384, d)] = 2

    # 2. kernels vs plain versions on the card
    max_err, shapes = phase_kernels(torch, ru, per_shape)
    # shapes the v2_fork train step gives B2/B3: the three MelGAN heads
    # see real and fake together (B = 16) after the 1245-band-frame crop
    # per side: 131072 - 2 * 1245 * 16 = 91232 samples, halved twice
    ci1_main = [(16, 91232), (16, 45616), (16, 22808)]
    ci1_err, ci1_shapes = phase_ci1_kernels(torch, ci, ci1_main)

    # 3. offline serving at full v2 width
    torch.manual_seed(SEED)
    cfg = build_config(["v2"], ["fused_kernels=true"])
    model = RAVE(cfg, device="cuda").eval()
    plain = RAVE(build_config(["v2"], ["fused_kernels=false"]),
                 device="cuda").eval()
    plain.load_state_dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(SEED)
    t = np.arange(SAMPLES) / cfg.sampling_rate
    audio = np.stack([0.3 * np.sin(2 * np.pi * f * t)
                      + 0.05 * rng.standard_normal(SAMPLES)
                      for f in (110.0, 220.0, 440.0, 880.0)])
    x = torch.tensor(audio[:, :, None], dtype=torch.float32, device="cuda")

    with torch.inference_mode():
        for k in KERNELS:
            k.launches = 0
        y = model(x)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in KERNELS}
        check(launches["residual_unit"] == 16,
              f"B1 launches per forward: {launches['residual_unit']} != 16")
        check(tuple(y.shape) == tuple(x.shape), f"output shape {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), "offline output not finite")
        y_plain = plain(x)
        plain_err = (y - y_plain).abs().max().item()
        check(plain_err <= OFFLINE_TOL, f"fused vs plain: {plain_err}")

        cpu = RAVE(cfg, device="cpu").eval()
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        xs = x[:1, :8192]
        cpu_err = (model(xs).cpu() - cpu(xs.cpu())).abs().max().item()
        check(cpu_err <= CPU_TOL, f"card vs cpu on 8192 samples: {cpu_err}")

        torch.cuda.reset_peak_memory_stats()
        times, times_plain = [], []
        for _ in range(10):
            times.append(cuda_ms(torch, lambda: model(x), iters=1, warmup=0))
            times_plain.append(cuda_ms(torch, lambda: plain(x), iters=1,
                                       warmup=0))
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    audio_s = BATCH * SAMPLES / cfg.sampling_rate
    batch_ms = statistics.median(times)
    plain_batch_ms = statistics.median(times_plain)
    emit({"phase": "offline", "config": "v2", "params": n_params,
          "batch": [BATCH, SAMPLES, 1], "launches": launches,
          "max_abs_err_vs_plain": plain_err, "max_abs_err_vs_cpu": cpu_err,
          "batch_ms": batch_ms, "rtf": batch_ms / 1e3 / audio_s,
          "plain_batch_ms": plain_batch_ms,
          "plain_rtf": plain_batch_ms / 1e3 / audio_s,
          "peak_mem_mb": peak_mb})

    # 4. chunked streaming of request 0
    streamer = StreamingRAVE(cfg, model.state_dict(), chunk_size=CHUNK,
                             device="cuda")
    signal = audio[0].astype(np.float32)
    streamer.process_file(signal[:8 * CHUNK])  # warm-up
    streamer.reset()
    for k in KERNELS:
        k.launches = 0
    chunk_ms, outs = [], []
    for i in range(0, SAMPLES, CHUNK):
        t0 = time.perf_counter()
        out = streamer.forward(signal[i:i + CHUNK].reshape(1, -1, 1))
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out[0, :, 0])
    stream_launches = {k.name: k.launches for k in KERNELS}
    y_str = torch.cat(outs).cpu().numpy()
    d = streamer.total_delay_samples()
    a = y[0, :, 0].cpu().numpy()
    check(d < SAMPLES // 2, f"delay {d} >= half the signal")
    m = 2 * d + 256
    a_cmp, b_cmp = a[m - d: SAMPLES - d - 256], y_str[m: SAMPLES - 256]
    rel = float(np.median(np.abs(a_cmp - b_cmp)) / (np.abs(a_cmp).mean() + 1e-9))
    check(bool(np.isfinite(y_str).all()), "streamed output not finite")
    check(rel < 0.02, f"stream vs offline median rel err {rel}")
    med = statistics.median(chunk_ms)
    emit({"phase": "streaming", "chunk": CHUNK, "chunks": len(chunk_ms),
          "delay_samples": d, "median_rel_err": rel,
          "launches": stream_launches, "chunk_ms_median": med,
          "chunk_ms_p80": float(np.percentile(chunk_ms, 80)),
          "chunk_ms_max": max(chunk_ms),
          "rtf": med / 1e3 / (CHUNK / cfg.sampling_rate)})

    # 5. where the time goes on the card (torch.profiler)
    def stream_chunks(n=16):
        for i in range(0, n * CHUNK, CHUNK):
            streamer.forward(signal[i:i + CHUNK].reshape(1, -1, 1))

    with torch.inference_mode():
        prof_offline = device_profile(torch, lambda: model(x),
                                      names=("residual_unit_kernel",))
    prof_offline["share"] = {n: ms / prof_offline["device_ms"]
                             for n, ms in prof_offline["named_ms"].items()}
    streamer.reset()
    prof_stream = device_profile(torch, stream_chunks)
    emit({"phase": "profile", "offline_batch": prof_offline,
          "streaming_16_chunks": prof_stream})

    # 6. the v2_fork train step
    g_launches = phase_train(torch, np, KERNELS)

    # 7. the upstream v2 train step, kernel B1 inside it
    v2_launches = phase_train_v2(torch, np, KERNELS)

    # 8. voice-conversion serving of the fork, kernel B1 in convert
    vc_launches = phase_voice_conversion(torch, np, KERNELS)

    # 9. from-scratch speaker training: the step in both norms, the CLI
    vc_launches_d, vc_launches_g = phase_train_vc_step(torch, np, KERNELS,
                                                       "cohort")
    phase_train_vc_step(torch, np, KERNELS, "batch")
    run, db, wavs = phase_train_vc_cli(torch, np)
    train_vc_launches = {"D": vc_launches_d, "G": vc_launches_g}

    # 10. export: the v2 stream's CUDA graph, programs, host rate, stereo,
    # latent PCA and realtime host; then the trained run's export and eval
    phase_export_stream(torch, np, KERNELS, model.state_dict(), audio,
                        model, x, smi)
    phase_export_run(torch, np, run, db, wavs, smi)
    # 13(b). the trained run's convert.pt2 served by the C++ host
    native_convert = phase_native_convert(torch, np, run, wavs, smi)
    shutil.rmtree(SMOKE_DIR)

    # 11. the f0-conditioned fork: convert, FCPE, train, stream, probe
    pitch_convert, pitch_train, pitch_dir = phase_pitch(torch, np, KERNELS)

    # 12. the discrete and v3 presets, kernel B1 at C = 384
    dv3 = phase_discrete_v3(torch, np, KERNELS, smi)

    # 13. native: forward, convert_pg and the refusals of the C++ host
    phase_native(torch, np, KERNELS, model.state_dict(), audio, pitch_dir,
                 native_convert, smi)
    shutil.rmtree(SMOKE_DIR)

    # 14. summary
    def total(key, path="offline_v2"):
        return sum(s[key] * s["launches_per_call"] for s in shapes
                   if s["path"] == path)

    src = "rave_tpu_torch/csrc/residual_unit.cu"
    kernels = [{
        "name": "residual_unit", "route": "cuda", "source": src, "src": src,
        "replaces": "rave_tpu/ops/pallas/residual_unit.py:62",
        "checked": True, "launches": launches["residual_unit"],
        "max_abs_err": max_err, "ms": total("ms"),
        "plain_ms": total("plain_ms"), "device_ms": total("device_ms"),
        "plain_device_ms": total("plain_device_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": ("operations" if total("ops_ms") >= total("bytes_ms")
                     else "bytes"),
        "bound_ms_f32": total("bound_ms_f32"), "library_ms": None,
        "launches_v2_train_step": v2_launches,
        "launches_vc_convert": vc_launches,
        "launches_train_vc_step": {k: v["residual_unit"]
                                   for k, v in train_vc_launches.items()},
        "launches_pitch_convert": pitch_convert,
        "launches_pitch_train_step": {k: v["residual_unit"]
                                      for k, v in pitch_train.items()},
        "launches_discrete_forward": dv3["discrete_forward"][
            "residual_unit"],
        "launches_discrete_train_step": {
            k: v["residual_unit"]
            for k, v in dv3["discrete_train_step"].items()},
        "launches_v3_forward": dv3["v3_forward"]["residual_unit"],
        "launches_v3_train_step": {k: v["residual_unit"] for k, v in
                                   dv3["v3_train_step"].items()},
        **{path: {k: total(k, path) for k in (
            "ms", "plain_ms", "device_ms", "plain_device_ms", "bound_ms",
            "bound_ms_f32")}
           for path in ("train_v2", "offline_discrete", "train_discrete")}}]
    # B2/B3: one launch per head and G step; the plain twin is one
    # PyTorch call (F.conv1d, conv1d_input), so it is the library time
    for name, key, line, launches in (
            ("ci1_conv_forward", "fwd", 46, g_launches["ci1_conv_forward"]),
            ("ci1_conv_dx", "dx", 73, g_launches["ci1_conv_dx"])):
        per = lambda f: sum(s[key][f] for s in ci1_shapes)  # noqa: E731
        src = "rave_tpu_torch/csrc/ci1_conv.cu"
        kernels.append({
            "name": name, "route": "cuda", "source": src, "src": src,
            "replaces": f"rave_tpu/ops/pallas/ci1_conv.py:{line}",
            "checked": True, "launches": launches,
            "max_abs_err": ci1_err[key], "ms": per("ms"),
            "plain_ms": per("plain_ms"), "device_ms": per("device_ms"),
            "plain_device_ms": per("plain_device_ms"),
            "bound_ms": per("bound_ms"),
            "bound_by": ("operations" if per("ops_ms") >= per("bytes_ms")
                         else "bytes"),
            "launches_train_vc_step": {k: v[name] for k, v in
                                       train_vc_launches.items()},
            "launches_pitch_convert": 0,
            "launches_pitch_train_step": {k: v[name] for k, v in
                                          pitch_train.items()},
            "launches_discrete_forward": dv3["discrete_forward"][name],
            "launches_discrete_train_step": {
                k: v[name] for k, v in dv3["discrete_train_step"].items()},
            "launches_v3_forward": dv3["v3_forward"][name],
            "launches_v3_train_step": {k: v[name] for k, v in
                                       dv3["v3_train_step"].items()},
            "library_ms": per("plain_ms")})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
