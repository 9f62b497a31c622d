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
   and SPK only on G steps), two timed cycles, then a D, G pair at
   2 x 65536 against the CPU (one thread): losses and ENC/DEC/SPK
   gradient norms rtol 1e-3.  The same for a ``speaker_norm=batch``
   copy, whose running statistics advance on every step and equal the
   CPU's after the D and the G step (rtol 1e-4).  A profile of one G
   step and the speaker encoder's share of it.  (b) ``python -m
   rave_tpu_torch.cli`` preprocess, perturb (2 variants), units and
   train (the plain one-card command; 12 steps,
   ``phase_1_duration=4``, validation and checkpoints
   at step 8, two loader workers, ``--profile``) on 8 speakers x 4 clips
   of 131072 samples written under ``_smoke/``: the speaker CE,
   validation and conversion metrics logged, the last and best
   checkpoints written, the last one restoring bit for bit on the card;
   then ``--resume`` to step 16 under ``torch.distributed.run`` with
   ``--multihost`` (phase 16(b)).  Steps per second and the loader's
   share from the section times.
10. export: the serving surface of a trained run.  (a) The offline
   phase's v2 weights in a ``StreamingRAVE`` of 2048-sample chunks, batch
   1: ``process_file_scan`` (the chunk step captured once in a CUDA
   graph, replayed per chunk) against ``process_file`` over 64 chunks
   (max abs difference <= 2e-4; ms per chunk of each, median of 3 runs;
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
   32 points from 8 speakers.
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
   at 2 x 65536 card vs CPU (one thread): losses and ENC/DEC gradient
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
   finite), two timed cycles, the codebooks finite; a D, G pair at
   2 x 65536 from zero codebooks, card vs CPU (one thread, the same
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
   8 x 131072, two timed cycles, a profile of one G step and the
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
   Python call of the phase.  It runs after phase 15, so that its
   packages have compiled; ``_smoke/`` is removed after it.

14. a6: ``v1`` / ``onnx`` / ``raspberry``, the noise generators, the
   Wasserstein and spherical heads, each at its full width (random
   weights from seed 0), every random draw injected (seeded on the CPU,
   the same on the card and the CPU).  (a) ``v2`` + ``noise`` +
   ``wasserstein`` with ``fused_kernels=true``: the offline forward of
   4 x 131072 (B1 exactly 16 launches), fused vs plain and card vs CPU
   on 8192 samples (2e-4), the median of 10 batches (the plain copy in
   turns), a profile (B1's and the FFTs' shares); ``encode`` (the raw
   latent) then ``decode`` (the augmentation re-sampled); request 0
   streamed in 2048-sample chunks with zero draws against the offline
   forward with zero draws (median relative error < 0.02, no B1),
   chunk median and p80, the seeded stream finite and the same after
   ``reset``; D, G, G, G at 8 x 131072 (B1 16 per step, the MMD
   finite), timed cycles, a profile of one G step; a D, G pair at 2 x
   65536 card vs CPU (one thread, ``learning_rate=1e-6``,
   ``log_epsilon=1e-3``): losses and ENC/DEC/DIS gradient norms rtol
   1e-3.  (b) ``v1`` (capacity 64, noise on),
   ``onnx`` and ``raspberry``: offline and streamed as in (a), no B1;
   for ``v1`` also ``serialize`` (the reloaded ``forward.pt2`` against
   the live step over 8 chunks, 2e-4), D, G, D, G at 8 x 131072
   (EncoderV1's running statistics seen to move) and the pair with the
   running statistics rtol 1e-4.  (c) ``v2`` + ``spherical``: offline
   (B1 16), the angles' round trip and card vs CPU (1e-4), a stream
   encoded, turned into angles and back, and decoded.  (d) the
   full-width ``v3`` stream with AdaIN states that hold statistics
   (learning off, so every block transfers), its ``forward`` compiled
   into an AOTInductor package (by a subprocess at ``nice 19`` started
   before phase 6, so that the compile overlaps the train phases) and
   served by the C++ host over 32 blocks of 2048: every block and the
   last caches (the AdaIN states after the conv caches) against
   ``StreamingRAVE.forward`` (2e-4), p50/p80 block time.
15. hybrid: the ``hybrid`` preset (the log1p mel front end, 2048/128/128,
   feeding an encoder of ratios 2, 2, 2; two GRU layers on the decoder's
   latent) at full width with ``fused_kernels=true``, random weights
   from seed 0.  (a) The offline forward of 4 x 131072 (B1 exactly 10
   launches: 2 in the encoder, 8 in the decoder), finite and shaped like
   the input, fused vs plain and card vs CPU on 8192 samples (2e-4), the
   median of 10 batches (the plain copy in turns), a profile (B1's, the
   FFTs' and cuDNN's RNN kernels' shares) and the mel front end's and
   the decoder GRU's time alone (profiler and CUDA events).  (b)
   Request 0 in 2048-sample chunks (no B1) against the offline forward
   shifted by the delay past ``tests/test_streaming.py``'s hybrid margin
   (median relative error < 0.02), chunk median and p80,
   ``process_file_scan`` against ``process_file`` (2e-4) and ms per
   chunk of each.  (c) D, G, G, G at 8 x 131072 from ``phase_1_duration``
   (B1 10 per step), timed cycles, peak memory, a profile of one G
   step; a D, G pair at 2 x 65536 card vs CPU (one thread,
   ``learning_rate=1e-6``, ``log_epsilon=1e-3``): losses and ENC, DEC,
   GRU and DIS gradient norms rtol 1e-3.  (d) The stream's
   ``serialize`` (before phase 6): the reloaded ``forward.pt2`` against
   the live step over 8 chunks (2e-4); its ``forward`` package, compiled
   by phase 14's ``nice 19`` subprocess after ``v3``'s, served by the C++
   host over 32 blocks of 2048: every block and the last caches (the mel
   context and the GRU states among them) against
   ``StreamingRAVE.forward`` (2e-4), p50/p80 block time.  (e) The ported
   distances of 4 x 65536 voices on the card against the CPU (1e-4
   relative): the mel ``audio_distance_v1``, ``spectral_distance`` with
   mels, ``encodec_audio_distance`` and the weighted instantaneous-
   frequency distance.
16. parallel: data parallelism and time sharding (ROADMAP A12).  (a) Two
   ranks of this script (``--parallel-rank``), gloo named explicitly
   (NCCL refuses two ranks on one card), each the full-width
   from-scratch ``v2_fork`` of phase 9(a) (cohort norm, ``learning_rate``
   and ``speaker_learning_rate`` 1e-6, ``log_epsilon`` 1e-3) on its 4 of
   8 rows of 131072, a D then a G step from ``phase_1_duration``: B1,
   B2, B3 launched 16, 3, 0 times on each rank's D step and 16, 3, 3 on
   its G step; the ranks bit-equal (metrics, gradient norms, the state's
   CRC-32); against one process on the 8 rows, the losses and the ENC,
   DEC, SPK and DIS gradient norms rtol 1e-3, Adam's first moment of
   every parameter (the averaged gradient, element by element) within
   rtol 1e-3 of itself plus 1e-3 of its group's largest, every parameter
   and buffer within 2 lr plus rtol 1e-3, 99.9 % of the discriminator's update
   within 1 % of the rate; each rank's D and G step times over two timed
   cycles and the gradient all-reduce's time and share of them.  (b)
   The real entry point on NCCL: phase 9(b)'s resume command, run
   through ``python -m torch.distributed.run --standalone
   --nproc_per_node=1 ... train --multihost`` (one rank on the card): it
   restores the plain run's checkpoint, trains to step 16 with
   validation, and writes its checkpoint.  (c) The
   full-width ``v2`` forward (the offline phase's weights) of one
   524288-sample request time-sharded over the two ranks
   (``parallel/time_shard.py``), the halo the forward's receptive field
   measured on the card (``utils/receptive_field.py``) rounded up to
   whole hops: B1 16 per rank, the interior (a halo from each end)
   within 2e-4 of the one-process offline forward.

17. bf16: ``compute_dtype=bfloat16`` serving (ROADMAP A10a) and kernel
   B1's bf16 instance.  (a) B1-bf16 (TMA ring, ``wgmma`` m64n64k16 on
   bf16, float32 accumulation, two roundings) over C in {128, 256, 384,
   512}, k in {1, 3, 5}, dilations 1, 3, 9, T in {1, 333}, B in {1, 2}
   and d = 1000 (its launch the same as at d = 1: a wide dilation costs
   no shared memory): within 2 bf16 ulps of max |y| of its plain twin
   (which rounds after each GEMM, bias and add, as the JAX package's
   reference does), and nearer than the twin to float32 arithmetic on
   the same bf16 operands with the Pallas kernel's two roundings (summed
   over the grid; at each shape of the bf16 paths: the v2 forward's (4,
   2048, 128), (4, 512, 256), (4, 256, 512), phase 18's B = 8 ones and
   discrete's (4, 512, 384)); there the launch geometry (64 x 64 tiles,
   clusters of C / 64 CTAs of 288 threads), call times and device times
   (CUDA events around a CUDA graph of 20 raw launches, and the
   profiler's where it records one) beside the twin's, with the bounds
   (989 TFLOP/s of dense bf16, 3.35 TB/s) and the sums per bf16 forward
   and per bf16 train step.
   (b) The full-width ``v2`` batch (phase 3's weights,
   ``fused_kernels=true``) in bf16: 16 B1-bf16 launches (counted, and
   by ``torch.profiler``), no float32 B1, finite float32 audio between
   1e-3 and 0.02 relative L2 of the float32 batch (not float32, not
   wrong); CUDA-event medians of 10
   batches and device times of both, in turns.  (c) Its stream in
   2048-sample chunks over 32 chunks: bf16 and float32 caches, no B1,
   ``process_file_scan`` equal to the eager chunks (2e-4), the offline
   bf16 forward past the delay (median relative error < 0.01), chunk
   median and p80.  (d) ``v2_fork`` ``RAVE.convert`` of 4 x 131072 in
   bf16: 16 B1-bf16 launches, within 1e-3 to 0.02 of float32, times of
   both; the
   bf16 ``VoiceConverter`` over 8 chunks of 4096 (no B1, finite).  (e)
   The bf16 stream's ``serialize`` (before phase 6; bf16 caches in the
   manifest), its ``forward`` package compiled in phase 13's niced
   subprocess, served by the C++ host over 32 blocks: within 0.02
   relative L2 of the Python stream of the same chunks, p50/p80 block
   time.
18. bf16_train: ``compute_dtype=bfloat16`` training (ROADMAP A10b) and
   the bf16 instances of kernels B2 and B3.  (a) B2-bf16 and B3-bf16
   over phase 2's grid (odd T, unaligned windows, k up to 16, co up to
   64, T = 1), B3-bf16's cp.async staging on aligned T (g a view at
   storage offsets 1-7) and its TMA staging at co 1, 24, 64, k 2, 16 and
   every window shift of k = 16: within 1 bf16 ulp of max |y| of float32 arithmetic on the same bf16
   operands rounded once (the Pallas kernels' contract), the cuDNN bf16
   twin's distance from it beside; dx and dw through the
   ``autograd.Function`` against autograd of the twin (2 ulps); a launch
   that is its host thread's first CUDA call equal to the main thread's;
   at the three main-path shapes B3-bf16's geometry (a persistent grid
   of two CTAs per SM, TMA staging), 64 raw launches bit-equal to the
   first and to the wrapper's, call times, and device times by CUDA
   events around CUDA graphs of raw launches, cold (over copies of the
   operands, >= 100 MB between two reads of one copy) and warm, the
   profiler's beside them, cuDNN's (cold) and, for B3, its cp.async
   staging on the same work (g at storage offset 1) and a PyTorch sum of
   g over its channels (the card's read rate), and the byte bound.
   (b) B1-bf16's backward at the three B = 8 step shapes: the gradients
   of all five operands through the kernel's
   ``autograd.Function`` against autograd of the plain bf16 composition
   on the card, within 2 ulps of each gradient's max |g| (cuDNN's bf16
   weight gradients may sum in another order per call).  The backward
   is autograd of that composition, so this holds its wiring on the
   card; ``tests/test_torch_residual_unit.py`` holds its arithmetic
   against the JAX package's bf16 VJP.  (c) The
   full-width bf16 ``v2_fork`` (``fused_kernels=true``, frozen speaker
   encoder) at 8 x 131072 from ``phase_1_duration``: D, G, G, G with
   B1-bf16 16, B2-bf16 3 and B3-bf16 3 (0 on D) launches per step and
   no float32 instance, finite metrics, DIS moving on D, ENC and DEC on
   G, the speaker encoder never, the parameters float32; a timed bf16
   cycle and a float32 one of the same weights in turns (D and G ms,
   peak memory); one bf16 G step at 2 x 65536 card vs CPU, losses and
   ENC/DEC gradient norms rtol 1.3e-2, which the float32 step of the
   same weights on the card must miss.  (d) The full-width bf16 ``v2``:
   one D and one G step, B1-bf16 16 launches each, B2/B3 none.  (e) Run
   beside 9(b)'s resume and 10(a), on phase 9(b)'s db: ``python -m
   rave_tpu_torch.cli train`` on the bf16 ``v2_fork`` for 4 steps
   (``phase_1_duration=2``, a validation at step 3); its checkpoint
   holds float32 tensors only and ``load_run`` restores it into float32
   parameters.  (f) One bf16 D and one bf16 G step of every other preset
   the JAX package trains in bf16 (``v1``, ``onnx``, ``raspberry``,
   ``v2`` + ``noise`` + ``wasserstein``, ``v2`` + ``spherical`` +
   ``causal``, ``v3``, ``discrete``, ``discrete_v3``, ``v2_fork`` +
   ``pitch``, the from-scratch ``v2_fork``) at its own width, 65536
   samples: finite metrics, each group moving on its own step only, the
   parameters float32, every discriminator conv reading bf16; the
   launches recorded.

``python3 chip_smoke.py --parallel-cards N`` runs (a) and (c) alone
with N NCCL ranks, one per card of one host, against one
process on card 0, and ends with the same last two lines.

``python3 chip_smoke.py --b1-bf16-ab DIR`` (``--b3-bf16-ab DIR``) runs
phase 17(a) (18(a)) alone with the kernel also built from
``DIR/rave_tpu_torch/csrc/`` (an unpacked earlier commit) and timed in
turns with this checkout's, parent, new, new, parent; it fails unless
the new kernel's slower run beats the parent's faster run: per call of
each path for B1-bf16, at each main-path shape and per G step (cold) for
B3-bf16.  ``--b3-bf16-ab`` also holds the parent's float32 B3 bit-equal
to this checkout's.

Phase 13's four packages compile in ``nice 19`` subprocesses started
after phase 5 (the v2 ``forward``, then phase 17's bf16 one; the two
streams are serialized there too, from weights saved under
``rave_tpu_torch/_build/``, as are phase 14's ``v3`` and phase 15's
hybrid stream in the third), after phase 10(b) (the trained run's
``convert``, its export copied under ``rave_tpu_torch/_build/``) and
after phase 11 (``convert_pg`` and (d)'s CPU package).

Commands run beside the phases, so that the whole run stays well inside
its time limit: the C++ host's ``g++`` beside ``nvcc`` (phase 1); 9(b)'s
preprocess, perturb and units at nice 10 from phase 6 on, its 12 steps
beside 9(a), its resume and 18(e)'s bf16 command beside 10(a); 10(b)'s
export and eval beside phase 11; 11(b)'s commands at nice 10 beside
11(b)-(e).  Each phase line lists in ``beside`` the commands still
running when it was printed: its times share the card and the CPU with
them.

Before the last line it prints the ``nvidia-smi`` line and one JSON
object ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout that holds ``rave_tpu_torch``, it exits non-zero with no result.
"""

from __future__ import annotations

import itertools
import json
import math
import shutil
import statistics
import subprocess
import sys
import time

SEED = 0
BATCH, SAMPLES, CHUNK = 4, 131072, 2048
TRAIN_BATCH = 8
# timed D, G, G, G cycles of each train phase, and timed passes of the
# file path: 3 and 5 before phase 14 existed, 2 and 3 before phase 17,
# cut so that the whole run stays well inside its time limit (their
# checks run as before)
TIMED_CYCLES = 1
FILE_RUNS = 1
# rows of each D, G pair (or G step) held card vs CPU at 65536 samples:
# 4 before phase 18 existed, cut so that the whole run stays inside its
# time limit (each of these paths also runs at full width on the card in
# its phase)
PAIR_BATCH = 2
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
# the bf16 instances of B2/B3, launched only by a bf16 train step
NO_CI1_BF16 = {"ci1_conv_forward_bf16": 0, "ci1_conv_dx_bf16": 0}
# shapes the v2_fork train step gives B2/B3: the three MelGAN heads see
# real and fake together (B = 16) after the 1245-band-frame crop per
# side: 131072 - 2 * 1245 * 16 = 91232 samples, halved twice
CI1_MAIN = [(16, 91232), (16, 45616), (16, 22808)]
# and each rank of phase 16's data-parallel step (4 rows of real and
# fake); timed in phase 2 beside the main shapes, not summed with them
CI1_DP = [(8, 91232), (8, 45616), (8, 22808)]


T_START = time.perf_counter()
LAST_LINE = [T_START]    # when the last phase line was printed


def emit(obj) -> None:
    """One JSON line; a phase's lines carry the seconds since the script
    started (``t_s``) and the commands (:class:`Job`) that ran at some
    time since the previous phase line (``beside``): the times the line
    reports shared the card and the CPU with them."""
    if "phase" in obj:
        now = time.perf_counter()
        beside = [j.what for j in JOBS
                  if j.t_end is None or j.t_end > LAST_LINE[0]]
        LAST_LINE[0] = now
        obj = {**obj, "t_s": now - T_START,
               **({"beside": beside} if beside else {})}
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


class Job:
    """A subprocess started now and read later, while this process goes
    on with other work: its output goes to temporary files (a pipe left
    unread would stall it), ``main`` kills it and the processes it
    started (its session) if it is still running at the end, and
    ``result`` waits for it, fails the run on a non-zero
    exit and returns its stdout and the seconds from its start to its
    exit.  ``nice`` lowers its priority (CPU work beside this process's
    steps)."""

    def __init__(self, args, what: str, timeout: float = 600, nice=0):
        import tempfile
        import threading
        self.what, self.timeout = what, timeout
        self.out = tempfile.TemporaryFile("w+")
        self.err = tempfile.TemporaryFile("w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [*(["nice", "-n", str(nice)] if nice else []), *args],
            stdout=self.out, stderr=self.err, text=True,
            start_new_session=True)
        JOBS.append(self)
        self.seconds = self.t_end = None
        self.watch = threading.Thread(target=self._wait, daemon=True)
        self.watch.start()

    def _wait(self):
        try:
            self.proc.wait(timeout=self.timeout)
        except subprocess.TimeoutExpired:
            self.stop()
            self.proc.wait()
        self.t_end = time.perf_counter()
        self.seconds = self.t_end - self.t0

    def stop(self):
        import os
        import signal
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass

    def result(self):
        self.watch.join()
        self.out.seek(0)
        self.err.seek(0)
        out, err = self.out.read(), self.err.read()
        check(self.proc.returncode == 0, f"{self.what} exited "
              f"{self.proc.returncode}: {out[-1000:]} {err[-2000:]}")
        return out, self.seconds


class Later:
    """``fn(*args)`` in a thread from now on; ``result`` joins it and
    returns its value or raises its exception; ``seconds`` is the time
    ``fn`` took."""

    def __init__(self, fn, *args):
        import threading
        self.value, self.error, self.seconds = None, None, None
        self.thread = threading.Thread(target=self._run, args=(fn, args),
                                       daemon=True)
        self.thread.start()

    def _run(self, fn, args):
        t0 = time.perf_counter()
        try:
            self.value = fn(*args)
        except BaseException as e:  # noqa: BLE001 - re-raised in result
            self.error = e
        self.seconds = time.perf_counter() - t0

    def result(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.value


def cli_job(*args, what=None, timeout=600, launcher=(), nice=0) -> Job:
    """``python -m rave_tpu_torch.cli *args`` as a :class:`Job`."""
    return Job([sys.executable, *launcher, "-m", "rave_tpu_torch.cli",
                *args], what or f"cli {args[0]}", timeout, nice)


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
        # one CTA per batch row, 64-step time tile and 64 channels; the
        # C / 64 CTAs of a time tile in one cluster
        check(info["ctas"] == B * -(-T // 64) * (C // 64)
              and info["cluster"] == C // 64,
              f"B1 {(B, T, C)}: {info['ctas']} CTAs, cluster "
              f"{info['cluster']}")
        # the v2 and discrete paths fill the card's 132 SMs; the hybrid
        # encoder's units at batch 4 are 64 CTAs, half of them
        check(info["ctas"] >= 128 or path == "offline_hybrid",
              f"B1 {(B, T, C)}: {info['ctas']} CTAs")
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


def phase_ci1_kernels(torch, ci, main_shapes, dp_shapes=()):
    """Kernels B2 (forward) and B3 (data gradient) vs their plain twins
    on a grid, gradients through the autograd.Function, then times at
    the main path's shapes (``path`` "main") and at a data-parallel
    rank's (``path`` "dp")."""
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
    for (B, T), path in ([(s, "main") for s in main_shapes]
                         + [(s, "dp") for s in dp_shapes]):
        x, w, gy = ci1_inputs(torch, B, T, 15, seed=T)
        row = {"shape": [B, T, 16], "k": 15, "pad": [7, 7], "path": path,
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


def train_batch(torch, np, B, T, frames, seed=SEED, device="cuda"):
    """Audio (B, T, 1): sines at seeded pitches plus noise; unit ids
    (B, frames) in [0, 100)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 44100
    audio = np.stack([0.3 * np.sin(2 * np.pi * f * t)
                      + 0.05 * rng.standard_normal(T)
                      for f in rng.uniform(80, 800, B)])
    units = rng.integers(0, 100, (B, frames))
    return {"x": torch.tensor(audio[:, :, None], dtype=torch.float32,
                              device=device),
            "units": torch.tensor(units, device=device)}


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
                             "ci1_conv_dx": 0, "residual_unit_bf16": 0,
                             **NO_CI1_BF16},
                       "G": {"residual_unit": 0, "ci1_conv_forward": 3,
                             "ci1_conv_dx": 3, "residual_unit_bf16": 0,
                             **NO_CI1_BF16}}

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
    for _ in range(TIMED_CYCLES * 4):
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
    expect = {"residual_unit": 16, "ci1_conv_forward": 0, "ci1_conv_dx": 0,
              "residual_unit_bf16": 0, **NO_CI1_BF16}

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
    for _ in range(TIMED_CYCLES):
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
                           "ci1_conv_dx": 0, "residual_unit_bf16": 0,
                           **NO_CI1_BF16},
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
                "ci1_conv_dx": 3 if kind == "G" else 0,
                "residual_unit_bf16": 0, **NO_CI1_BF16}
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
    for _ in range(TIMED_CYCLES * 4):
        kind = kind_of(state)
        times[kind].append(cuda_ms(torch, lambda: step_fn(state, batch),
                                   iters=1, warmup=0))
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    d_ms, g_ms = statistics.median(times["D"]), statistics.median(times["G"])
    audio_s = TRAIN_BATCH * cfg.n_signal / cfg.sampling_rate

    # a short D, G pair on the card and on the CPU (one thread: PyTorch's
    # threaded oneDNN conv1d data gradient is wrong at some strided
    # shapes); PAIR_BATCH items, as many speakers, so that the cohort
    # norm sees a cohort
    short = build_config(["v2_fork"], over + ["n_signal=65536",
                                              f"batch_size={PAIR_BATCH}"])
    torch.manual_seed(SEED + 1)
    card = loop.TrainState(short, device=device, step=short.phase_1_duration)
    cpu = loop.TrainState(short, device="cpu", step=short.phase_1_duration)
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               card.model.state_dict().items()})
    cpu.disc.load_state_dict({k: v.cpu() for k, v in
                              card.disc.state_dict().items()})
    sb = vc_batch(torch, np, PAIR_BATCH, short.n_signal, 74, device,
                  seed=SEED + 2)
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


def train_vc_db(np) -> Later:
    """(b) of phase 9, its data, started before phase 6: 8 synthetic
    speakers x 4 clips of 131072 written under ``_smoke/``, then ``python
    -m rave_tpu_torch.cli`` preprocess, perturb (2 variants) and units in
    turn, at nice 10 in a thread while the train phases run.  Its result:
    the db and each command's seconds."""
    from pathlib import Path
    from rave_tpu_torch.data.audio_io import save_wav

    root = Path(SMOKE_DIR)
    shutil.rmtree(root, ignore_errors=True)
    clips = voices(np, 8, 4 * SAMPLES, seed=SEED + 3)
    for s in range(8):
        d = root / "audio" / f"spk{s}"
        d.mkdir(parents=True)
        for k in range(4):
            save_wav(str(d / f"{k}.wav"), clips[s, k * SAMPLES:
                                                (k + 1) * SAMPLES], 44100)
    db = str(root / "db")

    def commands():
        seconds = {}
        _, seconds["preprocess"] = cli_job(
            "preprocess", "--input_path", str(root / "audio"),
            "--output_path", db, "--num_workers", "4", nice=10).result()
        _, seconds["perturb"] = cli_job(
            "perturb", "--db_path", db, "--variants", "2", "--num_workers",
            "8", nice=10).result()
        _, seconds["units"] = cli_job("units", "--db_path", db,
                                      nice=10).result()
        return db, seconds

    return Later(commands)


def train_vc_cli_job(data, device="cuda") -> dict:
    """(b) of phase 9, its 12 steps, started once the db of
    :func:`train_vc_db` (``data``) is made, beside (a): ``python -m
    rave_tpu_torch.cli train`` as a one-card user starts it, 4 steps in
    phase 1, validation and checkpoints at step 8, two loader workers,
    ``--profile``."""
    from pathlib import Path
    db, seconds = data.result()
    runs = str(Path(SMOKE_DIR) / "runs")
    over = ["fused_kernels=true", "train_speaker_encoder=true",
            "speaker_classes=8", "phase_1_duration=4"]
    train = ["train", "--config", "v2_fork",
             *[a for o in over for a in ("--override", o)],
             "--db_path", db, "--out_path", runs, "--val_every", "8",
             "--ckpt_every", "8", "--num_workers", "2", "--profile",
             "--device", device]
    return {"db": db, "runs": runs, "seconds": seconds, "over": over,
            "train": train, "t0": time.perf_counter(),
            "job": cli_job(*train, "--max_steps", "12")}


def phase_train_vc_cli(torch, np, started, device="cuda"):
    """(b) of phase 9: the command of :func:`train_vc_cli_job`
    (``started``) finished its 12 steps, then ``--resume``; the
    checkpoint restores bit for bit.  The resume runs through the
    data-parallel entry point on NCCL (phase 16(b)): ``python -m
    torch.distributed.run --standalone --nproc_per_node=1 -m
    rave_tpu_torch.cli train --multihost``, one rank on the card, whose
    step, logging, validation and checkpoints are a single process's.
    The resume runs in the background: returns the run directory, the
    db, the first clip of each speaker (phase 10 exports the run;
    ``main`` removes ``_smoke/`` after phase 13) and a function that
    waits for the resume, checks it and returns the torchrun command's
    numbers."""
    from pathlib import Path
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.train import checkpoint, loop

    t_phase = started["t0"]
    root = Path(SMOKE_DIR)
    db, runs, seconds = started["db"], started["runs"], started["seconds"]
    over, train = started["over"], started["train"]

    # one rank under torchrun: NCCL on the card, gloo on the CPU
    torchrun = ["-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node=1"]
    rank_line = ("rank 0 of 1 on cuda:0 (nccl)" if device == "cuda"
                 else "rank 0 of 1 on cpu (gloo)")
    out, seconds["train"] = started["job"].result()
    check("finished at step 12" in out and "rank 0 of" not in out,
          f"train did not finish: {out[-2000:]}")
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
    resume = cli_job(*train, "--multihost", "--max_steps", "16",
                     "--resume", launcher=torchrun)

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

    def finish():
        out2, seconds["resume"] = resume.result()
        check("resumed from step 12" in out2 and "finished at step 16" in out2
              and rank_line in out2, f"resume: {out2[-2000:]}")
        ckpts = sorted(p.name for p in ck.glob("ckpt_*.pt"))
        check(ckpts == ["ckpt_12.pt", "ckpt_16.pt", "ckpt_9.pt"],
              f"checkpoints after the resume {ckpts}")
        emit({"phase": "train_vc", "step": "cli", "overrides": over,
              "records": json.loads((Path(db) / "meta.json").read_text())[
                  "count"],
              "seconds": seconds, "sections_ms": sec,
              "steps_per_s": sec["step"][1] / (wall / 1e3),
              "loader_share": (sec["load"][0] + sec["put"][0]) / wall,
              "validation": val[0], "checkpoints": names,
              "restored_bit_exact": True,
              "resume_launcher": " ".join(torchrun) + " --multihost",
              "phase_seconds": time.perf_counter() - t_phase})
        return {"launcher": " ".join(torchrun) + " --multihost",
                "rank": rank_line, "resume_s": seconds["resume"],
                "checkpoints": ckpts}

    return run, db, [str(root / "audio" / f"spk{s}" / "0.wav")
                     for s in range(8)], finish


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
    for _, dtype, nbytes, rank, *dims in ins:
        check(int(rank) == len(dims), f"manifest line {dims}")
        shape = [int(d) for d in dims]
        if dtype == "bfloat16":
            a = np.frombuffer(raw, "<i2", int(nbytes) // 2, at)
            t = torch.tensor(a.reshape(shape)).view(torch.bfloat16)
        else:
            t = torch.tensor(np.frombuffer(raw, "<f4", int(nbytes) // 4,
                                           at).reshape(shape))
        caches.append(t.to(device))
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
    for _ in range(FILE_RUNS):
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


def export_run_jobs(run, db, wavs, device="cuda") -> dict:
    """(b) of phase 10, its commands, started once phase 9(b)'s resume
    has ended, beside phase 11: ``python -m rave_tpu_torch.cli export
    --voice_conversion`` and ``eval`` of the run, at once (eval writes
    only its embeddings)."""
    return {"t0": time.perf_counter(), "export": cli_job(
        "export", "--run", str(run), "--chunk_size", str(VC_CHUNK),
        "--voice_conversion", "--speaker_wavs", *wavs[:VC_SPEAKERS],
        "--device", device, timeout=EXPORT_TIMEOUT),
        "eval": cli_job("eval", "--run", str(run), "--db_path", str(db),
                        "--device", device, timeout=EXPORT_TIMEOUT)}


def phase_export_run(torch, np, run, wavs, jobs, card, device="cuda"):
    """(b) of phase 10: the commands of :func:`export_run_jobs` (``jobs``)
    of the run phase 9(b) trained; the reloaded programs against the
    live converter and stream built from the same checkpoint (``card``
    as in :func:`phase_export_stream`)."""
    from rave_tpu_torch.data.audio_io import load_wav
    from rave_tpu_torch.export.streaming import (StreamingRAVE, load_run,
                                                 run_params)
    from rave_tpu_torch.export.voice_conversion import VoiceConverter

    t_phase = jobs["t0"]
    seconds = {"export": jobs["export"].result()[1]}
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

    seconds["eval"] = jobs["eval"].result()[1]
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


def cli_tf32_off_job(*args, timeout=600, nice=10) -> Job:
    """The port's CLI (``rave_tpu_torch.cli.main``) in a subprocess with
    TF32 off, so that a card run compares with a CPU run in float32, as
    a :class:`Job` at nice ``nice``."""
    return Job([sys.executable, "-c", CLI_TF32_OFF, *args],
               f"cli {args[0]}", timeout, nice)


def phase_pitch(torch, np, KERNELS, device="cuda"):
    """The f0-conditioned fork (see the module docstring, phase 11).
    Returns B1's launches per ``convert``, each kernel's per D and G step
    and the directory of the serialized converter (under ``_smoke/``,
    which the caller removes)."""
    from pathlib import Path
    from rave_tpu_torch.config import build_config
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
    root = Path(SMOKE_DIR) / "pitch"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
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
                           "ci1_conv_dx": 0, "residual_unit_bf16": 0,
                           **NO_CI1_BF16},
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
    fcpe_cli = pitch_commands(np, root, ckpt, sr, device)
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
    emit({"phase": "pitch", "step": "fcpe", "f0_rel_err_vs_cpu": fcpe_rel,
          "voiced_share": float((ff_cpu.numpy() > 0).mean()),
          "fcpe_f0_device_ms": fcpe_ms, "convert_batch_ms": fcpe_convert_ms,
          "fcpe_vs_yin_max_abs": fcpe_vs_yin})

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
                "ci1_conv_dx": 3 if kind == "G" else 0,
                "residual_unit_bf16": 0, **NO_CI1_BF16}
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
    # one G step at PAIR_BATCH x 65536 on the card and on the CPU (one
    # thread)
    short = build_config(PITCH_STACK, ["fused_kernels=true",
                                       "n_signal=65536",
                                       f"batch_size={PAIR_BATCH}"])
    g_step = short.phase_1_duration + 1
    torch.manual_seed(SEED + 1)
    card = loop.TrainState(short, device=device, step=g_step)
    cpu_t = loop.TrainState(short, device="cpu", step=g_step)
    cpu_t.model.load_state_dict({k: v.cpu() for k, v in
                                 card.model.state_dict().items()})
    cpu_t.disc.load_state_dict({k: v.cpu() for k, v in
                                card.disc.state_dict().items()})
    xs4 = glides(np, PAIR_BATCH, short.n_signal, seed=SEED + 8)
    m4, s4 = f0_stats(np, xs4, sr)
    sb = {"x": torch.tensor(xs4[:, :, None]),
          "units": torch.tensor(np.random.default_rng(SEED + 9).integers(
              0, 100, (PAIR_BATCH, 74))),
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
          "card_s": rf_card_s})

    # (b)'s commands, once they have ended
    stats, seconds = fcpe_cli["stats"].result()
    out, seconds["validate_assets"] = fcpe_cli["assets"].result()
    check(sorted(stats[0]) == [f"spk{s}" for s in range(PITCH_SPEAKERS)],
          f"speaker_stats speakers {sorted(stats[0])}")
    stats_rel = max(abs(stats[0][n][k] - stats[1][n][k])
                    / max(abs(stats[1][n][k]), 1e-12)
                    for n in stats[1] for k in ("mean", "std"))
    check(stats_rel <= STATS_RTOL, f"speaker_stats card vs cpu: {stats_rel}")
    check("fcpe (pitch teacher): pass" in out,
          f"validate_assets: {out[-1500:]}")
    emit({"phase": "pitch", "step": "fcpe_cli", "speaker_stats": stats[0],
          "speaker_stats_rel_err_vs_cpu": stats_rel,
          "validate_assets": [ln for ln in out.splitlines()
                              if ln.startswith("fcpe")],
          "seconds": seconds, "phase_seconds": time.perf_counter() - t_phase})
    return convert_launches, train_launches, out_dir


def pitch_commands(np, root, ckpt, sr, device="cuda") -> dict:
    """(b) of phase 11, its commands, started now at nice 10 and read at
    the end of the phase: ``preprocess`` of 4 gliding speakers x 2 clips,
    then ``speaker_stats --pitch_ckpt`` on the card and on the CPU
    together (``stats``: a :class:`Later` of the two JSON files and the
    seconds), and ``validate_assets`` beside them (``assets``)."""
    from rave_tpu_torch.data.audio_io import save_wav
    corpus = glides(np, PITCH_SPEAKERS, 2 * PITCH_CLIP, seed=SEED + 5)
    for s in range(PITCH_SPEAKERS):
        d = root / "audio" / f"spk{s}"
        d.mkdir(parents=True)
        for k in range(2):
            save_wav(str(d / f"{k}.wav"),
                     corpus[s, k * PITCH_CLIP:(k + 1) * PITCH_CLIP], sr)
    db = str(root / "db")

    def stats():
        seconds = {}
        _, seconds["preprocess"] = cli_tf32_off_job(
            "preprocess", "--input_path", str(root / "audio"),
            "--output_path", db, "--num_workers", "4").result()
        outs = [root / f"stats_{i}.json" for i in range(2)]
        jobs = [cli_tf32_off_job("speaker_stats", "--db_path", db,
                                 "--pitch_ckpt", ckpt, "--out", str(out),
                                 "--device", dev)
                for out, dev in zip(outs, (device, "cpu"))]
        for job, dev in zip(jobs, (device, "cpu")):
            _, seconds[f"speaker_stats_{dev}"] = job.result()
        return [json.loads(out.read_text()) for out in outs], seconds

    return {"stats": Later(stats),
            "assets": cli_tf32_off_job(
                "validate_assets", "--fcpe_ckpt", ckpt, "--out",
                str(root / "assets.md"), "--device", device)}


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
PAIR_OVER = ["n_signal=65536", f"batch_size={PAIR_BATCH}",
             "learning_rate=1e-6"]
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
    """The gradient norms of the encoder and the decoder, and of the GRU
    layers (``gru``) where the model has them."""
    groups = [("enc", st.enc_params), ("dec", st.dec_params)]
    gru = [p for n, p in st.model.named_parameters() if ".gru." in n]
    if gru:
        groups.append(("gru", gru))
    return {g: float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                    for p in ps)))
            for g, ps in groups}


def dis_grad_norm(torch, st) -> float:
    """The norm of the discriminator's gradient, which a D step leaves in
    ``.grad`` (a G step differentiates the generator only)."""
    return float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                for p in st.disc.parameters())))


def card_vs_cpu_pair(torch, np, stack, over, counts, reset, device="cuda"):
    """A D, G pair of ``stack`` with ``over`` at 2 x 65536 (``PAIR_OVER``)
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
    audio = voices(np, PAIR_BATCH, short.n_signal, SEED + 2)
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
                 cycles=None, pattern="DGGG"):
    """One cycle of ``pattern`` (D, G, G, G; D, G for a config with
    ``update_discriminator_every=2``), four steps, from the state's step
    with ``expect`` launches on every step and finite metrics, then
    ``cycles`` (``TIMED_CYCLES``) timed ones of four steps: median D and
    G ms, audio seconds per second and peak memory."""
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
    check([c["kind"] for c in warm] == list((pattern * 4)[:4]),
          f"{what} cycle {warm}")
    times = {"D": [], "G": []}
    torch.cuda.reset_peak_memory_stats()
    for _ in range((cycles or TIMED_CYCLES) * 4):
        kind = kind_of()
        times[kind].append(cuda_ms(torch, lambda: fn(st, batch), iters=1,
                                   warmup=0))
    d_ms, g_ms = statistics.median(times["D"]), statistics.median(times["G"])
    audio_s = batch["x"].shape[0] * batch["x"].shape[1] / 44100
    n_d = pattern.count("D")
    return {"warmup_cycle": warm, "d_step_ms": d_ms, "g_step_ms": g_ms,
            "d_step_ms_all": times["D"], "g_step_ms_all": times["G"],
            "audio_s_per_s": len(pattern) * audio_s / (
                (n_d * d_ms + (len(pattern) - n_d) * g_ms) / 1e3),
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
                           "ci1_conv_dx": 0, "residual_unit_bf16": 0,
                           **NO_CI1_BF16},
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
    expect = {"residual_unit": 6, "ci1_conv_forward": 0, "ci1_conv_dx": 0,
              "residual_unit_bf16": 0, **NO_CI1_BF16}
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
    expect = {"residual_unit": 0, "ci1_conv_forward": 0, "ci1_conv_dx": 0,
              "residual_unit_bf16": 0, **NO_CI1_BF16}
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


def serve_native(torch, np, export_dir, prefix, x, host, device="cuda",
                 compiled=None):
    """``<export_dir>/<prefix>.pt2`` compiled into its AOTInductor package
    (or ``compiled``, the package and its compile seconds, when it was
    compiled already) and served by the host over the blocks ``x``
    ``(n, chunk)``: the host's JSON line with the compile seconds, the
    package's size and the operators it runs through the proxy executor;
    the blocking loop's outputs ``(n, chunk)``; the last caches, flat;
    the package's path."""
    from rave_tpu_torch.export import native
    pkg, compile_s = compiled or native.compile_package(export_dir, prefix,
                                                        device)
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
    manifest = export_dir / ("io_manifest.txt" if prefix == "forward"
                             else f"{prefix}_manifest.txt")
    return res, y, read_carry(np, files["c"], manifest), pkg


def read_carry(np, path, manifest):
    """The caches of a raw file written in a manifest's cache dtypes
    (``float32``, ``bfloat16``), flat, as float32."""
    raw, vals, at = path.read_bytes(), [], 0
    lines = [ln.split() for ln in manifest.read_text().splitlines()[1:]]
    for _, dtype, nbytes, *_ in [ln for ln in lines
                                 if ln[0] == "out"][1:]:
        nbytes = int(nbytes)
        if dtype == "bfloat16":
            bits = np.frombuffer(raw, "<u2", nbytes // 2, at)
            vals.append((bits.astype(np.uint32) << 16).view(np.float32))
        else:
            vals.append(np.frombuffer(raw, "<f4", nbytes // 4, at))
        at += nbytes
    check(at == len(raw), f"{path.name}: {len(raw)} bytes, manifest {at}")
    return np.concatenate(vals)


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


def native_v2_export(torch, state, device="cuda", after=()) -> dict:
    """13(a)'s program: the offline phase's v2 weights in a stream of
    2048-sample chunks, serialized under ``rave_tpu_torch/_build/`` and its
    ``forward`` package compiled by a niced subprocess (started after
    phase 5, so that the work overlaps phases 6-12), then the packages
    of ``after`` (17(e)'s bf16 ``forward``)."""
    from rave_tpu_torch.config import build_config
    cfg = build_config(["v2"], ["fused_kernels=true"])
    exp, spec = stream_spec(torch, "native_v2", cfg, state, chunk_size=CHUNK)
    return {"dir": exp, **compile_in_background(
        [(exp, "forward", device, spec), *after])}


def native_convert_export(np, run, wavs, device="cuda") -> dict:
    """13(b)'s program: phase 10(b)'s export of the trained run, copied
    under ``rave_tpu_torch/_build/`` (``_smoke/`` is removed after phase
    10), its ``convert`` package compiled by a niced subprocess while
    phases 11 and 12 run; the 32 blocks of a speaker's clip it serves."""
    from rave_tpu_torch.data.audio_io import load_wav
    from rave_tpu_torch.data.audio_io import load_wav
    from rave_tpu_torch.ops.kernels.build import BUILD_DIR
    out = BUILD_DIR / "native_convert"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(run / "export", out)
    x = load_wav(wavs[VC_SPEAKERS])[0].astype(np.float32)[
        :NATIVE_VC_BLOCKS * VC_CHUNK].reshape(NATIVE_VC_BLOCKS, VC_CHUNK)
    return {"dir": out, "x": x,
            **compile_in_background([(out, "convert", device)])}


def native_pg_export(torch, pitch_dir, device="cuda") -> dict:
    """13(c)'s ``convert_pg`` package of phase 11's export and (d)'s CPU
    package (a tiny v2 exported on the CPU: any program will do), both
    compiled by one niced subprocess while phase 12 runs."""
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.export.streaming import StreamingRAVE
    from rave_tpu_torch.models.rave import RAVE
    from rave_tpu_torch.ops.kernels.build import BUILD_DIR
    tiny = BUILD_DIR / "native_cpu"
    tcfg = build_config(["v2"], NATIVE_CPU_TINY)
    torch.manual_seed(SEED)
    StreamingRAVE(tcfg, RAVE(tcfg, device="cpu").state_dict(),
                  chunk_size=CHUNK, device="cpu").serialize(tiny)
    return {"pitch_dir": pitch_dir, "tiny": tiny,
            **compile_in_background([(pitch_dir, "convert_pg", device),
                                     (tiny, "forward", "cpu")])}


def phase_native_convert(torch, np, conv, card, device="cuda"):
    """(b) of the native phase: the ``convert.pt2`` of phase 10(b)'s
    trained run (:func:`native_convert_export`) served by the host over 32
    blocks of 4096 of a speaker's clip, against the reloaded program with
    the same zero embedding.  Returns the host's numbers."""
    from rave_tpu_torch.export import native

    t_phase = time.perf_counter()
    if HOST_BUILD:
        host = HOST_BUILD[0].result()
        build_s = HOST_BUILD[0].seconds
    else:
        host = native.build_host(device)
        build_s = time.perf_counter() - t_phase
    wait_s = time.perf_counter() - t_phase
    out, x = conv["dir"], conv["x"]
    res, y, carry, pkg = serve_native(torch, np, out, "convert", x, host,
                                      device, compiled_packages(conv)[out])
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
    res.update(host_build_s=build_s, host_build_wait_s=wait_s,
               compile_wait_s=conv["compile_wait_s"],
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


def phase_native(torch, np, KERNELS, state, audio, nv2, pgc, convert_res,
                 card, device="cuda"):
    """(a), (c) and (d) of the native phase (see the module docstring),
    their packages compiled in the background (:func:`native_v2_export`,
    :func:`native_pg_export`), then its summary line beside (b)'s numbers
    ``convert_res``."""
    from pathlib import Path
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.export import native
    from rave_tpu_torch.export.streaming import StreamingRAVE
    from rave_tpu_torch.ops.pitch import yin_f0

    t_phase = time.perf_counter()
    for k in KERNELS:
        k.launches = 0
    root = Path(SMOKE_DIR)
    host = native.build_host(device)
    pitch_dir, tiny = pgc["pitch_dir"], pgc["tiny"]
    # (a) forward of full-width v2, 64 blocks of 2048
    cfg = build_config(["v2"], ["fused_kernels=true"])
    sr = StreamingRAVE(cfg, state, chunk_size=CHUNK, device=device)
    exp = nv2["dir"]
    signal = audio[0, :NATIVE_BLOCKS * CHUNK].astype(np.float32)
    x = signal.reshape(NATIVE_BLOCKS, CHUNK)
    fwd, y, carry, fwd_pkg = serve_native(
        torch, np, exp, "forward", x, host, device,
        compiled_packages(nv2)[exp])
    want = sr.process_file(signal).reshape(NATIVE_BLOCKS, CHUNK)
    live = np.concatenate([c.reshape(-1).cpu().numpy()
                           for c in sr.caches])
    fwd.update(hold_host(np, "forward", y, want, carry, live))
    fwd["serialize_s"] = nv2["serialize_s"][exp]
    fwd["compile_wait_s"] = nv2["compile_wait_s"]
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
    packages = compiled_packages(pgc)
    cpu_ok = packages[tiny]
    pg, y, carry, pg_pkg = serve_native(torch, np, pitch_dir,
                                        "convert_pg", x, host, device,
                                        packages[pitch_dir])
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
    check(cpu_ok[0].exists(), f"CPU package: {cpu_ok}")
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


# ----------------------------------------------------------------------
# phase 14: the v1 family, the noise generators, the Wasserstein and
# spherical heads (ROADMAP A6), and the v3 native package
# ----------------------------------------------------------------------

A6_STREAM_CHUNKS = 32    # 2048-sample chunks streamed per config
A6_PAIR_OVER = ["n_signal=65536", f"batch_size={PAIR_BATCH}",
                "learning_rate=1e-6", "log_epsilon=1e-3"]
SPHERE_TOL = 1e-4        # max |a - b| of unit vectors and their angles


def a6_draws(torch, cfg, B, T, seed) -> dict:
    """Every random tensor a forward or a train step of ``cfg`` takes for
    ``B`` x ``T`` samples, drawn on the CPU from ``seed`` (so that the
    card and the CPU get the same numbers): ``eps`` (variational),
    ``ref`` (Wasserstein), ``aug`` (noise augmentation), ``noise`` (the
    noise branch's uniform draw)."""
    g = torch.Generator().manual_seed(seed)
    T_z = T // cfg.total_ratio()
    out = {}
    if cfg.latent_head == "variational":
        out["eps"] = torch.randn(B, cfg.latent_size, T_z, generator=g)
    if cfg.latent_head == "wasserstein":
        out["ref"] = torch.randn(B, cfg.latent_size, T_z, generator=g)
    if cfg.noise_augmentation:
        out["aug"] = torch.randn(B, cfg.noise_augmentation, T_z,
                                 generator=g)
    v1 = cfg.generator_version == "v1"
    if (cfg.v1_use_noise if v1 else cfg.use_noise):
        n = 64 if v1 else math.prod(cfg.noise_ratios)
        out["noise"] = torch.rand(B, T // cfg.n_band // n, cfg.n_band, n,
                                  generator=g) * 2 - 1
    return out


def on(draws, device) -> dict:
    return {k: v.to(device) for k, v in draws.items()}


def forward_with(model, x, draws):
    return model(x, draws.get("aug"), draws.get("noise"))


def bn_buffers(torch, model) -> list:
    from rave_tpu_torch.models.blocks import BatchNorm
    return [b.detach().cpu().clone() for m in model.encoder.modules()
            if isinstance(m, BatchNorm)
            for b in (m.running_mean, m.running_var)]


def a6_serve(torch, np, KERNELS, stack, over, audio, expect_b1, card,
             device="cuda", names=("residual_unit", "fft"), phase="a6"):
    """Offline serving of ``stack`` at its full width (random weights from
    the seed, ``train_mode`` off), the draws injected: ``expect_b1``
    launches of B1 per forward, finite output of the input's shape, fused
    vs plain (where the config fuses) and card vs CPU on 8192 samples
    within ``CPU_TOL``, the median of 10 batches (the plain copy in
    turns) and a profile of one (the shares of the kernels whose names
    hold each of ``names``: B1's and the FFTs').  Returns the model, its
    state and the numbers, which it emits under ``phase``."""
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.models.rave import RAVE

    cfg = build_config(stack, over)
    torch.manual_seed(SEED)
    model = RAVE(cfg, device=device, train_mode=False)
    state = model.state_dict()
    fused = cfg.fused_kernels
    plain = None
    if fused:
        plain = RAVE(build_config(stack, over + ["fused_kernels=false"]),
                     device=device, train_mode=False)
        plain.load_state_dict(state)
    x = torch.tensor(audio[:, :, None], dtype=torch.float32, device=device)
    B, T = audio.shape
    d = on(a6_draws(torch, cfg, B, T, SEED + 3), device)
    res = {"config": "+".join(stack), "overrides": over,
           "params": sum(p.numel() for p in model.parameters()),
           "batch": [B, T, 1], "draws": sorted(d)}
    with torch.inference_mode():
        for k in KERNELS:
            k.launches = 0
        y = forward_with(model, x, d)
        torch.cuda.synchronize()
        res["launches"] = {k.name: k.launches for k in KERNELS}
        check(res["launches"]["residual_unit"] == expect_b1,
              f"{stack}: B1 launches {res['launches']}")
        check(tuple(y.shape) == tuple(x.shape), f"{stack}: {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), f"{stack}: output not finite")
        if plain is not None:
            res["max_abs_err_vs_plain"] = float(
                (y - forward_with(plain, x, d)).abs().max())
            check(res["max_abs_err_vs_plain"] <= OFFLINE_TOL,
                  f"{stack} fused vs plain: {res['max_abs_err_vs_plain']}")
        cpu = RAVE(cfg, device="cpu", train_mode=False)
        cpu.load_state_dict({k: v.cpu() for k, v in state.items()})
        short = a6_draws(torch, cfg, 1, 8192, SEED + 4)
        y_card = forward_with(model, x[:1, :8192], on(short, device))
        res["max_abs_err_vs_cpu"] = float(
            (y_card.cpu() - forward_with(cpu, x[:1, :8192].cpu(),
                                         short)).abs().max())
        check(res["max_abs_err_vs_cpu"] <= CPU_TOL,
              f"{stack} card vs cpu: {res['max_abs_err_vs_cpu']}")
        times, times_plain = [], []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(10):
            times.append(cuda_ms(torch, lambda: forward_with(model, x, d),
                                 iters=1, warmup=0))
            if plain is not None:
                times_plain.append(cuda_ms(
                    torch, lambda: forward_with(plain, x, d), iters=1,
                    warmup=0))
        res["peak_mem_mb"] = torch.cuda.max_memory_allocated() / 2 ** 20
        prof = device_profile(torch, lambda: forward_with(model, x, d),
                              names=names)
    prof["share"] = {n: ms / prof["device_ms"]
                     for n, ms in prof["named_ms"].items()}
    res.update(batch_ms=statistics.median(times), batch_ms_all=times,
               rtf=statistics.median(times) / 1e3 / (B * T / 44100),
               profile=prof)
    if times_plain:
        res["plain_batch_ms"] = statistics.median(times_plain)
    emit({"phase": phase, "step": "offline", "card": card, **res})
    return cfg, model, state, y, res


def a6_stream(torch, np, KERNELS, cfg, state, audio, card, device="cuda"):
    """Request 0 streamed in 2048-sample chunks with zero draws (the
    deterministic path) against the offline forward with zero draws,
    shifted by the delay (median relative error < 0.02), B1 launched
    never, chunk latency median and p80; then with seeded draws: finite,
    and the same again after ``reset``."""
    from rave_tpu_torch.export.streaming import StreamingRAVE
    from rave_tpu_torch.models.rave import RAVE

    n = A6_STREAM_CHUNKS * CHUNK
    signal = audio[0, :n].astype(np.float32)
    model = RAVE(cfg, device=device, train_mode=False)
    model.load_state_dict(state)
    zero = {k: torch.zeros_like(v) for k, v in
            a6_draws(torch, cfg, 1, n, 0).items()}
    with torch.inference_mode():
        off = forward_with(model, torch.tensor(signal[None, :, None],
                                               device=device),
                           on(zero, device))[0, :, 0].cpu().numpy()
    del model
    sr = StreamingRAVE(cfg, state, chunk_size=CHUNK, device=device,
                       seed=None)
    sr.process_file(signal[:4 * CHUNK])     # warm-up
    sr.reset()
    for k in KERNELS:
        k.launches = 0
    outs, chunk_ms = [], []
    for i in range(0, n, CHUNK):
        t0 = time.perf_counter()
        out = sr.forward(signal[i:i + CHUNK].reshape(1, -1, 1))
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out[0, :, 0])
    launches = {k.name: k.launches for k in KERNELS}
    check(not any(launches.values()), f"{cfg.name} stream: {launches}")
    y = torch.cat(outs).cpu().numpy()
    d = sr.total_delay_samples()
    check(d < n // 2, f"{cfg.name}: delay {d} >= half of {n}")
    m = 2 * d + 256
    a, b = off[m - d:n - d - 256], y[m:n - 256]
    rel = float(np.median(np.abs(a - b)) / (np.abs(a).mean() + 1e-9))
    check(rel < 0.02, f"{cfg.name} stream vs offline: {rel}")
    seeded = StreamingRAVE(cfg, state, chunk_size=CHUNK, device=device,
                           seed=SEED)
    first = seeded.process_file(signal[:8 * CHUNK])
    again = seeded.process_file(signal[:8 * CHUNK])
    check(bool(np.isfinite(first).all()), f"{cfg.name}: seeded stream")
    check(np.array_equal(first, again), f"{cfg.name}: seeded stream after "
          "reset differs")
    return {"chunk": CHUNK, "chunks": len(chunk_ms), "delay_samples": d,
            "median_rel_err": rel, "launches": launches,
            "chunk_ms_median": statistics.median(chunk_ms),
            "chunk_ms_p80": float(np.percentile(chunk_ms, 80)),
            "seeded_draws_finite_and_repeat": True}


def a6_pair(torch, np, stack, over, counts, reset, device="cuda"):
    """A D, G pair of ``stack`` at 2 x 65536 (``A6_PAIR_OVER``:
    ``learning_rate=1e-6`` and ``log_epsilon=1e-3``, ROADMAP C) from one
    seeded state on the card and on the CPU (one thread), every draw the
    same on both: losses, ENC/DEC gradient norms and the D step's DIS
    gradient norm within ``TRAIN_RTOL``, EncoderV1's running statistics
    after each step within ``BN_RTOL`` (atol 1e-7, as phase 9's)."""
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.train import loop, schedules

    short = build_config(stack, over + A6_PAIR_OVER)
    torch.manual_seed(SEED + 1)
    card = loop.TrainState(short, device=device, step=short.phase_1_duration)
    cpu = loop.TrainState(short, device="cpu", step=short.phase_1_duration)
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               card.model.state_dict().items()})
    cpu.disc.load_state_dict({k: v.cpu() for k, v in
                              card.disc.state_dict().items()})
    audio = voices(np, PAIR_BATCH, short.n_signal, SEED + 2)
    x = torch.tensor(audio[:, :, None], dtype=torch.float32)
    d = a6_draws(torch, short, PAIR_BATCH, short.n_signal, SEED + 5)
    rest = {k: v for k, v in d.items() if k != "eps"}
    eps = d.get("eps")
    eps_card = None if eps is None else eps.to(device)
    fn = loop.make_train_step(short)
    threads = torch.get_num_threads()
    rel, launches, bn = {}, {}, {}
    for kind in ("D", "G"):
        check(schedules.is_discriminator_step(card.step, short)
              == (kind == "D"), f"{stack} pair: step {card.step}")
        reset()
        m_card = {k: float(v) for k, v in fn(
            card, {"x": x.to(device)}, eps_card,
            draws=on(rest, device)).items()}
        launches[kind] = counts()
        torch.set_num_threads(1)
        try:
            m_cpu = {k: float(v) for k, v in fn(
                cpu, {"x": x}, eps, draws=rest).items()}
        finally:
            torch.set_num_threads(threads)
        check(all(np.isfinite(v) for v in m_card.values()),
              f"{stack} pair {kind}: {m_card}")
        rel.update({f"{kind}/{k}": abs(m_card[k] - m_cpu[k])
                    / max(abs(m_cpu[k]), 1e-12) for k in m_cpu})
        got, want = bn_buffers(torch, card.model), bn_buffers(torch,
                                                              cpu.model)
        bn[kind] = max((float((g - w).abs().max())
                        for g, w in zip(got, want)), default=0.0)
        check(all(torch.allclose(g, w, rtol=BN_RTOL, atol=1e-7)
                  for g, w in zip(got, want)),
              f"{stack} running statistics after {kind}: {bn[kind]}")
    n_card, n_cpu = grad_norms(torch, card), grad_norms(torch, cpu)
    rel.update({f"grad_norm_{g}": abs(n_card[g] - n_cpu[g]) / n_cpu[g]
                for g in n_cpu})
    n_card["dis"], n_cpu["dis"] = dis_grad_norm(torch, card), \
        dis_grad_norm(torch, cpu)
    rel["D/grad_norm_dis"] = abs(n_card["dis"] - n_cpu["dis"]) / n_cpu["dis"]
    check(max(rel.values()) <= TRAIN_RTOL, f"{stack} card vs cpu: {rel}")
    return {"overrides": over + A6_PAIR_OVER, "rel_err": rel,
            "grad_norms_card": n_card, "grad_norms_cpu": n_cpu,
            "running_stats_max_abs_err": bn, "launches": launches}


def a6_train(torch, np, KERNELS, stack, over, expect_b1, counts, reset,
             device="cuda"):
    """D, G, G, G (``v1``: D, G, D, G, its ``update_discriminator_every``
    is 2) at 8 x 131072 from ``phase_1_duration`` (the draws from the
    state's generator), ``expect_b1`` B1 launches per step, then
    ``TIMED_CYCLES`` timed cycles and a profile of one G step; the
    regulariser finite; EncoderV1's running statistics seen to move."""
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.train import loop

    cfg = build_config(stack, over)
    torch.manual_seed(SEED)
    st = loop.TrainState(cfg, device=device, step=cfg.phase_1_duration,
                         seed=SEED)
    before = bn_buffers(torch, st.model)
    audio = voices(np, TRAIN_BATCH, SAMPLES, SEED + 6)
    batch = {"x": torch.tensor(audio[:, :, None], dtype=torch.float32,
                               device=device)}
    expect = {k.name: 0 for k in KERNELS}
    expect["residual_unit"] = expect_b1
    pattern = "DG" if cfg.update_discriminator_every == 2 else "DGGG"
    step_fn = loop.make_train_step(cfg)
    res = train_cycles(torch, np, st, step_fn, batch, expect, counts, reset,
                       "+".join(stack), pattern=pattern)

    # where the time of one G step goes
    def one_g_step():
        st.step = cfg.phase_1_duration + 1
        step_fn(st, batch)

    prof = device_profile(torch, one_g_step, names=("residual_unit", "fft"))
    prof["share"] = {n: ms / prof["device_ms"]
                     for n, ms in prof["named_ms"].items()}
    regs = [c["metrics"]["loss_regularization"] for c in res["warmup_cycle"]
            if c["kind"] == "G"]
    check(all(np.isfinite(r) for r in regs), f"{stack} regulariser {regs}")
    after = bn_buffers(torch, st.model)
    moved = [float((a - b).abs().max()) for a, b in zip(after, before)]
    if before:
        check(min(moved) > 0, f"{stack}: running statistics still {moved}")
    res.update(pattern=pattern, launches_per_step=expect,
               regularization=regs, g_step_profile=prof,
               running_stats_moved=moved,
               start_step=cfg.phase_1_duration, batch=[TRAIN_BATCH,
                                                       SAMPLES, 1])
    return res


def a6_launches(a6, name) -> dict:
    """The ``kernels`` line's fields of phase 14 for kernel ``name``."""
    return {"launches_wasserstein_forward": a6["wasserstein_forward"][name],
            "launches_wasserstein_train_step": {
                k: v[name] for k, v in a6["wasserstein_train_step"].items()},
            "launches_spherical_forward": a6["spherical_forward"][name],
            "launches_v1_forward": a6["v1_forward"][name]}


def a6_wasserstein(torch, np, KERNELS, audio, card, counts, reset,
                   device="cuda") -> dict:
    """(a) of phase 14; returns B1's launches per forward and step."""
    stack, over = ["v2", "noise", "wasserstein"], ["fused_kernels=true"]
    cfg, model, state, _, served = a6_serve(torch, np, KERNELS, stack, over,
                                            audio, 16, card, device)
    x = torch.tensor(audio[:, :, None], dtype=torch.float32, device=device)
    g = torch.Generator(device=device).manual_seed(SEED)
    with torch.inference_mode():
        z = model.encode(x)
        y = model.decode(z, generator=g)
    check(tuple(z.shape) == (len(audio), SAMPLES // cfg.total_ratio(),
                             cfg.latent_size), f"wasserstein z {z.shape}")
    check(tuple(y.shape) == tuple(x.shape)
          and bool(torch.isfinite(y).all()), "wasserstein encode -> decode")
    del model
    stream = a6_stream(torch, np, KERNELS, cfg, state, audio, card, device)
    emit({"phase": "a6", "step": "stream", "card": card,
          "config": "+".join(stack), **stream})
    train = a6_train(torch, np, KERNELS, stack, over, 16, counts, reset,
                     device)
    pair = a6_pair(torch, np, stack, over, counts, reset, device)
    emit({"phase": "a6", "step": "train", "card": card,
          "config": "+".join(stack), **train, "pair": pair})
    return {"wasserstein_forward": served["launches"],
            "wasserstein_train_step": {c["kind"]: train["launches_per_step"]
                                       for c in train["warmup_cycle"]}}


def a6_v1_family(torch, np, KERNELS, audio, card, counts, reset,
                 device="cuda") -> dict:
    """(b) of phase 14; returns B1's launches per forward of each."""
    from pathlib import Path
    from rave_tpu_torch.export.streaming import StreamingRAVE

    out = {}
    for name in ("v1", "onnx", "raspberry"):
        cfg, model, state, _, served = a6_serve(torch, np, KERNELS, [name],
                                                [], audio, 0, card, device)
        out[f"{name}_forward"] = served["launches"]
        del model
        stream = a6_stream(torch, np, KERNELS, cfg, state, audio, card,
                           device)
        emit({"phase": "a6", "step": "stream", "card": card, "config": name,
              **stream})
        if name != "v1":
            continue
        # the v1 stream serialized; its reloaded forward vs the live step
        sr = StreamingRAVE(cfg, state, chunk_size=CHUNK, device=device)
        exp = Path(SMOKE_DIR) / "a6_v1_export"
        sr.serialize(exp)
        prog = torch.export.load(exp / "forward.pt2").module()
        carry = [c.clone() for c in sr.init_caches]
        sr.reset()
        err = 0.0
        with torch.no_grad():
            for i in range(0, 8 * CHUNK, CHUNK):
                c = torch.tensor(audio[:1, i:i + CHUNK, None],
                                 dtype=torch.float32, device=device)
                yp, carry = prog(carry, c)
                err = max(err, float((yp - sr.forward(c)).abs().max()))
        check(err <= EXPORT_TOL, f"v1 forward.pt2 vs live: {err}")
        shutil.rmtree(exp)
        train = a6_train(torch, np, KERNELS, ["v1"], [], 0, counts, reset,
                         device)
        pair = a6_pair(torch, np, ["v1"], [], counts, reset, device)
        emit({"phase": "a6", "step": "train", "card": card, "config": "v1",
              "serialize_max_abs_err": err, **train, "pair": pair})
    return out


def a6_spherical(torch, np, KERNELS, audio, card, device="cuda") -> dict:
    """(c) of phase 14; returns B1's launches per forward."""
    from rave_tpu_torch.export.streaming import StreamingRAVE
    from rave_tpu_torch.models.latent import (angles_to_unit_norm_vector,
                                              unit_norm_vector_to_angles)

    cfg, model, state, _, served = a6_serve(
        torch, np, KERNELS, ["v2", "spherical"], ["fused_kernels=true"],
        audio, 16, card, device)
    x = torch.tensor(audio[:, :, None], dtype=torch.float32, device=device)
    with torch.inference_mode():
        z = model.encode(x)
    del model
    ang = unit_norm_vector_to_angles(z)
    round_trip = float((angles_to_unit_norm_vector(ang) - z).abs().max())
    ang_err = float((ang.cpu() - unit_norm_vector_to_angles(z.cpu()))
                    .abs().max())
    check(round_trip <= SPHERE_TOL, f"spherical round trip {round_trip}")
    check(ang_err <= SPHERE_TOL, f"spherical angles card vs cpu {ang_err}")
    sr = StreamingRAVE(cfg, state, chunk_size=CHUNK, device=device)
    ys = []
    for i in range(0, 8 * CHUNK, CHUNK):
        zc = sr.encode(audio[:1, i:i + CHUNK, None].astype(np.float32))
        zc = zc.cpu().numpy()
        back = sr.preprocess_latent(sr.postprocess_latent(zc))
        check(float(np.abs(back - zc).max()) <= SPHERE_TOL,
              "spherical stream latent round trip")
        ys.append(sr.decode(back).cpu().numpy())
    check(bool(np.isfinite(np.concatenate(ys)).all()),
          "spherical stream: output not finite")
    emit({"phase": "a6", "step": "spherical", "card": card,
          "round_trip_max_abs_err": round_trip,
          "angles_card_vs_cpu": ang_err, "streamed_chunks": len(ys)})
    return {"spherical_forward": served["launches"]}


def phase_a6(torch, np, KERNELS, audio, card, v3, device="cuda"):
    """Phase 14 (see the module docstring), ``v3`` the handle of
    :func:`a6_v3_export`.  Returns B1's launches per ``v2`` + ``noise`` +
    ``wasserstein`` forward and D and G step, per ``v2`` + ``spherical``
    forward and per ``v1``-family forward."""
    counts = lambda: {k.name: k.launches for k in KERNELS}  # noqa: E731

    def reset():
        for k in KERNELS:
            k.launches = 0

    t_phase = time.perf_counter()
    out = a6_wasserstein(torch, np, KERNELS, audio, card, counts, reset,
                         device)
    out.update(a6_v1_family(torch, np, KERNELS, audio, card, counts, reset,
                            device))
    out.update(a6_spherical(torch, np, KERNELS, audio, card, device))
    out["v3_native"] = a6_native_v3(torch, np, audio, card, v3, device)
    emit({"phase": "a6", "card": card, "b1_launches": out,
          "phase_seconds": time.perf_counter() - t_phase})
    return out


def a6_v3_export(torch, device="cuda", before=(), after=()):
    """The full-width ``v3`` stream with AdaIN states that hold statistics
    (learning off, so every block transfers), serialized under
    ``rave_tpu_torch/_build/`` and its ``forward`` compiled into an
    AOTInductor package by a subprocess at the lowest CPU priority
    (``nice 19``, :func:`compile_in_background`), after the packages of
    ``before`` (phase 13(a)'s v2 ``forward``) and before those of
    ``after`` (phase 15's hybrid): started before phase 6, the compiles
    (2-3 min each) overlap the device-bound train phases and leave the CPU
    to them, and phases 13-15 serve the packages
    (:func:`compiled_packages`).  Returns the stream, the directory, the
    subprocess and the stream without the statistics."""
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.export.streaming import StreamingRAVE
    from rave_tpu_torch.models.blocks import AdaIN
    from rave_tpu_torch.models.rave import RAVE

    cfg = build_config(["v3"])
    torch.manual_seed(SEED)
    state = RAVE(cfg, device=device).state_dict()
    base = StreamingRAVE(cfg, state, chunk_size=CHUNK, device=device)
    g = torch.Generator(device=device).manual_seed(SEED + 7)
    adain = []
    for s in base.adain:
        s = s.clone()
        shape = s[..., 0].shape
        for slot in (AdaIN.MEAN_X, AdaIN.MEAN_Y):
            s[..., slot] = 0.1 * torch.randn(shape, generator=g,
                                             device=device)
        for slot in (AdaIN.STD_X, AdaIN.STD_Y):
            s[..., slot] = 0.8 + 0.4 * torch.rand(shape, generator=g,
                                                  device=device)
        s[..., AdaIN.N_X] = s[..., AdaIN.N_Y] = 1.0
        adain.append(s)
    sr = StreamingRAVE(cfg, state, chunk_size=CHUNK, device=device,
                       adain_state=adain)
    exp, spec = stream_spec(torch, "a6_native_v3", cfg, state,
                            chunk_size=CHUNK, adain_state=adain)
    return {"stream": sr, "dir": exp, "plain": base,
            **compile_in_background([*before, (exp, "forward", device, spec),
                                     *after])}


BACKGROUND = []          # every compile subprocess, killed when main ends
HOST_BUILD = []          # the C++ host's build, started before phase 1
JOBS = []                # every Job started


def compile_in_background(items) -> dict:
    """A subprocess at ``nice 19`` compiling, in turn, the AOTInductor
    package of each ``(export dir, prefix, device)`` of ``items`` (see
    :func:`compiled_packages`); an item with a fourth entry, the spec of
    :func:`stream_spec`, is first serialized into its export dir there,
    so that this process spends no time on it.  Its output goes to a
    temporary file (a pipe left unread would stall it)."""
    import tempfile
    log = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import json, os, sys, time; os.nice(19)\n"
         "import torch\n"
         "from rave_tpu_torch.export.native import compile_package\n"
         "from rave_tpu_torch.export.streaming import StreamingRAVE\n"
         "for d, pre, dev, spec in zip(*[iter(sys.argv[1:])] * 4):\n"
         "    if spec:\n"
         "        t0 = time.perf_counter()\n"
         "        s = torch.load(spec, weights_only=False)\n"
         "        StreamingRAVE(s['cfg'], s['state'], device=dev,\n"
         "                      **s['kw']).serialize(d)\n"
         "        print(json.dumps({'dir': d, 'serialize_s':\n"
         "                          time.perf_counter() - t0}), flush=True)\n"
         "    p, s = compile_package(d, pre, dev)\n"
         "    print(json.dumps([str(p), s]), flush=True)",
         *[str(a) for item in items for a in (*item, "")[:4]]],
        stdout=log, stderr=subprocess.STDOUT, text=True)
    BACKGROUND.append(proc)
    return {"compile": proc, "log": log, "dirs": [item[0] for item in items]}


def stream_spec(torch, name, cfg, state, **kw) -> tuple:
    """A stream for :func:`compile_in_background` to serialize: ``cfg``,
    the weights ``state`` and ``StreamingRAVE``'s keywords ``kw`` saved
    as ``rave_tpu_torch/_build/<name>.spec.pt``.  Returns the export dir
    ``_build/<name>`` and the spec's path."""
    from rave_tpu_torch.ops.kernels.build import BUILD_DIR
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    spec = BUILD_DIR / f"{name}.spec.pt"
    torch.save({"cfg": cfg, "state": state, "kw": kw}, spec)
    return BUILD_DIR / name, spec


def compiled_packages(v3) -> dict:
    """The packages the subprocess of :func:`compile_in_background`
    (``v3["compile"]``) compiled, once it has ended: ``{export dir:
    (package, compile seconds)}``; the seconds waited for it (at the
    first call) in ``v3["compile_wait_s"]``, the serialize seconds of
    each dir it serialized in ``v3["serialize_s"]``."""
    from pathlib import Path
    if "packages" not in v3:
        proc = v3["compile"]
        t0 = time.perf_counter()
        try:
            proc.wait(timeout=NATIVE_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        v3["log"].seek(0)
        text = v3["log"].read()
        v3["compile_wait_s"] = time.perf_counter() - t0
        check(proc.returncode == 0, f"package compiles: {text[-2000:]}")
        lines = [json.loads(ln) for ln in text.strip().splitlines()
                 if ln.startswith('["')]
        check(len(lines) == len(v3["dirs"]),
              f"package compiles: {len(lines)} of {len(v3['dirs'])}")
        v3["packages"] = {d: (Path(p), sec)
                          for d, (p, sec) in zip(v3["dirs"], lines)}
        v3["serialize_s"] = {
            Path(r["dir"]): r["serialize_s"] for r in
            (json.loads(ln) for ln in text.strip().splitlines()
             if ln.startswith('{"dir"'))}
    return v3["packages"]


def a6_native_v3(torch, np, audio, card, v3, device="cuda"):
    """(d) of phase 14: the ``v3`` package of :func:`a6_v3_export`, once
    compiled, served by the C++ host over ``NATIVE_VC_BLOCKS`` blocks of
    2048: every block and the last caches (the AdaIN states included)
    against ``StreamingRAVE.forward`` within ``EXPORT_TOL``; p50/p80
    block time; the transfer changes the output."""
    from rave_tpu_torch.export import native

    sr, exp = v3["stream"], v3["dir"]
    compiled = compiled_packages(v3)[exp]
    host = native.build_host(device)
    n = NATIVE_VC_BLOCKS
    signal = audio[0, :n * CHUNK].astype(np.float32)
    res, y, carry, _ = serve_native(torch, np, exp, "forward",
                                    signal.reshape(n, CHUNK), host, device,
                                    compiled=compiled)
    want = sr.process_file(signal).reshape(n, CHUNK)
    live = np.concatenate([c.reshape(-1).cpu().numpy() for c in sr.caches])
    res.update(hold_host(np, "v3 forward", y, want, carry, live))
    plain = v3["plain"].process_file(signal).reshape(n, CHUNK)
    check(float(np.abs(plain - want).max()) > 1e-3,
          "v3: the AdaIN transfer changed nothing")
    res.update(n_adain_states=sr.n_adain,
               compile_wait_s=v3["compile_wait_s"],
               compiled_in_background=True)
    emit({"phase": "a6", "step": "native_v3", "card": card, "config": "v3",
          "chunk": CHUNK, "chunk_ms_of_audio": CHUNK / 44.1, **res})
    shutil.rmtree(exp)
    return {k: res[k] for k in ("compile_s", "block_ms_p50", "block_ms_p80",
                                "max_abs_err_vs_program")}


# ----------------------------------------------------------------------
# phase 15: the hybrid preset (mel front end, GRU layers) and the rest
# of the loss library (ROADMAP A7)
# ----------------------------------------------------------------------

HYBRID_OVER = ["fused_kernels=true"]
HYBRID_B1 = 10           # B1 launches per hybrid forward and D or G step
HYBRID_STREAM_CHUNKS = 64   # 2048-sample chunks of request 0 (131072)
SERIALIZE_CHUNKS = 8     # chunks of the reloaded forward.pt2 vs the live step
LOSS_RTOL = 1e-4         # card vs CPU of each ported distance


def hybrid_export(torch, device="cuda"):
    """The full-width ``hybrid`` stream (``fused_kernels=true``, random
    weights from the seed: the weights of phase 15's offline model) of
    2048-sample chunks, to be serialized under ``rave_tpu_torch/_build/``
    and compiled by :func:`a6_v3_export`'s subprocess after ``v3``'s
    ``forward``.  Returns the stream, the directory, the weights and the
    subprocess's item."""
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.export.streaming import StreamingRAVE
    from rave_tpu_torch.models.rave import RAVE

    cfg = build_config(["hybrid"], HYBRID_OVER)
    torch.manual_seed(SEED)
    state = RAVE(cfg, device=device, train_mode=False).state_dict()
    sr = StreamingRAVE(cfg, state, chunk_size=CHUNK, device=device)
    exp, spec = stream_spec(torch, "hybrid_native", cfg, state,
                            chunk_size=CHUNK)
    return {"stream": sr, "dir": exp, "state": state,
            "item": (exp, "forward", device, spec)}


def hybrid_stream(torch, np, KERNELS, model, sr, audio, card):
    """(b) of phase 15: request 0 in 2048-sample chunks (no B1) against
    the offline forward shifted by the delay, past the margin of
    ``tests/test_streaming.py``'s hybrid case (the clip head: offline
    reflect-pads, the stream starts from zeros; the GRU state's decay):
    median relative error < 0.02; chunk median and p80;
    ``process_file_scan`` (its CUDA graph) against ``process_file`` on
    the same audio, ms per chunk of each."""
    n = HYBRID_STREAM_CHUNKS * CHUNK
    signal = audio[0, :n].astype(np.float32)
    with torch.inference_mode():
        off = model(torch.tensor(signal[None, :, None], device=sr.device)
                    )[0, :, 0].cpu().numpy()
    sr.process_file(signal[:4 * CHUNK])     # warm-up
    sr.reset()
    for k in KERNELS:
        k.launches = 0
    outs, chunk_ms = [], []
    for i in range(0, n, CHUNK):
        t0 = time.perf_counter()
        out = sr.forward(signal[i:i + CHUNK].reshape(1, -1, 1))
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out[0, :, 0])
    launches = {k.name: k.launches for k in KERNELS}
    check(not any(launches.values()), f"hybrid stream: {launches}")
    y = torch.cat(outs).cpu().numpy()
    check(bool(np.isfinite(y).all()), "hybrid stream: output not finite")
    d = sr.total_delay_samples()
    m = 2 * d + sr.cfg.mel_n_fft + 4096
    check(m + 256 < n, f"hybrid: margin {m} >= {n}")
    a, b = off[m - d:n - d - 256], y[m:n - 256]
    rel = float(np.median(np.abs(a - b)) / (np.abs(a).mean() + 1e-9))
    check(rel < 0.02, f"hybrid stream vs offline: {rel}")
    sr.process_file_scan(signal[:4 * CHUNK])    # captures the graph
    t0 = time.perf_counter()
    scan = sr.process_file_scan(signal)
    scan_ms = (time.perf_counter() - t0) * 1e3 / HYBRID_STREAM_CHUNKS
    t0 = time.perf_counter()
    eager = sr.process_file(signal)
    eager_ms = (time.perf_counter() - t0) * 1e3 / HYBRID_STREAM_CHUNKS
    scan_err = float(np.abs(scan - eager).max())
    check(scan_err <= EXPORT_TOL, f"hybrid scan vs file: {scan_err}")
    res = {"chunk": CHUNK, "chunks": len(chunk_ms), "delay_samples": d,
           "margin_samples": m, "median_rel_err": rel, "launches": launches,
           "chunk_ms_median": statistics.median(chunk_ms),
           "chunk_ms_p80": float(np.percentile(chunk_ms, 80)),
           "chunk_ms_of_audio": CHUNK / 44.1,
           "scan_ms_per_chunk": scan_ms, "file_ms_per_chunk": eager_ms,
           "scan_vs_file_max_abs_err": scan_err}
    emit({"phase": "hybrid", "step": "stream", "card": card, **res})
    return res


def hybrid_native(torch, np, audio, card, hyb, v3, device="cuda"):
    """(d) of phase 15: ``forward.pt2`` of :func:`hybrid_export`, reloaded,
    against the live step over ``SERIALIZE_CHUNKS`` chunks; its package
    (compiled by :func:`a6_v3_export`'s subprocess after ``v3``'s) served
    by the C++ host over ``NATIVE_VC_BLOCKS`` blocks of 2048: every block
    and the last caches (the mel context and the GRU states among them)
    against ``StreamingRAVE.forward`` within ``EXPORT_TOL``; p50/p80 block
    time."""
    from rave_tpu_torch.export import native

    sr, exp = hyb["stream"], hyb["dir"]
    compiled = compiled_packages(v3)[exp]
    prog = torch.export.load(exp / "forward.pt2").module()
    carry = [c.clone() for c in sr.init_caches]
    sr.reset()
    err = 0.0
    with torch.no_grad():
        for i in range(0, SERIALIZE_CHUNKS * CHUNK, CHUNK):
            c = torch.tensor(audio[:1, i:i + CHUNK, None],
                             dtype=torch.float32, device=device)
            yp, carry = prog(carry, c)
            err = max(err, float((yp - sr.forward(c)).abs().max()))
    check(err <= EXPORT_TOL, f"hybrid forward.pt2 vs live: {err}")
    del prog
    host = native.build_host(device)
    n = NATIVE_VC_BLOCKS
    signal = audio[0, :n * CHUNK].astype(np.float32)
    res, y, carry, _ = serve_native(torch, np, exp, "forward",
                                    signal.reshape(n, CHUNK), host, device,
                                    compiled=compiled)
    want = sr.process_file(signal).reshape(n, CHUNK)
    live = np.concatenate([c.reshape(-1).cpu().numpy() for c in sr.caches])
    res.update(hold_host(np, "hybrid forward", y, want, carry, live))
    ranks = sorted({c.dim() for c in sr.caches})
    res.update(serialize_max_abs_err=err, serialize_s=v3["serialize_s"][exp],
               n_caches=len(sr.caches), cache_ranks=ranks,
               compiled_in_background=True)
    emit({"phase": "hybrid", "step": "native", "card": card,
          "chunk": CHUNK, "chunk_ms_of_audio": CHUNK / 44.1, **res})
    shutil.rmtree(exp)
    return {k: res[k] for k in ("compile_s", "block_ms_p50", "block_ms_p80",
                                "max_abs_err_vs_program",
                                "serialize_max_abs_err")}


def hybrid_losses(torch, np, card, device="cuda"):
    """(e) of phase 15: the ported distances of 4 x 65536 synthetic voices
    against 4 others on the card and on the CPU, each term within
    ``LOSS_RTOL`` relative: the mel ``audio_distance_v1`` (128 mels),
    ``spectral_distance`` (2048, 128 mels, L1 and L2),
    ``encodec_audio_distance`` and the weighted instantaneous-frequency
    distance (default scales), this one on voices with a silent head of
    1025 samples: frame 0 of a reflect-padded STFT is symmetric, its
    spectrum real, and a phase step there wraps to +pi or -pi by the
    sign of a rounding-level imaginary part (``tests/
    test_torch_loss_library.py``)."""
    from rave_tpu_torch.ops import losses as L

    x = voices(np, 4, 65536, SEED + 8)
    y = voices(np, 4, 65536, SEED + 9)
    xh, yh = x.copy(), y.copy()
    xh[:, :2048 // 2 + 1] = yh[:, :2048 // 2 + 1] = 0

    def terms(dev):
        t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
        with torch.no_grad():
            out = {"audio_distance_v1_mel": L.audio_distance_v1(
                t(x), t(y), num_mels=128),
                "spectral_distance_mel": L.spectral_distance(
                    t(x), t(y), 2048, norms=("L1", "L2"), mel=128)}
            for k, v in L.encodec_audio_distance(t(x), t(y)).items():
                out[f"encodec_{k}"] = v
            for k, v in L.weighted_instantaneous_spectral_distance(
                    t(xh), t(yh), weighted=True).items():
                out[f"instantaneous_{k}"] = v
        return {k: float(v) for k, v in out.items()}

    card_v, cpu_v = terms(device), terms("cpu")
    rel = {k: abs(card_v[k] - cpu_v[k]) / max(abs(cpu_v[k]), 1e-12)
           for k in cpu_v}
    check(all(np.isfinite(v) and v > 0 for v in card_v.values()),
          f"hybrid losses: {card_v}")
    check(max(rel.values()) <= LOSS_RTOL, f"losses card vs cpu: {rel}")
    res = {"batch": [4, 65536], "card": card_v, "cpu": cpu_v,
           "rel_err": rel, "rtol": LOSS_RTOL}
    emit({"phase": "hybrid", "step": "losses", "card_name": card, **res})
    return res


def phase_hybrid(torch, np, KERNELS, audio, card, hyb, v3, device="cuda"):
    """Phase 15 (see the module docstring), ``hyb`` the handle of
    :func:`hybrid_export`, ``v3`` that of :func:`a6_v3_export`.  Returns
    the launches of every kernel per hybrid forward and per D and G
    step."""
    counts = lambda: {k.name: k.launches for k in KERNELS}  # noqa: E731

    def reset():
        for k in KERNELS:
            k.launches = 0

    t_phase = time.perf_counter()
    # (a) offline
    stack = ["hybrid"]
    cfg, model, state, _, served = a6_serve(
        torch, np, KERNELS, stack, HYBRID_OVER, audio, HYBRID_B1, card,
        device, names=("residual_unit", "fft", "RNN"), phase="hybrid")
    check(all(torch.equal(state[k], hyb["state"][k]) for k in state),
          "hybrid: the stream's weights differ from the offline model's")
    x = torch.tensor(audio[:, :, None], dtype=torch.float32, device=device)
    with torch.inference_mode():
        z = model.encode(x).transpose(1, 2)
        fns = {"mel_front_end": lambda: model.mel_frontend(x[..., 0]),
               "decoder_gru": lambda: model.decoder.gru(z)}
        parts = {k: device_ms(torch, f, iters=5) for k, f in fns.items()}
        # CUDA events beside the profiler, which once recorded no kernel
        # of the mel front end late in a whole run (PERF.md section 7)
        event_ms = {k: cuda_ms(torch, f, iters=20) for k, f in fns.items()}
    total_ms = served["profile"]["device_ms"]
    emit({"phase": "hybrid", "step": "offline_parts", "card": card,
          "device_ms": parts, "event_ms": event_ms,
          "forward_device_ms": total_ms,
          "share": {k: v / total_ms for k, v in parts.items()}})
    # (b) streaming
    stream = hybrid_stream(torch, np, KERNELS, model, hyb["stream"], audio,
                           card)
    del model
    # (c) training
    train = a6_train(torch, np, KERNELS, stack, HYBRID_OVER, HYBRID_B1,
                     counts, reset, device)
    pair = a6_pair(torch, np, stack, HYBRID_OVER, counts, reset, device)
    check("grad_norm_gru" in pair["rel_err"],
          f"hybrid pair: no GRU gradient norm in {sorted(pair['rel_err'])}")
    emit({"phase": "hybrid", "step": "train", "card": card,
          "config": "hybrid", **train, "pair": pair})
    # (d) export and the C++ host
    native = hybrid_native(torch, np, audio, card, hyb, v3, device)
    # (e) the ported losses
    losses = hybrid_losses(torch, np, card, device)
    out = {"forward": served["launches"],
           "train_step": {c["kind"]: train["launches_per_step"]
                          for c in train["warmup_cycle"]}}
    emit({"phase": "hybrid", "card": card, "launches": out,
          "batch_ms": served["batch_ms"],
          "plain_batch_ms": served.get("plain_batch_ms"),
          "chunk_ms_median": stream["chunk_ms_median"],
          "d_step_ms": train["d_step_ms"], "g_step_ms": train["g_step_ms"],
          "native": native, "losses_max_rel_err": max(
              losses["rel_err"].values()),
          "phase_seconds": time.perf_counter() - t_phase})
    return out


# ----------------------------------------------------------------------
# phase 16: data parallelism and time sharding (ROADMAP A12)
# ----------------------------------------------------------------------

PAR_RANKS = 2            # gloo ranks on the one card (NCCL refuses two)
PAR_BATCH = 8            # rows of the v2_fork pair's global batch
PAR_OVER = VC_TRAIN + ["learning_rate=1e-6", "speaker_learning_rate=1e-6",
                       "log_epsilon=1e-3"]
PAR_RTOL = 1e-3          # ranks vs one process: losses, gradient norms, state
TS_SAMPLES = 524288      # the time-sharded request
PAR_TIMEOUT = 600        # s, each rank, and each torchrun launch


def par_dp_steps(torch, np, KERNELS, device, save=None) -> dict:
    """A D then a G step of the full-width from-scratch ``v2_fork``
    (cohort norm, ``PAR_OVER``) from ``phase_1_duration`` on this process's
    rows of the global batch of ``PAR_BATCH`` voices (all of
    them without a process group): per step the metrics, the gradient norm
    of each group that stepped, the launches, the step's time and the
    gradient all-reduce's; the state's CRC-32 (equal on every rank or it
    raises); ``save``: a path for the parameters and buffers, or None to
    return them.  Then two timed D, G cycles."""
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.parallel import mesh
    from rave_tpu_torch.train import loop

    cfg = build_config(["v2_fork"], PAR_OVER)
    torch.manual_seed(SEED)
    state = loop.TrainState(cfg, device=device, step=cfg.phase_1_duration)
    mesh.check_replicated(state.model, state.disc)
    batch = mesh.local_rows(vc_batch(torch, np, PAR_BATCH,
                                     cfg.n_signal, 148, device))
    step_fn = loop.make_train_step(cfg)
    reduce_ms, all_reduce_mean = [], mesh.all_reduce_mean

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def timed_all_reduce(tensors):
        # the gradient's all-reduce (the metrics' is a 0-d stack)
        tensors = list(tensors)
        sync()
        t0 = time.perf_counter()
        all_reduce_mean(tensors)
        sync()
        if sum(t.numel() for t in tensors if t is not None) > 64:
            reduce_ms.append((time.perf_counter() - t0) * 1e3)

    groups = {"D": {"dis": list(state.disc.parameters())},
              "G": {"enc": state.enc_params, "dec": state.dec_params,
                    "spk": state.spk_params}}
    out = {"steps": [], "rows": int(batch["x"].shape[0])}
    mesh.all_reduce_mean = timed_all_reduce
    try:
        before = {k: v.detach().clone()
                  for k, v in state.disc.state_dict().items()}
        for kind in ("D", "G"):
            for k in KERNELS:
                k.launches = 0
            reduce_ms.clear()
            sync()
            t0 = time.perf_counter()
            metrics = step_fn(state, batch)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            out["steps"].append({
                "kind": kind, "ms": ms, "all_reduce_ms": sum(reduce_ms),
                "launches": {k.name: k.launches for k in KERNELS},
                "metrics": {k: float(v) for k, v in metrics.items()},
                "grad_norms": {g: float(torch.sqrt(sum(
                    (p.grad.double() ** 2).sum() for p in ps)))
                    for g, ps in groups[kind].items()}})
        out["crc32"] = mesh.check_replicated(state.model, state.disc)
        named = {**{f"gen/{k}": v for k, v in
                    state.model.state_dict().items()},
                 **{f"dis/{k}": v for k, v in
                    state.disc.state_dict().items()}}
        named["dis_update"] = torch.cat([
            (v - before[k]).reshape(-1) for k, v in
            state.disc.state_dict().items()])
        # Adam's first moments: (1 - b1) times the gradient each group
        # stepped with, the ranks' average under the group
        names = {id(p): f"gen/{k}" for k, p in state.model.named_parameters()}
        names.update({id(p): f"dis/{k}"
                      for k, p in state.disc.named_parameters()})
        for g, opt in (("ENC", state.enc_opt), ("DEC", state.dec_opt),
                       ("SPK", state.spk_opt), ("DIS", state.dis_opt)):
            for p, st in (opt.state.items() if opt is not None else ()):
                named[f"mu/{g}/{names[id(p)]}"] = st["exp_avg"]
        named = {k: v.detach().cpu().clone() for k, v in named.items()}
        if save is not None:
            torch.save(named, save)
        else:
            out["state"] = named
        # timed cycles
        timed = {"D": [], "G": [], "all_reduce_D": [], "all_reduce_G": []}
        for _ in range(2):
            for kind in ("D", "G"):
                state.step = cfg.phase_1_duration + (kind == "G")
                reduce_ms.clear()
                sync()
                t0 = time.perf_counter()
                step_fn(state, batch)
                sync()
                timed[kind].append((time.perf_counter() - t0) * 1e3)
                timed[f"all_reduce_{kind}"].append(sum(reduce_ms))
        out["timed"] = timed
    finally:
        mesh.all_reduce_mean = all_reduce_mean
    return out


def par_time_sharded(torch, np, KERNELS, device, state, x, halo) -> dict:
    """The full-width ``v2`` forward (``fused_kernels=true``, the offline
    phase's weights ``state``) over this rank's time shard of the clip
    ``x`` ``(1, TS_SAMPLES, 1)``, haloed by ``halo``: its output shard, B1's
    launches and the call's time."""
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.models.rave import RAVE
    from rave_tpu_torch.parallel import mesh
    from rave_tpu_torch.parallel.time_shard import time_sharded

    cfg = build_config(["v2"], ["fused_kernels=true"])
    model = RAVE(cfg, device=device).eval()
    model.load_state_dict(state)
    n, r = mesh.world(), mesh.rank()
    T_l = x.shape[1] // n
    x_l = x[:, r * T_l:(r + 1) * T_l].to(device)
    fn = time_sharded(model, halo, cfg.total_ratio())
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else lambda: None)
    with torch.inference_mode():
        fn(x_l)                                   # warm-up
        for k in KERNELS:
            k.launches = 0
        sync()
        t0 = time.perf_counter()
        y = fn(x_l)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
    return {"y": y.cpu(), "ms": ms,
            "launches": {k.name: k.launches for k in KERNELS}}


def par_rank(r: int, n: int, outdir: str, device: str = "cuda",
             backend: str = "gloo") -> int:
    """One rank of phase 16(a) and (c), started by :func:`phase_parallel`
    as ``chip_smoke.py --parallel-rank <r> <n> <dir> <device> <backend>``:
    gloo, named, with every rank on ``cuda:0``, or NCCL with rank ``r``
    on card ``r``; its results in ``<dir>/rank<r>.json`` (rank 0 also
    saves its state there, every rank its output shard)."""
    import os
    from pathlib import Path
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from rave_tpu_torch.ops.kernels import KERNELS
    from rave_tpu_torch.ops.kernels.build import build_all
    from rave_tpu_torch.parallel import mesh
    out = Path(outdir)
    if device == "cuda":
        build_all(KERNELS)        # built by the parent: this loads them
    os.environ.update(RANK=str(r), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(r if backend == "nccl" else 0))
    dev = mesh.init_from_env(device, backend=backend,
                             init_method=f"file://{out / 'init'}",
                             timeout_s=PAR_TIMEOUT)
    res = {"rank": r, "world": mesh.world(),
           "backend": torch.distributed.get_backend()}
    res["dp"] = par_dp_steps(torch, np, KERNELS, dev,
                             save=out / "dp_state.pt" if r == 0 else None)
    res["dp"].pop("state", None)
    torch.cuda.empty_cache()
    ts = json.loads((out / "time_shard.json").read_text())
    ts_out = par_time_sharded(
        torch, np, KERNELS, dev, torch.load(out / "v2_state.pt"),
        torch.from_numpy(np.load(out / "ts_x.npy")), ts["halo"])
    torch.save(ts_out.pop("y"), out / f"ts_y{r}.pt")
    res["time_sharded"] = ts_out
    mesh.barrier()
    torch.distributed.destroy_process_group()
    (out / f"rank{r}.json").write_text(json.dumps(res))
    return 0


def phase_parallel(torch, np, KERNELS, audio, state_v2, card, torchrun,
                   device="cuda", ranks=PAR_RANKS,
                   backend="gloo") -> dict:
    """Phase 16 (see the module docstring); ``torchrun``: (b)'s numbers,
    from phase 9(b)'s train commands.  ``ranks`` NCCL ranks, one per
    card, with ``--parallel-cards``.  Returns the per-rank launches of
    the G step and of the time-sharded forward."""
    from pathlib import Path
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.models.rave import RAVE
    from rave_tpu_torch.ops.kernels.build import BUILD_DIR
    from rave_tpu_torch.parallel.time_shard import halo_for
    from rave_tpu_torch.utils.receptive_field import measure_receptive_field

    t_phase = time.perf_counter()
    out = BUILD_DIR / "parallel"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    # (c)'s inputs: the offline phase's weights, one request of 524288
    # samples, the halo from the forward's measured receptive field
    cfg = build_config(["v2"], ["fused_kernels=true"])
    model = RAVE(cfg, device=device).eval()
    model.load_state_dict(state_v2)
    t0 = time.perf_counter()
    rf = measure_receptive_field(lambda a: model(a), device=device)
    rf_s = time.perf_counter() - t0
    hop = cfg.total_ratio()
    halo = halo_for(max(rf), hop)
    reps = -(-TS_SAMPLES // audio.shape[1])
    x = np.tile(audio[1], reps)[:TS_SAMPLES].reshape(1, -1, 1).astype(
        np.float32)
    np.save(out / "ts_x.npy", x)
    torch.save({k: v.cpu() for k, v in state_v2.items()}, out / "v2_state.pt")
    (out / "time_shard.json").write_text(json.dumps({"halo": halo}))
    torch.cuda.empty_cache()

    # (a) and (c) in the ranks
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--parallel-rank", str(r), str(ranks),
         str(out), device, backend], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(ranks)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PAR_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"parallel rank {r}: rc {p.returncode}\n"
              f"{log[-3000:]}")
    ranks_s = time.perf_counter() - t0
    results = [json.loads((out / f"rank{r}.json").read_text())
               for r in range(ranks)]
    for r, res in enumerate(results):
        check(res["world"] == ranks and res["backend"] == backend,
              f"rank {r}: {res['world']} ranks, {res['backend']}")
        for st in res["dp"]["steps"]:
            want = {"residual_unit": 16, "ci1_conv_forward": 3,
                    "ci1_conv_dx": 3 if st["kind"] == "G" else 0,
                    "residual_unit_bf16": 0, **NO_CI1_BF16}
            check(st["launches"] == want,
                  f"rank {r} {st['kind']} launches {st['launches']}")
        check(res["time_sharded"]["launches"]["residual_unit"] == 16,
              f"rank {r} time-sharded B1 {res['time_sharded']['launches']}")
    r0 = results[0]["dp"]
    for r, res in enumerate(results[1:], 1):
        check(res["dp"]["crc32"] == r0["crc32"],
              f"the states of ranks 0 and {r} differ")
        for a, b in zip(r0["steps"], res["dp"]["steps"]):
            check(a["metrics"] == b["metrics"]
                  and a["grad_norms"] == b["grad_norms"],
                  f"ranks 0 and {r} differ on {a['kind']}: {a['metrics']} "
                  f"{b['metrics']}")

    # (a)'s reference: one process, all 8 rows, on the card
    torch.cuda.empty_cache()
    one = par_dp_steps(torch, np, KERNELS, device)
    got = torch.load(out / "dp_state.pt")
    rel = {}
    for a, b in zip(r0["steps"], one["steps"]):
        k0 = a["kind"]
        for k, v in b["metrics"].items():
            if k.startswith("loss_"):
                rel[f"{k0}/{k}"] = abs(a["metrics"][k] - v) / max(abs(v),
                                                                    1e-12)
        for g, v in b["grad_norms"].items():
            rel[f"{k0}/grad_norm_{g}"] = abs(a["grad_norms"][g] - v) / v
    check(max(rel.values()) <= PAR_RTOL, f"ranks vs one process: {rel}")
    # every parameter and buffer; an element whose gradient is rounding
    # noise moves by the rate either way (ROADMAP C), so within 2 lr
    lr = 1e-6
    state_err, mu_err = {}, {}
    for k, v in one["state"].items():
        if k.startswith("mu/"):
            # the averaged gradient, element by element: rtol of itself
            # plus rtol of its group's largest (an element whose gradient
            # is rounding noise differs in its own digits)
            g = k.split("/")[1]
            scale = max(float(w.abs().max()) for j, w in
                        one["state"].items() if j.startswith(f"mu/{g}/"))
            err = (got[k].double() - v.double()).abs() / (
                v.double().abs() + scale)
            mu_err[k] = float(err.max()) if err.numel() else 0.0
            continue
        if k == "dis_update":
            continue
        w = got[k].double()
        err = ((w - v.double()).abs() - 2 * lr).clamp_min(0) / (
            v.double().abs() + 1e-30)
        state_err[k] = float(err.max()) if err.numel() else 0.0
    worst = max(state_err, key=state_err.get)
    check(state_err[worst] <= PAR_RTOL,
          f"state {worst}: {state_err[worst]} over rtol {PAR_RTOL}")
    mu_worst = max(mu_err, key=mu_err.get)
    check({k.split("/")[1] for k in mu_err} == {"ENC", "DEC", "SPK", "DIS"}
          and mu_err[mu_worst] <= PAR_RTOL,
          f"first moment {mu_worst}: {mu_err[mu_worst]} over rtol {PAR_RTOL}")
    # the D step's rule: the discriminator's update within 1 % of the rate
    du = (got["dis_update"] - one["state"]["dis_update"]).abs()
    d_share = float((du <= 0.01 * lr).double().mean())
    check(d_share >= D_STEP_SHARE, f"D update share {d_share}")
    one_ms = {k: statistics.median(one["timed"][k]) for k in ("D", "G")}
    del one, got

    # (c)'s reference: the one-process offline forward of the request
    with torch.inference_mode():
        y_off = model(torch.from_numpy(x).to(device)).cpu()
    del model
    y_sh = torch.cat([torch.load(out / f"ts_y{r}.pt")
                      for r in range(ranks)], dim=1)
    check(tuple(y_sh.shape) == tuple(y_off.shape),
          f"time-sharded shape {tuple(y_sh.shape)}")
    ts_err = float((y_sh - y_off)[:, halo:-halo].abs().max())
    check(ts_err <= OFFLINE_TOL, f"time-sharded interior vs offline: {ts_err}")

    shutil.rmtree(out)

    def per_rank(key):
        return [res["dp"]["steps"][key] for res in results]

    g_launches = [s["launches"] for s in per_rank(1)]
    ts_launches = [res["time_sharded"]["launches"] for res in results]
    timed = [res["dp"]["timed"] for res in results]
    g_ms = [statistics.median(t["G"]) for t in timed]
    d_ms = [statistics.median(t["D"]) for t in timed]
    emit({"phase": "parallel", "card": card, "ranks": ranks,
          "backend": (f"{backend} (one rank per card)" if backend == "nccl"
                      else f"{backend} ({ranks} ranks on one card)"),
          "config": "v2_fork", "overrides": PAR_OVER,
          "rows_per_rank": PAR_BATCH // ranks,
          "batch": [PAR_BATCH, SAMPLES, 1],
          "ranks_vs_one_process_rel_err": rel,
          "state_max_rel_err_past_2lr": state_err[worst],
          "state_worst": worst, "d_update_share_within_1pct_lr": d_share,
          "first_moment_max_rel_err": mu_err[mu_worst],
          "first_moment_worst": mu_worst,
          "ranks_bit_equal": True,
          "launches_g_step": g_launches,
          "launches_d_step": [s["launches"] for s in per_rank(0)],
          "d_step_ms": d_ms, "g_step_ms": g_ms,
          "d_step_ms_all": [t["D"] for t in timed],
          "g_step_ms_all": [t["G"] for t in timed],
          "all_reduce_ms_d": [statistics.median(t["all_reduce_D"])
                              for t in timed],
          "all_reduce_ms_g": [statistics.median(t["all_reduce_G"])
                              for t in timed],
          "all_reduce_share_g": [statistics.median(t["all_reduce_G"]) / g
                                 for t, g in zip(timed, g_ms)],
          "all_reduce_share_d": [statistics.median(t["all_reduce_D"]) / d
                                 for t, d in zip(timed, d_ms)],
          "one_process_d_ms": one_ms["D"], "one_process_g_ms": one_ms["G"],
          "time_sharded": {
              "samples": TS_SAMPLES, "receptive_field": list(rf),
              "receptive_field_s": rf_s, "halo": halo, "hop": hop,
              "interior_max_abs_err_vs_offline": ts_err,
              "launches": ts_launches,
              "ms": [res["time_sharded"]["ms"] for res in results]},
          "torchrun_nccl": torchrun, "ranks_s": ranks_s,
          "phase_seconds": time.perf_counter() - t_phase})
    return {"g_step": g_launches, "time_sharded_forward": ts_launches}


# ----------------------------------------------------------------------
# phase 17: bf16 serving (ROADMAP A10a) and kernel B1's bf16 instance
# ----------------------------------------------------------------------

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
BF16_OVER = ["fused_kernels=true", "compute_dtype=bfloat16"]
# B1-bf16 against its plain twin: max |kernel - twin| in bf16 ulps of
# max |y| (2 ** (floor(log2 max |y|) - 7)).  The twin rounds after each
# GEMM, bias and add, the kernel twice; on the CPU, float32 arithmetic
# with the kernel's two roundings stays within 1 ulp of the twin over the
# grid below.
B1_BF16_ULPS = 2.0
# the bf16 batch (and convert) against the float32 one of the same
# weights, relative L2: bf16 keeps 8 significant bits through ~30 convs
# (about 5e-3 at full width); a trunk that stayed float32 (TF32 off)
# would read about 1e-6, under the lower bound
BF16_REL_L2 = 0.02
BF16_MIN_REL_L2 = 1e-3
BF16_STREAM_CHUNKS = 32  # 2048-sample chunks of request 0 streamed in bf16
BF16_HOST_BLOCKS = 32    # 2048-sample blocks of the bf16 package in the host
# the host's blocks against the Python stream, relative L2: Inductor
# fuses the step's pointwise ops and rounds to bf16 at other places
# (5e-3 on the CPU at a tiny width)
BF16_HOST_REL_L2 = 0.02
BF16_STREAM_MEDIAN = 0.01  # the bf16 stream vs the offline bf16 forward
BF16_VC_CHUNKS = 8       # 4096-sample chunks of the bf16 VoiceConverter


B1_BF16_SYMBOL = "residual_unit_bf16_wgmma_kernel"
B1_BF16_THREADS = 288     # two consumer warpgroups and one producer warp
GRAPH_LAUNCHES = 20       # raw launches captured in one CUDA graph
GRAPH_REPLAYS = 5         # replays of it timed by CUDA events
RAW_REPEATS = 64          # raw launches held bit-equal to the wrapper's
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "UTMASTG", "LDSM", "LDGSTS",
            "SYNCS")


def named_device_ms(torch, fn, name: str, iters: int = 20):
    """Device time in ms per call of ``fn`` of the kernels whose name
    holds ``name``, by :func:`device_profile` over ``iters`` calls; None
    where the profile recorded none of them.  Late in a whole run the
    profiler has recorded none of B1-bf16's kernels launched outside a
    model (run alone, the kernel and phase 17 had them recorded), and
    none of the mel front end's in phase 15: :func:`graph_ms` is the
    time that cannot drop out."""
    prof = device_profile(torch, lambda: [fn() for _ in range(iters)],
                          names=(name,))
    if not prof["named_count"][name]:
        return None
    return prof["named_ms"][name] / iters


def graph_ms(torch, fn, n: int = GRAPH_LAUNCHES,
             replays: int = GRAPH_REPLAYS) -> float:
    """Device time of one call of ``fn`` in ms: CUDA events around
    ``replays`` replays of a CUDA graph of ``n`` calls, so that no host
    work sits between the launches and no profiler can drop one."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (n * replays)


def b1_bf16_raw(torch, ru, args, d, pl, kernel=None):
    """One B1-bf16 launch on operands prepared once (weights in the
    kernel's layout, the output allocated): no wrapper work, what a CUDA
    graph of raw launches replays.  ``kernel`` defaults to the port's
    own; x must need no time padding (T % 8 == 0)."""
    x, w1, b1, w2, b2 = args
    w1k, w2k = ru.prepare_weights(w1, w2)
    out = torch.empty_like(x)
    B, C, T = x.shape
    kern = kernel or ru.KERNEL_BF16
    ptrs = [t.data_ptr() for t in (x, w1k, b1, w2k, b2, out)]

    def launch():
        kern.launch(*ptrs, B, C, T, w1.shape[-1], d, pl,
                    torch.cuda.current_stream().cuda_stream)
        return out
    launch.operands = (w1k, w2k, out)  # kept alive with the closure
    return launch


def kernel_build_info(lib, name: str) -> dict:
    """What ``nvcc -Xptxas -v`` printed for the kernels of the library
    ``lib`` whose name holds ``name`` (registers, barriers, spills, any
    wgmma note), and the counts of ``SASS_OPS`` in their SASS by
    ``cuobjdump -sass``, or why there are none."""
    from pathlib import Path
    from rave_tpu_torch.ops.kernels.build import nvcc
    ptxas, cur = [], False
    for line in Path(lib).with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            cur = name in line
        if cur or "wgmma" in line.lower():
            ptxas.append(line.strip())
    tool = Path(nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        return {"ptxas": ptxas, "sass": f"no cuobjdump beside {nvcc()}"}
    dump = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    sass, fn = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            fn = fn if name in fn else None
            if fn:
                sass[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn:
            for op in SASS_OPS:
                sass[fn][op] += op in line
    return {"ptxas": ptxas, "sass": sass}


def bf16_ulp(y) -> float:
    """The spacing of bf16 values at ``max |y|``."""
    return 2.0 ** (math.floor(math.log2(y.abs().max().item())) - 7)


def b1_bf16_contract(torch, x, w1, b1, w2, b2, d, pl, pr):
    """B1's bf16 contract in float32 arithmetic on the bf16 operands (TF32
    off): lrelu(x) in bf16, GEMM 1, + b1 and lrelu in float32, the hidden
    tile rounded to bf16 once, GEMM 2, + b2 and + x in float32, rounded
    once: the Pallas kernel's two roundings."""
    import torch.nn.functional as F
    from rave_tpu_torch.ops.precision import leaky_relu
    h = F.pad(leaky_relu(x), (pl, pr)).float()
    h = F.leaky_relu(F.conv1d(h, w1.float(), b1.float(), dilation=d), 0.2)
    y = F.conv1d(h.to(torch.bfloat16).float(), w2.float()[:, :, None],
                 b2.float())
    return (y + x.float()).to(torch.bfloat16)


def b1_bf16_case(torch, ru, args, d, pl, pr) -> dict:
    """One B1-bf16 launch against its twin (bf16 ulps of max |y|) and both
    against the float32 contract (relative L2)."""
    got = ru.residual_unit_cuda(*args, d, pl, pr)
    twin = ru.residual_unit_reference(*args, d, pl, pr)
    ref = b1_bf16_contract(torch, *args, d, pl, pr).float()
    torch.cuda.synchronize()
    check(got.dtype == torch.bfloat16, f"B1-bf16 output {got.dtype}")
    diff = (got.float() - twin.float()).abs().max().item()
    norm = max(ref.norm().item(), 1e-30)
    return {"max_abs_err": diff, "ulps": diff / bf16_ulp(twin.float()),
            "kernel_rel_l2": (got.float() - ref).norm().item() / norm,
            "twin_rel_l2": (twin.float() - ref).norm().item() / norm,
            "kernel_sq": (got.float() - ref).norm().item() ** 2,
            "twin_sq": (twin.float() - ref).norm().item() ** 2}


def phase_bf16_kernels(torch, ru, launches_per_shape, parent=None) -> dict:
    """17(a): B1-bf16 over a grid (C in {128, 256, 384, 512}, k in {1, 3,
    5}, the v2 dilations, odd T and T = 1, d = 1000) and at the shapes
    the bf16 paths give it: within ``B1_BF16_ULPS`` of the twin; nearer
    the float32 contract than the twin (at each main-path shape, and over
    the grid as a whole); the launch geometry (64 x 64 tiles, clusters of
    C / 64, a wide dilation costing no shared memory); ``RAW_REPEATS``
    raw launches each bit-equal to the wrapper's output (a race in the
    kernel shows as a launch that differs); then call times and device
    times (CUDA graphs of raw launches, and the profiler's where it
    records one) beside the twin's, and the bounds.  ``parent``, a
    B1-bf16 kernel built from an earlier commit, is held to the same
    ulps and timed in turns with this one: parent, new, new, parent."""
    bf = torch.bfloat16
    grid = [(k, C, d, T, B) for C in (128, 256, 384, 512) for k in (1, 3, 5)
            for d in (1, 3, 9) for T in (1, 333) for B in (1, 2)]
    wide = ru.launch_info(1, 128, 333, 3, 1000, bf)
    narrow = ru.launch_info(1, 128, 333, 3, 1, bf)
    check(wide == narrow, f"B1-bf16 d=1000: {wide}, d=1: {narrow} (a wide "
          "dilation must cost no shared memory)")
    grid.append((3, 128, 1000, 333, 1))
    worst, sq_k, sq_t = {"ulps": 0.0, "max_abs_err": 0.0}, 0.0, 0.0
    for n, (k, C, d, T, B) in enumerate(grid):
        args = [a.to(bf) for a in unit_inputs(torch, B, C, T, k=k, seed=n)]
        pl, pr = pads(k, d)
        r = b1_bf16_case(torch, ru, args, d, pl, pr)
        check(r["ulps"] <= B1_BF16_ULPS,
              f"B1-bf16 k={k} C={C} d={d} T={T} B={B}: {r['ulps']} ulps")
        for key in worst:
            worst[key] = max(worst[key], r[key])
        sq_k, sq_t = sq_k + r["kernel_sq"], sq_t + r["twin_sq"]
    check(sq_k <= sq_t, f"B1-bf16 grid: kernel {sq_k} vs twin {sq_t} "
          "squared distance from the float32 contract")
    torch.cuda.empty_cache()
    emit({"phase": "bf16", "step": "kernel", "name": "residual_unit_bf16",
          "cases": len(grid), "worst": worst, "ulps_bound": B1_BF16_ULPS,
          "grid_rel_l2_ratio_kernel_to_twin": (sq_k / sq_t) ** 0.5,
          "launch_d1000": wide})

    shapes = []
    for (path, B, T, C, d), count in launches_per_shape.items():
        args = [a.to(bf) for a in unit_inputs(torch, B, C, T, seed=C + d)]
        pl, pr = pads(3, d)
        kernel = lambda: ru.residual_unit_cuda(*args, d, pl, pr)  # noqa: E731
        plain = lambda: ru.residual_unit_reference(  # noqa: E731
            *args, d, pl, pr)
        raw = b1_bf16_raw(torch, ru, args, d, pl)
        old = parent and b1_bf16_raw(torch, ru, args, d, pl, kernel=parent)
        with torch.inference_mode():
            r = b1_bf16_case(torch, ru, args, d, pl, pr)
            check(r["ulps"] <= B1_BF16_ULPS,
                  f"B1-bf16 main-path {(B, T, C)} d={d}: {r['ulps']} ulps")
            check(r["kernel_rel_l2"] <= r["twin_rel_l2"],
                  f"B1-bf16 {(B, T, C)} d={d}: kernel {r['kernel_rel_l2']} "
                  f"farther from the float32 contract than the twin "
                  f"{r['twin_rel_l2']}")
            want = kernel().float()
            raw_err = max((raw().float() - want).abs().max().item()
                          for _ in range(RAW_REPEATS))
            check(raw_err == 0, f"B1-bf16 {(B, T, C)} d={d}: a raw launch "
                  f"of {RAW_REPEATS} differs from the wrapper's by {raw_err}")
            if old:
                twin = plain().float()
                parent_ulps = ((old().float() - twin).abs().max().item()
                               / bf16_ulp(twin))
                check(parent_ulps <= B1_BF16_ULPS, f"B1-bf16 parent "
                      f"{(B, T, C)} d={d}: {parent_ulps} ulps")
            plain_ms = cuda_ms(torch, plain)
            ms = cuda_ms(torch, kernel)
            ms2 = cuda_ms(torch, kernel)
            plain_ms2 = cuda_ms(torch, plain)
            plain_dev = graph_ms(torch, plain)
            runs = [graph_ms(torch, fn)
                    for fn in ((old, raw, raw, old) if old else (raw, raw))]
            dev, dev2 = runs[1:3] if old else runs
            plain_dev2 = graph_ms(torch, plain)
            prof_ms = named_device_ms(torch, kernel, B1_BF16_SYMBOL)
            plain_prof_ms = device_ms(torch, plain)
        info = ru.launch_info(B, C, T, 3, d, bf)
        check(info["ctas"] == B * -(-T // 64) * (C // 64)
              and info["cluster"] == C // 64
              and info["threads"] == B1_BF16_THREADS,
              f"B1-bf16 {(B, T, C)}: {info}")
        flops = 2 * B * T * C * C * 4
        nbytes = 2 * (2 * B * T * C + 4 * C * C + 2 * C)
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        shapes.append({
            "shape": [B, T, C], "dilation": d, "path": path,
            "launches_per_call": count, "launch": info,
            **{k: r[k] for k in ("max_abs_err", "ulps", "kernel_rel_l2",
                                 "twin_rel_l2")},
            "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2),
            "device_ms": min(dev, dev2),
            "plain_device_ms": min(plain_dev, plain_dev2),
            "device_ms_runs": [dev, dev2], "device_ms_worst": max(dev, dev2),
            **({"parent_ulps": parent_ulps,
                "parent_device_ms_runs": [runs[0], runs[3]],
                "parent_device_ms": min(runs[0], runs[3])} if old else {}),
            "profiler_device_ms": prof_ms,
            "plain_profiler_device_ms": plain_prof_ms,
            "bound_ms": max(t_ops, t_bytes), "ops_ms": t_ops,
            "bytes_ms": t_bytes,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6})
        del raw, old
    keys = ("ms", "plain_ms", "device_ms", "device_ms_worst",
            "plain_device_ms", "bound_ms") + (
        ("parent_device_ms",) if parent else ())
    sums = {path: {key: sum(s[key] * s["launches_per_call"] for s in shapes
                            if s["path"] == path)
                   for key in keys}
            for path in dict.fromkeys(s["path"] for s in shapes)}
    emit({"phase": "bf16", "step": "kernel_times",
          "name": "residual_unit_bf16", "shapes": shapes,
          "device_ms": "CUDA events around a graph of "
                       f"{GRAPH_LAUNCHES} raw launches x {GRAPH_REPLAYS}",
          "per_call": sums})
    return {"worst": worst, "shapes": shapes, "per_call": sums}


def bf16_export(torch, state, device="cuda") -> dict:
    """17(e)'s program: the offline phase's v2 weights in a bf16 stream of
    2048-sample chunks, serialized under ``rave_tpu_torch/_build/`` and
    compiled into a ``forward`` package by phase 13's niced subprocess
    after the float32 one (:func:`native_v2_export`; ``item``)."""
    from rave_tpu_torch.config import build_config
    cfg = build_config(["v2"], BF16_OVER)
    exp, spec = stream_spec(torch, "native_bf16", cfg, state,
                            chunk_size=CHUNK)
    return {"dir": exp, "item": (exp, "forward", device, spec)}


def rel_l2(a, b) -> float:
    return float(((a - b) ** 2).sum() ** 0.5 / ((b ** 2).sum() ** 0.5))


def phase_bf16(torch, np, KERNELS, ru, audio, state, card, nv2, bfx,
               device="cuda"):
    """Phase 17 (see the module docstring): B1-bf16 against its twin and
    the float32 contract, the bf16 v2 batch, stream, ``v2_fork`` convert
    and the bf16 ``forward`` package in the C++ host.  Returns the
    launch counts of each path and the kernel's numbers."""
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.export import native
    from rave_tpu_torch.export.streaming import StreamingRAVE
    from rave_tpu_torch.export.voice_conversion import VoiceConverter
    from rave_tpu_torch.models.rave import RAVE

    t_phase = time.perf_counter()
    counts = lambda: {k.name: k.launches for k in KERNELS}  # noqa: E731

    def reset():
        for k in KERNELS:
            k.launches = 0

    bf = torch.bfloat16
    only = lambda n: {"residual_unit": 0, "ci1_conv_forward": 0,  # noqa: E731
                      "ci1_conv_dx": 0, "residual_unit_bf16": n,
                      **NO_CI1_BF16}
    # (a) the kernel at the bf16 paths' shapes
    kern = phase_bf16_kernels(torch, ru, bf16_main_shapes())

    # (b) the offline batch in bf16 against the float32 one
    cfg = build_config(["v2"], BF16_OVER)
    model = RAVE(cfg, device=device).eval()
    model.load_state_dict(state)
    f32 = RAVE(build_config(["v2"], ["fused_kernels=true"]),
               device=device).eval()
    f32.load_state_dict(state)
    x = torch.tensor(audio[:, :, None], dtype=torch.float32, device=device)
    with torch.inference_mode():
        reset()
        y = model(x)
        torch.cuda.synchronize()
        launches = counts()
        check(launches == only(16), f"bf16 forward launches {launches}")
        check(y.dtype == torch.float32 and tuple(y.shape) == tuple(x.shape)
              and bool(torch.isfinite(y).all()), "bf16 batch output")
        y32 = f32(x)
        rel = rel_l2(y, y32)
        check(BF16_MIN_REL_L2 <= rel <= BF16_REL_L2,
              f"bf16 vs float32 batch: {rel}")
        prof = device_profile(torch, lambda: model(x),
                              names=(B1_BF16_SYMBOL, "residual_unit_kernel"))
        check(prof["named_count"] == {B1_BF16_SYMBOL: 16,
                                      "residual_unit_kernel": 0},
              f"bf16 forward profile: {prof['named_count']}")
        times, times32 = [], []
        for _ in range(10):
            times.append(cuda_ms(torch, lambda: model(x), iters=1,
                                 warmup=0))
            times32.append(cuda_ms(torch, lambda: f32(x), iters=1,
                                   warmup=0))
        dev, dev32 = device_ms(torch, lambda: model(x), iters=5), device_ms(
            torch, lambda: f32(x), iters=5)
    audio_s = BATCH * SAMPLES / cfg.sampling_rate
    batch_ms, batch_ms32 = statistics.median(times), statistics.median(
        times32)
    emit({"phase": "bf16", "step": "offline", "card": card, "config": "v2",
          "overrides": BF16_OVER, "batch": [BATCH, SAMPLES, 1],
          "launches": launches, "profile_b1_bf16_count":
          prof["named_count"][B1_BF16_SYMBOL],
          "b1_bf16_share": prof["named_ms"][B1_BF16_SYMBOL]
          / prof["device_ms"],
          "rel_l2_vs_float32": rel, "rel_l2_bound": BF16_REL_L2,
          "batch_ms": batch_ms, "batch_ms_float32": batch_ms32,
          "rtf": batch_ms / 1e3 / audio_s,
          "device_ms": dev, "device_ms_float32": dev32,
          "batch_ms_all": times, "batch_ms_float32_all": times32})
    del f32

    # (c) the bf16 stream: eager against the CUDA graph, against the
    # offline bf16 forward past the delay, no B1 launch
    sr = StreamingRAVE(cfg, state, chunk_size=CHUNK, device=device)
    dtypes = [str(c.dtype) for c in sr.init_caches]
    check("torch.bfloat16" in dtypes and "torch.float32" in dtypes,
          f"bf16 stream caches {sorted(set(dtypes))}")
    n = BF16_STREAM_CHUNKS * CHUNK
    signal = audio[0, :n].astype(np.float32)
    sr.process_file(signal[:8 * CHUNK])  # warm-up
    sr.reset()
    reset()
    chunk_ms, outs = [], []
    for i in range(0, n, CHUNK):
        t0 = time.perf_counter()
        out = sr.forward(signal[i:i + CHUNK].reshape(1, -1, 1))
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out[0, :, 0])
    stream_launches = counts()
    check(stream_launches == only(0), f"bf16 stream launches "
          f"{stream_launches}")
    eager = torch.cat(outs).cpu().numpy()
    scan = sr.process_file_scan(signal)
    graph_err = float(np.abs(scan - eager).max())
    check(graph_err <= EXPORT_TOL, f"bf16 graph vs eager: {graph_err}")
    d = sr.total_delay_samples()
    a = y[0, :n, 0].cpu().numpy()
    m = 2 * d + 256
    a_cmp, b_cmp = a[m - d:n - d - 256], eager[m:n - 256]
    med = float(np.median(np.abs(a_cmp - b_cmp))
                / (np.abs(a_cmp).mean() + 1e-9))
    check(med < BF16_STREAM_MEDIAN,
          f"bf16 stream vs offline median rel err {med}")
    emit({"phase": "bf16", "step": "stream", "card": card, "chunk": CHUNK,
          "chunks": BF16_STREAM_CHUNKS, "cache_dtypes": {
              t: dtypes.count(t) for t in sorted(set(dtypes))},
          "launches": stream_launches, "graph_vs_eager_max_abs": graph_err,
          "delay_samples": d, "median_rel_err_vs_offline": med,
          "chunk_ms_median": statistics.median(chunk_ms),
          "chunk_ms_p80": float(np.percentile(chunk_ms, 80))})

    # (d) v2_fork convert in bf16 against float32, and the streamed
    # converter once
    fcfg = build_config(["v2_fork"], BF16_OVER)
    torch.manual_seed(SEED)
    fork32 = RAVE(build_config(["v2_fork"], ["fused_kernels=true"]),
                  device=device).eval()
    fstate = fork32.state_dict()
    fork = RAVE(fcfg, device=device).eval()
    fork.load_state_dict(fstate)
    speakers = voices(np, VC_SPEAKERS, VC_SAMPLES)
    half = VC_SAMPLES // 2
    src = torch.tensor(speakers[:, :half, None], device=device)
    tgt = torch.tensor(np.roll(speakers, -1, axis=0)[:, half:, None],
                       device=device)
    with torch.inference_mode():
        reset()
        yc = fork.convert(src, tgt)
        torch.cuda.synchronize()
        convert_launches = counts()
        check(convert_launches == only(16),
              f"bf16 convert launches {convert_launches}")
        check(bool(torch.isfinite(yc).all()), "bf16 convert not finite")
        yc32 = fork32.convert(src, tgt)
        crel = rel_l2(yc, yc32)
        check(BF16_MIN_REL_L2 <= crel <= BF16_REL_L2,
              f"bf16 vs float32 convert: {crel}")
        ctimes, ctimes32 = [], []
        for _ in range(5):
            ctimes.append(cuda_ms(torch, lambda: fork.convert(src, tgt),
                                  iters=1, warmup=0))
            ctimes32.append(cuda_ms(torch, lambda: fork32.convert(src, tgt),
                                    iters=1, warmup=0))
    del fork32, fork
    vc = VoiceConverter(fcfg, fstate, chunk_size=VC_CHUNK, device=device)
    vc.speaker_table = vc.table_from_clips(list(speakers))
    vc.set_speaker(1)
    reset()
    vc_ms, vouts = [], []
    for i in range(BF16_VC_CHUNKS):
        t0 = time.perf_counter()
        vouts.append(vc.forward(speakers[0, i * VC_CHUNK:(i + 1) * VC_CHUNK]))
        vc_ms.append((time.perf_counter() - t0) * 1e3)
    vc_launches = counts()
    check(vc_launches == only(0), f"bf16 VoiceConverter launches "
          f"{vc_launches}")
    check(all(np.isfinite(v).all() for v in vouts),
          "bf16 VoiceConverter output not finite")
    emit({"phase": "bf16", "step": "convert", "card": card,
          "config": "v2_fork", "overrides": BF16_OVER,
          "batch": [VC_SPEAKERS, half, 1], "launches": convert_launches,
          "rel_l2_vs_float32": crel, "rel_l2_bound": BF16_REL_L2,
          "convert_ms": statistics.median(ctimes),
          "convert_ms_float32": statistics.median(ctimes32),
          "voice_converter": {"chunk": VC_CHUNK, "chunks": BF16_VC_CHUNKS,
                              "launches": vc_launches,
                              "chunk_ms_median": statistics.median(vc_ms)}})
    del vc

    # (e) the bf16 forward package in the C++ host against the Python
    # stream of the same chunks
    host = native.build_host(device)
    exp = bfx["dir"]
    compiled = compiled_packages(nv2)[exp]
    manifest = (exp / "io_manifest.txt").read_text()
    check("bfloat16" in manifest, "bf16 manifest without bfloat16 caches")
    n = BF16_HOST_BLOCKS * CHUNK
    signal = audio[0, :n].astype(np.float32)
    xb = signal.reshape(BF16_HOST_BLOCKS, CHUNK)
    res, yh, _, _ = serve_native(torch, np, exp, "forward", xb, host, device,
                                 compiled)
    want = sr.process_file(signal).reshape(BF16_HOST_BLOCKS, CHUNK)
    hrel = rel_l2(yh, want)
    check(hrel <= BF16_HOST_REL_L2, f"bf16 host vs Python stream: {hrel}")
    emit({"phase": "bf16", "step": "native", "card": card, "config": "v2",
          "overrides": BF16_OVER, "chunk": CHUNK,
          "chunk_ms_of_audio": CHUNK / cfg.sampling_rate * 1e3,
          "rel_l2_vs_python_stream": hrel,
          "max_abs_err_vs_python_stream": float(np.abs(yh - want).max()),
          "rel_l2_bound": BF16_HOST_REL_L2,
          "serialize_s": nv2["serialize_s"][exp],
          **{k: res[k] for k in ("blocks", "block_ms_p50", "block_ms_p80",
                                 "pipelined_rtf", "blocking_rtf", "loaded_s",
                                 "compile_s", "package_mb", "cuda_graph")},
          "phase_seconds": time.perf_counter() - t_phase})
    return {"forward": launches["residual_unit_bf16"],
            "convert": convert_launches["residual_unit_bf16"],
            "stream_chunk": stream_launches["residual_unit_bf16"]
            / BF16_STREAM_CHUNKS, **kern}


# phase 18: bf16 training (ROADMAP A10b) and the bf16 instances of B2/B3
CI1_BF16_ULPS = 1.0      # B2/B3-bf16 vs float32 arithmetic rounded once
B3_BF16_SYMBOL = "ci1_dx_bf16_mma_kernel"
B3_BF16_THREADS = 128    # four warps, each feeding its own ring
B3_BF16_STAGES = 2       # slots of a warp's ring
# cold device times: at least this many bytes pass between two reads
# of one copy of a launch's operands (the H100's L2 holds 50 MB)
COLD_BYTES = 100e6
# B1-bf16's backward (autograd of the bf16 twin) against autograd of the
# plain bf16 composition: the same arithmetic, but cuDNN's bf16 weight
# gradients split their sums in an order that may change between calls
B1_BF16_GRAD_ULPS = 2.0
# a bf16 G step card vs CPU (both bf16): the two devices' convs sum in
# another order, which flips a bf16 rounding now and then; the float32
# step of the same weights on the card, which misses every bf16 rounding,
# is the control that must miss it.  Set between the two readings of the
# largest relative error over the losses and ENC/DEC gradient norms at 2
# x 65536 (NVIDIA H100 80GB HBM3, 700.00 W): the bf16 step 6.3e-3 (the
# ENC norm), the float32 control 2.8e-2 (the audio distance)
BF16_TRAIN_RTOL = 1.3e-2
BF16_CLI_STEPS = 4       # steps of the bf16 train command
# 18(f): every other preset the JAX package trains in bf16, at its own
# width (the stack, its overrides, the batch rows); ``hybrid`` is refused
# at build in both packages (ROADMAP C)
BF16_PRESETS = {
    "v1": (["v1"], [], PAIR_BATCH),
    "onnx": (["onnx"], [], PAIR_BATCH),
    "raspberry": (["raspberry"], [], PAIR_BATCH),
    "v2_noise_wasserstein": (["v2", "noise", "wasserstein"], [], PAIR_BATCH),
    "v2_spherical_causal": (["v2", "spherical", "causal"], [], PAIR_BATCH),
    "v3": (["v3"], [], PAIR_BATCH),
    "discrete": (["discrete"], [], PAIR_BATCH),
    "discrete_v3": (["discrete_v3"], [], PAIR_BATCH),
    "v2_fork_pitch": (["v2_fork", "pitch"], [], PAIR_BATCH),
    # four distinct speakers: at two rows the cohort norm maps every
    # embedding to +-1
    "v2_fork_scratch": (["v2_fork"], [
        "train_speaker_encoder=true", "speaker_classes=4",
        "latent_adversary_weight=0.5"], 4),
}
BF16_PRESET_SAMPLES = 65536


def ci1_bf16_case(torch, ci, x, w, gy, pad) -> dict:
    """B2-bf16 and B3-bf16 at one shape against float32 arithmetic on the
    same bf16 operands rounded once (bf16 ulps of max |y|), and the cuDNN
    bf16 twin's distance from the same."""
    out = {}
    for name, cuda_fn, plain_fn, arg in (
            ("fwd", ci.conv1d_ci1_cuda, ci.conv1d_ci1_reference, x),
            ("dx", ci.conv1d_ci1_dx_cuda, ci.conv1d_ci1_dx_reference, gy)):
        got = cuda_fn(arg, w, pad)
        twin = plain_fn(arg, w, pad)
        ref = plain_fn(arg.float(), w.float(), pad).to(torch.bfloat16)
        torch.cuda.synchronize()
        check(got.dtype == torch.bfloat16 and got.shape == ref.shape,
              f"B2/B3-bf16 {name}: {got.dtype} {tuple(got.shape)}")
        ulp = bf16_ulp(ref.float())
        err = (got.float() - ref.float()).abs().max().item()
        out[name] = {"max_abs_err": err, "ulps": err / ulp,
                     "twin_ulps": (twin.float() - ref.float()).abs().max()
                     .item() / ulp}
    return out


def ci1_raw(torch, kern, big, w, out, pad_arg):
    """One B2 or B3 launch of ``kern`` (this checkout's or an earlier
    commit's) on operands prepared once, ``big`` x or g and ``out`` its
    output: no wrapper work, what a CUDA graph of raw launches
    replays."""
    B, _, T = big.shape
    args = (big.data_ptr(), w.data_ptr(), out.data_ptr(), B, w.shape[0],
            w.shape[2], T, pad_arg)

    def launch():
        kern.launch(*args, torch.cuda.current_stream().cuda_stream)
        return out
    launch.operands = (big, w, out)  # kept alive with the closure
    return launch


def rotating(fns):
    """A function that calls the next of ``fns`` each time, in turn: over
    copies of the operands, a CUDA graph of a multiple of ``len(fns)``
    calls reads each copy again only after every other one."""
    calls = itertools.count()
    return lambda: fns[next(calls) % len(fns)]()


def cold_copies(nbytes: int) -> int:
    """Copies of the operands of a launch that moves ``nbytes`` so that at
    least ``COLD_BYTES`` pass between two reads of the same copy."""
    return 1 + -(-int(COLD_BYTES) // nbytes)


def phase_bf16_ci1_kernels(torch, ci, main_shapes, parent=None) -> dict:
    """18(a): B2-bf16 and B3-bf16 over phase 2's grid (odd T, unaligned
    windows, k up to 16, co up to 64, T = 1), B3-bf16's cp.async staging
    on aligned T (g a view at storage offsets 1-7) and its TMA staging at
    co 1, 24, 64, k 2, 16 and every window shift of k = 16; then at the
    main path's shapes: the launch geometry, ``RAW_REPEATS`` raw launches
    of B3-bf16 each bit-equal to the first and to the wrapper's output,
    call times, and device times by CUDA events around CUDA graphs of raw
    launches, cold (over ``cold_copies`` copies of the operands) and warm
    (one copy), the profiler's beside them, cuDNN's (the twin, the
    library call) cold, B3-bf16's cp.async staging cold (g at storage
    offset 1), and the byte bound.  ``parent``, the (bf16, float32) B3 kernels
    built from an earlier commit, is held to the same ulps (bf16) and
    bit-equal to this checkout's float32 B3, and its B3-bf16 timed cold
    in turns with this one: parent, new, new, parent.  Returns the
    worst errors, the rows and the B3-bf16 sums per shape and per G
    step."""
    bf = torch.bfloat16
    worst = {n: {"max_abs_err": 0.0, "ulps": 0.0, "twin_ulps": 0.0}
             for n in ("fwd", "dx")}

    def hold(r, what):
        for name, v in r.items():
            check(v["ulps"] <= CI1_BF16_ULPS,
                  f"B2/B3-bf16 {name} {what}: {v['ulps']} ulps")
            for k in v:
                worst[name][k] = max(worst[name][k], v[k])

    n = 0
    cases = [(B, T, k, pad, 16, 0) for T in (777, 1000, 4096, 8192, 91232)
             for k in (5, 15) for pad in (((k - 1) // 2, k // 2), (k - 1, 0))
             for B in (1, 16)]
    cases += [(3, T, k, pad, (1, 24, 64)[i % 3], 0) for i, (T, k, pad) in
              enumerate((T, k, pad) for T in (1, 31, 1001, 8193)
                        for k in (2, 8, 16)
                        for pad in (((k - 1) // 2, k // 2), (0, k - 1)))]
    # B3-bf16's cp.async staging on aligned T: g a view at storage offsets
    # 1-7 (per-row shifts); its TMA staging at other widths and taps, and
    # T = 1 and 8; TMA at every shift S = -pad_right mod 8 of k = 16 and at
    # k = 15, pad_right 4, bands that end past three pieces (S + k > 17)
    cases += [(1, T, 15, (7, 7), 16, off) for T in (8, 1024, 91232)
              for off in range(1, 8)]
    cases += [(2, T, k, pad, co, 0) for co in (1, 24, 64) for k in (2, 16)
              for T in (1, 8, 4096)
              for pad in (((k - 1) // 2, k // 2), (k - 1, 0))]
    cases += [(1, 1024, 16, (15 - pr, pr), 16, 0) for pr in range(16)]
    cases += [(1, 1024, 15, (10, 4), 16, 0)]
    for B, T, k, pad, co, off in cases:
        x, w, gy = (t.to(bf) for t in ci1_inputs(torch, B, T, k, co=co,
                                                 seed=n))
        if off:
            gy = torch.cat([gy.new_zeros(off), gy.flatten()])[off:].view(
                gy.shape)
        hold(ci1_bf16_case(torch, ci, x, w, gy, pad),
             f"T={T} k={k} pad={pad} B={B} co={co} offset={off}")
        n += 1
    # dx and dw through the autograd.Function against autograd of the
    # plain bf16 composition (dw is cuDNN's in both)
    x, w, gy = (t.to(bf) for t in ci1_inputs(torch, 4, 8192, 15, seed=99))
    args = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    ref = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    ci.conv1d_ci1(*args, (7, 7)).backward(gy)
    ci.conv1d_ci1_reference(*ref, (7, 7)).backward(gy)
    grad_ulps = [(a.grad.float() - r.grad.float()).abs().max().item()
                 / bf16_ulp(r.grad.float()) for a, r in zip(args, ref)]
    check(all(u <= B1_BF16_GRAD_ULPS for u in grad_ulps),
          f"B2/B3-bf16 autograd: dx, dw {grad_ulps} ulps")
    # a launch that is the first CUDA call of its host thread (as in
    # autograd's backward thread) equals the main thread's
    import threading
    got = []
    th = threading.Thread(target=lambda: got.append(
        ci.conv1d_ci1_dx_cuda(gy, w, (7, 7))))
    th.start()
    th.join()
    check(len(got) == 1 and torch.equal(
        got[0], ci.conv1d_ci1_dx_cuda(gy, w, (7, 7))),
        "B3-bf16 launched from a new host thread")
    emit({"phase": "bf16_train", "step": "ci1_kernels", "cases": n,
          "worst": worst, "ulps_bound": CI1_BF16_ULPS,
          "autograd_ulps_dx_dw": grad_ulps})

    old, old32 = parent or (None, None)
    shapes = []
    for B, T in main_shapes:
        x, w, gy = (t.to(bf) for t in ci1_inputs(torch, B, T, 15, seed=T))
        r = ci1_bf16_case(torch, ci, x, w, gy, (7, 7))
        hold(r, f"main-path shape {(B, T)}")
        info = ci.dx_launch_info(B, 16, 15, T, bf)
        # a persistent grid of two CTAs per SM, at most one (batch row,
        # 128-step tile) pair per warp (a CTA has four); TMA staging
        items = B * -(-T // 128)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        check(info["threads"] == B3_BF16_THREADS
              and info["stages"] == B3_BF16_STAGES and info["tma"] == 1
              and info["blocks"] == min(2 * sms, -(-items // 4)),
              f"B3-bf16 {(B, T)}: {info}")
        row = {"shape": [B, T, 16], "k": 15, "pad": [7, 7],
               "dx_launch": info}
        with torch.no_grad():
            want = ci.conv1d_ci1_dx_cuda(gy, w, (7, 7))
            raw = ci1_raw(torch, ci.DX_BF16, gy, w, torch.empty_like(want),
                          7)
            first = raw().clone()
            same = sum(torch.equal(raw(), first) for _ in range(RAW_REPEATS))
            check(same == RAW_REPEATS and torch.equal(first, want),
                  f"B3-bf16 {(B, T)}: {RAW_REPEATS - same} of "
                  f"{RAW_REPEATS} raw launches differ from the first, "
                  f"first equal to the wrapper's: "
                  f"{torch.equal(first, want)}")
            if old:
                twin = ci.conv1d_ci1_dx_reference(gy, w, (7, 7)).float()
                got = ci1_raw(torch, old, gy, w, torch.empty_like(want), 7)()
                parent_ulps = ((got.float() - twin).abs().max().item()
                               / bf16_ulp(twin))
                check(parent_ulps <= CI1_BF16_ULPS, f"B3-bf16 parent "
                      f"{(B, T)}: {parent_ulps} ulps")
                g32, w32 = gy.float(), w.float()
                new32 = ci.conv1d_ci1_dx_cuda(g32, w32, (7, 7))
                got32 = ci1_raw(torch, old32, g32, w32,
                                torch.empty_like(new32), 7)()
                check(torch.equal(new32, got32), f"float32 B3 {(B, T)}: "
                      "this checkout's differs from the parent's")
                row["parent_ulps"] = parent_ulps
                row["float32_b3_equal_to_parent"] = True
            for name, kern, cuda_fn, plain_fn, big, kname in (
                    ("fwd", ci.FORWARD_BF16, ci.conv1d_ci1_cuda,
                     ci.conv1d_ci1_reference, x, "ci1_fwd_kernel"),
                    ("dx", ci.DX_BF16, ci.conv1d_ci1_dx_cuda,
                     ci.conv1d_ci1_dx_reference, gy, B3_BF16_SYMBOL)):
                kernel = lambda: cuda_fn(big, w, (7, 7))  # noqa: E731
                plain = lambda: plain_fn(big, w, (7, 7))  # noqa: E731
                out = kernel()
                nbytes = 2 * (big.numel() + out.numel() + w.numel())
                copies = cold_copies(nbytes)
                bigs = [big] + [big.clone() for _ in range(copies - 1)]
                raws = [ci1_raw(torch, kern, b_, w, torch.empty_like(out), 7)
                        for b_ in bigs]
                cold = rotating(raws)
                plain_cold = rotating([
                    lambda b_=b_: plain_fn(b_, w, (7, 7)) for b_ in bigs])
                launches = copies * -(-GRAPH_LAUNCHES // copies)
                # call times: plain, kernel, kernel, plain; best of each
                plain_ms = cuda_ms(torch, plain)
                ms = cuda_ms(torch, kernel)
                ms2 = cuda_ms(torch, kernel)
                plain_ms2 = cuda_ms(torch, plain)
                olds = name == "dx" and old and rotating([
                    ci1_raw(torch, old, b_, w, torch.empty_like(out), 7)
                    for b_ in bigs])
                runs = [graph_ms(torch, fn, launches) for fn in (
                    (olds, cold, cold, olds) if olds else (cold, cold))]
                dev, dev2 = runs[1:3] if olds else runs
                if name == "dx":
                    # B3-bf16's cp.async staging on the same shape and
                    # work: each copy of g a view at storage offset 1
                    offs = [torch.cat([b_.new_zeros(1), b_.flatten()])[1:]
                            .view(b_.shape) for b_ in bigs]
                    cpa = rotating([ci1_raw(torch, kern, b_, w,
                                            torch.empty_like(out), 7)
                                    for b_ in offs])
                    cp_async_ms = min(graph_ms(torch, cpa, launches)
                                      for _ in range(2))
                    del offs, cpa
                flops = 2 * B * T * 16 * 15
                t_ops = flops / PEAK_F32_FLOPS * 1e3
                t_bytes = nbytes / PEAK_BYTES * 1e3
                row[name] = {
                    **r[name], "ms": min(ms, ms2),
                    "plain_ms": min(plain_ms, plain_ms2),
                    "device_ms": min(dev, dev2),
                    "device_ms_runs": [dev, dev2],
                    "device_ms_worst": max(dev, dev2),
                    "device_ms_warm": graph_ms(torch, raws[0]),
                    "cold_copies": copies,
                    **({"parent_device_ms_runs": [runs[0], runs[3]],
                        "parent_device_ms": min(runs[0], runs[3])}
                       if olds else {}),
                    "profiler_device_ms": named_device_ms(torch, kernel,
                                                          kname),
                    "plain_device_ms": graph_ms(torch, plain_cold,
                                                launches),
                    "plain_profiler_device_ms": device_ms(torch, plain),
                    # B3's: its cp.async staging, cold; the card's read
                    # rate, one PyTorch call that only reads g (a sum
                    # over its channels), cold
                    **({"cp_async_device_ms": cp_async_ms,
                        "read_device_ms": graph_ms(torch, rotating([
                            lambda b_=b_: b_.sum(dim=1) for b_ in bigs]),
                            launches)} if name == "dx" else {}),
                    "bound_ms": max(t_ops, t_bytes), "ops_ms": t_ops,
                    "bytes_ms": t_bytes}
                del bigs, raws, cold, plain_cold, olds
        shapes.append(row)
        torch.cuda.empty_cache()
    keys = ("device_ms", "device_ms_worst", "device_ms_warm",
            "cp_async_device_ms", "plain_device_ms", "read_device_ms",
            "bound_ms") + (
        ("parent_device_ms",) if parent else ())
    per_call = {f"{s['shape']}": {k: s["dx"][k] for k in keys}
                for s in shapes}
    per_call["g_step"] = {k: sum(s["dx"][k] for s in shapes) for k in keys}
    emit({"phase": "bf16_train", "step": "ci1_kernel_times",
          "shapes": shapes,
          "device_ms": "CUDA events around a graph of raw launches "
                       f"(a multiple of the cold copies, at least "
                       f"{GRAPH_LAUNCHES}) x {GRAPH_REPLAYS}; cold: "
                       f">= {COLD_BYTES / 1e6:.0f} MB between two reads "
                       "of a copy; warm: one copy",
          "b3_bf16_per_call": per_call})
    return {"worst": worst, "shapes": shapes, "per_call": per_call}


def phase_bf16_b1_backward(torch, ru) -> dict:
    """18(b): B1-bf16's backward at the three B = 8 step shapes: the
    gradients of all five operands through the kernel's
    ``autograd.Function`` against autograd of the plain bf16 composition,
    within ``B1_BF16_GRAD_ULPS`` of each gradient's max |g|: the wiring
    of the backward, which is autograd of that composition."""
    bf = torch.bfloat16
    rows = []
    for C, T, d in ((128, SAMPLES // 64, 9), (256, SAMPLES // 256, 9),
                    (512, SAMPLES // 512, 3)):
        base = [a.to(bf) for a in unit_inputs(torch, TRAIN_BATCH, C, T,
                                               seed=C + 7)]
        dev = base[0].device
        g = torch.randn(TRAIN_BATCH, C, T, device=dev, generator=torch
                        .Generator(device=dev.type).manual_seed(C)).to(bf)
        args = [a.clone().requires_grad_(True) for a in base]
        ref = [a.clone().requires_grad_(True) for a in base]
        pl, pr = pads(3, d)
        ru.residual_unit(*args, d, pl, pr).backward(g)
        ru.residual_unit_reference(*ref, d, pl, pr).backward(g)
        torch.cuda.synchronize()
        ulps = {n: (a.grad.float() - r.grad.float()).abs().max().item()
                / bf16_ulp(r.grad.float())
                for n, a, r in zip(("x", "w1", "b1", "w2", "b2"), args, ref)}
        check(all(a.grad.dtype == bf for a in args),
              f"B1-bf16 backward dtypes {[a.grad.dtype for a in args]}")
        check(max(ulps.values()) <= B1_BF16_GRAD_ULPS,
              f"B1-bf16 backward {(TRAIN_BATCH, T, C)} d={d}: {ulps} ulps")
        rows.append({"shape": [TRAIN_BATCH, T, C], "dilation": d,
                     "ulps": ulps})
    emit({"phase": "bf16_train", "step": "b1_backward", "shapes": rows,
          "ulps_bound": B1_BF16_GRAD_ULPS})
    return {"shapes": rows}


def phase_bf16_train(torch, np, KERNELS, card, cli_res, device="cuda"):
    """Phase 18 (see the module docstring): B2/B3-bf16, B1-bf16's
    backward, the full-width bf16 ``v2_fork`` and ``v2`` steps, and the
    bf16 train command's result (run earlier, while phase 9's db
    existed).  Returns the launches and the kernels' numbers."""
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.ops.kernels import ci1_conv as ci
    from rave_tpu_torch.ops.kernels import residual_unit as ru
    from rave_tpu_torch.train import loop, schedules

    t_phase = time.perf_counter()
    counts = lambda: {k.name: k.launches for k in KERNELS}  # noqa: E731

    def reset():
        for k in KERNELS:
            k.launches = 0

    ci1 = phase_bf16_ci1_kernels(torch, ci, CI1_MAIN)
    b1 = phase_bf16_b1_backward(torch, ru)
    torch.cuda.empty_cache()

    def launches_of(b1_n, fwd_n, dx_n):
        return {k.name: 0 for k in KERNELS} | {
            "residual_unit_bf16": b1_n, "ci1_conv_forward_bf16": fwd_n,
            "ci1_conv_dx_bf16": dx_n}

    # (c) the full-width bf16 v2_fork, frozen speaker encoder: D, G, G, G
    cfg = build_config(["v2_fork"], BF16_OVER)
    cfg32 = build_config(["v2_fork"], ["fused_kernels=true"])
    torch.manual_seed(SEED)
    state = loop.TrainState(cfg, device=device, step=cfg.phase_1_duration)
    step_fn = loop.make_train_step(cfg)
    batch = train_batch(torch, np, TRAIN_BATCH, cfg.n_signal, 148,
                        device=device)
    groups = {"dis": list(state.disc.parameters()),
              "enc": state.enc_params, "dec": state.dec_params,
              "speaker": list(state.model.speaker_encoder.parameters())}
    kind_of = lambda st: ("D" if schedules.is_discriminator_step(  # noqa
        st.step, st.cfg) else "G")
    cycle = []
    for _ in range(4):
        kind = kind_of(state)
        before = {g: [p.detach().clone() for p in ps]
                  for g, ps in groups.items()}
        reset()
        values = {k: float(v) for k, v in step_fn(state, batch).items()}
        torch.cuda.synchronize()
        got = counts()
        want = launches_of(16, 3, 3 if kind == "G" else 0)
        check(got == want, f"bf16 v2_fork {kind} step launches {got}")
        check(sorted(values) == TRAIN_METRICS
              and all(np.isfinite(v) for v in values.values()),
              f"bf16 v2_fork {kind} step metrics {values}")
        moved = {g: any(not torch.equal(p, q) for p, q in zip(ps, before[g]))
                 for g, ps in groups.items()}
        want_moved = {"dis": kind == "D", "enc": kind == "G",
                      "dec": kind == "G", "speaker": False}
        check(moved == want_moved, f"bf16 v2_fork {kind} step moved {moved}")
        check(all(p.dtype == torch.float32 for ps in groups.values()
                  for p in ps), "bf16 v2_fork: parameters not float32")
        cycle.append({"kind": kind, "launches": got, "metrics": values})
    check([c["kind"] for c in cycle] == ["D", "G", "G", "G"],
          f"bf16 v2_fork cycle {[c['kind'] for c in cycle]}")
    del before

    # timed: a bf16 cycle and a float32 one of the same weights, in turns
    f32 = loop.TrainState(cfg32, device=device, step=state.step)
    f32.model.load_state_dict(state.model.state_dict())
    f32.disc.load_state_dict(state.disc.state_dict())
    f32_fn = loop.make_train_step(cfg32)
    for _ in range(2):   # float32 warm-up: a D and a G step
        f32_fn(f32, batch)
    times = {"bfloat16": {"D": [], "G": []}, "float32": {"D": [], "G": []}}
    peak = {}
    for name, st, fn in (("bfloat16", state, step_fn),
                         ("float32", f32, f32_fn)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(TIMED_CYCLES * 4):
            kind = kind_of(st)
            times[name][kind].append(cuda_ms(torch, lambda: fn(st, batch),
                                              iters=1, warmup=0))
        peak[name] = torch.cuda.max_memory_allocated() / 2 ** 20
    del f32, f32_fn
    step_ms = {n: {k: statistics.median(v) for k, v in t.items()}
               for n, t in times.items()}
    del state, step_fn, batch
    torch.cuda.empty_cache()

    # one short bf16 G step of PAIR_BATCH rows, card vs CPU, both in bf16
    # (the CPU's threads, as phase 6's float32 step); the float32 step of
    # the same weights on the card is the control
    over = ["n_signal=65536", f"batch_size={PAIR_BATCH}"]
    short = build_config(["v2_fork"], BF16_OVER + over)
    short32 = build_config(["v2_fork"], ["fused_kernels=true", *over])
    g_step = short.phase_1_duration + 1
    torch.manual_seed(SEED + 1)
    card_st = loop.TrainState(short, device=device, step=g_step)
    weights = ({k: v.cpu() for k, v in card_st.model.state_dict().items()},
               {k: v.cpu() for k, v in card_st.disc.state_dict().items()})
    cpu_st = loop.TrainState(short, device="cpu", step=g_step)
    ctrl_st = loop.TrainState(short32, device=device, step=g_step)
    for st in (cpu_st, ctrl_st):
        st.model.load_state_dict(weights[0])
        st.disc.load_state_dict(weights[1])
    sb = train_batch(torch, np, PAIR_BATCH, short.n_signal, 74,
                     seed=SEED + 4, device=device)
    short_fn = loop.make_train_step(short)
    reset()
    m_card = {k: float(v) for k, v in short_fn(card_st, sb).items()}
    short_launches = counts()
    check(short_launches == launches_of(16, 2, 2),
          f"bf16 short G step launches {short_launches}")
    m_cpu = {k: float(v) for k, v in short_fn(
        cpu_st, {k: v.cpu() for k, v in sb.items()}).items()}
    m_ctrl = {k: float(v) for k, v in loop.make_train_step(short32)(
        ctrl_st, sb).items()}

    def norms(st):
        return {g: float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                        for p in ps)))
                for g, ps in (("enc", st.enc_params), ("dec", st.dec_params))}

    def rel_to_cpu(m, n):
        rel = {k: abs(m[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12)
               for k in m_cpu if m_cpu[k] != 0 or m[k] != 0}
        rel.update({f"grad_norm_{g}": abs(n[g] - n_cpu[g]) / n_cpu[g]
                    for g in n_cpu})
        return rel

    n_card, n_cpu, n_ctrl = norms(card_st), norms(cpu_st), norms(ctrl_st)
    rel, rel_ctrl = rel_to_cpu(m_card, n_card), rel_to_cpu(m_ctrl, n_ctrl)
    emit({"phase": "bf16_train", "step": "card_vs_cpu", "rel_err": rel,
          "float32_control_rel_err": rel_ctrl, "rtol": BF16_TRAIN_RTOL})
    check(max(rel.values()) <= BF16_TRAIN_RTOL,
          f"bf16 card vs cpu G step: {rel}")
    check(max(rel_ctrl.values()) > BF16_TRAIN_RTOL,
          f"the float32 control passes the bf16 card vs cpu rtol: "
          f"{rel_ctrl}")
    del card_st, cpu_st, ctrl_st
    emit({"phase": "bf16_train", "step": "v2_fork", "card": card,
          "config": "v2_fork", "overrides": BF16_OVER,
          "batch": [TRAIN_BATCH, cfg.n_signal, 1],
          "start_step": cfg.phase_1_duration, "warmup_cycle": cycle,
          "step_ms": step_ms, "step_ms_all": times, "peak_mem_mb": peak,
          "card_vs_cpu": {"rel_err": rel, "rtol": BF16_TRAIN_RTOL,
                          "rows": PAIR_BATCH,
                          "float32_control_rel_err": rel_ctrl,
                          "launches": short_launches,
                          "card": m_card, "grad_norms_card": n_card,
                          "grad_norms_cpu": n_cpu}})

    # (d) the full-width bf16 v2: one D and one G step, B1-bf16 only
    vcfg = build_config(["v2"], BF16_OVER)
    torch.manual_seed(SEED)
    vst = loop.TrainState(vcfg, device=device, step=vcfg.phase_1_duration)
    vfn = loop.make_train_step(vcfg)
    vbatch = {"x": train_batch(torch, np, TRAIN_BATCH, vcfg.n_signal, 1,
                               device=device)["x"]}
    v2_steps = {}
    for _ in range(2):   # v2 from phase_1_duration: D, then G
        kind = kind_of(vst)
        reset()
        values = {k: float(v) for k, v in vfn(vst, vbatch).items()}
        torch.cuda.synchronize()
        got = counts()
        check(got == launches_of(16, 0, 0),
              f"bf16 v2 {kind} step launches {got}")
        check(sorted(values) == TRAIN_V2_METRICS
              and all(np.isfinite(v) for v in values.values()),
              f"bf16 v2 {kind} step metrics {values}")
        v2_steps[kind] = {"launches": got, "metrics": values}
    check(sorted(v2_steps) == ["D", "G"], f"bf16 v2 steps {sorted(v2_steps)}")
    del vst, vfn, vbatch
    torch.cuda.empty_cache()
    emit({"phase": "bf16_train", "step": "v2", "card": card,
          "overrides": BF16_OVER, "batch": [TRAIN_BATCH, SAMPLES, 1],
          "steps": v2_steps, "cli": cli_res})
    presets = phase_bf16_presets(torch, np, KERNELS, counts, reset,
                                 device)
    emit({"phase": "bf16_train", "step": "presets", "card": card,
          "samples": BF16_PRESET_SAMPLES, "presets": presets,
          "phase_seconds": time.perf_counter() - t_phase})
    return {"ci1": ci1, "b1_backward": b1,
            "launches_v2_fork": {c["kind"]: c["launches"] for c in cycle},
            "launches_v2": {k: v["launches"] for k, v in v2_steps.items()},
            "launches_presets": {n: p["launches"]
                                 for n, p in presets.items()}}


def phase_bf16_presets(torch, np, KERNELS, counts, reset, device="cuda"):
    """18(f): one bf16 D step and one bf16 G step of every preset in
    ``BF16_PRESETS`` at its own width (``fused_kernels=true``), from
    ``phase_1_duration``: finite metrics, DIS moving on D and only on D,
    ENC, DEC (and SPK with a trained speaker encoder) on G and only on G,
    the parameters float32, every discriminator conv reading bf16."""
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.models.discriminators import WNConv
    from rave_tpu_torch.train import loop, schedules

    out = {}
    for name, (stack, extra, rows) in BF16_PRESETS.items():
        t0 = time.perf_counter()
        cfg = build_config(stack, BF16_OVER + extra + [
            f"n_signal={BF16_PRESET_SAMPLES}", f"batch_size={rows}"])
        torch.manual_seed(SEED)
        st = loop.TrainState(cfg, device=device, step=cfg.phase_1_duration)
        fn = loop.make_train_step(cfg)
        batch = train_batch(torch, np, rows, cfg.n_signal,
                            cfg.n_signal * 148 // SAMPLES, seed=SEED + 5,
                            device=device)
        if not cfg.hubert_units:
            del batch["units"]
        if cfg.speaker_classes:
            batch["speaker"] = torch.arange(rows, device=device)
        if cfg.pitch_embedding_size:
            batch["f0_median"] = torch.log(torch.linspace(
                110.0, 220.0, rows, device=device))
            batch["f0_std"] = torch.full((rows,), 0.3, device=device)
        groups = {"dis": list(st.disc.parameters()),
                  "enc": st.enc_params, "dec": st.dec_params,
                  "spk": st.spk_params}
        reads = set()
        hooks = [m.register_forward_pre_hook(
            lambda mod, args: reads.add(args[0].dtype))
            for m in st.disc.modules() if isinstance(m, WNConv)]
        steps = {}
        for _ in range(2):
            kind = ("D" if schedules.is_discriminator_step(st.step, cfg)
                    else "G")
            before = {g: [p.detach().clone() for p in ps]
                      for g, ps in groups.items()}
            reset()
            values = {k: float(v) for k, v in fn(st, batch).items()}
            torch.cuda.synchronize()
            launches = {k: v for k, v in counts().items() if v}
            check(all(np.isfinite(v) for v in values.values()),
                  f"bf16 {name} {kind} step metrics {values}")
            moved = {g: any(not torch.equal(p, q)
                            for p, q in zip(ps, before[g]))
                     for g, ps in groups.items() if ps}
            want = {g: (g == "dis") == (kind == "D") for g in moved}
            check(moved == want, f"bf16 {name} {kind} step moved {moved}")
            steps[kind] = {"metrics": values, "launches": launches}
        for h in hooks:
            h.remove()
        check(sorted(steps) == ["D", "G"], f"bf16 {name} steps "
              f"{sorted(steps)}")
        check(reads == {torch.bfloat16}, f"bf16 {name} discriminator "
              f"reads {reads}")
        check(all(p.dtype == torch.float32 for ps in groups.values()
                  for p in ps), f"bf16 {name}: parameters not float32")
        out[name] = {"rows": rows, "steps": steps,
                     "launches": {k: v["launches"] for k, v in
                                  steps.items()},
                     "seconds": time.perf_counter() - t0}
        del st, fn, batch, groups, before
        torch.cuda.empty_cache()
    return out


def bf16_train_cli_job(db, device="cuda") -> dict:
    """18(e)'s command, started right after phase 9(b)'s train (beside
    the resume and phase 10(a)): ``python -m rave_tpu_torch.cli train``
    on a bf16 ``v2_fork`` config (the frozen speaker encoder, B1/B2/B3 in
    bf16) for ``BF16_CLI_STEPS`` steps from ``phase_1_duration=2`` with a
    validation at step 3, on phase 9(b)'s db."""
    from pathlib import Path
    runs = Path(SMOKE_DIR) / "runs_bf16"
    over = [*BF16_OVER, "phase_1_duration=2"]
    return {"runs": runs, "over": over, "job": cli_job(
        "train", "--config", "v2_fork",
        *[a for o in over for a in ("--override", o)], "--db_path", db,
        "--out_path", str(runs), "--max_steps", str(BF16_CLI_STEPS),
        "--val_every", "3", "--ckpt_every", "0", "--num_workers", "2",
        "--device", device, what="bf16 train")}


def phase_bf16_train_cli(torch, job, device="cuda") -> dict:
    """18(e): the command of :func:`bf16_train_cli_job` (``job``) has
    finished its steps and its validation; the run's checkpoint holds
    float32 tensors only, and ``load_run`` restores it into a float32
    state (the state ``export`` serves from)."""
    from rave_tpu_torch.export.streaming import load_run

    runs, over = job["runs"], job["over"]
    stdout, seconds = job["job"].result()
    check(f"finished at step {BF16_CLI_STEPS}" in stdout,
          f"bf16 train did not finish: {stdout[-2000:]}")
    run = next(runs.iterdir())
    recs = [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]
    val = [rec for rec in recs if "validation" in rec]
    check(len(val) == 1 and all(
        math.isfinite(v) for rec in recs for v in rec.values()
        if isinstance(v, float)), f"bf16 train records {recs}")
    ckpt = run / "checkpoints" / f"ckpt_{BF16_CLI_STEPS}.pt"
    saved = torch.load(ckpt, weights_only=True)

    def floats(tree):
        if torch.is_tensor(tree):
            return [tree.dtype] if tree.is_floating_point() else []
        if isinstance(tree, dict):
            return [d for v in tree.values() for d in floats(v)]
        if isinstance(tree, (list, tuple)):
            return [d for v in tree for d in floats(v)]
        return []

    dtypes = sorted({str(d) for d in floats(saved)})
    check(dtypes == ["torch.float32"], f"bf16 run checkpoint dtypes {dtypes}")
    cfg, state = load_run(str(run), device=device)
    check(cfg.compute_dtype == "bfloat16"
          and {p.dtype for p in state.model.parameters()} == {torch.float32},
          "bf16 run reloaded with non-float32 parameters")
    del state, saved
    return {"overrides": over, "steps": BF16_CLI_STEPS,
            "validation": val[0]["validation"],
            "step0": {k: v for k, v in recs[0].items()
                      if k.startswith("loss_")},
            "checkpoint_dtypes": dtypes, "seconds": seconds}


def request_audio(np):
    """The offline phase's 4 requests of ``SAMPLES`` samples: tones at
    110, 220, 440 and 880 Hz plus seeded noise."""
    rng = np.random.default_rng(SEED)
    t = np.arange(SAMPLES) / 44100
    return np.stack([0.3 * np.sin(2 * np.pi * f * t)
                     + 0.05 * rng.standard_normal(SAMPLES)
                     for f in (110.0, 220.0, 440.0, 880.0)])


def main_parallel_cards(n: int) -> int:
    """``chip_smoke.py --parallel-cards N``: phase 16(a) and (c) with N
    NCCL ranks, one per card (the real data-parallel path, which the
    one-card run can only approximate with gloo), against one process on
    card 0; ends with the usual last two lines, ``count`` N."""
    import numpy as np
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"chip_smoke: --parallel-cards {n} needs {n} CUDA cards",
              file=sys.stderr)
        return 1
    from rave_tpu_torch.config import build_config
    from rave_tpu_torch.models.rave import RAVE
    from rave_tpu_torch.ops.kernels import KERNELS
    from rave_tpu_torch.ops.kernels.build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count()})
    emit({"phase": "build", "seconds": build_all(KERNELS)})
    torch.manual_seed(SEED)
    model = RAVE(build_config(["v2"], ["fused_kernels=true"]),
                 device="cuda").eval()
    phase_parallel(torch, np, KERNELS, request_audio(np), model.state_dict(),
                   smi[0], None, ranks=n, backend="nccl")
    print(smi[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def bf16_main_shapes() -> dict:
    """The shapes the bf16 paths give B1-bf16, each mapped to its launches
    per call: the bf16 v2 forward and convert (each (C, d) once in the
    encoder and once in the generator, batch 4), phase 18's bf16 v2 and
    v2_fork D or G step (batch 8) and the bf16 discrete forward (C =
    384)."""
    T0 = SAMPLES // 16
    per_shape = {}
    for C, T, dils in ((128, T0 // 4, (1, 3, 9)), (256, T0 // 16, (1, 3, 9)),
                       (512, T0 // 32, (1, 3))):
        for d in dils:
            per_shape[("offline_v2", BATCH, T, C, d)] = 2
            per_shape[("train_v2", TRAIN_BATCH, T, C, d)] = 2
    for d in (1, 3, 9):
        per_shape[("offline_discrete", BATCH, T0 // 16, 384, d)] = 2
    return per_shape


def main_ab(flag: str, parent: str) -> int:
    """``chip_smoke.py --b1-bf16-ab DIR`` or ``--b3-bf16-ab DIR``: the
    kernel phase of B1-bf16 (17(a)) or of B2/B3-bf16 (18(a)) with the
    kernel built from ``DIR/rave_tpu_torch/csrc/`` (an unpacked earlier
    commit) timed in turns beside this checkout's (parent, new, new,
    parent); fails unless the new kernel's slower run is faster than the
    parent's faster run, per call of each path (B1-bf16) or at each
    main-path shape and per G step (B3-bf16, cold).  ``--b3-bf16-ab``
    also holds the parent's float32 B3 bit-equal to this checkout's.
    Prints the phase's lines and the usual last two."""
    from pathlib import Path

    import torch

    if not torch.cuda.is_available():
        print(f"chip_smoke: {flag} needs a CUDA card", file=sys.stderr)
        return 1
    from rave_tpu_torch.ops.kernels import ci1_conv as ci
    from rave_tpu_torch.ops.kernels import residual_unit as ru
    from rave_tpu_torch.ops.kernels.build import CudaKernel, build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi})
    csrc = Path(parent).resolve() / "rave_tpu_torch" / "csrc"

    def parent_of(kern, mod):
        return CudaKernel(f"{kern.name}_parent", str(csrc / kern.source.name),
                          kern.symbol, mod._ARGS)

    # the kernels compared, the names of their builds' functions (this
    # checkout's, the parent's), and the phase run with the parent
    if flag == "--b1-bf16-ab":
        new, old = ru.KERNEL_BF16, [parent_of(ru.KERNEL_BF16, ru)]
        names = (B1_BF16_SYMBOL, "residual_unit_bf16")

        def run():
            return phase_bf16_kernels(torch, ru, bf16_main_shapes(),
                                      parent=old[0])["per_call"]
    else:
        new, old = ci.DX_BF16, [parent_of(k, ci) for k in (ci.DX_BF16,
                                                           ci.DX)]
        names = (B3_BF16_SYMBOL, "ci1_dx_kernelI13__nv_bfloat16Li15E")

        def run():
            return phase_bf16_ci1_kernels(torch, ci, CI1_MAIN,
                                          parent=old)["per_call"]
    emit({"phase": "build", "seconds": build_all([new, *old]),
          "new": kernel_build_info(new.library_path, names[0]),
          "parent": kernel_build_info(old[0].library_path, names[1])})
    for path, s in run().items():
        check(s["device_ms_worst"] < s["parent_device_ms"],
              f"{new.name} {path}: new {s['device_ms_worst']} ms, parent "
              f"{s['parent_device_ms']}")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


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

    # 1. build every kernel from the checkout's sources; phase 13's C++
    # host builds in a thread meanwhile
    from rave_tpu_torch.export import native
    HOST_BUILD.append(Later(native.build_host, "cuda"))
    seconds = build_all(KERNELS)
    HOST_BUILD[0].result()
    ptxas = [line.strip()
             for lib in dict.fromkeys(k.library_path for k in KERNELS)
             for line in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": seconds,
          "kernels": [k.name for k in KERNELS], "ptxas": ptxas,
          "b1_bf16": kernel_build_info(ru.KERNEL_BF16.library_path,
                                       B1_BF16_SYMBOL),
          "b3_bf16": kernel_build_info(ci.DX_BF16.library_path,
                                       B3_BF16_SYMBOL)})

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
    # hybrid: its mel encoder's fusable units (dilation 1; C = 128 at 512
    # and 256 at 256 frames of 128 samples), once each per forward and
    # per train step; its decoder is v2's (the v2 shapes, once each)
    for path, B in (("offline_hybrid", BATCH), ("train_hybrid", TRAIN_BATCH)):
        for C, T in ((128, SAMPLES // 256), (256, SAMPLES // 512)):
            per_shape[(path, B, T, C, 1)] = 1

    # 2. kernels vs plain versions on the card
    max_err, shapes = phase_kernels(torch, ru, per_shape)
    ci1_err, ci1_shapes = phase_ci1_kernels(torch, ci, CI1_MAIN, CI1_DP)

    # 3. offline serving at full v2 width
    torch.manual_seed(SEED)
    cfg = build_config(["v2"], ["fused_kernels=true"])
    model = RAVE(cfg, device="cuda").eval()
    plain = RAVE(build_config(["v2"], ["fused_kernels=false"]),
                 device="cuda").eval()
    plain.load_state_dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    audio = request_audio(np)
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

    # 14(d)'s v3 package, then 15(d)'s hybrid one, compile in a niced
    # subprocess from here on
    hyb = hybrid_export(torch)
    v3 = a6_v3_export(torch, after=[hyb["item"]])
    # 13(a)'s v2 forward package, then 17(e)'s bf16 one, compile in a
    # second niced subprocess
    bfx = bf16_export(torch, model.state_dict())
    nv2 = native_v2_export(torch, model.state_dict(),
                           after=[bfx["item"]])
    try:
        return _phases(torch, np, KERNELS, smi, kind, model, x, audio,
                       launches, max_err, shapes, ci1_err, ci1_shapes, v3,
                       hyb, nv2, bfx)
    finally:
        for job in JOBS:
            if job.proc.poll() is None:
                job.stop()
        for proc in BACKGROUND:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _phases(torch, np, KERNELS, smi, kind, model, x, audio, launches,
            max_err, shapes, ci1_err, ci1_shapes, v3, hyb, nv2, bfx) -> int:
    """Phases 6-17 and the summary (see :func:`main`)."""
    from rave_tpu_torch.ops.kernels import residual_unit as ru
    # 9(b)'s corpus and db, made by the CLI at nice 10 from here on
    vc_db = train_vc_db(np)

    # 6. the v2_fork train step
    g_launches = phase_train(torch, np, KERNELS)

    # 7. the upstream v2 train step, kernel B1 inside it
    v2_launches = phase_train_v2(torch, np, KERNELS)

    # 8. voice-conversion serving of the fork, kernel B1 in convert
    vc_launches = phase_voice_conversion(torch, np, KERNELS)

    # 9. from-scratch speaker training: (b)'s 12 steps from here on,
    # beside (a), the step in both norms
    vc_cli = train_vc_cli_job(vc_db)
    vc_launches_d, vc_launches_g = phase_train_vc_step(torch, np, KERNELS,
                                                       "cohort")
    phase_train_vc_step(torch, np, KERNELS, "batch")
    torch.cuda.empty_cache()
    run, db, wavs, resume = phase_train_vc_cli(torch, np, vc_cli)
    train_vc_launches = {"D": vc_launches_d, "G": vc_launches_g}
    # 18(e): the bf16 train command, on phase 9(b)'s db, beside 9(b)'s
    # resume and phase 10(a)
    bf16_cli = bf16_train_cli_job(db)

    # 10. export: the v2 stream's CUDA graph, programs, host rate, stereo,
    # latent PCA and realtime host; then the trained run's export and
    # eval, beside phase 11
    phase_export_stream(torch, np, KERNELS, model.state_dict(), audio,
                        model, x, smi)
    torchrun = resume()
    run_jobs = export_run_jobs(run, db, wavs)

    # 11. the f0-conditioned fork: convert, FCPE, train, stream, probe
    pitch_convert, pitch_train, pitch_dir = phase_pitch(torch, np, KERNELS)
    # 13(c)'s convert_pg package and 13(d)'s CPU one compile meanwhile
    pg = native_pg_export(torch, pitch_dir)

    phase_export_run(torch, np, run, wavs, run_jobs, smi)
    # 13(b)'s input: the trained run's convert.pt2, copied out of
    # _smoke/ and compiled by a niced subprocess meanwhile
    conv = native_convert_export(np, run, wavs)
    bf16_cli = phase_bf16_train_cli(torch, bf16_cli)

    # 12. the discrete and v3 presets, kernel B1 at C = 384
    dv3 = phase_discrete_v3(torch, np, KERNELS, smi)

    # 14. v1 / onnx / raspberry, the noise generators, the Wasserstein and
    # spherical heads; the v3 native package
    a6 = phase_a6(torch, np, KERNELS, audio, smi, v3)

    # 15. the hybrid preset: mel front end, GRU layers, the loss library
    hybrid = phase_hybrid(torch, np, KERNELS, audio, smi, hyb, v3)

    # 13. native, after 14 and 15 so that its packages have compiled: (b)
    # the trained run's convert; forward, convert_pg and the refusals of
    # the C++ host
    native_convert = phase_native_convert(torch, np, conv, smi)
    phase_native(torch, np, KERNELS, model.state_dict(), audio, nv2, pg,
                 native_convert, smi)
    shutil.rmtree(SMOKE_DIR)

    # 16. data parallelism over two ranks, the CLI on NCCL, time sharding
    par = phase_parallel(torch, np, KERNELS, audio, model.state_dict(), smi,
                         torchrun)

    # 17. bf16 serving: B1-bf16, the batch, the stream, convert, the host
    bf16 = phase_bf16(torch, np, KERNELS, ru, audio, model.state_dict(), smi,
                      nv2, bfx)

    # 18. bf16 training: B2/B3-bf16, B1-bf16's backward, the v2_fork and
    # v2 steps
    bf16_train = phase_bf16_train(torch, np, KERNELS, smi, bf16_cli)

    # summary
    def total(key, path="offline_v2"):
        t = sum(s[key] * s["launches_per_call"] for s in shapes
                if s["path"] == path)
        if path.endswith("_hybrid"):
            # its decoder's units: the v2 path's, once each
            t += total(key, path.replace("hybrid", "v2")) / 2
        return t

    def hybrid_launches(name):
        return {"launches_hybrid_forward": hybrid["forward"][name],
                "launches_hybrid_train_step": {
                    k: v[name] for k, v in hybrid["train_step"].items()}}

    def par_launches(name):
        # per rank, in rank order
        return {"launches_ddp_g_step": [r[name] for r in par["g_step"]],
                "launches_time_sharded_forward": [
                    r[name] for r in par["time_sharded_forward"]]}

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
        **a6_launches(a6, "residual_unit"),
        **hybrid_launches("residual_unit"),
        **par_launches("residual_unit"),
        "launches_bf16_forward": 0,
        **{path: {k: total(k, path) for k in (
            "ms", "plain_ms", "device_ms", "plain_device_ms", "bound_ms",
            "bound_ms_f32")}
           for path in ("train_v2", "offline_discrete", "train_discrete",
                        "offline_hybrid", "train_hybrid")}}]
    # B2/B3: one launch per head and G step; the plain twin is one
    # PyTorch call (F.conv1d, conv1d_input), so it is the library time
    for name, key, line, launches in (
            ("ci1_conv_forward", "fwd", 46, g_launches["ci1_conv_forward"]),
            ("ci1_conv_dx", "dx", 73, g_launches["ci1_conv_dx"])):
        per = lambda f, path="main": sum(  # noqa: E731
            s[key][f] for s in ci1_shapes if s["path"] == path)
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
            **a6_launches(a6, name),
            **hybrid_launches(name),
            **par_launches(name),
            "library_ms": per("plain_ms"),
            "dp_rank_step": {f: per(f, "dp") for f in (
                "ms", "plain_ms", "device_ms", "plain_device_ms",
                "bound_ms")}})
    # B1-bf16: the bf16 v2 forward's shapes; no PyTorch call computes B1

    def bsum(f, path="offline_v2"):
        vals = [(s[f], s["launches_per_call"]) for s in bf16["shapes"]
                if s["path"] == path]
        if any(v is None for v, _ in vals):
            return None     # a time the profiler did not record
        return sum(v * n for v, n in vals)

    src = "rave_tpu_torch/csrc/residual_unit.cu"
    kernels.append({
        "name": "residual_unit_bf16", "route": "cuda", "source": src,
        "replaces": "rave_tpu/ops/pallas/residual_unit.py:62",
        "launches": bf16["forward"],
        "max_abs_err": bf16["worst"]["max_abs_err"],
        "ms": bsum("ms"), "plain_ms": bsum("plain_ms"),
        "device_ms": bsum("device_ms"),
        "plain_device_ms": bsum("plain_device_ms"),
        "profiler_device_ms": bsum("profiler_device_ms"),
        "bound_ms": bsum("bound_ms"),
        "bound_by": ("operations" if bsum("ops_ms") >= bsum("bytes_ms")
                     else "bytes"),
        "library_ms": None, "ulps_vs_twin": bf16["worst"]["ulps"],
        "launches_bf16_convert": bf16["convert"],
        "launches_bf16_v2_fork_train_step": {
            k: v["residual_unit_bf16"]
            for k, v in bf16_train["launches_v2_fork"].items()},
        "launches_bf16_v2_train_step": {
            k: v["residual_unit_bf16"]
            for k, v in bf16_train["launches_v2"].items()},
        "launches_bf16_stream_chunk": bf16["stream_chunk"],
        **{path: {k: bsum(k, path) for k in (
            "ms", "plain_ms", "device_ms", "plain_device_ms",
            "profiler_device_ms", "bound_ms")}
           for path in ("offline_discrete", "train_v2")}})
    # B2/B3-bf16: one launch per MelGAN head and bf16 v2_fork step (B3
    # on G steps); the twin is one cuDNN call, so it is the library time;
    # device times cold (CUDA graphs of raw launches over copies)
    ci1b = bf16_train["ci1"]
    for name, key, line in (("ci1_conv_forward_bf16", "fwd", 46),
                            ("ci1_conv_dx_bf16", "dx", 73)):
        per = lambda f: sum(s[key][f] for s in ci1b["shapes"])  # noqa
        prof = [s[key]["profiler_device_ms"] for s in ci1b["shapes"]]
        src = "rave_tpu_torch/csrc/ci1_conv.cu"
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"rave_tpu/ops/pallas/ci1_conv.py:{line}",
            "launches": bf16_train["launches_v2_fork"]["G"][name],
            "launches_bf16_v2_fork_train_step": {
                k: v[name] for k, v in bf16_train["launches_v2_fork"].items()},
            "max_abs_err": max(ci1b["worst"][key]["max_abs_err"],
                               max(s[key]["max_abs_err"]
                                   for s in ci1b["shapes"])),
            "ulps_vs_float32_rounded_once": ci1b["worst"][key]["ulps"],
            "twin_ulps_vs_float32_rounded_once":
                ci1b["worst"][key]["twin_ulps"],
            "ms": per("ms"), "plain_ms": per("plain_ms"),
            "device_ms": per("device_ms"),
            "device_ms_warm": per("device_ms_warm"),
            "profiler_device_ms": None if None in prof else sum(prof),
            "plain_device_ms": per("plain_device_ms"),
            "bound_ms": per("bound_ms"),
            "bound_by": ("operations" if per("ops_ms") >= per("bytes_ms")
                         else "bytes"),
            "library_ms": per("plain_ms")})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(par_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                          *sys.argv[5:7]))
    if sys.argv[1:2] == ["--parallel-cards"]:
        sys.exit(main_parallel_cards(int(sys.argv[2])))
    if sys.argv[1:2] in (["--b1-bf16-ab"], ["--b3-bf16-ab"]):
        sys.exit(main_ab(sys.argv[1], sys.argv[2]))
    sys.exit(main())
