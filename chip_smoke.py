#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (segan_pytorch_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (no CPU fallback; it exits non-zero without a CUDA card
and when the port's package is not beside it):
  1. device facts: torch, nvcc and nvidia-smi (card name and power limit);
  2. build the seven hand-written kernel sources from segan_pytorch_tpu_torch/csrc/
     (conv1d_prelu.cu, conv1d_wgmma.cu, conv1d_wgmma_tf32.cu, encoder_fused.cu,
     encoder_fused_wgmma.cu, conv1d_rows.cu, encoder_fused_wgmma_tf32.cu), one nvcc each
     (ptxas -v: registers and spills), and the host
     libraries of native/ (the wav gather and the P.862 scorer), one
     g++ each, all started together;
  3. the per-layer kernel (fused_conv1d_prelu) vs its plain PyTorch version on the card,
     into NaN-filled outputs, at the five SEGAN+ encoder shapes for 1, 8, 64 and 300
     16384-sample chunks, at every shape of WSEGAN's step at its batch, 150, with biases
     (G's enc1, D's enc1 with Cin = 2, and enc2-5, which G and D share) and at edge shapes
     (bias, T_in = 4 (T_out - 1) + 31 in a pitched buffer, ragged, stride 1, and enc3 of
     64 chunks in contiguous odd rows) and at serving's few-row shapes (windows of 2048 and
     4096, a window of 2048's enc4 at 4 rows and of 4096's enc5 at 8, WSEGAN's 33792
     samples), x through G's pitched pad (rows of a multiple of 8 samples) at every
     main-path shape, in fp32 (TF32 off, relative error <= 1e-4) and bf16 (<= 2e-2), each
     on the route _route picks, read from the counters (wgmma where the rule gives it, in
     fp32 by 3xTF32, in bf16 the rows kernel at one batch row or a ragged T_out up to 256
     rows, mma.sync elsewhere on the tensor cores and always in odd rows, enc1's small
     passes and the ragged and stride-1 shapes on FMAs), then on the other routes forced
     (the rows kernel, mma.sync and FMA, where each takes the shape); in fp32 enc5 at 64, 150 and 300
     chunks also vs a float64 conv (<= 1e-4). Times in turns (CUDA events, median of 10
     after 2 warm-ups, one call per pair): every route, plain and cuDNN's F.conv1d alone,
     in each dtype, and the device time of the chosen route's kernels and of mma.sync's
     (10 launches back to back through their C entry points, weights and plan made once;
     median of 6 rounds)
     and, in bf16 where the routes differ, a wrapper call's cost 5 calls back to back
     (median and interquartile range); TFLOP/s, share of peak, bounds, encoder sums per
     batch, and the WSEGAN step's 25 calls (G's five rows once, D's five in each of its
     four passes). Where bf16 takes the rows kernel, its device time and a call 5 back to
     back against the route it replaced (the rule without it), the device time less at
     every such shape. At 64 and 300 chunks the chosen routes must take at most 0.6x
     mma.sync's device time in each dtype, bf16 mma.sync at most half the FMA route's
     time, and fp32, chosen and mma.sync, no more than the FMA route; at no bf16 shape
     where the rule picks another route than mma.sync may a call back to back be slower
     than mma.sync's by more than their spread;
  3b. the chained kernel (fused_enc23_fwd: at SEGAN+'s widths from one chunk's enc3 rows
     on wgmma, fp32 by 3xTF32 with enc3's depth over a cluster of 1, 2 or 4 blocks by
     batch; else fp32 on mma.sync by 3xTF32 where C2 and C3 are multiples of 8, else on
     FMAs, and bf16 on mma.sync) vs enc23_plain, into NaN-filled outputs, at the
     SEGAN+ enc2+enc3 widths (h1 (B, 64, 4096) -> 128 -> 256) for B = 1, 8, 37, 64 and
     300 and 8 with bias, at those widths with T1 = 64 (both reflected ends in one tile),
     1168 (a ragged last tile, T3 % 8 != 0) and 3200 (ragged, T3 % 8 == 0), with and
     without bias, and at two narrow odd shapes, in fp32 and bf16 with the same limits,
     each route and tile read from the counters: fp32 on the route and tile the wrapper
     picks, then on the wgmma kernel at each cluster size where it takes the shape
     (every SEGAN+-width case), on enc23_tf32_kernel at tiles 16 and 32 and on the FMA
     kernel forced; bf16 on the route _route picks, then on the other one forced where it
     takes the shape; at B = 300 also vs the per-layer kernel chain in pitched rows
     (bf16, both layers on wgmma: pre2 bit for bit, pre3 and post3 within the limit, as
     enc3's depth is summed in another order) and fp32 pre3 of both 3xTF32 kernels vs a
     float64 chain (<= 1e-4). Times in turns at B = 1, 8, 64 and 300 of the A/B tool's
     three arms, fp32 on enc23_tf32_kernel at both tiles and on the FMA kernel forced,
     bf16 on mma.sync forced, and cuDNN's two convs alone; in fp32 at B >= 8 the tensor
     cores must take no more time than the FMA kernel. Device times at B = 1, 64 and 300
     in both dtypes (CUDA graphs of 10 calls through the C entry points: the chained
     kernel on wgmma and on mma.sync, the pitched per-layer pair with its pads, cuDNN's
     two convs): at 64 and 300 the bf16 wgmma kernel must beat mma.sync's, and wherever
     the rule sends an fp32 call to the wgmma kernel it must beat enc23_tf32_kernel's. An fp32 call with
     C3 = 36 must take the FMA kernel and be right; a bf16 one must raise ValueError
     (whole n8 tiles) and launch nothing. Both fp32 tiles in turns at B = 16 and 32, on
     either side of where the tile rule switches;
  3c. the A/B tool (python -m segan_pytorch_tpu_torch.tools.encoder_fused_bench) at its
     defaults, batch 300 bf16, then with --dtype float32: both kernels must launch in it,
     the chained kernel on wgmma in both dtypes (fp32 by 3xTF32) and forced onto mma.sync
     (fp32 enc23_tf32_kernel at tile 32), the per-layer kernel (kernel x2, in pitched
     rows) on wgmma in both, and agree with the plain chain within 2e-2 and 1e-4;
  3d. the TF32 policy: with cuDNN's TF32 on process-wide, a bare fp32 GDeconv1DBlock and
     Conv1dPReLU's backward convs on the card vs float64 on the CPU (<= 1e-4); the
     deconv's error with the ops' policy bypassed is printed beside it;
  4. the slice: a full-width SEGAN+ generator (seeded init, PReLU slopes U(0, 0.3))
     saved as a reference-format .ckpt + train.opts, then the port's clean.py CLI
     (--device cuda) on 8 synthetic wavs with --batch_utts 1 and 4 in fp32 and in bf16.
     Checks: outputs finite and of their inputs' lengths, the kernel launched 5 times per
     G forward, each call on the route _route picks for its shape and G's pitched rows
     (the counters against the logged calls; bf16 on wgmma at some, the one-chunk passes'
     enc3-5 on the rows kernel), batched ==
     sequential, and the card's generate() == a CPU copy's (plain ops) within 1e-3
     relative. Prints audio seconds enhanced per wall second, the device memory that the
     first fp32 forward keeps (the split weights), and G chunks/s at batch 64, fp32 and
     bf16 (4 wgmma launches a forward), on the rule's routes, in bf16 with mma.sync in
     place of wgmma, and on the FMA route, in turns.
  5. the train path (models/segan.py SEGAN.train_step), every check fatal:
     5a. Conv1dPReLU's backward (dx, dw, db, da) on the card vs autograd of
     conv1d_prelu_plain on the card at the five encoder shapes at B = 8 and enc2 at
     B = 300, x a view in G's pitched rows, each forward on the route _route picks, fp32 (TF32 off, <= 1e-4) and bf16 (<= 2e-2), slopes U(0, 0.3), the upstream
     gradient gy zeroed where pre lies within the limit of 0 (there the PReLU's branch
     depends on the last bit); then per dtype one RMSprop and one Adam step (the port's
     build_optimizer) on w in place, after which the kernel must equal the plain version
     with the new w (its padded, and in bf16 its permuted, weights cached by w's version
     must not be stale);
     5b. a full-width SEGAN+ G + D (--no_bias, slopes U(0, 0.3)), one fp32 step at B = 4
     (one row masked) on the card and on a CPU copy (oneDNN off), same init, batch, z and
     phase draws, both held against the step in float64 on the CPU: the card's losses
     (g_adv in the step with D's learning rate 0, below) and Genh <= 1e-3 relative; D's
     gradients, all tensors together, within max(1e-3, 4 x the CPU fp32 ones' error) in
     L2 and each within max(1e-2, 4 x the CPU's) (the step's per-channel gradient sums
     cancel; D's conv biases, which feed a BatchNorm
     and so have a true gradient of 0, are checked to be noise). G's step gradients go
     through D after its RMSprop step and through PReLU kinks, where last-bit differences
     flip a sign: printed; G's backward from a fixed gradient of Genh, card vs float64,
     each tensor <= 1e-3; with D's learning rate 0, g_adv <= 1e-3 and G's step gradients
     <= 5e-2 all together;
     5c. the step at full width, batch 300, fp32 and bf16: 2 warm-up steps, then 5 timed
     by CUDA events with the kernel's counters set to 0 just before and read just after
     (5 launches per step, each on the route _route picks: bf16 enc2-5 on wgmma); losses
     finite; slices/s, the median
     split into G forward / D update / G update, peak device memory; then the main of
     `python -m segan_pytorch_tpu_torch.bench --steps 5 --warmup 2` in bf16 and fp32.
  6. the training run at full SEGAN+ width (`python -m segan_pytorch_tpu_torch.train`'s
     main in-process, batch 300, fp32, --no_bias, a log point per step): a synthetic
     corpus of 16 x 20 s pairs (608 slices: batches of 300, 300 and a ragged 8) and 2 x
     4 s validation pairs; one epoch, then --resume to epoch 2. Every check fatal: finite
     losses at each log point, "Resumed from step 3" and iterations 4-6 in the second run,
     the EOE and best-val indices and payloads (the EOE payload with the optimizer state
     and 6 steps), fused_conv1d_prelu launched 5 x (train steps + G forwards of the
     training samples and of evaluate) times over both runs, each on the route _route
     picks (3xTF32, enc1's small passes on FMAs; read from its counters, set to 0 just
     before the first run, against the logged calls), the kernel on the
     encoder weights that resume() loads equal to the plain version (<= 1e-4, and away from
     a fresh G's), and the port's clean CLI on the validation wavs with the last EOE G.
     Prints the PESQ backend, each run's batch-loop, evaluate and checkpoint-save seconds
     and data wait per step, and the warm loop's slices/s beside 5c's and the bench's.
  7. WSEGAN on the card (models/wsegan.py, scripts/run_wsegan_train.sh's flags: spectral
     norm in G and D, Adam, the misaligned pair, biases), every check fatal:
     7a. one full-width fp32 step at B = 4 (one row masked, one 'additive') on the card
     and on a CPU copy, both held against the step in float64 on the CPU: the losses
     (g_adv and g_loss, which go through D', with D's learning rate 0) and Genh <= 1e-5;
     D's gradients within max(1e-5, 4 x the CPU's) all together and max(1e-4, 4 x) each;
     u and v <= 1e-5; G's gradients with D's learning rate 0 <= 3e-5; 25 launches, 3xTF32
     but G's enc1 (4 rows of 4096: the FMA kernel); a control, the card's step with every cuDNN conv and matmul in one TF32
     pass, must break each of these bounds;
     7b. the step at batch 150, fp32 and bf16: 5 timed steps with 25 launches each, each
     on the route _route picks (fp32 3xTF32 but G's enc1 on FMAs; bf16 enc2-5 of G and D
     on wgmma); slices/s, the split G forward / D update / G update, peak memory, and the
     time of the kernel's copy of the 25 w / sigma of a step for their routes (padded;
     fp32 split; for wgmma padded and permuted), timed alone (the kernel itself is timed in phase 3); then the
     bench entry's main with `--engine wsegan` and `--engine aewsegan` at batch 150;
     7c. `train.main` with the script's flags on 4 x 4 s synthetic pairs (two batches of
     150 an epoch): one epoch, then --resume to epoch 2 ("Resumed from step 2", iterations
     3-4, EOE G and D named after the steps taken, 25 launches a step); the clean CLI on
     the last EOE G (the WSEGAN engine: one G pass per wav); then --aewsegan for one epoch
     with a validation set (Genh_SD at each log point, no D).
  8. serving at full width (`segan_pytorch_tpu_torch.serve`, every check fatal, every
     request answered 200): the server in this process (`build_server`, `serve_forever`
     on a thread, --device cuda) on a SEGAN+ G (--no_bias, a quiet output layer) in fp32
     and then bf16: /healthz; 20 sequential one-chunk /enhance requests (p50 and p95
     wall); 8 concurrent ones of 1-6 chunks, seeded, overlap 0 and 0.25, in fewer G
     passes than requests (/metrics); /enhance_stream at windows 16384 and 2048 fed in
     uneven pieces; 4 concurrent streams through the WindowBatcher with 4 /enhance
     requests. Each answer against the port's generate() on the card with the seed's z,
     each stream against the offline chunk_grid + overlap_add path, within SERVE_TOL and
     STREAM_TOL, and the controls (another seed's z, the other join) outside them. The
     kernel's counters against the recorded G forwards: 5 launches each, on the route
     _route picks for each layer. Then a WSEGAN engine (snorm G with biases) with 4
     concurrent requests of three padded lengths against its generate_batch. 8a: the
     kernel against its plain version (NaN-filled outputs, route from the counters) at
     every shape the servers ran and at passes of 1-128 chunks (3 among them) and windows
     of 2048 and 4096 at 1-8 rows, in fp32 and bf16, timed with the FMA route forced, plain and cuDNN
     beside bounds; then `python -m segan_pytorch_tpu_torch.serve --device cuda` in a
     subprocess: /healthz, one /enhance, SIGTERM, exit 0 within --drain_seconds.
  9. POST /admin/reload at full width (every check fatal; serve.RETIRE_SECONDS cut to
     1 s; the servers under --auth_token): 9a, an fp32 server of SEGAN+ A answers a
     reload without the token with 401, one to a missing file with 500 and then the
     same request bit for bit (with cudnn.deterministic on for that check:
     cuDNN's default fp32 transposed-conv algorithm sums in no fixed order, and two
     identical requests without it are printed apart); four clients send one-chunk /enhance
     requests without pause while a reload swaps in B (other weights): every answer 200
     and equal to A's or B's generate() with the seed's z within SERVE_TOL (B's for every
     request sent after the reload's 200), A's and B's own answers apart by more than
     it, /metrics sampled every 50 ms never going back; p50 / p95 request wall without
     and during the reload, the reload's load and warm-up seconds and, timed alone, the
     checkpoint's read and its copy to the card. Then five reloads (A, B, A, B, A) on a
     server of B: after each retirement and gc.collect() the retired engine is collected,
     the kernel's weight cache holds the live G's encoder weights and nothing new, and
     torch.cuda.memory_allocated() is back within the probe's MEM_TOL of the one-generation
     baseline (printed: a generation's bytes). 9b, a bf16 server: a reload A -> B held to
     B's generate() within the bf16 bound (A's outside it), then a reload to the WSEGAN
     checkpoint by its cfg_file: /healthz says WSEGAN, 3 concurrent requests equal its
     generate_batch. The kernel's counters against the recorded G forwards (warm-ups and
     served passes): 5 launches each, on the routes _route picks. 9c, the reload probe
     (tools/reload_leak_probe.py) on the card, three generations. 9d: the kernel's calls
     through the phase are recorded, and every layer shape that 8a did not hold (WSEGAN's
     biased warm-ups and one-row passes among them) is held against the plain version
     as 8a holds its shapes. TLS and the WebSocket listener are host code held by
     the CPU tests; the phase says so and checks neither.
  10. the train step as a CUDA graph (`train_step_multi`, `models/multistep.py`), every
     check fatal: 10a, for SEGAN+ at batch 300 (--no_bias) in fp32 and bf16, WSEGAN at 150
     with its script's flags and AEWSEGAN at 150, one graphed call of 4 sub-steps against
     4 `train_step` calls of an engine of the same state (the same batches, one ragged,
     and the same streams), under cudnn.deterministic (the Adam engines' eager twin with
     capturable Adam): each sub-step's losses, Genh and the changes to the parameters,
     buffers and optimizer state within 1e-6 (they read 0), a control with sub-steps 2
     and 3 swapped outside it; the first call's kernel launches (the eager warm-up step's
     and the capture's), each on the route _route picks (bf16 on wgmma at enc2-5, as
     a replay's device kernels show too), the graph pool beside the eager step's peak; for SEGAN+ fp32 the
     same under cuDNN's default algorithms beside two eager engines' own difference
     (printed). 10b (SEGAN+ fp32): an eager G forward through the kernel after each of two
     graphed calls against a CPU copy of G (<= 1e-3), an eager step between two graphed
     calls, the next call against the eager engine; the controls: the kernel captured
     with its cache consulted replays stale weights, and the engine with both guards off
     (the cache read during capture, no version bump after replays) fails the second
     forward. 10c: a call that only replays makes no host sync
     (`set_sync_debug_mode("error")`) and moves no launch counter, and a replay runs the
     kernel 5 / 25 / 5 times (profiler device events). Then `step_flops()` timed,
     `bench --steps_per_call 4` and 1 at batch 300 (bf16, fp32; at 1 5c's runs) and at 16,
     once each, each line with its MFU; 10d: `train.main` at batch 64 for two epochs of
     six batches with
     `--steps_per_call 4` (iterations 4-6 and 10-12 logged, checkpoint indices equal to
     the single-step run's) and `--profile` at batch 32 (the trace, the two [profile]
     lines, the MFU in the log).
  11. train.main's data options on the card, every check fatal, the kernel's counters set
     to 0 before each run and read after: (a) SEGAN+ at batch 300, one epoch of 912
     slices with --random_scale 0.5 1 2 --preemph_norm --shuffle_buffer 256
     --loader_dtype bfloat16 --compute_dtype bfloat16: every device batch bf16 (2 bytes
     a sample) and equal to its host batch bit for bit, n // 300 = 3 steps, finite
     losses, the training samples written from the bf16 host rows, 5 launches per step
     and G forward; (b) where h5py is installed, the port's tools/make_h5.py writes
     train.h5 and valid.h5 and a --h5 run of one epoch with validation follows, else a
     line says that h5py is absent; (c) WSEGAN with its script's flags at batch 150 on
     12 of the files at stride 0.5 (four steps) with --noises_dir (three noise wavs of
     2 s) and --snr_levels 0 5 10: every row's additive mask 1, den_loss nonzero, 25
     launches a step. (a') runs (a) again with --steps_per_call 3 and with single steps,
     both under cudnn.deterministic: one graphed call takes the three bf16 batches, and
     the state and losses equal the single steps' (<= 1e-6). Prints slices/s and the
     data wait per step of (a) and (c) beside phase 6's warm loop, the host's build of a
     batch of each over 12 batches drawn with no card work, and a line saying that
     resuming a JAX run directory is held by the CPU tests alone.
  12. A7a, a bnorm G and D's SincConv front end at full width (phase_a7a), every check
     fatal: (a) SEGAN+ with --gnorm_type bnorm (--no_bias) at batch 300 in fp32 and bf16,
     1 warm-up and 2 timed steps (slices/s, the G forward / D update / G update split,
     peak memory, MFU from step_flops()) with 0 launches of fused_conv1d_prelu (a bnorm G
     takes the plain conv), one fp32 step at B = 4 vs float64 on the CPU (losses and Genh
     <= 1e-3, G's running statistics <= 1e-4), --steps_per_call 4 vs 4 eager steps under
     cudnn.deterministic (every state tensor <= 1e-6), and the trained G's checkpoint
     through the clean CLI (--device cuda), generate() card vs a CPU copy <= 1e-3; (b)
     SEGAN+ with --sinc_conv --dpool_slen 64: the same timing with 5 launches a step on
     the tensor cores, one step vs float64, and the front end alone at batch 300 (forward,
     and forward + backward to its parameters, fp32 and bf16); (c) WSEGAN with its script's flags and the
     sinc D at batch 150: the kernel at the sinc D's four block shapes (64 -> 128 at
     T_out 4096 ... 512 -> 1024 at 64, bias) vs its plain version in fp32 and bf16, on the
     route it picks and on the FMA route forced, timed beside the plain version and
     cuDNN; 2 timed steps of 5 + 4 x 4 launches; one step at B = 3 vs float64 within 7a's
     bounds (u and v after Adam's step within max(1e-5, 4 x the CPU fp32 step's));
     (d) LayerNorm, ResBlock1D, ResARModule, SincConv, CombFilter, PostProcessingCombNet,
     Conv1DResBlock (strided and transposed) and pos_code, card vs CPU at batch 8 and
     64-512 channels over 4096-16384 samples, fp32 <= 1e-4, bf16 <= 2e-2.
  13. A7b and A7c (phase_a7bc), every check fatal: (a) Generator1D at the SEGAN v1
     paper's widths (11 encoder layers 16 ... 1024 at stride 2, K = 31, z_dim 1024, skips
     merged by concat; 73.1M parameters) on 64 chunks of 16384 samples, fp32 and its bf16
     copy: one forward each with the kernel's counters set to 0 just before and read just
     after (11 launches; each call's route, read from the counters, the one _route picks at
     stride 2 for its shape and pitched rows: mma.sync below 128 output channels, wgmma
     from 128, the tensor cores at every layer but the first, whose route is the stride's
     enc1 rule), the forward and a forward + backward of an L1 loss timed in turns
     (chunks/s), FLOPs
     (the encoder's from its shapes, the rest by FlopCounterMode); at B = 2 the fp32
     forward and gradients on the card and on the CPU vs float64 on the CPU (output <=
     1e-3, each gradient's relative L2 error <= max(1e-3, 4 x the CPU fp32 one's)); the
     bf16 copy vs the fp32 model of its rounded parameters (<= 2e-2); (b) the kernel at
     that encoder's 11 stride-2 shapes at B = 64, x in Generator1D's pitched rows, vs its
     plain version in NaN-filled outputs (fp32 <= 1e-4, bf16 <= 2e-2) on the route _route
     picks (read from the counters) and on the FMA route forced, timed in turns with the
     plain version and cuDNN's F.conv1d, and each route's kernel through its entry point
     (device ms), beside bounds; then every plan of the tensor-core routes at those shapes
     (each wgmma block tile and split-K count, each mma.sync tile and 1-4 slices) vs the
     plain version; (c) every option of
     the CPU tests at toy width, card vs CPU (fp32 <= 1e-4; rnn_core on cuDNN's LSTM), and
     rnn_core's bf16 copy vs fp32 (<= 2e-2); (d) STOI of 3 s, F0Evaluator on a spawned pool
     of two (terminated), and one epoch of both random-chunk datasets over a synthetic
     corpus with .lf0 targets, each timed.
  14. multi-GPU training (phase_dp), every check fatal, on the one card: (a) NCCL at a
     world size of 1, joined by initialize_distributed as the CLI joins: a full-width
     SEGAN+ step through the grouped code equals the ungrouped one bit for bit under
     cudnn.deterministic; then, in a spawned process of its own and its own NCCL group
     of one, the grouped step as a CUDA graph that holds its NCCL collectives (SEGAN+ at
     global batch 300 in fp32 and bf16, WSEGAN fp32 at 150 with its script's flags):
     phase 10's check (_graph_vs_eager) read as equality, one `train_step_multi` call of 4
     sub-steps against 4 eager grouped `train_step` calls under cudnn.deterministic
     (losses, Genh, every parameter, buffer and optimizer tensor bit for bit), the
     all-reduces that the capture recorded equal to an eager grouped step's (counted at
     torch.distributed.all_reduce), a call that only replays makes no host sync and moves
     no counter, and a replay runs the kernel 5 / 25 times and the collective kernels it
     prints (profiler device events); the grouped SEGAN+ step's slices/s graphed and
     eager at batch 300 and 16; (b) two processes sharing the card over gloo on CUDA
     tensors, SEGAN+ at global batch 64 (50 valid rows, the mask's zeros on rank 1), fp32
     on cuDNN's default algorithms and bf16 on its deterministic ones, each rank's step
     against the one-process step (5b's bounds; in bf16 the gradients against the
     one-process fp32 step, deterministic too, within 4 x the one-process bf16 step's
     distance from it; 5 launches per rank); (c) four processes, dp 2 x mp 2, WSEGAN at
     global batch 16 with D's head split, on cuDNN's default algorithms, against one
     process (7a's bounds; 25 launches per rank); each check prints D's three tensors
     nearest their bounds; (b) and (c) run
     together, and in each every rank's grouped call of two sub-steps on its gloo group
     raises, naming the backend, with no launch; (d) enhance_sharded
     over two G replicas on cuda:0 against generate within 1e-5. Per-rank times are of
     processes sharing one card, not speed figures; NCCL cannot run two ranks on one card.
  15. the user tools at full SEGAN+ width (phase_tools), every check fatal: (a) the
     port's tools/make_demo_corpus.py writes 150 + 4 pairs of 3 s, and
     eval_noisy_performance scores the test split (the logfile's layout, finite means);
     (b) weight_converter turns a full-width G and D (.ckpt) into npz trees and back:
     strict loads, every tensor equal, and the G forward (B = 4) and D's equal the
     originals' bit for bit on the card under cudnn.deterministic; (c) tools/ab_parity.py
     in fp32 on the card on the test split (5 launches a file); (d) tools/serving_bench.py
     with its own server process (--reps 8, --concurrency 4, stream windows of 4096);
     (e) tools/serving_soak.py for 12 s, a reload every 4 s, a sample every 2 s: no
     error, monotonic counters, fd drift <= SOAK_FD_DRIFT, thread drift <= 3 a reload +
     SOAK_THREAD_SLACK, and the card's memory.used within its first sample + (unretired
     generations + 1) x phase 9a's generation + SOAK_MARGIN_MIB; (f)
     tools/train_throughput_bench.py at batch 300 for 3 epochs of 2 batches, the first
     skipped, beside phases 5c's and 6's rates; (g) one HTTPS /enhance (a certificate
     from openssl) and one WebSocket stream through the repo's tools/ws_client.py
     against the port's server in this process, vs generate() <= 1e-5 and vs the offline
     stream path within one PCM16 LSB, 5 launches per recorded G forward (where openssl
     or websockets is missing a line says so and that part is left out); (h) the kernel
     against its plain version at every layer shape the tools reach (their own server
     processes' passes of 1-8 rows of 16384 and stream windows of 4096 at 1-2 rows, the
     trainer's batch 300, and the in-process calls) that phases 3, 8 and 9 did not hold.
Each phase prints its seconds as it ends ("[time] phase ..."), and one line the
seconds of all and the total. The line before the last is the JSON kernel report
(launches of fused_conv1d_prelu from
phase 4, train_launches_per_step from 5c, train_run_launches from phase 6,
wsegan_train_launches_per_step from 7b, wsegan_run_launches from 7c, serve_launches
(_mma, _tf32) from phase 8's served G forwards and reload_launches (_mma, _tf32) from
phase 9's (and launches_rows phase 4's bf16 runs', serve_ and reload_launches_rows),
its times the bf16 encoder sum at 64
chunks and, under fp32_*, the fp32 one, under d_enc1_* WSEGAN's
first D layer at B = 150, and under wsegan_step_* the step's 25 calls from phase 3 and
its weight pad from 7b, under graph_launches_per_replay the launches a replay of each
phase-10 case's graphed step makes and of each 14a case's graphed grouped step ('grouped
...'), data_options_launches (_segan, _h5, _wsegan) those
of phase 11's runs, a7a_*_launches_per_step phase 12's (bnorm G 0, sinc D SEGAN+ 5,
sinc D WSEGAN 21), and under sinc_d_* (fp32_sinc_d_*) the sums of 12c's four sinc D
shapes at batch 150, a7b_g1d_launches_per_forward phase 13's (11), under
a7b_g1d_launched its four counters by dtype, and under g1d_enc_* (fp32_g1d_enc_*) the
sums of 13b's eleven stride-2 shapes at batch 64 (device_ms the picked routes' kernels,
<route>_device_ms and <route>_launches by route),
p14_segan_launches_per_rank_step and p14_wsegan_launches_per_rank_step phase 14's (5 and
25), p14_enhance_sharded_launches 14d's (10), tools_launches phase 15's in-process parts
(tools_convert_launches 15b's, tools_ab_parity_launches 15c's, tools_tls_ws_launches
15g's);
launches of fused_conv1d_prelu_wgmma (the per-layer kernel's bf16 wgmma route) from
phase 4 (train_launches 5c's bf16 steps'), its times the sums of G's layers on it at 64
chunks from phase 3 (ms a wrapper call, device_ms 10 launches back to back),
g1d_launches_per_forward and g1d_device_ms its launches in phase 13's Generator1D forward
and their layers' device ms at stride 2 (13b), and the same of
fused_conv1d_prelu_wgmma_tf32 (the fp32 wgmma route) in fp32 (train_launches 5c's fp32
steps');
launches of fused_enc23_fwd (encoder_fused.cu) from phase 3c, the tool's chained calls
forced onto mma.sync (launches_tf32 those of its fp32 run, enc23_tf32_kernel), its times
that arm's at batch 300 in fp32 (device_ms from 3b's CUDA graphs), library_ms cuDNN's two
convs from phase 3b, bf16_mma_ms and bf16_mma_device_ms enc23_mma_kernel forced at batch
300 (3b);
launches of fused_enc23_fwd_wgmma (encoder_fused_wgmma.cu, the bf16 wgmma route) from phase
3c, its times the tool's at batch 300 in bf16, device_ms and those of the other arms
(mma_, kernel_x2_, library_) at batch 300, 64 (b64_) and 1 (b1_) from 3b's CUDA graphs;
launches of fused_conv1d_prelu_rows (conv1d_rows.cu, the bf16 rows route) from phase 4's
bf16 runs (serve_ and reload_launches those of phases 8 and 9), its times one chunk's
enc3-5 summed from phase 3 (ms a call in turns, device_ms and replaced_device_ms 10
launches back to back of it and of mma.sync, call_ms and replaced_call_ms 5 calls back
to back), its max_abs_err the worst over phase 3's rows shapes;
launches of fused_enc23_fwd_wgmma_tf32 (encoder_fused_wgmma_tf32.cu, the fp32 wgmma
route) from phase 3c, its times the tool's at batch 300 in fp32 (tf32_ms enc23_tf32_kernel
forced, kernel_x2_ms the pitched per-layer pair), b1_ and b64_ the calls in turns at 1 and
64 chunks (ms, tf32_ms, plain_ms, library_ms, bound_ms; 3b), device_ms and those of the
other arms (tf32_, kernel_x2_, library_) at batch 300, 64 (b64_) and 1 (b1_) from 3b's
CUDA graphs;
the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 1234
SR = 16000
FP32_TOL = 1e-4   # fp32 sums in another order than cuDNN's (TF32 off)
BF16_TOL = 2e-2   # bf16 outputs: one rounding of 2^-8 relative, plus the inputs'
SLICE_TOL = 1e-3  # whole G, card vs CPU: 10 layers of reordered fp32 sums
KERNELS = [  # the fixed fields of the kernels line, in its order
    dict(name="fused_conv1d_prelu", route="cuda",
         source="segan_pytorch_tpu_torch/csrc/conv1d_prelu.cu",
         replaces="segan_pytorch_tpu/ops/pallas/conv1d.py:127"),
    dict(name="fused_enc23_fwd", route="cuda",
         source="segan_pytorch_tpu_torch/csrc/encoder_fused.cu",
         replaces="segan_pytorch_tpu/ops/pallas/encoder_fused.py:112"),
    dict(name="fused_conv1d_prelu_wgmma", route="cuda",
         source="segan_pytorch_tpu_torch/csrc/conv1d_wgmma.cu",
         replaces="segan_pytorch_tpu/ops/pallas/conv1d.py:127"),
    dict(name="fused_conv1d_prelu_wgmma_tf32", route="cuda",
         source="segan_pytorch_tpu_torch/csrc/conv1d_wgmma_tf32.cu",
         replaces="segan_pytorch_tpu/ops/pallas/conv1d.py:127"),
    dict(name="fused_enc23_fwd_wgmma", route="cuda",
         source="segan_pytorch_tpu_torch/csrc/encoder_fused_wgmma.cu",
         replaces="segan_pytorch_tpu/ops/pallas/encoder_fused.py:112"),
    dict(name="fused_conv1d_prelu_rows", route="cuda",
         source="segan_pytorch_tpu_torch/csrc/conv1d_rows.cu",
         replaces="segan_pytorch_tpu/ops/pallas/conv1d.py:127"),
    dict(name="fused_enc23_fwd_wgmma_tf32", route="cuda",
         source="segan_pytorch_tpu_torch/csrc/encoder_fused_wgmma_tf32.cu",
         replaces="segan_pytorch_tpu/ops/pallas/encoder_fused.py:112"),
]


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|: an absolute tolerance would pass anything once the
    N(0, 0.02) weights have shrunk the deep activations. NaN (an output row the kernel
    never wrote) makes it NaN, which fails every bound."""
    ref = ref.float()
    return float((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def worst(values) -> float:
    """The largest of the values, NaN if any is NaN: the built-in max() drops a NaN
    that is not in first place, and would pass an output the kernel left unwritten."""
    return float(np.max(list(values)))


def nan_outputs(*shapes, dtype):
    """Outputs filled with NaN, so that a row the kernel does not write cannot pass for
    a right one left behind in the allocator's memory."""
    import torch

    return tuple(torch.full(s, float("nan"), dtype=dtype, device="cuda") for s in shapes)


def phase_device():
    import torch
    from segan_pytorch_tpu_torch.ops.kernels import build

    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), python {sys.version.split()[0]}")
    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"nvcc: {nvcc}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible")
    print(smi)
    return smi


def phase_build():
    from segan_pytorch_tpu_torch.ops.kernels import build

    names = ("conv1d_prelu", "conv1d_wgmma", "conv1d_wgmma_tf32", "encoder_fused",
             "encoder_fused_wgmma", "conv1d_rows", "encoder_fused_wgmma_tf32")
    hosts = ("segan_io", "pesq862")  # the C++ wav gather and P.862 scorer of native/
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + len(hosts)) as pool:  # one compiler per source
        kernels = [pool.submit(build.build_library, name) for name in names]
        libs = [pool.submit(build.build_host_library, name) for name in hosts]
        built = [f.result() for f in kernels]
        host_paths = [f.result() for f in libs]
    secs = time.perf_counter() - t0
    for name, (path, log) in zip(names, built):
        print(f"build: {name} ({'compiled' if log is not None else 'already built'}) "
              f"-> {path}")
        if log:
            print(log.strip())
    for name, path in zip(hosts, host_paths):
        print(f"build: native/{name}.cpp -> {path}")
    print(f"build: {len(names)} kernels and {len(hosts)} host libraries in {secs:.2f} s")


BF16_PEAK = 989e12  # dense bf16 tensor-core FLOP/s of an H100 SXM at 700 W
FP32_PEAK = 67e12   # fp32 FLOP/s outside the tensor cores
TF32_PEAK = 495e12  # dense TF32 tensor-core FLOP/s
DEVICE_REPS = 6  # rounds of phase 3's device timings (10 launches back to back each)
HOLD_REPS = 4  # rounds of _hold_kernel's timings in turns (phases 8a, 9d, 15h)
HBM_RATE = 3.35e12  # device memory bytes/s


def enc23_work(b, t1, c1, c2, c3, has_bias, itemsize):
    """(operations, bytes) of fused_enc23_fwd: the two convs' useful FLOPs; h1, the
    weights, biases and slopes read once, pre2, pre3 and post3 written once."""
    kw = 31
    flops = 2.0 * b * kw * (t1 // 4 * c2 * c1 + t1 // 16 * c3 * c2)
    elems = (b * c1 * t1 + kw * (c2 * c1 + c3 * c2) + (2 if has_bias else 1) * (c2 + c3)
             + b * c2 * t1 // 4 + 2 * b * c3 * t1 // 16)
    return flops, itemsize * elems


def bound_ms(flops, nbytes, peak) -> float:
    """The least time the card could take: the larger of the operations at `peak` and
    the bytes (each input read once, each output written once) at HBM_RATE."""
    return 1e3 * max(flops / peak, nbytes / HBM_RATE)


D_ENC1 = "B=150 D enc1 bias"  # phase 3's row of WSEGAN's first D layer
# phase 3's rows of WSEGAN's step at the script's batch, 150, with biases, and the calls a
# step makes at each: G's enc1 once, D's enc1 (the (judged, noisy) pair, Cin = 2) in each
# of D's four passes, and enc2-5, whose shapes G and D share, 1 + 4 times
WS_ROWS = {"B=150 G enc1 bias": 1, D_ENC1: 4,
           **{f"B=150 enc{i} bias": 5 for i in range(2, 6)}}


@contextlib.contextmanager
def _logged_launches():
    """Wraps the kernel's `_launch` while inside: every call that leaves the route to
    the wrapper appends (dtype, B, Cin, T_in, Cout, K, stride, pitched rows) to the list
    it yields, the counting left to the wrapper."""
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K

    log, launch = [], K._launch

    def logged(x, w, b, a, stride, t_out=None, **kw):
        if kw.get("force") is None:
            log.append((x.dtype, *x.shape, w.shape[0], w.shape[2], stride, _pitched(K, x)))
        return launch(x, w, b, a, stride, t_out, **kw)

    K._launch = logged
    try:
        yield log
    finally:
        K._launch = launch


def _want_counts(K, log):
    """The five counters' moves (``_counters``) that _route's picks for the logged calls
    give."""
    import torch

    routes = [(dt, K._route(dt, B, cin, cout, k, s, (t_in - k) // s + 1, p))
              for dt, B, cin, t_in, cout, k, s, p in log]
    return (len(routes), sum(r != "fma" for _, r in routes),
            sum(r != "fma" and dt == torch.float32 for dt, r in routes),
            sum(r == "wgmma" for _, r in routes), sum(r == "rows" for _, r in routes))


def _pitched(K, x) -> bool:
    """Whether the wrapper sees x in rows TMA reads (``_launch``'s test)."""
    return K._pitch(x) % 8 == 0 and x.data_ptr() % 16 == 0


def _took(K, before) -> str:
    """The route of the one call since `before` (``_counters``), read from the counters."""
    moved = [n - b for n, b in zip(_counters(K), before)]
    assert moved[0] == 1, moved
    return "rows" if moved[4] else "wgmma" if moved[3] else ("mma" if moved[1] else "fma")


def _case_x(b, cin, t_in, g, layout):
    """x of a kernel case in fp32 and in bf16 (the same values, rounded): "pad" through
    G's pitched pad of a random h (T_in = 4 T_out + 29), "pitched" random rows in a
    buffer of rows rounded up to 8 samples, "contiguous" random odd rows."""
    import torch
    from segan_pytorch_tpu_torch.ops.conv import reflect_pad_pitched

    if layout == "pad":
        h = torch.randn((b, cin, t_in - 29), generator=g).cuda()
        return reflect_pad_pitched(h, 14, 15), reflect_pad_pitched(h.bfloat16(), 14, 15)
    width = -(-t_in // 8) * 8 if layout == "pitched" else t_in
    buf = torch.randn((b, cin, width), generator=g).cuda()
    return buf[..., :t_in], buf.bfloat16()[..., :t_in]


def _in_turns(arms, reps=10, warmup=2, calls=1):
    """{arm: (median ms, interquartile range ms)} per call of `arms` timed in turns,
    `calls` calls back to back per pair of CUDA events (``tools/conv1d_routes.py``): with
    one, a time includes the host's where the host is the slower; with more, it is a
    call's cost when calls follow each other, the longer of the host's time and the
    device's."""
    from segan_pytorch_tpu_torch.tools.conv1d_routes import median_iqr, times_in_turns

    return {n: median_iqr(v) for n, v in times_in_turns(arms, reps, warmup, calls).items()}


def _entry_arm(K, route, x, w, b, a, stride, t_out, out, plan=None):
    """A closure that launches `route`'s kernel for x's dtype through its C entry point
    alone, the wrapper's weights, plan (or `plan`, a tensor-core route's (tile, splits);
    the rows kernel's (n, rows_per_tile, cluster)) and split-K workspace made once: calls back to back then cost the device's time
    wherever a kernel takes longer than the ctypes call (~15 us of host), with no wrapper
    in between (nor a profiler, whose CUPTI session slows the launches of the phases
    after it)."""
    import torch

    B, cin, t_in = x.shape
    cout, _, k = w.shape
    sms = K._sm_count(x.device.index)
    stream = torch.cuda.current_stream().cuda_stream
    if route == "rows":  # no workspace: the split-K sums meet in the cluster
        plan = plan or K._rows_plan(B, cin, cout, t_out, sms)
        wk = K._rows_weights(w)
        args = (x.data_ptr(), wk[2], None if b is None else b.data_ptr(), a.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), *plan, B, cin, t_in, K._pitch(x),
                cout, t_out, stream)
        fn = K._rows_entries()[1]

        def run_rows():
            assert wk is not None and fn(*args) == 0, route
        return run_rows
    launch, splits_of, launch_mma, launch_tf32 = K._entries()
    fp32 = x.dtype == torch.float32
    if route == "fma":
        plan = (splits_of(B, cin, cout, t_out, k, sms),)
        fn, wp = (lambda *args: launch(K._DTYPE_CODES[x.dtype], *args)), (w,)
    elif route == "mma":
        plan = plan or K._mma_plan(B, cin, cout, t_out, sms, stride, x.dtype)
        fn, wp = (launch_tf32, K._padded_weights(w)) if fp32 else (
            launch_mma, (K._padded_weights(w),))
    else:  # fp32 takes the split pair of the mma.sync route, bf16 the permuted copy
        plan = plan or K._wgmma_plan(B, cin, cout, t_out, sms, x.dtype)
        fn = K._wgmma_entry(x.dtype)
        wp = K._padded_weights(w) if fp32 else (K._permuted_weights(w),)
    part = (torch.empty((plan[-1], B, cout, t_out), dtype=torch.float32, device=x.device)
            if plan[-1] > 1 else None)
    args = (x.data_ptr(), *(v.data_ptr() for v in wp), None if b is None else b.data_ptr(),
            a.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), None if part is None else part.data_ptr(),
            *plan, B, cin, t_in, K._pitch(x), cout, t_out)
    args += (k, stride, stream) if route == "fma" else (stride, stream)

    def run():
        assert fn(*args) == 0, route
        return part

    return run


def phase_kernel():
    """Kernel vs plain on the card, at the encoder shapes of 1, 8, 64 and 300 chunks, at
    those of WSEGAN's step at batch 150 and at edge shapes; each route's choice read from
    its counters. Returns the bf16 and fp32 results at B = 64, WSEGAN's first D layer and
    the WSEGAN step's 25 calls, for the kernels line, the wgmma kernels' at B = 64
    (bf16, fp32), and the rows kernel's at one chunk's enc3-5."""
    import torch
    import torch.nn.functional as F
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(SEED)
    T, Kw, S = 16384, 31, 4
    chans = [1, 64, 128, 256, 512, 1024]
    # (label, B, Cin, T_in, Cout, K, stride, bias, kind, x layout); kind "enc" for the
    # SEGAN+ encoder (--no_bias), "ws" for WSEGAN's step (WS_ROWS), "rows" for serving's
    # few-row shapes, "edge" for the rest; the route of each dtype is the one _route picks
    # for the shape and layout
    cases = []
    for B in (1, 8, 64, 300):
        t = T
        for i in range(5):
            t //= S
            cases.append((f"B={B} enc{i + 1}", B, chans[i], S * t + Kw - 2, chans[i + 1], Kw,
                          S, False, "enc", "pad"))
    t = T
    for i in range(5):
        t //= S
        label = "B=150 G enc1 bias" if i == 0 else f"B=150 enc{i + 1} bias"
        cases.append((label, 150, chans[i], S * t + Kw - 2, chans[i + 1], Kw, S, True, "ws",
                      "pad"))
    # serving's few-row shapes that the rows kernel takes beside one chunk's enc3-5 above
    # (one batch row, or a T_out the mma.sync kernel does not take): windows of 2048
    # (enc2-5) and 4096 (enc2) at one row, a window of 2048's enc4 at 4 rows and of 4096's
    # enc5 at 8, and WSEGAN's pass of 33792 padded samples (enc4-5, bias)
    for label, b, i, t_out, bias in (("w2048", 1, 1, 128, False), ("w2048", 1, 2, 32, False),
                                     ("w2048", 1, 3, 8, False), ("w2048", 1, 4, 2, False),
                                     ("w4096", 1, 1, 256, False), ("w2048 B=4", 4, 3, 8, False),
                                     ("w4096 B=8", 8, 4, 4, False),
                                     ("WSEGAN 33792", 1, 3, 132, True),
                                     ("WSEGAN 33792", 1, 4, 33, True)):
        cases.append((f"{label} enc{i + 1}{' bias' if bias else ''}", b, chans[i],
                      S * t_out + Kw - 2, chans[i + 1], Kw, S, bias, "rows", "pad"))
    cases += [
        (D_ENC1, 150, 2, S * 4096 + Kw - 2, 64, Kw, S, True, "ws", "pad"),
        ("B=8 enc3 bias", 8, 128, 1053, 256, Kw, S, True, "edge", "pad"),
        ("T_in=91 bias", 3, 512, 91, 1024, Kw, S, True, "edge", "pitched"),  # reads x[91]: 0
        ("T_in=1051 bias", 32, 128, 1051, 256, Kw, S, True, "edge", "pitched"),  # wgmma
        ("B=64 enc3 odd rows", 64, 128, 1053, 256, Kw, S, False, "edge", "contiguous"),
        ("ragged T_out=243", 3, 5, 1000, 70, Kw, S, True, "edge", "contiguous"),
        ("stride 1", 2, 48, 300, 40, Kw, 1, True, "edge", "contiguous"),
        # stride 2 (Generator1D): T_out 8 and 24 at odd B, whose last m16 group is half
        # live, on wgmma alone; Cin 5; each zero tap reads x[T_in], which must read 0
        ("s2 T_out=8 B=3 bias", 3, 512, 45, 1024, Kw, 2, True, "edge", "pitched"),
        ("s2 T_out=24 B=5", 5, 40, 77, 128, Kw, 2, False, "edge", "pitched"),
        ("s2 Cin=5 bias", 2, 5, 61, 256, Kw, 2, True, "edge", "pitched"),
    ]
    assert {c[0] for c in cases if c[8] == "ws"} == set(WS_ROWS)
    sums = {}  # (B, column) -> ms summed over the five encoder layers
    # WSEGAN's 25 calls a step by dtype prefix: ms (each row times its calls), bound and
    # max |kernel - plain|
    ws = {"fp32_": {}, "": {}}
    d_enc1 = {}  # the D enc1 row's numbers, for the kernels line
    max_abs = {}  # B -> max |kernel - plain| over the bf16 encoder layers
    max_abs32 = 0.0  # max |tensor cores - plain| over the fp32 encoder layers at B = 64
    wg64 = {}  # the wgmma kernel at B = 64: its layers' sums, for the kernels line
    wg64_32 = {}  # the same of the fp32 wgmma kernel
    spreads = []  # (label, chosen ms, mma.sync ms, spread) where bf16 picks another route
    # where bf16 takes the rows kernel: (label, its device ms, the replaced route and its
    # device ms, calls back to back of both, plain, cuDNN, bound, max abs err)
    rows_cases = []
    print(f"{'layer':>18} {'x shape':>19} {'Cout':>5} {'T_out':>5} | {'fp32':>8} "
          f"{'fp32 mma':>8} {'fp32 fma':>8} {'bf16':>8} {'bf16 mma':>8} {'bf16 fma':>8} | "
          f"fp32 route {'ms':>8} {'mma ms':>8} {'fma ms':>8} {'plain':>8} {'cuDNN':>8} | "
          f"bf16 route {'ms':>8} {'mma ms':>8} {'fma ms':>8} {'plain':>8} {'cuDNN':>8} (iqr) "
          f"| bf16 {'TFLOP/s':>7} {'peak':>6} | fp32 device TFLOP/s, 3xTF32 peak | bound ms "
          f"fp32, bf16")
    for label, b, cin, t_in, cout, kw, s, has_bias, kind, layout in cases:
        main = kind == "enc"
        x, xb = _case_x(b, cin, t_in, g, layout)
        # x's rows as the wrapper sees them (one row of one channel reads as contiguous,
        # contiguous rows of a multiple of 8 samples as pitched)
        pitched = _pitched(K, xb)
        if layout == "contiguous":
            assert not pitched or t_in % 8 == 0, label
        else:
            assert pitched or (b, cin) == (1, 1), label
        w = (torch.randn((cout, cin, kw), generator=g) / (cin * kw) ** 0.5).cuda()
        bias = (torch.randn((cout,), generator=g) * 0.1).cuda() if has_bias else None
        a = (torch.rand((cout,), generator=g) * 0.3).cuda()
        t_out = K._check(x, w, bias, a, s)
        shape = (b, cout, t_out)
        assert t_out == (t_in - kw) // s + 1, (label, t_out)
        tc_shape = K._tensor_core_shape(torch.float32, cout, kw, s, t_out)
        wg_shape = K._wgmma_shape(torch.float32, cin, cout, kw, s, t_out, pitched)
        if (t_in - kw) % s == 0 and (tc_shape or wg_shape):
            assert s * (t_out - 1) + K.KP - 1 == t_in, label  # the zero tap reads x[T_in]
        # the other routes that take the shape, each held against plain too
        others = [r for r, ok in (("wgmma", wg_shape), ("mma", tc_shape),
                                  ("fma", tc_shape or wg_shape)) if ok]
        # fp32: the route that _route picks (3xTF32 on the tensor cores at the main-path
        # shapes, wgmma where the rule gives it, but enc1's FMA rows), read from the
        # counters, then the other routes forced
        route = K._route(torch.float32, b, cin, cout, kw, s, t_out, pitched)
        before = _counters(K)
        y, pre = K._launch(x, w, bias, a, s, t_out,
                           out=nan_outputs(shape, shape, dtype=x.dtype))
        y_ref, pre_ref = K.conv1d_prelu_plain(x, w, bias, a, s)
        torch.cuda.synchronize()
        took = _took(K, before)
        assert took == route, f"{label}: fp32 took the {took} route, not {route}"
        assert K.launches_tf32 - before[2] == (took != "fma"), label
        e32 = worst([rel_err(y, y_ref), rel_err(pre, pre_ref)])
        assert e32 <= FP32_TOL, f"{label}: fp32 {took} vs plain rel err {e32:.3e} > {FP32_TOL}"
        e32_abs = worst([float((y - y_ref).abs().max()), float((pre - pre_ref).abs().max())])
        if kind != "edge" and cin == 512 and b >= 64:
            # the deepest layer against float64: the tensor cores' own fp32 sums do not
            # promise to round to nearest, and the plain version has errors of its own
            # (at B = 150 enc5's 2400 rows leave the last 64-row tile half full)
            pre64 = F.conv1d(x.double(), w.double(),
                             bias.double() if has_bias else None, stride=s)
            e64, e64_plain = rel_err(pre, pre64), rel_err(pre_ref, pre64)
            print(f"{label}: fp32 pre vs a float64 conv: rel err {e64:.3e} on the {took} "
                  f"route, {e64_plain:.3e} for the plain version", flush=True)
            assert e64 <= FP32_TOL, f"{label}: fp32 {took} vs float64 rel err {e64:.3e}"
            del pre64
        if main and b == 64:
            max_abs32 = worst([max_abs32, e32_abs])
        del y, pre
        e32f = {}
        for r in others:
            if r == took:
                continue
            yf, pref = K._launch(x, w, bias, a, s, t_out, force=r,
                                 out=nan_outputs(shape, shape, dtype=x.dtype))
            torch.cuda.synchronize()
            e32f[r] = worst([rel_err(yf, y_ref), rel_err(pref, pre_ref)])
            assert e32f[r] <= FP32_TOL, f"{label}: fp32 {r} vs plain rel err {e32f[r]:.3e}"
            del yf, pref
        del y_ref, pre_ref
        nan = float("nan")
        t32 = dict.fromkeys(("pick", "mma", "fma", "plain", "cuDNN"), nan)
        d32 = dict.fromkeys(("pick", "mma"), nan)
        if kind != "rows":  # serving's few-row shapes: fp32's routes held, not timed
            arms32 = {"pick": lambda: K.fused_conv1d_prelu(x, w, bias, a, s)}
            for r in ("mma", "fma") if tc_shape else ("fma",):
                arms32[r] = lambda r=r: K._launch(x, w, bias, a, s, t_out, force=r)
            arms32["plain"] = lambda: K.conv1d_prelu_plain(x, w, bias, a, s)
            arms32["cuDNN"] = lambda: F.conv1d(x, w, bias, stride=s)
            t32.update({n: v[0] for n, v in _in_turns(arms32).items()})
            # the chosen route's kernels and mma.sync's, device time (10 launches back to
            # back through the entry points, median of DEVICE_REPS)
            outs = nan_outputs(shape, shape, dtype=x.dtype)
            d32.update({n: v[0] for n, v in _in_turns(
                {n: _entry_arm(K, took if n == "pick" else n, x, w, bias, a, s, t_out, outs)
                 for n in ("pick", "mma") if n == "pick" or tc_shape},
                reps=DEVICE_REPS, calls=10).items()})
            del outs
        # bf16: the route that _route picks, read from the counters, then mma.sync and the
        # FMA kernel forced; all of them, plain and cuDNN timed in turns
        hb = [xb] + [v.bfloat16() if v is not None else None for v in (w, bias, a)]
        del x, w
        route16 = K._route(torch.bfloat16, b, cin, cout, kw, s, t_out, pitched)
        before = _counters(K)
        yb, preb = K._launch(*hb, s, t_out,
                             out=nan_outputs(shape, shape, dtype=torch.bfloat16))
        yb_ref, preb_ref = K.conv1d_prelu_plain(*hb, s)
        torch.cuda.synchronize()
        took16 = _took(K, before)
        assert took16 == route16, f"{label}: bf16 took the {took16} route, not {route16}"
        assert yb.dtype == torch.bfloat16
        e16 = worst([rel_err(yb, yb_ref), rel_err(preb, preb_ref)])
        assert e16 <= BF16_TOL, f"{label}: bf16 {took16} vs plain rel err {e16:.3e} > {BF16_TOL}"
        e16_abs = worst([float((yb - yb_ref).abs().max()), float((preb - preb_ref).abs().max())])
        if main:
            max_abs[b] = worst([max_abs.get(b, 0.0), e16_abs])
        del yb, preb
        e16f = {}
        rows_shape = (K._rows_shape(torch.bfloat16, cin, cout, kw, s) and b * t_out
                      <= K.ROWS_MAX_ROWS and K._rows_fits(b, cin, t_out))
        for r in (["rows"] if rows_shape else []) + others + (
                ["fma"] if took16 == "rows" and "fma" not in others else []):
            if r == took16:
                continue
            yf, pref = K._launch(*hb, s, t_out, force=r,
                                 out=nan_outputs(shape, shape, dtype=torch.bfloat16))
            torch.cuda.synchronize()
            e16f[r] = worst([rel_err(yf, yb_ref), rel_err(pref, preb_ref)])
            assert e16f[r] <= BF16_TOL, f"{label}: bf16 {r} vs plain rel err {e16f[r]:.3e}"
            del yf, pref
        del yb_ref, preb_ref
        arms = {"pick": lambda: K.fused_conv1d_prelu(*hb, s)}
        for r in ("mma", "fma") if tc_shape else ("fma",):
            arms[r] = lambda r=r: K._launch(*hb, s, t_out, force=r)
        arms["plain"] = lambda: K.conv1d_prelu_plain(*hb, s)
        arms["cuDNN"] = lambda: F.conv1d(hb[0], hb[1], hb[2], stride=s)
        t16i = _in_turns(arms)
        t16 = {n: v[0] for n, v in t16i.items()}
        t16.setdefault("mma", float("nan"))
        # the chosen route and mma.sync: their kernels' device time (10 launches back to
        # back through the entry points), and a wrapper call's cost back to back (5 calls
        # per pair of events: the host's time where it is the longer, as in a G forward at
        # few chunks; the rule's measure)
        pair = {r: arms[r] for r in ("pick", "mma") if r in arms}
        # where the rows kernel is chosen, the route it replaced (the rule without it)
        replaced = (K._route(torch.bfloat16, b, cin, cout, kw, s, t_out, pitched, rows=False)
                    if took16 == "rows" else None)
        outs = nan_outputs(shape, shape, dtype=torch.bfloat16)
        d16 = {n: v[0] for n, v in _in_turns(
            {n: _entry_arm(K, took16 if n == "pick" else n, *hb, s, t_out, outs)
             for n in list(pair) + ([replaced] if replaced not in (None, "mma") else [])},
            reps=DEVICE_REPS, calls=10).items()}
        d16.setdefault("mma", float("nan"))
        if replaced is not None:  # and a call's cost of each, 5 back to back
            b2b_rows = _in_turns({"pick": arms["pick"], replaced: arms.get(replaced) or (
                lambda: K._launch(*hb, s, t_out, force=replaced))}, calls=5)
            rows_cases.append(dict(
                label=label, device_ms=d16["pick"], replaced=replaced,
                replaced_device_ms=d16[replaced], ms=t16["pick"],
                call_ms=b2b_rows["pick"][0], replaced_call_ms=b2b_rows[replaced][0],
                plain_ms=t16["plain"], library_ms=t16["cuDNN"],
                bound_ms=bound_ms(2.0 * b * t_out * cout * cin * kw,
                                  2 * (b * cin * t_in + cout * cin * kw
                                       + (2 if has_bias else 1) * cout + 2 * b * cout * t_out),
                                  BF16_PEAK),
                max_abs_err=e16_abs, err=e16, forced=dict(e16f)))
            assert d16["pick"] < d16[replaced], (
                f"{label}: the rows kernel took {d16['pick']:.4f} ms of device time, the "
                f"{replaced} route it replaced {d16[replaced]:.4f}")
        # the stride-4 rule's route against mma.sync, same call (stride 2's rule rests on
        # tools/conv1d_routes.py --stride 2)
        if tc_shape and took16 != "mma" and s == 4:
            b2b = _in_turns(pair, calls=5)
            spreads.append((label, b2b["pick"][0], b2b["mma"][0],
                            max(b2b["pick"][1], b2b["mma"][1])))
        flops = 2.0 * b * t_out * cout * cin * kw
        nbytes = 2 * (b * cin * t_in + cout * cin * kw + (2 if has_bias else 1) * cout
                      + 2 * b * cout * t_out)  # in bf16: x, w, b, a read, y, pre written
        kernel_ms = t16["pick"]
        if cin == 1:  # bound by memory: bytes/s and the share of the memory rate
            rate = nbytes / kernel_ms * 1e3
            rate = f"{rate * 1e-12:.3f} TB/s {rate / HBM_RATE:6.1%}"
        else:  # bound by operations: TFLOP/s and the share of the bf16 peak
            rate = flops / kernel_ms * 1e3
            rate = f"{rate * 1e-12:7.1f} {rate / BF16_PEAK:6.1%}"
        # useful fp32 TFLOP/s on the device, and the share of the 3xTF32 peak
        rate32 = flops / d32["pick"] * 1e3
        rate32 = f"{rate32 * 1e-12:7.1f} {3 * rate32 / TF32_PEAK:6.1%}"
        # fp32: the smaller of the FMA pipes' bound and the 3xTF32 tensor cores' (three
        # TF32 products per fp32 product); bytes of fp32 x, w, b, a, y and pre
        b32 = min(bound_ms(flops, 2 * nbytes, FP32_PEAK),
                  bound_ms(3 * flops, 2 * nbytes, TF32_PEAK))
        b16 = bound_ms(flops, nbytes, BF16_PEAK)
        if label == D_ENC1:
            d_enc1 = dict(d_enc1_ms=t16["pick"], d_enc1_plain_ms=t16["plain"],
                          d_enc1_bound_ms=b16, d_enc1_library_ms=t16["cuDNN"],
                          d_enc1_max_abs_err=e16_abs, fp32_d_enc1_ms=t32["pick"],
                          fp32_d_enc1_plain_ms=t32["plain"], fp32_d_enc1_bound_ms=b32,
                          fp32_d_enc1_library_ms=t32["cuDNN"],
                          fp32_d_enc1_max_abs_err=e32_abs)
        if main:
            for col, v in [("fp32 pick", t32["pick"]), ("fp32 mma", t32["mma"]),
                           ("fp32 fma", t32["fma"]), ("fp32 plain", t32["plain"]),
                           ("fp32 cuDNN", t32["cuDNN"]), ("fp32 bound", b32),
                           ("fp32 pick device", d32["pick"]),
                           ("fp32 mma device", d32["mma"]), ("bf16 pick", t16["pick"]),
                           ("bf16 mma", t16["mma"]), ("bf16 fma", t16["fma"]),
                           ("bf16 plain", t16["plain"]), ("bf16 cuDNN", t16["cuDNN"]),
                           ("bf16 bound", b16), ("bf16 pick device", d16["pick"]),
                           ("bf16 mma device", d16["mma"])]:
                sums[b, col] = sums.get((b, col), 0.0) + v
            for wg, tk, t, d, bnd, e_abs in ((wg64, took16, t16, d16, b16, e16_abs),
                                             (wg64_32, took, t32, d32, b32, e32_abs)):
                if b == 64 and tk == "wgmma":
                    for col, v in (("ms", t["pick"]), ("plain_ms", t["plain"]),
                                   ("library_ms", t["cuDNN"]), ("bound_ms", bnd),
                                   ("device_ms", d["pick"]),
                                   ("mma_sync_device_ms", d["mma"])):
                        wg[col] = wg.get(col, 0.0) + v
                    wg["max_abs_err"] = worst([wg.get("max_abs_err", 0.0), e_abs])
        if kind == "ws":
            for p, t, bnd, e_abs in (("fp32_", t32, b32, e32_abs), ("", t16, b16, e16_abs)):
                for col, v in (("kernel_ms", t["pick"]), ("plain_ms", t["plain"]),
                               ("library_ms", t["cuDNN"]), ("bound_ms", bnd)):
                    ws[p][col] = ws[p].get(col, 0.0) + WS_ROWS[label] * v
                ws[p]["max_abs_err"] = worst([ws[p].get("max_abs_err", 0.0), e_abs])
        nan = float("nan")
        print(f"{label:>18} {str((b, cin, t_in)):>19} {cout:>5} {t_out:>5} | {e32:8.1e} "
              f"{e32f.get('mma', nan):8.1e} {e32f.get('fma', nan):8.1e} {e16:8.1e} "
              f"{e16f.get('mma', nan):8.1e} {e16f.get('fma', nan):8.1e} | {took:>5} "
              + " ".join(f"{t32[c]:8.4f}" for c in ("pick", "mma", "fma", "plain", "cuDNN"))
              + f"; device {d32['pick']:.4f} vs mma.sync {d32['mma']:.4f} | {took16:>5} "
              + " ".join(f"{t16i[c][0]:8.4f} ({t16i[c][1]:.4f})" if c in t16i
                         else f"{'nan':>8} {'':8}"
                         for c in ("pick", "mma", "fma", "plain", "cuDNN"))
              + f"; device {d16['pick']:.4f} vs mma.sync {d16['mma']:.4f}"
              + f" | {rate} | {rate32} | {b32:.4f} {b16:.4f}", flush=True)
        del hb
    for b in (1, 8, 64, 300):
        print(f"encoder sum B={b}: " + ", ".join(
            f"{col} {sums[b, col]:.4f}" for col in ("fp32 pick", "fp32 mma", "fp32 fma",
                                                    "fp32 plain", "fp32 cuDNN", "fp32 bound",
                                                    "fp32 pick device", "fp32 mma device",
                                                    "bf16 pick", "bf16 mma", "bf16 fma",
                                                    "bf16 plain", "bf16 cuDNN", "bf16 bound",
                                                    "bf16 pick device", "bf16 mma device"))
              + f" ms; fp32 route / mma.sync {sums[b, 'fp32 pick'] / sums[b, 'fp32 mma']:.3f} "
              f"(device {sums[b, 'fp32 pick device'] / sums[b, 'fp32 mma device']:.3f}, "
              f"{sums[b, 'fp32 bound'] / sums[b, 'fp32 pick device']:.1%} of the bound), "
              f"route / fma {sums[b, 'fp32 pick'] / sums[b, 'fp32 fma']:.3f}, "
              f"route / cuDNN {sums[b, 'fp32 pick'] / sums[b, 'fp32 cuDNN']:.3f}; "
              f"bf16 route / mma.sync {sums[b, 'bf16 pick'] / sums[b, 'bf16 mma']:.3f} "
              f"(device {sums[b, 'bf16 pick device'] / sums[b, 'bf16 mma device']:.3f}), "
              f"mma.sync / fma {sums[b, 'bf16 mma'] / sums[b, 'bf16 fma']:.3f}, "
              f"route / cuDNN {sums[b, 'bf16 pick'] / sums[b, 'bf16 cuDNN']:.3f}")
        if b >= 64:  # the chosen routes at most 0.6x mma.sync forced on the device, in
            # each dtype; bf16 mma.sync at least halving the FMA route's time; fp32 (3xTF32,
            # chosen and mma.sync) no slower than the FMA route
            for dt in ("bf16", "fp32"):
                assert sums[b, f"{dt} pick device"] <= 0.6 * sums[b, f"{dt} mma device"], (
                    b, dt, sums)
            assert sums[b, "bf16 mma"] <= 0.5 * sums[b, "bf16 fma"], (b, sums)
            assert max(sums[b, "fp32 pick"], sums[b, "fp32 mma"]) <= sums[b, "fp32 fma"], (
                b, sums)
    print("bf16 shapes where _route picks another route than mma.sync, ms a call of the "
          "chosen route vs mma.sync forced, 5 calls back to back (same-call spread, the "
          "larger interquartile range of the two): "
          + "; ".join(f"{l} {c:.4f} vs {m:.4f} ({sp:.4f})" for l, c, m, sp in spreads),
          flush=True)
    slower = [(l, c, m, sp) for l, c, m, sp in spreads if c > m + sp]
    assert not slower, f"the chosen route slower than mma.sync beyond the spread: {slower}"
    print("bf16 shapes on the rows kernel, device ms (10 launches back to back through the "
          "entry points) against the route it replaced, then a call 5 back to back of each, "
          "one call in turns, plain, cuDNN, bound, rel err (forced routes' rel err): " + "; ".join(
              f"{r['label']} {r['device_ms']:.4f} vs {r['replaced']} "
              f"{r['replaced_device_ms']:.4f}, calls {r['call_ms']:.4f} vs "
              f"{r['replaced_call_ms']:.4f}, {r['ms']:.4f}, {r['plain_ms']:.4f}, "
              f"{r['library_ms']:.4f}, {r['bound_ms']:.4f}, {r['err']:.1e} ("
              + ", ".join(f"{k} {v:.1e}" for k, v in r["forced"].items()) + ")"
              for r in rows_cases), flush=True)
    one_chunk = [r for r in rows_cases if r["label"] in ("B=1 enc3", "B=1 enc4", "B=1 enc5")]
    assert len(one_chunk) == 3, [r["label"] for r in rows_cases]
    rows_line = {col: sum(r[col] for r in one_chunk)
                 for col in ("ms", "device_ms", "replaced_device_ms", "call_ms",
                             "replaced_call_ms", "plain_ms", "library_ms", "bound_ms")}
    rows_line.update(max_abs_err=worst(r["max_abs_err"] for r in rows_cases),
                     bound_by="bytes", shapes=len(rows_cases))
    print("the rows kernel at one chunk's enc3-5, summed: " + ", ".join(
        f"{k} {v:.4f}" for k, v in rows_line.items() if isinstance(v, float)), flush=True)
    print("WSEGAN step B=150, the kernel's 25 calls (G's enc1-5 once, D's enc1-5 in each of "
          "four passes), ms and max abs err: " + "; ".join(
              f"{p[:-1] or 'bf16'} " + ", ".join(f"{col} {v:.4g}" for col, v in c.items())
              for p, c in ws.items()), flush=True)
    return dict(d_enc1, **{f"{p}wsegan_step_{col}": v for p, c in ws.items()
                           for col, v in c.items()},
                max_abs_err=max_abs[64], ms=sums[64, "bf16 pick"],
                mma_sync_ms=sums[64, "bf16 mma"],
                plain_ms=sums[64, "bf16 plain"], bound_ms=sums[64, "bf16 bound"],
                bound_by="operations", library_ms=sums[64, "bf16 cuDNN"],
                fp32_max_abs_err=max_abs32, fp32_ms=sums[64, "fp32 pick"],
                fp32_mma_sync_ms=sums[64, "fp32 mma"],
                fp32_fma_ms=sums[64, "fp32 fma"], fp32_plain_ms=sums[64, "fp32 plain"],
                fp32_bound_ms=sums[64, "fp32 bound"], fp32_library_ms=sums[64, "fp32 cuDNN"],
                fp32_device_ms=sums[64, "fp32 pick device"],
                fp32_mma_sync_device_ms=sums[64, "fp32 mma device"],
                fp32_ms_b300=sums[300, "fp32 pick"],
                fp32_mma_sync_ms_b300=sums[300, "fp32 mma"],
                fp32_device_ms_b300=sums[300, "fp32 pick device"],
                fp32_mma_sync_device_ms_b300=sums[300, "fp32 mma device"],
                ms_b300=sums[300, "bf16 pick"], mma_sync_ms_b300=sums[300, "bf16 mma"],
                device_ms=sums[64, "bf16 pick device"],
                mma_sync_device_ms=sums[64, "bf16 mma device"],
                device_ms_b300=sums[300, "bf16 pick device"],
                mma_sync_device_ms_b300=sums[300, "bf16 mma device"]), dict(
                    wg64, bound_by="operations"), dict(wg64_32, bound_by="operations"), rows_line


def phase_enc23():
    """The chained kernel vs enc23_plain on the card, into NaN-filled outputs, each route
    read from its counters: fp32 on the route _route picks, then on the wgmma kernel at
    each cluster size where it takes the shape, on enc23_tf32_kernel at both tiles and on
    the FMA kernel forced; bf16 on the route _route picks and on the other one forced
    (wgmma and mma.sync); at B = 300 also vs the per-layer kernel chain in pitched rows
    (bf16: pre2 bit for bit) and fp32 pre3 of both 3xTF32 kernels vs a float64 chain.
    Times in turns, and at B = 1, 64 and 300 the device alone (CUDA graphs of 10 calls
    through the C entry points). Returns the max abs errors at the SEGAN+ widths (fp32 of
    the rule's route and of enc23_tf32_kernel forced), the times in turns and the device
    times, each by dtype and batch."""
    import torch
    import torch.nn.functional as F
    from segan_pytorch_tpu_torch.ops.conv import reflect_pad_1d
    from segan_pytorch_tpu_torch.ops.kernels import encoder_fused as EF
    from segan_pytorch_tpu_torch.ops.kernels.conv1d_prelu import conv1d_prelu_plain
    from segan_pytorch_tpu_torch.tools import encoder_fused_bench as bench

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(SEED + 4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [  # (label, B, T1, C1, C2, C3, bias, SEGAN+ widths)
        ("B=1", 1, 4096, 64, 128, 256, False, True),
        ("B=8", 8, 4096, 64, 128, 256, False, True),
        ("B=37", 37, 4096, 64, 128, 256, False, True),
        ("B=64", 64, 4096, 64, 128, 256, False, True),
        ("B=300", 300, 4096, 64, 128, 256, False, True),
        ("B=8 bias", 8, 4096, 64, 128, 256, True, True),
        ("wide T1=64 bias", 3, 64, 5, 128, 256, True, False),
        ("wide T1=64", 3, 64, 5, 128, 256, False, False),
        ("wide T1=1168 bias", 2, 1168, 8, 128, 256, True, False),
        ("wide T1=1168", 2, 1168, 8, 128, 256, False, False),
        ("wide T1=3200", 3, 3200, 64, 128, 256, False, False),
        ("narrow T1=64", 3, 64, 5, 24, 40, True, False),
        ("ragged tile T1=592", 2, 592, 5, 24, 40, False, False),
    ]
    timed = ("B=1", "B=8", "B=64", "B=300")
    device_timed = ("B=1", "B=64", "B=300")
    max_abs = {torch.float32: 0.0, torch.bfloat16: 0.0, "tf32 forced": 0.0}
    timed_ms = {torch.float32: {}, torch.bfloat16: {}}
    device = {torch.float32: {}, torch.bfloat16: {}}
    counters = lambda: (EF.launches, EF.launches_tf32, EF.launches_tile16,
                        EF.launches_wgmma, EF.launches_wgmma_tf32)
    start = counters()

    def launched(run, want):
        """run() and check that it made one launch of the route and tile `want`."""
        before = counters()
        out = run()
        torch.cuda.synchronize()
        moved = tuple(n - b for n, b in zip(counters(), before))
        assert moved == want, (f"launches (all, tf32, tile 16, wgmma, wgmma_tf32) moved "
                               f"by {moved}, not {want}")
        return out

    want_of = {"tf32": lambda t: (1, 1, int(t == 16), 0, 0),
               "fma": lambda t: (1, 0, 0, 0, 0), "mma": lambda t: (1, 0, 0, 0, 0),
               "wgmma": lambda t: (1, 0, 0, 1, 0), "wgmma_tf32": lambda t: (1, 0, 0, 0, 1)}
    for label, b, t1, c1, c2, c3, has_bias, full in cases:
        h1 = torch.randn((b, c1, t1), generator=g).cuda()
        w2 = (torch.randn((c2, c1, EF.K), generator=g) / (c1 * EF.K) ** 0.5).cuda()
        w3 = (torch.randn((c3, c2, EF.K), generator=g) / (c2 * EF.K) ** 0.5).cuda()
        b2, b3 = ((torch.randn((c,), generator=g) * 0.1).cuda() if has_bias else None
                  for c in (c2, c3))
        a2, a3 = ((torch.rand((c,), generator=g) * 0.3).cuda() for c in (c2, c3))
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            args = [v.to(dtype) if v is not None else None
                    for v in (h1, w2, b2, a2, w3, b3, a3)]
            EF._check(*args)
            shapes = [(b, c2, t1 // 4), (b, c3, t1 // 16), (b, c3, t1 // 16)]
            fp32 = dtype == torch.float32
            nan_out = lambda: nan_outputs(*shapes, dtype=dtype)
            # the route that _route picks: at the SEGAN+ widths from one chunk's enc3 rows
            # wgmma (fp32 by 3xTF32), else mma.sync (fp32 by 3xTF32 at the tile by batch)
            route = EF._route(dtype, c2, c3, b * (t1 // 16), args[0].data_ptr() % 16 == 0)
            tile = EF._tf32_tile(b, t1, sms) if route == "tf32" else (
                EF.WGMMA_TILE if route in ("wgmma", "wgmma_tf32") else 32)
            got = launched(lambda: EF._launch(*args, out=nan_out()), want_of[route](tile))
            ref = EF.enc23_plain(*args)
            err = worst(rel_err(o, r) for o, r in zip(got, ref))
            assert err <= tol, f"{label} {dtype} {route}: vs plain rel err {err:.3e} > {tol}"
            if full:
                max_abs[dtype] = worst([max_abs[dtype]] + [float((o - r).abs().max())
                                                           for o, r in zip(got, ref)])
            errs = {}
            if fp32:  # the wgmma kernel at each cluster, both tiles of mma.sync, FMAs
                if EF._wgmma_shape(dtype, c2, c3, True):
                    for cl in EF.WGMMA_TF32_CLUSTERS:
                        o = launched(lambda: EF._launch(*args, force="wgmma_tf32", cluster=cl,
                                                        out=nan_out()),
                                     want_of["wgmma_tf32"](0))
                        errs[f"CL{cl}"] = worst(rel_err(v, r) for v, r in zip(o, ref))
                for t in (16, 32):
                    o = launched(lambda: EF._launch(*args, force="tf32", tile=t,
                                                    out=nan_out()),
                                 want_of["tf32"](t))
                    errs[f"tile {t}"] = worst(rel_err(v, r) for v, r in zip(o, ref))
                    if full:
                        max_abs["tf32 forced"] = worst(
                            [max_abs["tf32 forced"]] + [float((v - w).abs().max())
                                                        for v, w in zip(o, ref)])
                    if t == EF._tf32_tile(b, t1, sms):
                        forced_tf32 = o  # enc23_tf32_kernel at the tile its rule picks
                o = launched(lambda: EF._launch(*args, force="fma", out=nan_out()),
                             want_of["fma"](0))
                errs["fma"] = worst(rel_err(v, r) for v, r in zip(o, ref))
            else:  # the other bf16 route forced, where it takes the call
                for other in ("mma", "wgmma"):
                    if other == route or (other == "wgmma" and not EF._wgmma_shape(
                            dtype, c2, c3, True)):
                        continue
                    o = launched(lambda: EF._launch(*args, force=other, out=nan_out()),
                                 want_of[other](0))
                    errs[other] = worst(rel_err(v, r) for v, r in zip(o, ref))
            bad = {k: e for k, e in errs.items() if not e <= tol}
            assert not bad, f"{label} {dtype} forced routes vs plain rel err over {tol}: {bad}"
            if b == 300:
                x2 = bench.kernel_x2(*args)
                errs["x2"] = worst(rel_err(o, r) for o, r in zip(got, x2))
                assert errs["x2"] <= tol, f"{label} {dtype}: chained vs kernel x2 {errs['x2']}"
                if not fp32:
                    # pre2: the per-layer wgmma kernel's MMAs in its order; enc3 sums the
                    # folded depth (tap-major) where the per-layer kernel sums by channel
                    diffs = [float((o.float() - r.float()).abs().max()) for o, r in zip(got, x2)]
                    print(f"{label} bf16 {route} vs kernel x2 (pitched, per-layer wgmma): "
                          f"max abs pre2 {diffs[0]:.3e}, pre3 {diffs[1]:.3e}, post3 "
                          f"{diffs[2]:.3e}; pre2 bit for bit {torch.equal(got[0], x2[0])}")
                    assert route != "wgmma" or torch.equal(got[0], x2[0]), diffs
                del x2
                if fp32:  # the deepest sum, pre3, of both 3xTF32 kernels against float64
                    ref64 = EF.enc23_plain(*[v.double() if v is not None else None
                                             for v in args])
                    errs["f64"] = rel_err(got[1], ref64[1])
                    errs["f64 tf32"] = rel_err(forced_tf32[1], ref64[1])
                    e_plain = rel_err(ref[1], ref64[1])
                    del ref64
                    print(f"{label}: fp32 pre3 vs a float64 chain: rel err {errs['f64']:.3e} "
                          f"on {route}, {errs['f64 tf32']:.3e} on enc23_tf32_kernel (the "
                          f"plain chain {e_plain:.3e})")
                    assert errs["f64"] <= FP32_TOL, f"{label}: pre3 vs float64 {errs['f64']}"
                    assert errs["f64 tf32"] <= FP32_TOL, (label, errs["f64 tf32"])
            if fp32:
                del forced_tf32
            del got, ref
            print(f"{label:>20} {str(dtype)[6:]:>8} {route:>5} {tile:>2} | rel err {err:.2e}"
                  + "".join(f", {k} {v:.2e}" for k, v in errs.items()), flush=True)
            if label not in timed:
                continue
            # in turns: the arms of the A/B tool, fp32 at both tiles and on the FMA kernel
            # forced, bf16 on mma.sync forced where it takes wgmma, and cuDNN's two convs
            # alone (the library's share of the plain chain)
            h1p = reflect_pad_1d(args[0], *EF.PAD)
            p2p = reflect_pad_1d(conv1d_prelu_plain(h1p, *args[1:4], EF.S)[0], *EF.PAD)
            arms = {name: lambda arm=arm: arm(*args) for name, arm in bench.ARMS.items()}
            if fp32:
                for t in (16, 32):
                    arms[f"tile {t}"] = lambda t=t: EF._launch(*args, force="tf32", tile=t)
                arms["fma"] = lambda: EF._launch(*args, force="fma")
            elif route == "wgmma":
                arms["mma.sync"] = lambda: EF._launch(*args, force="mma")
            arms["cuDNN x2"] = lambda: (F.conv1d(h1p, args[1], args[2], stride=EF.S),
                                        F.conv1d(p2p, args[4], args[5], stride=EF.S))
            ms = bench.ms_in_turns(arms, reps=10, warmup=2)
            del h1p, p2p
            flops, nbytes = enc23_work(b, t1, c1, c2, c3, has_bias, args[0].element_size())
            # fp32: the smaller of the FMA pipes' bound and the 3xTF32 tensor cores'
            ms["bound"] = (min(bound_ms(flops, nbytes, FP32_PEAK),
                               bound_ms(3 * flops, nbytes, TF32_PEAK)) if fp32
                           else bound_ms(flops, nbytes, BF16_PEAK))
            print(f"{label:>20} {str(dtype)[6:]:>8} ms: " + ", ".join(
                f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
            if fp32:  # enc23_tf32_kernel at the tile its rule picks
                ms["tf32"] = ms[f"tile {EF._tf32_tile(b, t1, sms)}"]
            if fp32 and b >= 8:  # the tensor cores no slower than the FMA kernel forced
                assert ms["fused 2+3"] <= ms["fma"], (label, ms)
            if label in device_timed:
                dev = device[dtype][b] = bench.graph_ms(bench.device_arms(*args), reps=6)
                dev["bound"] = ms["bound"]
                print(f"{label:>20} {str(dtype)[6:]:>8} device ms: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in dev.items()), flush=True)
                if not fp32 and b >= 64:  # the bf16 wgmma kernel ahead of mma.sync's
                    assert dev["fused wgmma"] < dev["fused mma.sync"], dev
                if route == "wgmma_tf32":  # where the rule sends fp32: ahead of mma.sync's
                    assert dev["fused wgmma_tf32"] < dev["fused tf32"], dev
            timed_ms[dtype][b] = ms
    # fp32 C3 = 36 (not whole n8 tiles) takes the FMA kernel, and is right
    odd = [(torch.randn(s, generator=g) * 0.1).cuda()
           for s in ((2, 5, 128), (24, 5, EF.K), (24,), (24,), (36, 24, EF.K), (36,), (36,))]
    shapes = [(2, 24, 32), (2, 36, 8), (2, 36, 8)]
    got = launched(lambda: EF._launch(*odd, out=nan_outputs(*shapes, dtype=torch.float32)),
                   (1, 0, 0, 0, 0))
    err = worst(rel_err(o, r) for o, r in zip(got, EF.enc23_plain(*odd)))
    print(f"fp32 C3 = 36: FMA kernel, rel err {err:.2e}")
    assert err <= FP32_TOL, f"fp32 C3 = 36 vs plain rel err {err:.3e}"
    bad = [v.bfloat16() for v in odd]
    before = counters()
    try:
        EF.fused_enc23_fwd(*bad)
    except ValueError as e:
        print(f"bf16 C3 = 36 refused: {e}")
    else:
        raise AssertionError("the bf16 kernel took C3 = 36, which is not whole n8 tiles")
    assert counters() == before, "a refused call launched the kernel"
    print("chained kernel launches in phase 3b (all, mma.sync 3xTF32, of those at tile 16, "
          f"wgmma, wgmma 3xTF32): {tuple(n - b for n, b in zip(counters(), start))}")
    # where the tile rule switches: both fp32 tiles in turns on either side of B * 8 = SMs
    for b in (16, 32):
        args = bench.make_inputs(b, dtype=torch.float32, device="cuda")
        ms = bench.ms_in_turns({t: lambda t=t: EF._launch(*args, force="tf32", tile=t)
                                for t in (16, 32)}, reps=10, warmup=2)
        print(f"fp32 tiles at B={b}: 16 {ms[16]:.4f} ms, 32 {ms[32]:.4f} ms; the rule takes "
              f"{EF._tf32_tile(b, 4096, sms)}", flush=True)
    return max_abs, timed_ms, device


def phase_tool():
    """The A/B tool at its defaults (batch 300, bf16: the chained kernel on wgmma, kernel
    x2 in pitched rows on the per-layer wgmma route), then in fp32 (the chained kernel on
    its fp32 wgmma route, the per-layer pair on wgmma by 3xTF32), each beside the chained
    kernel forced onto mma.sync: the path of the chained kernel. Returns its results by
    dtype and the launches of both kernels in it."""
    import torch
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.ops.kernels import encoder_fused as EF
    from segan_pytorch_tpu_torch.tools import encoder_fused_bench as bench

    K.launches = K.launches_mma = K.launches_tf32 = K.launches_wgmma = K.launches_rows = 0
    EF.launches = EF.launches_tf32 = EF.launches_tile16 = EF.launches_wgmma = 0
    EF.launches_wgmma_tf32 = 0
    res = {"bfloat16": bench.main([])}
    torch.cuda.synchronize()
    bf16 = {"fused_conv1d_prelu": K.launches, "fused_conv1d_prelu wgmma": K.launches_wgmma,
            "fused_enc23_fwd": EF.launches, "fused_enc23_fwd wgmma": EF.launches_wgmma}
    res["float32"] = bench.main(["--dtype", "float32"])
    torch.cuda.synchronize()
    counts = {"fused_conv1d_prelu": K.launches, "fused_enc23_fwd": EF.launches,
              "fused_enc23_fwd tf32": EF.launches_tf32,
              "fused_enc23_fwd wgmma": EF.launches_wgmma,
              "fused_enc23_fwd wgmma_tf32": EF.launches_wgmma_tf32,
              "fused_enc23_fwd mma.sync": EF.launches - EF.launches_wgmma
              - EF.launches_wgmma_tf32}
    print(f"kernel launches in the A/B tool: {counts}; in its bf16 run {bf16}; "
          f"{K.launches_mma} of the per-layer kernel's on the tensor cores, "
          f"{K.launches_wgmma} on wgmma")
    assert all(n > 0 for n in counts.values()), counts
    assert K.launches_wgmma == K.launches, "kernel x2 left wgmma at 300 chunks"
    assert bf16["fused_enc23_fwd wgmma"] == counts["fused_enc23_fwd wgmma"] > 0 and bf16[
        "fused_enc23_fwd"] > bf16["fused_enc23_fwd wgmma"], "bf16: wgmma and mma.sync forced"
    assert counts["fused_enc23_fwd mma.sync"] == bf16["fused_enc23_fwd"] - bf16[
        "fused_enc23_fwd wgmma"] + counts["fused_enc23_fwd tf32"], "fp32 left its routes"
    assert EF.launches_tile16 == 0, "fp32 mma.sync forced off tile 32 at 300 chunks"
    assert (res["bfloat16"]["route"], res["float32"]["route"]) == ("wgmma", "wgmma_tf32"), res
    for dtype, tol in (("bfloat16", BF16_TOL), ("float32", FP32_TOL)):
        r = res[dtype]
        assert all(e <= tol for e in r["rel"].values()) and r["rel_mma"] <= tol, r
    return res, counts


def phase_tf32():
    """The port's TF32 policy: with cuDNN's TF32 switched on process-wide (PyTorch's
    default), a bare fp32 GDeconv1DBlock at G's second decoder shape and the convs of
    Conv1dPReLU's backward at enc3's shape still match float64 on the CPU. TF32 stays on
    for phase 4, whose card-vs-CPU check then rests on the ops' policy alone."""
    import torch
    from segan_pytorch_tpu_torch.models.modules import GDeconv1DBlock
    from segan_pytorch_tpu_torch.ops import conv as conv_ops
    from segan_pytorch_tpu_torch.ops.conv import conv1d_weight, conv_transpose1d
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K

    torch.backends.cudnn.allow_tf32 = True
    gen = torch.Generator().manual_seed(SEED + 5)
    blk = GDeconv1DBlock(1024, 256, 31, stride=4, generator=gen)
    with torch.no_grad():
        blk.act.weight.uniform_(0.0, 0.3, generator=gen)
    x = torch.randn((8, 1024, 64), generator=gen)
    with torch.no_grad():
        got = blk.cuda()(x.cuda()).cpu()
        # the same with the policy bypassed: what the check would see without it
        policy = conv_ops.full_precision
        conv_ops.full_precision = lambda dtype: contextlib.nullcontext()
        try:
            bypassed = blk(x.cuda()).cpu()
        finally:
            conv_ops.full_precision = policy
        want = blk.cpu().double()(x.double())
    e_dec, e_bypassed = rel_err(got, want), rel_err(bypassed, want)
    # Conv1dPReLU's backward on the card vs its convs in float64, from the card's own
    # pre (a pre within rounding of 0 may take the other PReLU branch in float64)
    x = torch.randn((8, 128, 1053), generator=gen)
    w = torch.randn((256, 128, 31), generator=gen) / (128 * 31) ** 0.5
    a = torch.rand((256,), generator=gen) * 0.3
    gy, gpre = (torch.randn((8, 256, 256), generator=gen) for _ in range(2))
    xc, wc, ac = (v.cuda().requires_grad_() for v in (x, w, a))
    y, pre = K.conv1d_prelu(xc, wc, None, ac, 4)
    torch.autograd.backward([y, pre], [gy.cuda(), gpre.cuda()])
    pre64 = pre.detach().cpu().double()
    dpre = torch.where(pre64 > 0, gy.double(), gy.double() * a.double().view(1, -1, 1))
    dpre = dpre + gpre.double()
    dx = conv_transpose1d(dpre, w.double(), stride=4)
    dx = torch.nn.functional.pad(dx, (0, x.shape[2] - dx.shape[2]))
    dw = conv1d_weight(x.double(), w.shape, dpre, stride=4)
    e_dx, e_dw = rel_err(xc.grad.cpu(), dx), rel_err(wc.grad.cpu(), dw)
    print(f"TF32 on process-wide: fp32 GDeconv1DBlock (8, 1024, 64) -> 256 vs float64 rel "
          f"err {e_dec:.3e} ({e_bypassed:.3e} with the ops' policy bypassed); "
          f"Conv1dPReLU backward dx {e_dx:.3e}, dw {e_dw:.3e}")
    assert worst([e_dec, e_dx, e_dw]) <= FP32_TOL, (e_dec, e_dx, e_dw)


def _write_wavs(wav_dir: Path):
    """8 int16 16 kHz wavs of 0.5-6 s: 1-chunk (<= 16384 samples) and multi-chunk."""
    from scipy.io import wavfile

    rng = np.random.RandomState(SEED)
    lengths = [8000, 14000, 16384, 27000, 40000, 53100, 74000, 96000]
    for i, n in enumerate(lengths):
        t = np.arange(n) / SR
        sig = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 800) * t) + 0.05 * rng.randn(n)
        wavfile.write(str(wav_dir / f"utt{i}.wav"), SR,
                      np.clip(sig * 32767, -32768, 32767).astype(np.int16))
    return lengths


def phase_slice(work: Path):
    """The port's main path at full SEGAN+ width. Returns the kernel launches it made
    (all, tensor cores, fp32 on the tensor cores, bf16 on wgmma, fp32 on wgmma, bf16 on
    the rows kernel)."""
    import torch
    from segan_pytorch_tpu_torch import clean
    from segan_pytorch_tpu_torch.data.wav_io import read_wav_raw
    from segan_pytorch_tpu_torch.models.generator import build_generator
    from segan_pytorch_tpu_torch.models.segan import SEGAN
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.tools.encoder_fused_bench import ms_in_turns
    from segan_pytorch_tpu_torch.utils.checkpoint import save_generator
    from segan_pytorch_tpu_torch.utils.config import SEGANConfig, dump_train_opts

    cfg = SEGANConfig(no_bias=True, save_path=str(work))
    gen = torch.Generator().manual_seed(SEED)
    G = build_generator(cfg, gen)
    with torch.no_grad():
        for name, p in G.named_parameters():
            if name.endswith("act.weight"):  # a fresh G has every slope at 0 (a ReLU)
                p.uniform_(0.0, 0.3, generator=gen)
    n_params = sum(p.numel() for p in G.parameters())
    ckpt = work / "segan+_generator.ckpt"
    save_generator(G, str(ckpt))
    opts_file = dump_train_opts(cfg, str(work))
    print(f"G: {n_params} parameters, checkpoint {ckpt.stat().st_size / 2**20:.1f} MiB")
    wav_dir = work / "noisy"
    wav_dir.mkdir()
    lengths = _write_wavs(wav_dir)
    audio_s = sum(lengths) / SR
    chunks = [-(-n // cfg.slice_size) for n in lengths]
    print(f"wavs: {len(lengths)}, {audio_s:.2f} s of audio, chunks per wav {chunks}")

    def run_clean(opts, b, out_dir):
        out_dir.mkdir()
        args = clean.build_parser().parse_args([
            "--g_pretrained_ckpt", str(ckpt), "--cfg_file", opts,
            "--test_files", str(wav_dir), "--synthesis_path", str(out_dir),
            "--seed", str(SEED), "--batch_utts", str(b), "--device", "cuda"])
        t0 = time.perf_counter()
        clean.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ys = []
        for i, n in enumerate(lengths):
            path = out_dir / f"utt{i}.wav"
            assert path.exists(), f"missing output {path}"
            _, y = read_wav_raw(str(path))
            assert y.shape == (n,), f"{path}: {y.shape} != ({n},)"
            assert np.isfinite(y).all(), f"{path}: non-finite samples"
            ys.append(y)
        return ys, wall

    # the main path: clean.py in fp32 (3xTF32 on the tensor cores), then in bf16
    cfg_bf16 = SEGANConfig(no_bias=True, compute_dtype="bfloat16", save_path=str(work))
    opts_bf16 = dump_train_opts(cfg_bf16, str(work / "bf16"))
    outs = {}
    K.launches = K.launches_mma = K.launches_tf32 = K.launches_wgmma = K.launches_rows = 0
    n_forwards = 0
    with _logged_launches() as log:
        for b in (1, 4):
            outs[b], wall = run_clean(opts_file, b, work / f"synth_b{b}")
            n_forwards += -(-len(lengths) // b)
            print(f"clean.py --batch_utts {b}: {audio_s / wall:.2f} s of audio per wall "
                  f"second ({audio_s:.2f} s in {wall:.3f} s, model load included)")
        fp32 = _counters(K)
        assert fp32 == _want_counts(K, log) and fp32[3] > 0, (fp32, _want_counts(K, log))
        assert fp32[0] >= 5 * n_forwards and fp32[0] % 5 == 0, (
            f"{fp32[0]} launches for {n_forwards} fp32 G forwards")
        del log[:]
        y_bf, wall = run_clean(opts_bf16, 4, work / "synth_bf16")
        y_bf1, wall1 = run_clean(opts_bf16, 1, work / "synth_bf16_b1")
        n_bf16 = -(-len(lengths) // 4) + len(lengths)
        bf = tuple(n - f for n, f in zip(_counters(K), fp32))
        assert bf == _want_counts(K, log), (bf, _want_counts(K, log))
    launches, launches_mma, launches_tf32, launches_wgmma, launches_rows = _counters(K)
    print(f"clean.py bf16 --batch_utts 4: {audio_s / wall:.2f} s of audio per wall second; "
          f"--batch_utts 1: {audio_s / wall1:.2f}")
    print(f"kernel launches on the main path: {launches} ({launches_mma} on the tensor "
          f"cores, {launches_tf32} of them in fp32 by 3xTF32; on wgmma {fp32[3]} fp32, "
          f"{bf[3]} bf16; on the rows kernel {bf[4]}) for {n_forwards} fp32 and {n_bf16} "
          f"bf16 G forwards, each on the route _route picks for its shape and G's pitched "
          f"rows")
    # bf16: enc2 on wgmma, enc3-5 of the one-chunk passes on the rows kernel
    assert bf[0] == 5 * n_bf16 and bf[2] == 0 and bf[3] > 0 and bf[4] > 0, bf
    assert fp32[4] == 0, fp32
    wgmma_bf16, wgmma_fp32, rows_bf16 = bf[3], fp32[3], bf[4]
    e_b1 = worst(np.abs(y1 - y4).max() / np.abs(y4).max() for y1, y4 in zip(y_bf1, y_bf))
    print(f"clean.py bf16 --batch_utts 1 vs 4 (the rows kernel vs mma.sync at one-chunk "
          f"passes' enc3-5): rel err {e_b1:.3e}")
    for y1, y4, yb in zip(outs[1], outs[4], y_bf):
        e = float(np.abs(y1 - y4).max() / np.abs(y1).max())
        assert e <= FP32_TOL, f"batched vs sequential rel err {e:.3e}"
    e_wav_bf = worst(np.abs(yb - y4).max() / np.abs(y4).max() for y4, yb in zip(outs[4], y_bf))
    print(f"clean.py bf16 vs fp32 wavs: rel err {e_wav_bf:.3e}")

    # the card vs a CPU copy of the same model (plain ops), same z; the device memory of
    # the split weights that the first fp32 forward caches
    gpu = SEGAN(cfg, device="cuda", seed=SEED)
    gpu.g_load_pretrained(str(ckpt))
    cpu = SEGAN(cfg, device="cpu", seed=SEED)
    cpu.g_load_pretrained(str(ckpt))
    wav = np.random.RandomState(SEED + 1).randn(lengths[3]).astype(np.float32) * 0.3
    z = np.random.RandomState(SEED + 2).randn(16, cfg.z_dim).astype(np.float32)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    y_gpu, gc_gpu = gpu.generate(wav, z=z)
    torch.cuda.synchronize()
    cached = torch.cuda.memory_allocated() - mem0
    ours = {id(p) for p in gpu.G.parameters()}
    want = sum(2 * 4 * w.shape[0] * w.shape[1] * K.KP  # (big, small), 32 taps, fp32
               for w in K._padded.keys() if id(w) in ours)
    print(f"device memory held after the first fp32 forward: {cached / 2**20:.1f} MiB "
          f"(the split encoder weights: {want / 2**20:.1f} MiB expected)")
    y_cpu, gc_cpu = cpu.generate(wav, z=z)
    e_wav = float(np.abs(y_gpu - y_cpu).max() / np.abs(y_cpu).max())
    e_gc = float(np.abs(gc_gpu - gc_cpu).max() / np.abs(gc_cpu).max())
    print(f"card vs CPU generate(): rel err {e_wav:.3e} (wav), {e_gc:.3e} (g_c)")
    assert e_wav <= SLICE_TOL and e_gc <= SLICE_TOL, (e_wav, e_gc)
    del cpu

    x64 = torch.from_numpy(np.random.RandomState(SEED + 3).randn(
        64, cfg.slice_size, 1).astype(np.float32) * 0.3).cuda()
    z64 = gpu.G.sample_z(tuple(x64.shape), torch.Generator().manual_seed(SEED)).cuda()

    def fma_route_forward(engine):  # the records hold routes: none read or kept meanwhile
        route = K._route
        K._route, records = (lambda *shape: "fma"), K._records
        K._records = {}
        try:
            return engine.infer_G(x64, z64)
        finally:
            K._route, K._records = route, records

    def mma_sync_forward(engine):  # the rule's routes, mma.sync in place of wgmma
        route = K._route
        K._route = lambda *shape: "mma" if route(*shape) == "wgmma" else route(*shape)
        records, K._records = K._records, {}
        try:
            return engine.infer_G(x64, z64)
        finally:
            K._route, K._records = route, records

    before = _counters(K)
    y32 = gpu.infer_G(x64, z64)
    routes32 = _g_routes(K, torch.float32, 64, cfg.slice_size, False)
    moved = [n - b for n, b in zip(_counters(K), before)]
    # 3xTF32 but enc1's FMA rows, enc2-5 on the fp32 wgmma route
    assert moved == [5, 5 - routes32.count("fma"), 5 - routes32.count("fma"), 4, 0] and (
        routes32.count("wgmma") == 4), (moved, routes32)
    before = K.launches_mma
    e32_fma = rel_err(fma_route_forward(gpu), y32)
    assert K.launches_mma == before and e32_fma <= SLICE_TOL, e32_fma
    before = K.launches_wgmma
    e32_sync = rel_err(mma_sync_forward(gpu), y32)
    assert K.launches_wgmma == before and e32_sync <= SLICE_TOL, e32_sync
    t = ms_in_turns({"rule": lambda: gpu.infer_G(x64, z64),
                     "mma": lambda: mma_sync_forward(gpu),
                     "fma": lambda: fma_route_forward(gpu)}, reps=10, warmup=2)
    print(f"G forward at batch 64 (fp32): {t['rule']:.3f} ms, {64e3 / t['rule']:.1f} "
          f"chunks/s (the rule's routes: " + ", ".join(routes32) + f"; 3xTF32 on the tensor "
          f"cores); {t['mma']:.3f} ms, {64e3 / t['mma']:.1f} chunks/s (mma.sync for wgmma, "
          f"same call; rule / mma.sync {t['rule'] / t['mma']:.3f}); {t['fma']:.3f} ms, "
          f"{64e3 / t['fma']:.1f} chunks/s (FMA route, same call); rel err vs the rule's "
          f"routes: mma.sync {e32_sync:.3e}, FMA route {e32_fma:.3e}")
    bf = SEGAN(cfg_bf16, generator=gpu.G, device="cuda")
    before = _counters(K)
    y_bf = bf.infer_G(x64, z64)
    routes = _g_routes(K, torch.bfloat16, 64, cfg.slice_size, False)
    moved = [n - b for n, b in zip(_counters(K), before)]
    assert moved == [5, 5 - routes.count("fma"), 0, routes.count("wgmma"), 0] and (
        routes.count("wgmma") == 4), (moved, routes)
    e_bf = rel_err(y_bf, y32)
    # a sanity bound: bf16 rounds every one of the 10 layers' inputs and outputs
    assert torch.isfinite(y_bf).all() and e_bf <= 0.1, e_bf
    before = K.launches_mma
    e_fma = rel_err(fma_route_forward(bf), y32)
    assert K.launches_mma == before and e_fma <= 0.1, e_fma
    before = K.launches_wgmma
    e_sync = rel_err(mma_sync_forward(bf), y32)
    assert K.launches_wgmma == before and e_sync <= 0.1, e_sync
    t = ms_in_turns({"rule": lambda: bf.infer_G(x64, z64),
                     "mma": lambda: mma_sync_forward(bf),
                     "fma": lambda: fma_route_forward(bf)}, reps=10, warmup=2)
    print(f"G forward at batch 64 (bf16): {t['rule']:.3f} ms, {64e3 / t['rule']:.1f} "
          f"chunks/s (the rule's routes: " + ", ".join(routes) + f"); {t['mma']:.3f} ms, "
          f"{64e3 / t['mma']:.1f} chunks/s (mma.sync for wgmma, same call; rule / mma.sync "
          f"{t['rule'] / t['mma']:.3f}); {t['fma']:.3f} ms, {64e3 / t['fma']:.1f} chunks/s "
          f"(FMA route, same call); rel err vs fp32 {e_bf:.3e} (mma.sync {e_sync:.3e}, FMA "
          f"route {e_fma:.3e})")
    return launches, launches_mma, launches_tf32, wgmma_bf16, wgmma_fp32, rows_bf16


# G's step gradients on the card vs float64 with D' = D: a PReLU kink taken the other way
# moves them by some 1e-3, so ten times that
KINK_TOL = 5e-2
# D's conv biases feed a BatchNorm, which takes the per-channel mean out: their true
# gradient is 0 and what autograd returns for them is rounding noise
BIAS_BEFORE_BN = tuple(f"enc_blocks.{i}.conv.bias" for i in range(5))


def phase_train_kernel():
    """5a: Conv1dPReLU's backward vs autograd of the plain version, on the card, x in
    G's pitched rows (each call on the route _route picks, read from the counters), and
    the kernel's cached weights across optimizer steps."""
    import torch
    from segan_pytorch_tpu_torch.models.segan import build_optimizer
    from segan_pytorch_tpu_torch.ops.conv import reflect_pad_pitched
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K

    torch.backends.cudnn.allow_tf32 = False  # the plain version's backward convs: fp32
    g = torch.Generator().manual_seed(SEED + 6)
    T, Kw, S = 16384, 31, 4
    chans = [1, 64, 128, 256, 512, 1024]
    print(f"{'layer':>12} {'dtype':>8} | {'dx':>9} {'dw':>9} {'db':>9} {'da':>9} | gy zeroed")
    for b, i in [(8, i) for i in range(5)] + [(300, 1)]:
        t_out = T // S ** (i + 1)
        cin, cout = chans[i], chans[i + 1]
        h = torch.randn((b, cin, S * t_out), generator=g)  # G pads it by 14 and 15
        w = torch.randn((cout, cin, Kw), generator=g) / (cin * Kw) ** 0.5
        bias = torch.randn((cout,), generator=g) * 0.1
        a = torch.rand((cout,), generator=g) * 0.3
        gy, gpre = (torch.randn((b, cout, t_out), generator=g) for _ in range(2))
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            x = reflect_pad_pitched(h.to(dtype).cuda(), 14, 15)  # a view, as G's blocks pass
            leaves = [v.requires_grad_() for v in
                      [x] + [v.to(dtype).cuda() for v in (w, bias, a)]]
            refs = [v.detach().clone().requires_grad_() for v in leaves]
            route = K._route(dtype, b, cin, cout, Kw, S, t_out, True)
            before = _counters(K)
            y, pre = K.conv1d_prelu(*leaves, S)
            assert _took(K, before) == route, (b, i, dtype, route)
            y_r, pre_r = K.conv1d_prelu_plain(*refs, S)
            p = pre_r.detach().float().abs()
            near = p <= tol * p.max()
            gy_d = torch.where(near, 0.0, gy.cuda()).to(dtype)
            gpre_d = gpre.cuda().to(dtype)
            torch.autograd.backward([y, pre], [gy_d, gpre_d])
            torch.autograd.backward([y_r, pre_r], [gy_d, gpre_d])
            errs = [rel_err(v.grad, r.grad) for v, r in zip(leaves, refs)]
            label = f"B={b} enc{i + 1}"
            print(f"{label:>12} {str(dtype)[6:]:>8} | " + " ".join(f"{e:9.2e}" for e in errs)
                  + f" | {float(near.float().mean()):.2%}", flush=True)
            assert worst(errs) <= tol, f"{label} {dtype}: backward vs plain {errs} > {tol}"
            del leaves, refs, y, pre, y_r, pre_r
    # the cached weights after an in-place optimizer step (x in pitched rows at 32
    # chunks, on the wgmma routes: bf16 the permuted copy, fp32 the split one)
    h = torch.randn((32, 128, 1024), generator=g).cuda()
    a = (torch.rand((256,), generator=g) * 0.3).cuda()
    w0 = torch.randn((256, 128, Kw), generator=g) / (128 * Kw) ** 0.5
    shape = (32, 256, 256)
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        xd, ad = reflect_pad_pitched(h.to(dtype), 14, 15), a.to(dtype)
        assert K._route(dtype, 32, 128, 256, Kw, S, 256, True) == "wgmma"
        for opt in ("rmsprop", "adam"):
            w = torch.nn.Parameter(w0.to(dtype).cuda())
            o = build_optimizer(opt, 1e-2, [w])
            y0, _ = K.fused_conv1d_prelu(xd, w, None, ad, S)  # caches w's padded copy
            w.grad = torch.randn(w.shape, generator=g).to(dtype).cuda()
            o.step()
            with torch.no_grad():
                y1, pre1 = K._launch(xd, w, None, ad, S, 256,
                                     out=nan_outputs(shape, shape, dtype=dtype))
                y_ref, pre_ref = K.conv1d_prelu_plain(xd, w, None, ad, S)
            e = worst([rel_err(y1, y_ref), rel_err(pre1, pre_ref)])
            moved = rel_err(y0, y_ref)
            print(f"after one {opt} step ({str(dtype)[6:]}): kernel vs plain with the new w "
                  f"rel err {e:.2e}; the old output differs by {moved:.2e}")
            assert e <= tol and moved > 10 * tol, (opt, dtype, e, moved)
    w = torch.nn.Parameter(w0.cuda())
    version = w._version
    w.grad = torch.ones_like(w)
    torch.optim.Adam([w], lr=1e-3, fused=True).step()
    print(f"for the record: fused Adam bumps the weight's version counter: "
          f"{w._version > version} (the port never uses fused=True)")


def _check_counts(r, n, dtype):
    """The counters of a `_time_steps` run: n launches, each on the route _route picks
    for its shape and x's layout (read from the counters against the logged calls), none
    by 3xTF32 in bf16. Returns the first four counts (all, tensor cores, 3xTF32, wgmma)."""
    c = r["counts"]
    assert c[0] == n and c == r["want"], (c, r["want"], n)
    assert dtype == "float32" or c[2] == 0, c
    return c[:4]


def _train_models(cfg, seed):
    """A seeded SEGAN+ G and D with every PReLU slope drawn from U(0, 0.3)."""
    import torch
    from segan_pytorch_tpu_torch.models.discriminator import build_discriminator
    from segan_pytorch_tpu_torch.models.generator import build_generator

    gen = torch.Generator().manual_seed(seed)
    G, D = build_generator(cfg, gen), build_discriminator(cfg, gen)
    with torch.no_grad():
        for name, p in list(G.named_parameters()) + list(D.named_parameters()):
            if name.endswith("act.weight"):
                p.uniform_(0.0, 0.3, generator=gen)
    return G, D


def _train_batch(b, t, seed):
    """bench.py's synthetic batch: clean ~ N(0, 0.1^2), noisy = clean + N(0, 0.02^2)."""
    import torch

    rng = np.random.RandomState(seed)
    clean = (rng.randn(b, t, 1) * 0.1).astype(np.float32)
    noisy = clean + (rng.randn(b, t, 1) * 0.02).astype(np.float32)
    return torch.from_numpy(clean), torch.from_numpy(noisy)


def phase_train_parity():
    """5b: one full-width fp32 step at B = 4 on the card and on a CPU copy, both held
    against the same step in float64 on the CPU; then G's backward alone, and a step
    with D's learning rate 0.

    The step is ill-conditioned in places, so its gradients are held to the CPU's own
    fp32 error, up to a factor: D's per-channel gradients (BatchNorm's scales, shifts,
    PReLU slopes) sum B x T terms that nearly cancel (the CPU's fp32 gradients of D's
    first block read ~2e-3 off float64). G's gradient goes through D after an RMSprop step that moves
    each weight by ~10 lr sign(g), so a last-bit difference in a gradient near 0 moves a
    weight of D' by 20 lr (G's gradients then read several 1e-2 off float64 on the card,
    printed, not held); and through PReLU kinks that a BatchNorm output within 1e-6 of 0
    may take either way, in D' as in D, each of which moves them by some 1e-3. So: the
    card's losses and Genh <= 1e-3 relative (g_adv, which goes through D' as well, in the
    second step below); D's gradients, all tensors together, within max(1e-3, 4 x the
    CPU fp32 ones' error) in L2 and each within max(1e-2, 4 x the CPU's);
    G's backward from a fixed upstream gradient, each tensor <= 1e-3; and in a second
    step with D's learning rate 0 (D' = D, no sign flips) g_adv <= 1e-3 and G's step
    gradients, all tensors together, <= KINK_TOL."""
    import copy
    import dataclasses
    import torch
    from segan_pytorch_tpu_torch.models.segan import SEGAN
    from segan_pytorch_tpu_torch.ops import conv as conv_ops
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.utils.config import SEGANConfig

    cfg = SEGANConfig(no_bias=True)
    G, D = _train_models(cfg, SEED + 7)
    clean, noisy = _train_batch(4, cfg.slice_size, SEED + 8)
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0])
    z = torch.randn((4, 16, cfg.z_dim), generator=torch.Generator().manual_seed(SEED + 9))
    phase = D.sample_phase(torch.Generator().manual_seed(SEED + 10), passes=3)

    def step(device, dtype=torch.float32, c=cfg):
        """One step of copies of G and D: (losses, Genh, gradients) on the CPU in
        float64. A float64 step runs on float64 copies of the fp32 weights (the engine's
        compute dtype set to float64); the CPU's convs are torch's own (oneDNN off)."""
        seg = SEGAN(c, generator=copy.deepcopy(G), discriminator=copy.deepcopy(D),
                    device=device)
        seg.compute_dtype = dtype
        with torch.backends.mkldnn.flags(enabled=False):
            m, genh, _ = seg.train_step(clean, noisy, mask, 100.0, z=z, phase=phase)
        grads = {f"{side}.{n}": p.grad.cpu().double() for side in ("G", "D")
                 for n, p in getattr(seg, side).named_parameters()
                 if not (side == "D" and n in BIAS_BEFORE_BN)}
        bias_noise = worst(float(blk.conv.bias.grad.norm() / blk.norm.bias.grad.norm())
                           for blk in seg.D.enc_blocks)
        return ({k: float(v) for k, v in m.items()}, genh.cpu().double(), grads,
                bias_noise)

    def g_backward(device, dtype=torch.float32):
        """G's gradients from a fixed upstream gradient of Genh, as the CPU's float64."""
        g = copy.deepcopy(G).to(device, dtype).train()
        with conv_ops.full_precision(dtype), torch.backends.mkldnn.flags(enabled=False):
            y = g(noisy.to(device, dtype), z.to(device, dtype))
            y.backward(d_genh.to(device, dtype))
        return {f"G.{n}": p.grad.cpu().double() for n, p in g.named_parameters()}

    def rel(a, ref):
        return float((a - ref).norm() / ref.norm().clamp_min(1e-300))

    def rel_all(a, ref, keys):
        num = sum(float((a[k] - ref[k]).norm()) ** 2 for k in keys)
        return (num / sum(float(ref[k].norm()) ** 2 for k in keys)) ** 0.5

    def show(e_card, e_cpu, keys):
        top = sorted(keys, key=lambda k: -e_card[k])[:3]
        return ", ".join(f"{k} ({e_card[k]:.1e}, {e_cpu[k]:.1e})" for k in top)

    # 3xTF32 launches of a G forward at B = 4: the five but enc1's FMA rows
    tc4 = 5 - _g_routes(K, torch.float32, 4, cfg.slice_size, False).count("fma")
    before = K.launches_tf32
    t0 = time.perf_counter()
    card = step("cuda")
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    assert K.launches_tf32 - before == tc4, f"{K.launches_tf32 - before} 3xTF32 launches"
    t0 = time.perf_counter()
    cpu = step("cpu")
    t_cpu = time.perf_counter() - t0
    ref = step("cpu", torch.float64)
    losses = {}
    for name, a in (("card", card), ("CPU", cpu)):
        losses[name] = {k: abs(a[0][k] - ref[0][k]) / abs(ref[0][k]) for k in ref[0]}
        losses[name]["Genh"] = rel_err(a[1], ref[1])
    e_card = {k: rel(v, ref[2][k]) for k, v in card[2].items()}
    e_cpu = {k: rel(v, ref[2][k]) for k, v in cpu[2].items()}
    d_keys = [k for k in ref[2] if k.startswith("D.")]
    g_keys = [k for k in ref[2] if k.startswith("G.")]
    d_all = {n: rel_all(a[2], ref[2], d_keys) for n, a in (("card", card), ("CPU", cpu))}
    g_all = {n: rel_all(a[2], ref[2], g_keys) for n, a in (("card", card), ("CPU", cpu))}
    d_genh = torch.randn(clean.shape, generator=torch.Generator().manual_seed(SEED + 14)) * 1e-3
    before = K.launches_tf32
    gb = {"card": g_backward("cuda"), "CPU": g_backward("cpu")}
    assert K.launches_tf32 - before == tc4, f"{K.launches_tf32 - before} 3xTF32 launches"
    gb_ref = g_backward("cpu", torch.float64)
    gb_err = {n: {k: rel(v, gb_ref[k]) for k, v in a.items()} for n, a in gb.items()}
    frozen = dataclasses.replace(cfg, d_lr=0.0)
    ref0 = step("cpu", torch.float64, frozen)
    card0 = step("cuda", c=frozen)
    g0_all = {n: rel_all(a[2], ref0[2], g_keys)
              for n, a in (("card", card0), ("CPU", step("cpu", c=frozen)))}
    g_adv0 = abs(card0[0]["g_adv"] - ref0[0]["g_adv"]) / abs(ref0[0]["g_adv"])
    print(f"train step, B=4 fp32, one row masked, vs float64 on the CPU (card {t_card:.2f} s,"
          f" CPU {t_cpu:.2f} s): losses and Genh card " + ", ".join(
              f"{k} {v:.1e}" for k, v in losses["card"].items()) + "; CPU " + ", ".join(
              f"{k} {v:.1e}" for k, v in losses["CPU"].items())
          + f"\n  D's gradients, all {len(d_keys)} tensors: card {d_all['card']:.1e}, CPU "
          f"{d_all['CPU']:.1e}; worst (card, CPU) {show(e_card, e_cpu, d_keys)}"
          f"\n  G's gradients, all {len(g_keys)} tensors: card {g_all['card']:.1e}, CPU "
          f"{g_all['CPU']:.1e}; worst (card, CPU) {show(e_card, e_cpu, g_keys)}"
          f"\n  G's backward from a fixed gradient of Genh: worst (card, CPU) "
          f"{show(gb_err['card'], gb_err['CPU'], list(gb_ref))}"
          f"\n  with d_lr = 0 (D' = D): card g_adv {g_adv0:.1e}; G's gradients, all "
          f"tensors: card {g0_all['card']:.1e}, CPU {g0_all['CPU']:.1e}"
          f"\n  D's BN-fed conv bias gradients / BN bias gradients: card {card[3]:.1e}, "
          f"float64 {ref[3]:.1e}", flush=True)
    # g_adv goes through D' too: held in the step with D' = D
    assert worst(v for k, v in losses["card"].items() if k != "g_adv") <= SLICE_TOL, losses
    assert g_adv0 <= SLICE_TOL, g_adv0
    assert d_all["card"] <= max(SLICE_TOL, 4 * d_all["CPU"]), d_all
    bad = {k: (e_card[k], e_cpu[k]) for k in d_keys
           if not e_card[k] <= max(10 * SLICE_TOL, 4 * e_cpu[k])}
    assert not bad, bad
    assert worst(gb_err["card"].values()) <= SLICE_TOL, gb_err["card"]
    assert g0_all["card"] <= KINK_TOL, g0_all
    assert card[3] <= 1e-3, card[3]


def _time_steps(seg, args, n_steps, warm=3):
    """`warm` steps, then `n_steps` timed by CUDA events, each phase of the step too, with
    the kernel's counters set to 0 just before the timed steps and read just after. Returns
    slices/s, the median step and phase split in ms, peak memory in GiB, the counters
    (``_counters``), the counts that _route's picks for the logged calls give
    (``_want_counts``) and the last losses."""
    import statistics
    import torch
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K

    marks = {"G forward": [], "D update": [], "G update": []}

    def timed(fn, name):
        def run(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            marks[name].append((start, end))
            return out
        return run

    for attr, name in (("_g_forward", "G forward"), ("_d_update", "D update"),
                       ("_g_update", "G update")):
        setattr(seg, attr, timed(getattr(seg, attr), name))
    for _ in range(warm):
        metrics, _, _ = seg.train_step(*args)
    float(next(iter(metrics.values())))
    for v in marks.values():
        v.clear()
    torch.cuda.reset_peak_memory_stats()
    steps, losses = [], []
    K.launches = K.launches_mma = K.launches_tf32 = K.launches_wgmma = K.launches_rows = 0
    with _logged_launches() as log:
        for _ in range(n_steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics, _, _ = seg.train_step(*args)
            end.record()
            steps.append((start, end))
            losses.append(torch.stack(list(metrics.values())))
        torch.cuda.synchronize()
    counts, want = _counters(K), _want_counts(K, log)
    losses = torch.stack(losses).cpu()
    assert torch.isfinite(losses).all(), losses
    total = steps[0][0].elapsed_time(steps[-1][1])
    for attr in ("_g_forward", "_d_update", "_g_update"):
        delattr(seg, attr)
    return dict(rate=args[0].shape[0] * n_steps / total * 1e3,
                ms=statistics.median(s.elapsed_time(e) for s, e in steps),
                split={k: statistics.median(s.elapsed_time(e) for s, e in v)
                       for k, v in marks.items()},
                peak=torch.cuda.max_memory_allocated() / 2**30, counts=counts, want=want,
                losses=dict(zip(metrics, losses[-1].tolist())))


def phase_train_b300():
    """5c: the step at full width and batch 300 in fp32 and bf16, timed by CUDA events;
    then the bench entry point. Returns the kernel's launches per step, the slices/s
    of the timed steps and of the bench entry, by dtype, and the wgmma launches of the
    steps by dtype."""
    import torch
    from segan_pytorch_tpu_torch.models.segan import SEGAN
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.utils.config import SEGANConfig

    from segan_pytorch_tpu_torch import bench

    B, n_steps = 300, 5
    per_step = set()
    rates, wgmma_launches = {}, {}
    for dtype in ("float32", "bfloat16"):
        cfg = SEGANConfig(no_bias=True, compute_dtype=dtype, batch_size=B)
        G, D = _train_models(cfg, SEED + 11)
        seg = SEGAN(cfg, generator=G, discriminator=D, device="cuda")
        clean, noisy = (v.cuda() for v in _train_batch(B, cfg.slice_size, SEED + 12))
        r = _time_steps(seg, (clean, noisy, torch.ones((B,), device="cuda"), 100.0),
                        n_steps, warm=2)
        launches, mma, tf32, wg = _check_counts(r, 5 * n_steps, dtype)
        # G's enc2-5 on wgmma, in fp32 by 3xTF32
        assert wg == n_steps * _g_routes(K, getattr(torch, dtype), B, cfg.slice_size,
                                         False).count("wgmma") > 0, wg
        wgmma_launches[dtype] = wg
        per_step.add(launches // n_steps)
        rates[dtype] = r["rate"]
        print(f"train step B={B} {dtype}: {r['rate']:.2f} slices/s (median {r['ms']:.3f} "
              f"ms/step); median split " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                                     r["split"].items())
              + f"; peak device memory {r['peak']:.2f} GiB; fused_conv1d_prelu launches "
              f"{launches} ({mma} on the tensor cores, {tf32} 3xTF32, {wg} wgmma); last "
              "losses " + ", ".join(f"{k} {v:.4f}" for k, v in r["losses"].items()),
              flush=True)
        del seg, G, D, clean, noisy
        torch.cuda.empty_cache()
    for dtype in ("bfloat16", "float32"):
        # the entry's main in this process, whose cuDNN plans the steps above warmed
        # (tests/test_torch_profiling.py runs it as a process of its own on the CPU)
        with contextlib.redirect_stdout(io.StringIO()):
            res = bench.main(["--steps", "5", "--warmup", "2", "--compute_dtype", dtype,
                              "--steps_per_call", "1"])
        print(f"bench ({dtype}): {json.dumps(res)}", flush=True)
        assert (res["metric"], res["batch"], res["compute_dtype"]) == (
            "train_slices_per_sec_per_chip", B, dtype) and res["value"] > 0, res
        rates[f"bench {dtype}"] = res["value"]
        rates[f"bench {dtype} run"] = res
    assert len(per_step) == 1, per_step
    return per_step.pop(), rates, wgmma_launches


def _write_corpus(root: Path, n_files: int, seconds: float, seed: int):
    """Paired int16 16 kHz wavs: clean a harmonic tone complex (f0 100-250 Hz, five
    harmonics, a syllable-rate envelope), noisy the clean one plus white noise at 0-15 dB
    SNR. Returns (clean dir, noisy dir)."""
    from scipy.io import wavfile

    rng = np.random.RandomState(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    dirs = []
    for sub in ("clean", "noisy"):
        (root / sub).mkdir(parents=True)
        dirs.append(str(root / sub))
    for i in range(n_files):
        f0 = rng.uniform(100, 250)
        clean = sum(rng.uniform(0.2, 1.0) / h * np.sin(2 * np.pi * h * f0 * t
                                                       + rng.uniform(0, 2 * np.pi))
                    for h in range(1, 6))
        clean *= 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
        clean *= 0.3 / np.abs(clean).max()
        noise = rng.randn(n) * np.sqrt(np.mean(clean ** 2) / 10 ** (rng.uniform(0, 15) / 10))
        wavfile.write(f"{dirs[0]}/u{i:02d}.wav", SR, (clean * 32767).astype(np.int16))
        wavfile.write(f"{dirs[1]}/u{i:02d}.wav", SR,
                      np.clip((clean + noise) * 32767, -32768, 32767).astype(np.int16))
    return dirs


def _pesq_backend() -> str:
    """The backend that metrics.pesq.PESQ takes here, in its order."""
    import importlib.util
    import os
    import shutil
    from segan_pytorch_tpu_torch.metrics import pesq_native

    mode = os.environ.get("SEGAN_TPU_PESQ", "auto")
    if mode not in ("approx", "native"):
        if shutil.which("pesqmain"):
            return "pesqmain (ITU binary)"
        if importlib.util.find_spec("pesq") is not None:
            return "the python pesq package"
        if mode == "strict":
            return "none (PESQ reads -1)"
    if mode != "approx" and pesq_native.get_lib() is not None:
        return "native/pesq862.cpp (P.862 pipeline, not ITU-certified)"
    return "the spectral approximation (metrics/perceptual.py)"


RUN_LINES = ("(Iter", "[*]", "[!]", "[data]", "Val ", "Time to process", "STOPPING")
LOG_RE = re.compile(r"^\(Iter (\d+)\) Batch (\d+)/(\d+) \(Epoch (\d+)\) d_real:(\S+), "
                    r"d_fake:(\S+), g_adv:(\S+), g_l1:(\S+) l1_w", re.M)


def phase_train_run(work: Path, rates):
    """6: the training run at full SEGAN+ width on the card: `python -m
    segan_pytorch_tpu_torch.train`'s main, batch 300, fp32, one epoch with a validation
    set, then --resume to epoch 2; then the port's clean CLI with the last EOE G. Returns
    the kernel's launches over the two runs."""
    import torch
    from segan_pytorch_tpu_torch import clean as clean_cli
    from segan_pytorch_tpu_torch.data.wav_io import read_wav_raw
    from segan_pytorch_tpu_torch.models.generator import build_generator
    from segan_pytorch_tpu_torch.models.segan import SEGAN
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.utils.checkpoint import save_generator
    from segan_pytorch_tpu_torch.utils.config import SEGANConfig, load_train_opts

    t0 = time.perf_counter()
    # 16 x 20 s: 38 slices each at stride 0.5, 608 in all: batches of 300, 300 and 8;
    # validation 2 x 4 s: 6 slices each, one batch of 300 with 12 valid rows
    train_dirs = _write_corpus(work / "train", 16, 20.0, SEED + 20)
    valid_dirs = _write_corpus(work / "valid", 2, 4.0, SEED + 21)
    print(f"corpus: 16 x 20 s training pairs, 2 x 4 s validation pairs, written in "
          f"{time.perf_counter() - t0:.2f} s; PESQ backend: {_pesq_backend()}", flush=True)
    # G starts from a checkpoint (--g_pretrained_ckpt) with a quiet output layer (its
    # weights x 0.01, its bias 0) and learns at 1/100 of SEGAN+'s rate (--g_lr 5e-7). A
    # random G's output carries a DC offset (the last deconv keeps a bias under
    # --no_bias, as upstream's does) that de-emphasis multiplies by 20, and RMSprop's
    # first steps move each weight by ~10 lr whatever its gradient: either puts SSNR near
    # its floor of -10 dB and COVL + PESQ + SSNR below the loop's first best of 0 (-5.6
    # on these wavs), so no best-val checkpoint would be written; the quiet G reads 2.5
    G = build_generator(SEGANConfig(no_bias=True), torch.Generator().manual_seed(SEED + 23))
    with torch.no_grad():
        G.dec_blocks[-1].deconv.weight.mul_(0.01)
        G.dec_blocks[-1].deconv.bias.zero_()
    save_generator(G, str(work / "g_start.ckpt"))
    del G
    save = work / "ckpt"
    argv = ["--save_path", str(save), "--clean_trainset", train_dirs[0],
            "--noisy_trainset", train_dirs[1], "--clean_valset", valid_dirs[0],
            "--noisy_valset", valid_dirs[1], "--cache_dir", str(work / "cache"),
            "--batch_size", "300", "--no_bias", "--save_freq", "1", "--seed", str(SEED),
            "--g_lr", "5e-7", "--device", "cuda"]

    runs = []
    K.launches = K.launches_mma = K.launches_tf32 = K.launches_wgmma = K.launches_rows = 0
    with _logged_launches() as log:
        for extra in (["--epoch", "1", "--g_pretrained_ckpt", str(work / "g_start.ckpt")],
                      ["--epoch", "2", "--resume"]):
            run = _timed_run(argv + extra)
            del run["steps"], run["dloader"]
            runs.append(run)
    launches, mma, tf32, wg, rows = _counters(K)
    want = _want_counts(K, log)

    # the loop: resumed at step 3, iterations on from 4, finite losses
    assert "[*] Resumed from step 3" in runs[1]["out"], runs[1]["out"][-2000:]
    for run, epoch, first in ((runs[0], 1, 1), (runs[1], 2, 4)):
        logged = LOG_RE.findall(run["out"])
        iters = [int(m[0]) for m in logged]
        assert iters == [first, first + 1, first + 2], iters
        assert all(int(m[2]) == 3 and int(m[3]) == epoch for m in logged), logged
        losses = np.array([[float(v) for v in m[4:]] for m in logged])
        assert np.isfinite(losses).all(), losses
        run["losses"] = losses[-1]
    assert (runs[0]["step"], runs[1]["step"]) == (3, 6), [r["step"] for r in runs]
    steps = 6
    forwards = runs[0]["forwards"] + runs[1]["forwards"]
    # a G forward per log point (gen_train_samples) and one for evaluate, per run
    assert forwards == 8, forwards
    print(f"fused_conv1d_prelu launches over the two runs: {launches} ({mma} on the tensor "
          f"cores, {tf32} 3xTF32) for {steps} train steps and {forwards} G forwards, each "
          f"on the route _route picks (enc1's small passes on FMAs: {launches - mma})")
    assert launches == 5 * (steps + forwards) and (launches, mma, tf32, wg, rows) == want and (
        mma == tf32), ((launches, mma, tf32, wg, rows), want)

    # the checkpoints: rotating EOE G and D, and the best-val ones, each index pointing at
    # payloads that exist, with the optimizer's state and the steps taken
    # each train() call starts from a best of 0 (as in JAX): a run saves a best-val G and
    # D when its val_obj is above 0
    val_objs = [json.loads(line)["value"] for line in
                (save / "train" / "scalars.jsonl").read_text().splitlines()
                if json.loads(line)["tag"] == "Genh-val_obj"]
    assert len(val_objs) == 2, val_objs
    want_best = [f"SEGAN-G-best_Generator-{i}.ckpt" for v, i in zip(val_objs, (4, 7))
                 if v > 0]
    indices = {}
    for prefix in ("EOE_G-", "EOE_D-", "SEGAN-G-", "SEGAN-D-"):
        path = save / f"{prefix}checkpoints"
        assert path.exists(), f"no index {path.name}: {sorted(os.listdir(save))}"
        indices[prefix] = json.loads(path.read_text())
        for name in indices[prefix]["latest"]:
            assert (save / f"weights_{name}").exists(), name
    assert indices["EOE_G-"]["latest"] == ["EOE_G-Generator-4.ckpt",
                                           "EOE_G-Generator-7.ckpt"], indices["EOE_G-"]
    assert indices["SEGAN-G-"]["latest"] == want_best, (val_objs, indices["SEGAN-G-"])
    last_g = save / "weights_EOE_G-Generator-7.ckpt"
    payload = torch.load(last_g, map_location="cpu", weights_only=True)
    assert payload["step"] == 6 and len(payload["optimizer"]["state"]) > 0, payload.keys()
    del payload
    print(f"checkpoints: EOE {indices['EOE_G-']['latest']}, best-val "
          f"{indices['SEGAN-G-']['latest']} (val_obj COVL + PESQ + SSNR of the two runs "
          + ", ".join(f"{v:.4f}" for v in val_objs) + f"); {last_g.stat().st_size / 2**20:.1f}"
          f" MiB per EOE G payload (weights + RMSprop state)")

    # after a resume the kernel runs on the loaded encoder weights: fill its weight cache
    # with a fresh G's, resume, and hold it against the plain version
    eng = SEGAN(load_train_opts(str(save / "train.opts")), device="cuda", seed=SEED)
    g = torch.Generator().manual_seed(SEED + 22)
    xs, before = [], []
    t_in = 4 * (16384 // 4) + 29
    for blk in eng.G.enc_blocks:
        w = blk.conv.weight
        xs.append(torch.randn((2, w.shape[1], t_in), generator=g).cuda())
        before.append(K.fused_conv1d_prelu(xs[-1], w, blk.conv.bias, blk.act.weight, 4)[1])
        t_in = (t_in - 29) // 4 + 29
    with contextlib.redirect_stdout(io.StringIO()):
        assert eng.resume(str(save)) == 6
    errs, moved = [], []
    with torch.no_grad():
        for x, blk, old in zip(xs, eng.G.enc_blocks, before):
            w, b, a = blk.conv.weight, blk.conv.bias, blk.act.weight
            t_out = K._check(x, w, b, a, 4)
            shape = (x.shape[0], w.shape[0], t_out)
            y, pre = K._launch(x, w, b, a, 4, t_out, out=nan_outputs(shape, shape,
                                                                      dtype=x.dtype))
            y_ref, pre_ref = K.conv1d_prelu_plain(x, w, b, a, 4)
            errs.append(worst([rel_err(y, y_ref), rel_err(pre, pre_ref)]))
            moved.append(rel_err(old, pre_ref))
    print("after resume: kernel vs plain on the loaded encoder weights, rel err "
          + ", ".join(f"{e:.1e}" for e in errs) + "; the fresh G's outputs differ by "
          + ", ".join(f"{m:.1e}" for m in moved))
    assert worst(errs) <= FP32_TOL and min(moved) > 10 * FP32_TOL, (errs, moved)
    del eng, xs, before

    # the port's clean CLI with the last EOE G
    out_dir = work / "enhanced"
    out_dir.mkdir()
    opts = clean_cli.build_parser().parse_args([
        "--g_pretrained_ckpt", str(last_g), "--cfg_file", str(save / "train.opts"),
        "--test_files", valid_dirs[1], "--synthesis_path", str(out_dir), "--seed",
        str(SEED), "--device", "cuda"])
    with contextlib.redirect_stdout(io.StringIO()):
        clean_cli.main(opts)
    for name in sorted(os.listdir(valid_dirs[1])):
        _, y = read_wav_raw(str(out_dir / name))
        assert y.shape == (64000,) and np.isfinite(y).all(), (name, y.shape)
    print(f"clean CLI with weights_EOE_G-Generator-7.ckpt: {len(os.listdir(out_dir))} "
          f"validation wavs enhanced")

    for i, run in enumerate(runs, 1):
        print(f"train run {i}: {run['wall']:.2f} s in main(), of which the batch loop "
              f"{run['loop']:.3f} s (3 steps of 300, a log point each: losses read, weight "
              f"norms, 20 sample wavs), evaluate {run['eval']:.3f} s, checkpoint saves "
              f"{run['save']:.3f} s on the calling thread; data wait per step "
              + ", ".join(f"{1e3 * w:.2f}" for w in run["wait"]) + " ms; last losses "
              + ", ".join(f"{v:.4f}" for v in run["losses"]), flush=True)
    loop = runs[1]["loop"]
    rates["run slices/s"], rates["run wait ms"] = 900 / loop, 1e3 * np.mean(runs[1]["wait"])
    print(f"training loop (run 2, warm): {900 / loop:.2f} slices/s over its 3 steps; the "
          f"bare fp32 step (5c) {rates['float32']:.2f}, the bench entry "
          f"{rates['bench float32']:.2f} slices/s", flush=True)
    return launches


# scripts/run_wsegan_train.sh's flags; every other option at its default (G and D with biases)
WSEGAN_FLAGS = dict(wsegan=True, gnorm_type="snorm", dnorm_type="snorm", opt="adam",
                    misalign_pair=True)
WSEGAN_ARGS = ["--no_train_gen", "--batch_size", "150", "--wsegan", "--gnorm_type", "snorm",
               "--dnorm_type", "snorm", "--opt", "adam", "--data_stride", "0.05",
               "--misalign_pair"]
WS_PER_STEP = 5 + 5 * 4  # G's five blocks once, D's five in each of its four passes


def _wsegan_models(cfg, seed):
    """A seeded full-width snorm G and D, Xavier-initialised as WSEGAN's are, every PReLU
    slope drawn from U(0, 0.3)."""
    import torch
    from segan_pytorch_tpu_torch.models.wsegan import apply_wsegan_weights_init

    G, D = _train_models(cfg, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    apply_wsegan_weights_init(G, gen)
    apply_wsegan_weights_init(D, gen)
    return G, D


# 7a's bounds. Without BatchNorm the WSEGAN step is well conditioned: on an H100 at 700 W
# the card's losses and Genh read <= 2.1e-7 off float64, D's gradients 5.3e-7 all together,
# u and v 7.9e-7, G's gradients with D' = D 1.2e-6; the control below (the cuDNN convs and
# matmuls in one TF32 pass) 4.3e-5, 2.7e-4, 9.6e-5 and 2.0e-4. Each bound sits between
WS_TOL = 1e-5     # losses, Genh, D's gradients all together, u and v
WS_G_TOL = 3e-5   # G's gradients all together, with D' = D


def phase_wsegan_parity():
    """7a: one full-width WSEGAN fp32 step (the script's flags: spectral norm in G and D,
    Adam, the misaligned pair) at B = 4, one row masked and one 'additive', on the card
    and on a CPU copy, both held against the step in float64 on the CPU; then a step with
    D's learning rate 0 for g_adv, which goes through D'. A control, the card's step with
    the ops' TF32 policy bypassed and TF32 on (every cuDNN conv and matmul in one TF32
    pass; the kernel stays 3xTF32), must land outside each bound that the step meets."""
    import copy
    import dataclasses
    import torch
    from segan_pytorch_tpu_torch.models.wsegan import WSEGAN
    from segan_pytorch_tpu_torch.ops import conv as conv_ops
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.utils.config import SEGANConfig

    cfg = SEGANConfig(**WSEGAN_FLAGS)
    G, D = _wsegan_models(cfg, SEED + 30)
    clean, noisy = _train_batch(4, cfg.slice_size, SEED + 31)
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0])
    amask = torch.tensor([0.0, 1.0, 0.0, 0.0])
    z = torch.randn((4, 16, cfg.z_dim), generator=torch.Generator().manual_seed(SEED + 32))
    phase = D.sample_phase(torch.Generator().manual_seed(SEED + 33), passes=4)
    perm = torch.tensor([2, 0, 3, 1])
    frozen = dataclasses.replace(cfg, d_lr=0.0)

    def step(device, dtype=torch.float32, c=cfg):
        """One step of copies of G and D: (losses, Genh, gradients, u and v) on the CPU
        in float64; a float64 step runs on float64 copies of the fp32 weights."""
        seg = WSEGAN(c, generator=copy.deepcopy(G), discriminator=copy.deepcopy(D),
                     device=device)
        seg.compute_dtype = dtype
        with torch.backends.mkldnn.flags(enabled=False):
            m, genh, _ = seg.train_step(clean, noisy, mask, amask, 100.0, z=z, phase=phase,
                                        perm=perm)
        grads = {f"{side}.{n}": p.grad.cpu().double() for side in ("G", "D")
                 for n, p in getattr(seg, side).named_parameters()}
        uv = {f"{side}.{n}": b.cpu().double() for side in ("G", "D")
              for n, b in getattr(seg, side).named_buffers()}
        return {k: float(v) for k, v in m.items()}, genh.cpu().double(), grads, uv

    def tf32_step(c):
        """The card's step with the ops' TF32 policy bypassed and TF32 on."""
        policy = conv_ops.full_precision
        flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        conv_ops.full_precision = lambda dtype: contextlib.nullcontext()
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return step("cuda", c=c)
        finally:
            conv_ops.full_precision = policy
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags

    def rel(a, ref):
        return float((a - ref).norm() / ref.norm().clamp_min(1e-300))

    def rel_all(a, ref, keys):
        num = sum(float((a[k] - ref[k]).norm()) ** 2 for k in keys)
        return (num / sum(float(ref[k].norm()) ** 2 for k in keys)) ** 0.5

    before = (K.launches, K.launches_tf32)
    t0 = time.perf_counter()
    card = step("cuda")
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    moved = (K.launches - before[0], K.launches_tf32 - before[1])
    # 3xTF32 but G's enc1 where its rows take the FMA kernel
    tc = WS_PER_STEP - _g_routes(K, torch.float32, 4, cfg.slice_size, True).count("fma")
    assert moved == (WS_PER_STEP, tc), f"launches (all, 3xTF32) {moved}"
    t0 = time.perf_counter()
    cpu = step("cpu")
    t_cpu = time.perf_counter() - t0
    ref, ref0 = step("cpu", torch.float64), step("cpu", torch.float64, frozen)
    runs = {"card": (card, step("cuda", c=frozen)), "CPU": (cpu, step("cpu", c=frozen)),
            "control": (tf32_step(cfg), tf32_step(frozen))}
    d_keys = [k for k in ref[2] if k.startswith("D.")]
    g_keys = [k for k in ref[2] if k.startswith("G.")]
    e = {}  # run -> its readings against float64
    for name, (a, a0) in runs.items():
        losses = {k: abs(a[0][k] - ref[0][k]) / abs(ref[0][k]) for k in ref[0]
                  if k not in ("g_adv", "g_loss")}  # these go through D' after Adam's step
        losses.update({k: abs(a0[0][k] - ref0[0][k]) / abs(ref0[0][k])
                       for k in ("g_adv", "g_loss")}, Genh=rel_err(a[1], ref[1]))
        e[name] = dict(losses=losses, d_all=rel_all(a[2], ref[2], d_keys),
                       d_each={k: rel(a[2][k], ref[2][k]) for k in d_keys},
                       g_all=rel_all(a[2], ref[2], g_keys), g0_all=rel_all(a0[2], ref0[2], g_keys),
                       uv={k: rel(v, ref[3][k]) for k, v in a[3].items()})
    for name, r in e.items():
        top_d = sorted(d_keys, key=lambda k: -r["d_each"][k])[:2]
        top_uv = sorted(r["uv"], key=lambda k: -r["uv"][k])[:2]
        print(f"WSEGAN step, B=4 fp32 (snorm G and D, Adam, misaligned pair), one row masked, "
              f"one 'additive', {name} vs float64 on the CPU"
              + (f" (card {t_card:.2f} s, CPU {t_cpu:.2f} s)" if name == "card" else "")
              + ": losses (g_adv and g_loss with d_lr = 0) and Genh " + ", ".join(
                  f"{k} {v:.1e}" for k, v in r["losses"].items())
              + f"\n  D's gradients, all {len(d_keys)} tensors {r['d_all']:.1e}, worst "
              + ", ".join(f"{k} {r['d_each'][k]:.1e}" for k in top_d)
              + f"; G's, all {len(g_keys)}: {r['g_all']:.1e}, with d_lr = 0 (D' = D) "
              f"{r['g0_all']:.1e}\n  u and v after the step: worst "
              + ", ".join(f"{k} {r['uv'][k]:.1e}" for k in top_uv), flush=True)

    def readings(r):  # each bound's reading: (losses and Genh, D's, G's with D' = D, u v)
        return (worst(r["losses"].values()), r["d_all"], r["g0_all"], worst(r["uv"].values()))

    card_r, cpu_r, control_r = (readings(e[n]) for n in ("card", "CPU", "control"))
    bounds = (WS_TOL, max(WS_TOL, 4 * cpu_r[1]), WS_G_TOL, WS_TOL)
    bad = {k: (e["card"]["d_each"][k], e["CPU"]["d_each"][k]) for k in d_keys
           if not e["card"]["d_each"][k] <= max(10 * WS_TOL, 4 * e["CPU"]["d_each"][k])}
    assert not bad, bad
    assert all(r <= b for r, b in zip(card_r, bounds)), (card_r, bounds)
    # the control: one TF32 pass in the step's cuDNN convs and matmuls breaks every bound
    assert all(r > b for r, b in zip(control_r, bounds)), (control_r, bounds)


def phase_wsegan_b150(kernel_ms):
    """7b: the WSEGAN step at full width and the script's batch, 150, in fp32 and bf16,
    timed by CUDA events; the weight pad (and fp32 split) that the per-layer kernel makes
    of each w / sigma, timed alone and printed beside `kernel_ms` (by dtype name: the
    kernel's 25 calls a step, which phase 3 holds and times at the step's shapes); then
    the bench entry with --engine wsegan and aewsegan. Returns the kernel's launches per
    step and by dtype the pad's ms a step."""
    import torch
    from segan_pytorch_tpu_torch.models.wsegan import WSEGAN
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.tools.encoder_fused_bench import ms_in_turns
    from segan_pytorch_tpu_torch.utils.config import SEGANConfig

    from segan_pytorch_tpu_torch import bench

    B, n_steps = 150, 5
    per_step = set()
    times = {}
    for dtype in ("float32", "bfloat16"):
        cfg = SEGANConfig(**WSEGAN_FLAGS, compute_dtype=dtype, batch_size=B)
        G, D = _wsegan_models(cfg, SEED + 34)
        seg = WSEGAN(cfg, generator=G, discriminator=D, device="cuda")
        clean, noisy = (v.cuda() for v in _train_batch(B, cfg.slice_size, SEED + 35))
        mask = torch.ones((B,), device="cuda")
        r = _time_steps(seg, (clean, noisy, mask, torch.zeros_like(mask), 100.0), n_steps,
                        warm=2)
        launches, mma, tf32, wg = _check_counts(r, WS_PER_STEP * n_steps, dtype)
        assert wg > 0, r["counts"]  # G's and D's enc2-5 on wgmma, in fp32 by 3xTF32
        per_step.add(launches // n_steps)
        # the kernel's copy of each w / sigma, made anew on every call, for its route:
        # padded (fp32: and split, for both tensor-core routes), in bf16 on wgmma padded
        # and its taps permuted, none for the FMA kernel; G's five once a step, D's five
        # in each of its passes
        cdt = seg.compute_dtype
        prep = {"mma": K._mma_weights,
                "wgmma": K._mma_weights if dtype == "float32" else K._wgmma_weights}

        def weights(blocks):
            out = []
            for i, blk in enumerate(blocks):
                w = blk.conv.get_weight().to(cdt)
                r = K._route(cdt, B, w.shape[1], w.shape[0], w.shape[2], 4,
                             cfg.slice_size // 4 ** (i + 1), True)
                if r in prep:
                    out.append((w, prep[r]))
            return out

        with torch.no_grad():
            gw, dw = weights(seg.G.enc_blocks), weights(seg.D.enc_blocks)
        pad = ms_in_turns({"G": lambda: [f(w) for w, f in gw],
                           "D": lambda: [f(w) for w, f in dw]})
        pad_step = pad["G"] + 4 * pad["D"]
        times[dtype] = dict(pad_ms=pad_step)
        kernel = kernel_ms[dtype]
        print(f"WSEGAN step B={B} {dtype}: {r['rate']:.2f} slices/s (median {r['ms']:.3f} "
              f"ms/step); median split " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                                     r["split"].items())
              + f"; peak device memory {r['peak']:.2f} GiB; fused_conv1d_prelu launches "
              f"{launches} ({mma} on the tensor cores, {tf32} 3xTF32, {wg} wgmma); the "
              f"weights' pad{' and split' if dtype == 'float32' else ' (and permutation)'} "
              f"{pad_step:.3f} ms a step (G {pad['G']:.3f}, D {pad['D']:.3f} a pass), "
              f"{pad_step / r['ms']:.2%} of it, beside the kernel's 25 calls {kernel:.3f} ms "
              f"a step (phase 3, ms a wrapper call); last losses " + ", ".join(
                  f"{k} {v:.4f}" for k, v in r["losses"].items()), flush=True)
        del seg, G, D, clean, noisy, gw, dw
        torch.cuda.empty_cache()
    for engine in ("wsegan", "aewsegan"):  # the entry's main in this process
        with contextlib.redirect_stdout(io.StringIO()):
            res = bench.main(["--engine", engine, "--batch_size", str(B), "--steps", "5",
                              "--warmup", "2", "--steps_per_call", "1"])
        print(f"bench --engine {engine} (bfloat16): {json.dumps(res)}", flush=True)
        assert (res["metric"], res["batch"], res["engine"]) == (
            "train_slices_per_sec_per_chip", B, engine) and res["value"] > 0, res
    assert per_step == {WS_PER_STEP}, per_step
    return per_step.pop(), times


WS_LOG_RE = re.compile(r"^Iter (\d+)/(\d+) \((\d+) bpe\) d_loss:(\S+), g_loss: (\S+), "
                       r"pow_loss: (\S+), den_loss: (\S+) btime", re.M)


def phase_wsegan_run(work: Path):
    """7c: `python -m segan_pytorch_tpu_torch.train`'s main with the script's flags at full
    width on the card, a synthetic corpus of 4 x 4 s pairs (two batches of 150 an epoch
    at stride 0.05): one epoch, then --resume to epoch 2; the port's clean CLI on the last
    EOE G, one G pass per wav; then --aewsegan for one epoch with a validation set.
    Returns the kernel's launches over the two WSEGAN runs."""
    import torch
    from segan_pytorch_tpu_torch import clean as clean_cli
    from segan_pytorch_tpu_torch import train as train_cli
    from segan_pytorch_tpu_torch.data.wav_io import read_wav_raw
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K

    train_dirs = _write_corpus(work / "train", 4, 4.0, SEED + 40)
    valid_dirs = _write_corpus(work / "valid", 2, 4.0, SEED + 41)
    save = work / "ws"
    argv = ["--save_path", str(save), "--clean_trainset", train_dirs[0], "--noisy_trainset",
            train_dirs[1], "--cache_dir", str(work / "cache"), "--save_freq", "1",
            "--seed", str(SEED), "--device", "cuda"] + WSEGAN_ARGS

    def run(args):
        out = io.StringIO()
        start = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                seg = train_cli.main(args)
        finally:
            print("\n".join(line for line in out.getvalue().splitlines()
                            if line.startswith(("Iter", "[*]", "[!]", "[data]"))), flush=True)
        torch.cuda.synchronize()
        return seg, out.getvalue(), time.perf_counter() - start

    K.launches = K.launches_mma = K.launches_tf32 = K.launches_wgmma = K.launches_rows = 0
    with _logged_launches() as log:
        runs = [run(argv + ["--epoch", "1"]), run(argv + ["--epoch", "2", "--resume"])]
    launches, mma, tf32, wg, rows = _counters(K)
    want = _want_counts(K, log)
    logged = [WS_LOG_RE.findall(out) for _, out, _ in runs]
    bpe = int(logged[0][0][2])
    assert bpe == 2, logged
    assert [int(m[0]) for m in logged[0]] == [1, 2], logged[0]
    assert [int(m[0]) for m in logged[1]] == [3, 4], logged[1]
    assert "[*] Resumed from step 2" in runs[1][1], runs[1][1][-2000:]
    losses = np.array([[float(v) for v in m[3:]] for log in logged for m in log])
    assert np.isfinite(losses).all(), losses
    seg = runs[1][0]
    assert seg.step == 4, seg.step
    # launches of one G forward, and of a step: G's blocks once, D's in its four passes
    g_fwd = len(seg.G.enc_blocks)
    per_step = g_fwd + 4 * len(seg.D.enc_blocks)
    print(f"fused_conv1d_prelu launches over the two WSEGAN runs: {launches} ({mma} on the "
          f"tensor cores, {tf32} 3xTF32) for 4 train steps")
    assert launches == per_step * 4 and (launches, mma, tf32, wg, rows) == want and (
        mma == tf32), ((launches, mma, tf32, wg, rows), want)
    index = json.loads((save / "EOE_G-checkpoints").read_text())
    assert index["latest"] == ["EOE_G-Generator-2.ckpt", "EOE_G-Generator-4.ckpt"], index
    d_index = json.loads((save / "EOE_D-checkpoints").read_text())
    assert d_index["current"] == "EOE_D-Discriminator-4.ckpt", d_index
    last_g = save / "weights_EOE_G-Generator-4.ckpt"
    payload = torch.load(last_g, map_location="cpu", weights_only=True)
    assert payload["step"] == 4 and len(payload["optimizer"]["state"]) > 0
    assert "enc_blocks.0.conv.weight_u" in payload["state_dict"]
    del payload, runs, seg

    # the clean CLI through the WSEGAN engine: one padded G pass per wav
    out_dir = work / "ws_enhanced"
    out_dir.mkdir()
    opts = clean_cli.build_parser().parse_args([
        "--g_pretrained_ckpt", str(last_g), "--cfg_file", str(save / "train.opts"),
        "--test_files", valid_dirs[1], "--synthesis_path", str(out_dir), "--seed",
        str(SEED), "--device", "cuda"])
    before = K.launches
    with contextlib.redirect_stdout(io.StringIO()):
        clean_cli.main(opts)
    names = sorted(os.listdir(valid_dirs[1]))
    assert K.launches - before == g_fwd * len(names), K.launches - before
    for name in names:
        _, y = read_wav_raw(str(out_dir / name))
        assert y.shape == (64000,) and np.isfinite(y).all(), (name, y.shape)
    print(f"clean CLI (WSEGAN engine) with {last_g.name}: {len(names)} wavs enhanced, one G "
          f"pass each ({K.launches - before} launches)")

    # AEWSEGAN: G alone, the validation set's spectral distortion at each log point
    ae_save = work / "ae"
    before = K.launches
    seg, out, wall = run(["--save_path", str(ae_save), "--clean_trainset", train_dirs[0],
                          "--noisy_trainset", train_dirs[1], "--cache_dir",
                          str(work / "cache"), "--clean_valset", valid_dirs[0],
                          "--noisy_valset", valid_dirs[1], "--save_freq", "1", "--seed",
                          str(SEED), "--device", "cuda", "--no_train_gen", "--batch_size",
                          "150", "--aewsegan", "--opt", "adam", "--data_stride", "0.05",
                          "--epoch", "1"])
    assert seg.D is None and seg.step == 2, (seg.D, seg.step)
    sds = [json.loads(line)["value"] for line in
           (ae_save / "train" / "scalars.jsonl").read_text().splitlines()
           if json.loads(line)["tag"] == "Genh_SD"]
    assert len(sds) == 2 and np.isfinite(sds).all(), sds
    # a G forward's launches for each of the two steps and each evaluate_sd
    assert K.launches - before == g_fwd * 2 + g_fwd * 2, K.launches - before
    assert (ae_save / "AEWSEGAN-G-checkpoints").exists()
    assert json.loads((ae_save / "train.opts").read_text())["deconv_impl"] == "edge-blocked"
    print(f"AEWSEGAN run: 2 steps in {wall:.2f} s, Genh_SD " + ", ".join(f"{v:.4f}" for v in sds)
          + f" dB; fused_conv1d_prelu launches {K.launches - before}", flush=True)
    return launches


# ---- phase 8: serving ----------------------------------------------------------------
# The bounds of a served answer against generate() with the same z, and of a stream
# against the offline path (PCM16, past one LSB of rounding), relative. On an H100 at
# 700 W the readings were <= 2.9e-7 and 0 in fp32, <= 5.8e-3 and 4.7e-3 in bf16 (split-K
# plans that differ by batch flip bf16 roundings); the controls, the answer against
# generate() with another seed's z or with the other join (hard cut vs cross-fade),
# >= 0.32. Each bound sits between, and the phase fails if a control meets it.
SERVE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
STREAM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SERVE_CHANS = [1, 64, 128, 256, 512, 1024]  # G's encoder widths (SEGAN+ and WSEGAN)


def _g_layers(b, t, bias):
    """The per-layer kernel's five calls in one G forward of b rows of t samples:
    (B, Cin, T_in, Cout, K, stride, bias); G pads each layer's input by 14 + 15."""
    return [(b, SERVE_CHANS[i], t // 4 ** i + 29, SERVE_CHANS[i + 1], 31, 4, bias)
            for i in range(5)]


def _pcm(n, seed):
    """n int16 samples at 16 kHz: a tone and noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / SR
    x = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 800) * t) + 0.05 * rng.randn(n)
    return np.clip(x * 32767, -32768, 32767).astype("<i2")


def _wav_body(n, seed):
    """`_pcm(n, seed)` as a WAV file's bytes."""
    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, SR, _pcm(n, seed))
    return buf.getvalue()


def _request(url, body=None, timeout=120, headers=None):
    """One request that must be answered 200 (urllib raises on an error status):
    (body, headers, wall seconds)."""
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(urllib.request.Request(url, data=body,
                                                       headers=headers or {}),
                                timeout=timeout) as r:
        data, status, headers = r.read(), r.status, dict(r.headers)
    assert status == 200, (url, status)
    return data, headers, time.perf_counter() - t0


def _stream(host, pcm, query, pieces):
    """A chunked POST of raw PCM16 to /enhance_stream in pieces of the given sizes (the
    rest in one), which must be answered 200; returns the streamed PCM16."""
    import http.client

    conn = http.client.HTTPConnection(host, timeout=120)
    try:
        conn.putrequest("POST", "/enhance_stream?" + query)
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        data, pos = pcm.tobytes(), 0
        for size in list(pieces) + [len(data)]:
            piece = data[pos: pos + size]
            pos += len(piece)
            if piece:
                conn.send(b"%x\r\n%s\r\n" % (len(piece), piece))
        conn.send(b"0\r\n\r\n")
        resp = conn.getresponse()
        out = resp.read()
        assert resp.status == 200, (query, resp.status, out[:300])
        return np.frombuffer(out, dtype="<i2")
    finally:
        conn.close()


def _in_threads(jobs):
    """Run the callables at once on threads; every one must return, and raise nothing."""
    import threading

    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # re-raised below, on the calling thread
            errors.append(e)

    ts = [threading.Thread(target=run, args=(fn,)) for fn in jobs]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in ts), "a request did not return"
    if errors:
        raise errors[0]


def _served_g(cfg, g):
    """A SEGAN+ G drawn from `g`, PReLU slopes U(0, 0.3), the output layer's weights x
    0.05 and its bias 0, so that the de-emphasized output stays inside PCM16's range."""
    import torch
    from segan_pytorch_tpu_torch.models.generator import build_generator

    G = build_generator(cfg, g)
    with torch.no_grad():
        for name, p in G.named_parameters():
            if name.endswith("act.weight"):
                p.uniform_(0.0, 0.3, generator=g)
        G.dec_blocks[-1].deconv.weight.mul_(0.05)
        G.dec_blocks[-1].deconv.bias.zero_()
    return G


def _serving_checkpoints(work: Path):
    """Full-width G checkpoints: SEGAN+ (--no_bias, slopes U(0, 0.3), the output layer's
    weights x 0.05 and bias 0, so that the de-emphasized output stays inside PCM16's
    range) with train.opts in fp32 and bf16, and a second SEGAN+ of other weights
    (phase 9's reload target, under "segan_b"); WSEGAN's snorm G with biases, Xavier-
    initialised, u and v moved near the top singular pairs by three train-mode forwards
    on the card."""
    import torch
    from segan_pytorch_tpu_torch.models.generator import build_generator
    from segan_pytorch_tpu_torch.models.wsegan import apply_wsegan_weights_init
    from segan_pytorch_tpu_torch.utils.checkpoint import save_generator
    from segan_pytorch_tpu_torch.utils.config import SEGANConfig, dump_train_opts

    out = {}
    cfg = SEGANConfig(no_bias=True, save_path=str(work))
    # B's weights from a generator of their own: A's and WSEGAN's stay as phase 8 had them
    gen_b = torch.Generator().manual_seed(SEED + 51)
    gen = torch.Generator().manual_seed(SEED + 50)
    for ckpt, g in (("segan.ckpt", gen), ("segan_b.ckpt", gen_b)):
        save_generator(_served_g(cfg, g), str(work / ckpt))
    for name in ("float32", "bfloat16"):
        out[name] = (work / "segan.ckpt", dump_train_opts(
            SEGANConfig(no_bias=True, compute_dtype=name), str(work / name)))
    out["segan_b"] = work / "segan_b.ckpt"
    ws_cfg = SEGANConfig(wsegan=True, gnorm_type="snorm", dnorm_type="snorm")
    G = build_generator(ws_cfg, gen)
    apply_wsegan_weights_init(G, gen)
    with torch.no_grad():
        for name, p in G.named_parameters():
            if name.endswith("act.weight"):
                p.uniform_(0.0, 0.3, generator=gen)
        G.cuda().train()
        for _ in range(3):
            G(torch.randn(1, 16384, 1, generator=gen).cuda(),
              G.sample_z((1, 16384, 1), gen).cuda())
    save_generator(G.eval().cpu(), str(work / "wsegan.ckpt"))
    out["wsegan"] = (work / "wsegan.ckpt", dump_train_opts(ws_cfg, str(work / "wsegan")))
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _seed_z(G, seed, length=16384):
    """A served request's z for `seed`: ``seed=<int>`` draws from a torch generator."""
    import torch

    return G.sample_z((1, length, 1), torch.Generator().manual_seed(seed))


def _prep(body, preemph):
    """A WAV body as the server takes it: normalized, then pre-emphasized."""
    from segan_pytorch_tpu_torch.ops.signal import normalize_wave_minmax, pre_emphasize_np
    from scipy.io import wavfile

    return pre_emphasize_np(normalize_wave_minmax(wavfile.read(io.BytesIO(body))[1]),
                            preemph)


def _rel_beyond(got, want, step=0.0):
    """max |got - want| beyond `step` (PCM16's rounding: 1) over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(max(np.abs(got - want).max() - step, 0.0) / np.abs(want).max())


def _offline_pcm(eng, pcm, window, overlap, seed):
    """A stream's PCM16 by the offline chunk_grid + overlap_add path on the engine's
    device, with the stream's z."""
    from segan_pytorch_tpu_torch.ops.signal import (de_emphasize_np, normalize_wave_minmax,
                                                    pre_emphasize_np)
    from segan_pytorch_tpu_torch.parallel.inference import chunk_grid, overlap_add

    pe = pre_emphasize_np(normalize_wave_minmax(pcm), eng.preemph)
    grid, hop, n = chunk_grid(pe, window, overlap)
    out = eng.infer_G(grid, _seed_z(eng.G, seed, window).expand(n, -1, -1)).cpu().numpy()
    y = de_emphasize_np(overlap_add(out, hop, len(pcm)), eng.preemph)
    return np.clip(y * 32767.0, -32768, 32767).astype("<i2")


class _InProcess:
    """``serve.build_server`` (--device cuda) with ``serve_forever`` on a thread; with a
    `token`, under --auth_token, which `post` and `reload` send."""

    def __init__(self, ckpt, opts_file, *extra, token=None):
        import threading
        from segan_pytorch_tpu_torch import serve

        self.serve = serve
        self.auth = {"Authorization": f"Bearer {token}"} if token else {}
        self.srv, self.state = serve.build_server(serve.parse_args(
            ["--g_pretrained_ckpt", str(ckpt), "--cfg_file", str(opts_file), "--port", "0",
             "--device", "cuda", "--seed", str(SEED), *extra,
             *(["--auth_token", token] if token else [])]))
        self.host = "127.0.0.1:%d" % self.srv.server_address[1]
        self.base = "http://" + self.host
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()

    def metrics(self):
        text = _request(self.base + "/metrics")[0].decode()
        return {ln.split()[0]: float(ln.split()[1]) for ln in text.splitlines()
                if ln and not ln.startswith("#")}

    def post(self, path, body):
        """`_request` of a POST to `path`, with the token."""
        return _request(self.base + path, body, headers=self.auth)

    def reload(self, body, auth=True):
        """POST /admin/reload (with the token unless `auth` is false): (status, answer,
        wall seconds)."""
        import urllib.error
        import urllib.request

        t0 = time.perf_counter()
        req = urllib.request.Request(self.base + "/admin/reload",
                                     data=json.dumps(body).encode(),
                                     headers=self.auth if auth else {})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, json.loads(r.read()), time.perf_counter() - t0
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read()), time.perf_counter() - t0

    def retired(self):
        """Wait until every replaced generation is retired."""
        for t in self.state["retiring"]:
            t.join(timeout=60)
            assert not t.is_alive(), "a generation was not retired"

    def stop(self):
        self.srv.shutdown()
        self.serve.close(self.srv, self.state)
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def _record_launches(calls: set):
    """Wrap the kernel's `_launch` so that every call adds its (B, Cin, T_in, Cout, K,
    stride, bias, dtype) to `calls`, the counting left to the wrapper; returns the
    function that unwraps it."""
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K

    launch = K._launch

    def recorded_launch(x, w, b, a, stride, t_out=None, **kw):
        calls.add((*x.shape, w.shape[0], w.shape[2], stride, b is not None, x.dtype))
        return launch(x, w, b, a, stride, t_out, **kw)

    K._launch = recorded_launch

    def unwrap():
        K._launch = launch

    return unwrap


class _Served(_InProcess):
    """An ``_InProcess`` server whose engine's G forwards are recorded (thread, rows,
    samples, milliseconds to the end of the device's work), and so are the kernel's calls
    (shape, bias, dtype), the kernel's counting left to its wrapper."""

    def __init__(self, ckpt, opts_file, *extra):
        import threading
        import torch

        super().__init__(ckpt, opts_file, *extra)
        self.engine = self.state["gen"][1]
        self.passes = []  # (thread name, rows, samples, ms)
        self.calls = set()  # (B, Cin, T_in, Cout, K, stride, bias, dtype)
        infer = self.engine.infer_G

        def timed_infer(x, z=None, ret_hid=False):
            t0 = time.perf_counter()
            out = infer(x, z, ret_hid)
            torch.cuda.synchronize()
            self.passes.append((threading.current_thread().name, int(np.shape(x)[0]),
                                int(np.shape(x)[1]), 1e3 * (time.perf_counter() - t0)))
            return out

        self.engine.infer_G = timed_infer
        self._unrecord = _record_launches(self.calls)

    def stop(self):
        self._unrecord()
        super().stop()


def _counters(K):
    """The per-layer kernel's five counters: all launches, tensor cores, of those fp32
    (3xTF32), on wgmma, and on the rows kernel (bf16)."""
    return K.launches, K.launches_mma, K.launches_tf32, K.launches_wgmma, K.launches_rows


def _g_routes(K, dtype, b, t, bias):
    """The routes _route picks for the five layers of one G forward of b rows of t
    samples, x in G's pitched rows."""
    return [K._route(dtype, B, cin, cout, k, s, (t_in - k) // s + 1, True)
            for B, cin, t_in, cout, k, s, _ in _g_layers(b, t, bias)]


def _expect_launches(K, before, passes, bias, fp32):
    """The kernel's counters since `before` (``_counters``) against the G forwards
    `passes` (rows, samples): five launches each, on the route that _route picks for
    each layer's shape and G's pitched rows (read from the counters), fp32 ones by
    3xTF32, bf16 ones on wgmma or the rows kernel where the rule says. Returns the five
    deltas."""
    import torch

    routes = [r for b, t in passes
              for r in _g_routes(K, torch.float32 if fp32 else torch.bfloat16, b, t, bias)]
    tc = sum(r != "fma" for r in routes)
    want = (len(routes), tc, tc if fp32 else 0, routes.count("wgmma"), routes.count("rows"))
    got = tuple(n - b for n, b in zip(_counters(K), before))
    assert got == want, (got, want, passes)
    return np.array(got)


def _hold_kernel(shapes, seed):
    """The kernel against its plain version at each layer shape (B, Cin, T_in, Cout, K,
    stride, bias) in fp32 and bf16, x through G's pitched pad (a stride-4, K = 31 shape;
    others in contiguous rows), on random inputs and NaN-filled outputs: on the route
    _route picks, read from the counters, then on the other routes that take the shape
    forced (the rows kernel in bf16 up to its rows, mma.sync, FMA); timed in turns with the
    plain version and cuDNN beside bounds, a table row per shape. Returns {shape: {dtype:
    (err, ms)}}."""
    import torch
    import torch.nn.functional as F
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.tools.encoder_fused_bench import ms_in_turns

    g = torch.Generator().manual_seed(seed)
    per_shape = {}
    print(f"{'served shape':>34} | {'routes':>11} {'fp32 err':>8} {'bf16 err':>8} | fp32 ms: "
          f"{'kernel':>7} {'mma':>7} {'fma':>7} {'plain':>7} {'cuDNN':>7} {'bound':>7} | "
          f"bf16 ms: {'kernel':>7} {'mma':>7} {'fma':>7} {'plain':>7} {'cuDNN':>7} "
          f"{'bound':>7}")
    for shape in sorted(shapes):
        b, cin, t_in, cout, kw, s, has_bias = shape
        layout = "pad" if (kw, s) == (31, 4) and t_in > 29 else "contiguous"
        xs = dict(zip((torch.float32, torch.bfloat16), _case_x(b, cin, t_in, g, layout)))
        w = (torch.randn((cout, cin, kw), generator=g) / (cin * kw) ** 0.5).cuda()
        bias = (torch.randn((cout,), generator=g) * 0.1).cuda() if has_bias else None
        a = (torch.rand((cout,), generator=g) * 0.3).cuda()
        t_out = K._check(xs[torch.float32], w, bias, a, s)
        tc_shape = K._tensor_core_shape(torch.float32, cout, kw, s, t_out)
        flops = 2.0 * b * t_out * cout * cin * kw
        nbytes = 2 * (b * cin * t_in + cout * cin * kw + (2 if has_bias else 1) * cout
                      + 2 * b * cout * t_out)
        row, routes = {}, []
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            args = [xs[dtype]] + [v.to(dtype) if v is not None else None
                                  for v in (w, bias, a)]
            route = K._route(dtype, b, cin, cout, kw, s, t_out, _pitched(K, args[0]))
            errs = {}
            rows_shape = (K._rows_shape(dtype, cin, cout, kw, s) and b * t_out
                          <= K.ROWS_MAX_ROWS and K._rows_fits(b, cin, t_out))
            for force in [None] + [r for r in (("rows",) if rows_shape else ()) + (
                    ("mma", "fma") if tc_shape else ("fma",)) if r != route]:
                before = _counters(K)
                y, pre = K._launch(*args, s, t_out, force=force,
                                   out=nan_outputs((b, cout, t_out), (b, cout, t_out),
                                                   dtype=dtype))
                y_ref, pre_ref = K.conv1d_prelu_plain(*args, s)
                took = _took(K, before)
                assert took == (force or route), (shape, dtype, took, force, route)
                assert K.launches_tf32 - before[2] == (took != "fma" and dtype == torch.float32)
                errs[took] = worst([rel_err(y, y_ref), rel_err(pre, pre_ref)])
                assert errs[took] <= tol, (shape, dtype, took, errs[took])
                del y, pre, y_ref, pre_ref
            arms = {"kernel": lambda: K.fused_conv1d_prelu(*args, s)}
            for r in ("mma", "fma") if tc_shape else ("fma",):
                arms[r] = lambda r=r: K._launch(*args, s, t_out, force=r)
            arms.update(plain=lambda: K.conv1d_prelu_plain(*args, s),
                        cuDNN=lambda: F.conv1d(args[0], args[1], args[2], stride=s))
            t = ms_in_turns(arms, reps=HOLD_REPS, warmup=2)
            t.setdefault("mma", float("nan"))
            t["bound"] = (min(bound_ms(flops, 2 * nbytes, FP32_PEAK),
                              bound_ms(3 * flops, 2 * nbytes, TF32_PEAK))
                          if dtype == torch.float32 else bound_ms(flops, nbytes, BF16_PEAK))
            row[dtype] = (errs[route], t)
            routes.append(route)
            del args
        per_shape[shape] = row
        (e32, t32), (e16, t16) = row[torch.float32], row[torch.bfloat16]
        cols = ("kernel", "mma", "fma", "plain", "cuDNN", "bound")
        print(f"{str(shape[:6]) + (' bias' if has_bias else ''):>34} | "
              f"{'/'.join(routes):>11} {e32:8.1e} {e16:8.1e} | "
              + " ".join(f"{t32[c]:7.4f}" for c in cols) + " | "
              + " ".join(f"{t16[c]:7.4f}" for c in cols), flush=True)
    return per_shape


def phase_serve(work: Path, smi: str, ckpts: dict):
    """8: the port's server at full width on the card (see the module docstring), on
    `_serving_checkpoints`. Returns the kernel's launches over the in-process servers
    (all, tensor cores, 3xTF32) and the layer shapes that 8a held against the plain
    version."""
    import signal as signal_mod
    import threading
    import torch
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.parallel.inference import chunk_grid
    from segan_pytorch_tpu_torch.utils.engine import build_enhancement_engine
    from scipy.io import wavfile

    S = 16384

    totals = np.zeros(5, np.int64)  # the kernel's launches in the served G forwards
    served = set()  # (B, samples, bias) of every G forward that served
    calls = set()
    for name in ("float32", "bfloat16"):
        fp32 = name == "float32"
        ckpt, opts_file = ckpts[name]
        srv = _Served(ckpt, opts_file)  # --warm_seconds 2: generate() and stream warm-up
        try:
            info = json.loads(_request(srv.base + "/healthz")[0])
            assert info["model"] == "SEGAN" and info["status"] == "ok", info
            srv.passes.clear()
            before = _counters(K)
            # 20 sequential one-chunk requests
            one = _wav_body(16000, SEED + 60)
            walls = []
            for i in range(20):
                last, _, wall = _request(srv.base + f"/enhance?seed={i}", one)
                walls.append(wall)
            assert [p[1:3] for p in srv.passes] == [(1, S)] * 20, srv.passes
            one_pass = np.median([p[3] for p in srv.passes])
            # 8 concurrent requests of 1-6 chunks, seeded, overlap 0 and 0.25
            m0, n0 = srv.metrics(), len(srv.passes)
            lengths = [16000, 30000, 45000, 60000, 75000, 90000, 20000, 50000]
            bodies = [_wav_body(n, SEED + 70 + i) for i, n in enumerate(lengths)]
            overlaps = [0.0, 0.25] * 4
            answers = [None] * 8
            _in_threads([lambda i=i: answers.__setitem__(i, _request(
                srv.base + f"/enhance?seed={100 + i}&overlap={overlaps[i]}",
                bodies[i])[0]) for i in range(8)])
            m1 = srv.metrics()
            coalesced = srv.passes[n0:]
            d_req = m1["segan_requests_total"] - m0["segan_requests_total"]
            d_pass = m1["segan_device_passes_total"] - m0["segan_device_passes_total"]
            assert d_req == 8 and 1 <= d_pass < d_req, (d_req, d_pass)
            # one stream at the default window and at 2048, fed in uneven pieces
            pcm = _pcm(48000, SEED + 80)
            one_stream = {}
            for window in (S, 2048):
                n0 = len(srv.passes)
                out = _stream(srv.host, pcm, f"seed=7&window={window}",
                              (3000, 17000, 999, 12345))
                one_stream[window] = (out, [p[3] for p in srv.passes[n0:]])
            # concurrent streams through the WindowBatcher, interleaved with /enhance
            m0 = srv.metrics()
            streams = [_pcm(40000, SEED + 90 + i) for i in range(4)]
            st_out, req_out = [None] * 4, [None] * 4
            jobs = [lambda i=i: st_out.__setitem__(i, _stream(
                srv.host, streams[i], f"seed={200 + i}", (8000 + 1000 * i,)))
                for i in range(4)]
            jobs += [lambda i=i: req_out.__setitem__(i, _request(
                srv.base + f"/enhance?seed={300 + i}", bodies[i])[0]) for i in range(4)]
            _in_threads(jobs)
            m1 = srv.metrics()
            wins = m1["segan_stream_windows_total"] - m0["segan_stream_windows_total"]
            wpass = (m1["segan_stream_window_passes_total"]
                     - m0["segan_stream_window_passes_total"])
            n_win = sum(chunk_grid(st, S, 0.25)[2] for st in streams)
            assert wins == n_win and 1 <= wpass < wins, (wins, n_win, wpass)
            passes = [(r, n) for _, r, n, _ in srv.passes]
            got = _expect_launches(K, before, passes, False, fp32)
        finally:
            srv.stop()
        totals += got
        served |= {(r, n, False) for r, n in passes}
        calls |= srv.calls
        print(f"serve {name}: fused_conv1d_prelu launches {got[0]} ({got[1]} on the tensor "
              f"cores, {got[2]} 3xTF32) for {len(passes)} G forwards, 5 each", flush=True)

        # the answers against the engine's own generate() and the offline stream path
        # on the card, with the same z (the reference's launches come after the count)
        _, ref = build_enhancement_engine(opts_file, str(ckpt), SEED, device="cuda")
        e = _rel_beyond(wavfile.read(io.BytesIO(last))[1],
                ref.generate(_prep(one, ref.preemph), z=_seed_z(ref.G, 19))[0])
        print(f"serve {name}: one-chunk /enhance (1 s of audio), 20 sequential requests: "
              f"p50 {1e3 * np.percentile(walls, 50):.3f} ms, p95 "
              f"{1e3 * np.percentile(walls, 95):.3f} ms wall, the G pass {one_pass:.3f} ms "
              f"(median); vs generate() rel err {e:.3e} ({smi})", flush=True)
        readings, controls = [e], []
        for i in range(8):
            got_i = wavfile.read(io.BytesIO(answers[i]))[1]
            pw = _prep(bodies[i], ref.preemph)
            readings.append(_rel_beyond(got_i, ref.generate(pw, z=_seed_z(ref.G, 100 + i),
                                                    overlap=overlaps[i])[0]))
            controls.append(_rel_beyond(got_i, ref.generate(pw, z=_seed_z(ref.G, 101 + i),
                                                    overlap=overlaps[i])[0]))
            if lengths[i] > S:  # the other join (hard cut vs cross-fade)
                controls.append(_rel_beyond(got_i, ref.generate(pw, z=_seed_z(ref.G, 100 + i),
                                                        overlap=0.25 - overlaps[i])[0]))
        print(f"serve {name}: 8 concurrent /enhance requests of 1-6 chunks in {int(d_pass)} "
              f"G passes (rows, ms: " + ", ".join(f"{r}, {ms:.3f}" for _, r, _, ms in coalesced)
              + f"); vs generate() with the same z rel err <= {max(readings):.3e} (bound "
              f"{SERVE_TOL[name]:g}); controls (another seed's z, the other join) >= "
              f"{min(controls):.3e} ({smi})", flush=True)
        assert max(readings) <= SERVE_TOL[name] < min(controls), (readings, controls)
        for window, (out, ms) in one_stream.items():
            want = _offline_pcm(ref, pcm, window, 0.25, 7)
            e = _rel_beyond(out, want, step=1)
            ctrl = _rel_beyond(out, _offline_pcm(ref, pcm, window, 0.25, 8), step=1)
            print(f"serve {name}: /enhance_stream window {window}: {len(ms)} windows, "
                  f"{np.median(ms):.3f} ms per window's G pass (median); vs the offline "
                  f"path rel err {e:.3e} beyond 1 LSB (bound {STREAM_TOL[name]:g}; max |out| "
                  f"{int(np.abs(want).max())} LSB; control, another seed's z, {ctrl:.3e}) "
                  f"({smi})", flush=True)
            assert out.shape == pcm.shape and e <= STREAM_TOL[name] < ctrl, (window, e, ctrl)
        e_st = worst(_rel_beyond(st_out[i], _offline_pcm(ref, streams[i], S, 0.25, 200 + i),
                                 step=1) for i in range(4))
        e_req = worst(_rel_beyond(wavfile.read(io.BytesIO(req_out[i]))[1],
                          ref.generate(_prep(bodies[i], ref.preemph),
                                       z=_seed_z(ref.G, 300 + i))[0]) for i in range(4))
        print(f"serve {name}: 4 concurrent streams ({int(wins)} windows in {int(wpass)} "
              f"passes) with 4 /enhance requests: streams vs offline rel err {e_st:.3e}, "
              f"requests vs generate() {e_req:.3e}", flush=True)
        assert e_st <= STREAM_TOL[name] and e_req <= SERVE_TOL[name], (e_st, e_req)
        del ref

    # one WSEGAN engine: snorm G with biases, one padded pass per utterance
    ckpt, opts_file = ckpts["wsegan"]
    srv = _Served(ckpt, opts_file, "--no_stream_coalesce", "--warm_seconds", "0.5")
    try:
        assert json.loads(_request(srv.base + "/healthz")[0])["model"] == "WSEGAN"
        srv.passes.clear()
        before = _counters(K)
        lengths = [20000, 20000, 33000, 5000]
        bodies = [_wav_body(n, SEED + 100 + i) for i, n in enumerate(lengths)]
        answers = [None] * 4
        _in_threads([lambda i=i: answers.__setitem__(i, _request(
            srv.base + f"/enhance?seed={400 + i}", bodies[i])[0]) for i in range(4)])
        passes = [(r, n) for _, r, n, _ in srv.passes]
        got = _expect_launches(K, before, passes, True, True)
    finally:
        srv.stop()
    totals += got
    served |= {(r, n, True) for r, n in passes}
    calls |= srv.calls
    _, ref = build_enhancement_engine(opts_file, str(ckpt), SEED, device="cuda")
    pads = [n + 1024 - n % 1024 for n in lengths]
    want = ref.generate_batch([_prep(b, ref.preemph) for b in bodies],
                              z=[_seed_z(ref.G, 400 + i, L) for i, L in enumerate(pads)])
    e = worst(_rel_beyond(wavfile.read(io.BytesIO(a))[1], w)
              for a, (w, _) in zip(answers, want))
    print(f"serve WSEGAN float32: 4 concurrent /enhance requests in G forwards of (rows, "
          f"samples) {passes}: vs generate_batch rel err {e:.3e} (bound "
          f"{SERVE_TOL['float32']:g}); kernel launches {tuple(int(v) for v in got)}",
          flush=True)
    assert e <= SERVE_TOL["float32"], e
    del ref

    # 8a: the kernel vs its plain version at every served shape, both dtypes: the passes
    # that ran, and the shapes of ROADMAP's list (passes of 2-128 chunks, windows of 2048
    # and 4096 at 1-8 rows) where they did not; 3 rows, the split-K plan that phase 9's
    # four clients meet
    listed = ({(b, S, False) for b in (1, 2, 3, 4, 16, 32, 128)}
              | {(b, w, False) for w in (2048, 4096) for b in (1, 2, 4, 8)})
    layers = {p: _g_layers(*p) for p in served | listed}
    known = {c for ls in layers.values() for c in ls}
    assert {c[:7] for c in calls} <= known, sorted({c[:7] for c in calls} - known)
    per_shape = _hold_kernel(known, SEED + 110)
    for p in sorted(layers):
        sums = {d: {c: sum(per_shape[l][d][1][c] for l in layers[p])
                    for c in ("kernel", "mma", "fma", "plain", "cuDNN", "bound")}
                for d in (torch.float32, torch.bfloat16)}
        routes = {d: _g_routes(K, d, *p) for d in (torch.float32, torch.bfloat16)}
        print(f"served G forward B={p[0]} T={p[1]}{' bias' if p[2] else ''}"
              f"{' (ran)' if p in served else ''}: 5 launches (routes fp32 "
              f"{'/'.join(routes[torch.float32])}, bf16 {'/'.join(routes[torch.bfloat16])}); "
              + "; ".join(f"{'fp32' if d == torch.float32 else 'bf16'} "
                          + ", ".join(f"{c} {v:.4f}" for c, v in sums[d].items())
                          for d in sums) + f" ms ({smi})", flush=True)

    # the command line in a subprocess: /healthz, one /enhance, SIGTERM, exit 0 in time
    port = _free_port()
    ckpt, opts_file = ckpts["float32"]
    drain = 10.0
    log = open(work / "serve.log", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "segan_pytorch_tpu_torch.serve", "--g_pretrained_ckpt",
         str(ckpt), "--cfg_file", str(opts_file), "--port", str(port), "--device", "cuda",
         "--warm_seconds", "0.5", "--drain_seconds", str(drain)],
        cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT)), stdout=log,
        stderr=subprocess.STDOUT)
    try:
        t0 = time.perf_counter()
        base = f"http://127.0.0.1:{port}"
        while True:
            assert proc.poll() is None, (work / "serve.log").read_text()[-3000:]
            try:
                if json.loads(_request(base + "/healthz", timeout=5)[0])["status"] == "ok":
                    break
            except OSError:
                assert time.perf_counter() - t0 < 180, "the server never answered"
                time.sleep(0.5)
        up = time.perf_counter() - t0
        data, _, wall = _request(base + "/enhance?seed=1", _wav_body(40000, SEED + 120))
        assert wavfile.read(io.BytesIO(data))[1].shape == (40000,)
        t1 = time.perf_counter()
        proc.send_signal(signal_mod.SIGTERM)
        rc = proc.wait(timeout=drain + 30)
        took = time.perf_counter() - t1
        text = (work / "serve.log").read_text()
        done = [ln for ln in text.splitlines() if "shutdown complete" in ln]
        print(f"python -m segan_pytorch_tpu_torch.serve --device cuda: /healthz after "
              f"{up:.1f} s, one /enhance of 2.5 s in {1e3 * wall:.1f} ms, SIGTERM -> exit "
              f"{rc} in {took:.2f} s (drain {drain:g} s; the server: {done[-1:]}; this "
              f"process's threads meanwhile: "
              f"{sorted(t.name for t in threading.enumerate())})", flush=True)
        assert rc == 0 and took <= drain and "shutdown complete" in text, text[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        log.close()
    return tuple(int(v) for v in totals), known


# ---- phase 9: reload on the card -------------------------------------------------------
RELOAD_RETIRE_SECONDS = 1.0  # serve.RETIRE_SECONDS during the phase (150 in service)


def phase_reload(work: Path, smi: str, ckpts: dict, checked: set):
    """9: POST /admin/reload at full width on the card (see the module docstring), on
    `_serving_checkpoints`; `checked` are the layer shapes phase 8a held. Returns the
    kernel's launches over the phase's recorded G forwards (all, tensor cores,
    3xTF32), a fp32 generation's device bytes (9a's mean) and the layer shapes held in
    8a and 9d."""
    import gc
    import importlib.util
    import threading
    import weakref
    import torch
    from segan_pytorch_tpu_torch import serve
    from segan_pytorch_tpu_torch.models.generator import build_generator
    from segan_pytorch_tpu_torch.models.segan import SEGAN
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.ops.signal import normalize_wave_minmax, pre_emphasize_np
    from segan_pytorch_tpu_torch.tools import reload_leak_probe
    from segan_pytorch_tpu_torch.utils.checkpoint import read_generator_state
    from segan_pytorch_tpu_torch.utils.config import SEGANConfig
    from segan_pytorch_tpu_torch.utils.engine import build_enhancement_engine
    from scipy.io import wavfile

    S = 16384
    ckpt_a, opts32 = ckpts["float32"]
    _, opts16 = ckpts["bfloat16"]
    ckpt_b = ckpts["segan_b"]
    ckpt_w, opts_w = ckpts["wsegan"]

    def seed_z(G, seed, length=S):
        return G.sample_z((1, length, 1), torch.Generator().manual_seed(seed))

    def prep(body, preemph):
        return pre_emphasize_np(normalize_wave_minmax(wavfile.read(io.BytesIO(body))[1]),
                                preemph)

    def rel(got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        return float(np.abs(got - want).max() / np.abs(want).max())

    def answer(data):
        return wavfile.read(io.BytesIO(data))[1]

    def refs(opts_file, ckpt, bodies_seeds, lengths=None):
        """The engine's own answers on the card, generate() (WSEGAN: generate_batch with
        the padded lengths' z) with each seed's z."""
        _, eng = build_enhancement_engine(str(opts_file), str(ckpt), SEED, device="cuda")
        if lengths is None:
            return [eng.generate(prep(b, eng.preemph), z=seed_z(eng.G, k))[0]
                    for b, k in bodies_seeds]
        return [w for w, _ in eng.generate_batch(
            [prep(b, eng.preemph) for b, _ in bodies_seeds],
            z=[seed_z(eng.G, k, L) for (_, k), L in zip(bodies_seeds, lengths)])]

    # the G forwards of the phase, recorded on the class: (rows, samples); and the
    # kernel's calls, (B, Cin, T_in, Cout, K, stride, bias, dtype), the probe's included
    passes, calls = [], set()
    infer = SEGAN.infer_G

    def recorded_infer(self, noisy, z=None, ret_hid=False):
        passes.append((int(np.shape(noisy)[0]), int(np.shape(noisy)[1])))
        return infer(self, noisy, z, ret_hid)

    totals = np.zeros(5, np.int64)
    retire = serve.RETIRE_SECONDS
    serve.RETIRE_SECONDS = RELOAD_RETIRE_SECONDS
    SEGAN.infer_G = recorded_infer
    unrecord = _record_launches(calls)
    try:
        # the pieces of a reload's load, timed alone: the checkpoint read on the host and
        # its copy into a G on the card
        t0 = time.perf_counter()
        state_dict = read_generator_state(str(ckpt_b))
        t_read = time.perf_counter() - t0
        G = build_generator(SEGANConfig(no_bias=True),
                            torch.Generator().manual_seed(0)).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        G.load_state_dict(state_dict)
        torch.cuda.synchronize()
        t_copy = time.perf_counter() - t0
        nbytes = sum(v.numel() * v.element_size() for v in state_dict.values())
        del G, state_dict

        # 9a: fp32 under --auth_token: a reload without the token, one to a missing
        # file, then A -> B under load
        srv = _InProcess(ckpt_a, opts32, "--warm_seconds", "1.0", token="phase-9")
        try:
            one = _wav_body(16000, SEED + 130)
            status, info, _ = srv.reload({"g_ckpt": str(ckpt_b)}, auth=False)
            assert status == 401 and info == {"error": "unauthorized"} and (
                srv.state["reloads"] == 0), (status, info)
            passes.clear()
            before = _counters(K)
            # cuDNN's default algorithm for the fp32 transposed convs sums in no fixed
            # order: the same request twice is compared bit for bit with
            # cudnn.deterministic on (its cost is timed below), and read without it
            plain = [answer(srv.post("/enhance?seed=0", one)[0]) for _ in "ab"]
            gen0 = srv.state["gen"]
            torch.backends.cudnn.deterministic = True
            try:
                first = srv.post("/enhance?seed=0", one)[0]
                status, info, _ = srv.reload({"g_ckpt": str(work / "missing.ckpt")})
                again = srv.post("/enhance?seed=0", one)[0]
            finally:
                torch.backends.cudnn.deterministic = False
            assert status == 500 and "reload failed" in info["error"], (status, info)
            assert srv.state["gen"] is gen0 and srv.state["reloads"] == 0
            assert again == first, "A's answer changed after a failed reload"
            del gen0
            print(f"reload without the token: 401; to a missing file: 500, and A answers "
                  f"bit for bit as before it "
                  f"(cudnn.deterministic on); without it two identical requests differ by "
                  f"rel {rel(plain[1], plain[0]):.3e}", flush=True)
            log, samples, errors, stop = [], [], [], threading.Event()

            def client(k):
                try:
                    while not stop.is_set():
                        seed = k + 4 * (len(log) % 2)
                        t_in = time.perf_counter()
                        data, _, _ = srv.post(f"/enhance?seed={seed}", one)
                        log.append((seed, t_in, time.perf_counter(), data))
                except Exception as e:  # an answer other than 200: re-raised below
                    errors.append(e)
                    stop.set()

            def sampler():
                while not stop.is_set():
                    samples.append(srv.metrics())
                    time.sleep(0.05)

            ts = [threading.Thread(target=client, args=(k,)) for k in range(4)]
            ts.append(threading.Thread(target=sampler))
            for t in ts:
                t.start()
            try:
                time.sleep(1.5)
                t_r0 = time.perf_counter()
                status, info, wall = srv.reload({"g_ckpt": str(ckpt_b)})
                t_r1 = time.perf_counter()
                time.sleep(1.5)
            finally:
                stop.set()
                for t in ts:
                    t.join(timeout=120)
            assert not any(t.is_alive() for t in ts), "a client hung"
            if errors:
                raise errors[0]
            assert status == 200 and info["reloads"] == 1, (status, info)
            srv.retired()
            samples.append(srv.metrics())
            got = _expect_launches(K, before, passes, False, True)
            totals += got
            n_pass = len(passes)
            for m0, m1 in zip(samples, samples[1:]):
                for k in m0:
                    if k.endswith("_total") or k.endswith("_sum"):
                        assert m1[k] >= m0[k], ("a counter went back", k, m0[k], m1[k])
            assert samples[-1]["segan_reloads_total"] == 1
            n_before = sum(t1 <= t_r0 for _, _, t1, _ in log)
            n_after = sum(t0 >= t_r1 for _, t0, _, _ in log)
            print(f"reload fp32 under load: 4 clients, {len(log)} one-chunk requests ("
                  f"{n_before} answered before the reload began, {n_after} sent after its "
                  f"200), all 200; {n_pass} G forwards (warm-ups and served passes), "
                  f"fused_conv1d_prelu launches {tuple(int(v) for v in got)} (5 each); "
                  f"{len(samples)} /metrics samples, none going back", flush=True)
            seconds = info["seconds"]
        finally:
            srv.stop()
        # the answers against A's and B's own generate() with each seed's z
        seeds = sorted({s for s, _, _, _ in log})
        want = {name: dict(zip(seeds, refs(opts32, c, [(one, k) for k in seeds])))
                for name, c in (("A", ckpt_a), ("B", ckpt_b))}
        worst_err, kinds = 0.0, {"A": 0, "B": 0}
        for seed, t_in, _, data in log:
            errs = {n: rel(answer(data), want[n][seed]) for n in want}
            kind = min(errs, key=errs.get)
            assert errs[kind] <= SERVE_TOL["float32"], (seed, errs)
            assert t_in < t_r1 or kind == "B", ("A's answer after the reload's 200", seed)
            kinds[kind] += 1
            worst_err = max(worst_err, errs[kind])
        control = min(rel(want["A"][k], want["B"][k]) for k in seeds)
        assert control > SERVE_TOL["float32"] and kinds["B"] > 0, (control, kinds)
        walls = {"without a reload": [t1 - t0 for _, t0, t1, _ in log if t1 <= t_r0],
                 "during the reload": [t1 - t0 for _, t0, t1, _ in log
                                       if t1 > t_r0 and t0 < t_r1]}
        print(f"reload fp32: answers A {kinds['A']}, B {kinds['B']}, each vs its engine's "
              f"generate() with the seed's z rel err <= {worst_err:.3e} (bound "
              f"{SERVE_TOL['float32']:g}); control, A's answer vs B's, >= {control:.3e}",
              flush=True)
        print(f"reload fp32: POST /admin/reload {wall:.3f} s wall: load {seconds['load']:.3f} "
              f"s (engine build, checkpoint read and copy to the card; alone: read "
              f"{t_read:.3f} s, copy of {nbytes / 2**20:.1f} MiB {t_copy:.3f} s), warm-up "
              f"{seconds['warm']:.3f} s ({smi})", flush=True)
        for name, w in walls.items():
            assert w, name
            print(f"reload fp32: one-chunk request wall {name}: p50 "
                  f"{1e3 * np.percentile(w, 50):.3f} ms, p95 {1e3 * np.percentile(w, 95):.3f} "
                  f"ms over {len(w)} requests ({smi})", flush=True)
        del want, log

        # memory: five reloads A, B, A, B, A on a server of B; each retired generation
        # must be collected and give its memory back
        srv = _InProcess(ckpt_b, opts32, "--warm_seconds", "1.0", token="phase-9")
        try:
            srv.post("/enhance?seed=1", one)
            gc.collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            pre = [weakref.ref(k) for k in K._padded.keys()]
            mems, gens, reload_s = [], [], []
            for i, c in enumerate([ckpt_a, ckpt_b] * 2 + [ckpt_a]):
                old = weakref.ref(srv.state["gen"][1])
                status, info, wall = srv.reload({"g_ckpt": str(c)})
                torch.cuda.synchronize()
                two = torch.cuda.memory_allocated()
                assert status == 200, info
                reload_s.append(wall)
                srv.post(f"/enhance?seed={i}", one)
                srv.retired()
                gc.collect()
                torch.cuda.synchronize()
                mems.append(torch.cuda.memory_allocated())
                gens.append(two - base)
                assert old() is None, f"reload {i}: the retired engine is still alive"
                G = srv.state["gen"][1].G
                live, n_enc = {id(p) for p in G.parameters()}, len(G.enc_blocks)
                # enc2-5 always on the tensor cores; enc1 only from 2^20 rows in fp32
                need = {id(b.conv.weight) for b in G.enc_blocks if b.conv.weight.shape[1] > 1}
                keys = list(K._padded.keys())
                own = [k for k in keys if id(k) in live]
                stray = [k for k in keys if id(k) not in live
                         and not any(r() is k for r in pre)]
                assert need <= {id(k) for k in own} and len(own) <= n_enc and not stray, (
                    i, len(own), len(stray))
                del G, keys, own, stray
            drift = [m - base for m in mems]
            print(f"reload memory: memory_allocated with one generation {base / 2**20:.1f} "
                  f"MiB; with two (the new one built, the old not yet retired) +"
                  f"{np.mean(gens) / 2**20:.1f} MiB (a generation); after each of 5 "
                  f"retirements and gc.collect() {[int(d) for d in drift]} B from the "
                  f"baseline (bound {reload_leak_probe.MEM_TOL / 2**20:g} MiB), the retired "
                  f"engines "
                  f"collected, the kernel's cache one entry per encoder layer of the live G; reloads "
                  f"{', '.join(f'{w:.3f}' for w in reload_s)} s ({smi})", flush=True)
            assert max(abs(d) for d in drift) <= reload_leak_probe.MEM_TOL, drift
            assert max(mems) - min(mems) <= reload_leak_probe.MEM_TOL, mems
        finally:
            srv.stop()

        # 9b: bf16 A -> B, then SEGAN+ -> WSEGAN by its cfg_file
        srv = _InProcess(ckpt_a, opts16, "--warm_seconds", "1.0", token="phase-9")
        try:
            bodies = [_wav_body(n, SEED + 140 + i) for i, n in enumerate((16000, 40000))]
            passes.clear()
            before = _counters(K)
            status, info, wall16 = srv.reload({"g_ckpt": str(ckpt_b)})
            assert status == 200, info
            got16 = [srv.post(f"/enhance?seed={500 + i}", b)[0]
                     for i, b in enumerate(bodies)]
            totals += _expect_launches(K, before, passes, False, False)
            n16 = len(passes)
            passes.clear()
            before = _counters(K)
            status, info, wall_w = srv.reload({"g_ckpt": str(ckpt_w), "cfg_file": str(opts_w)})
            assert status == 200, info
            model = json.loads(_request(srv.base + "/healthz")[0])["model"]
            assert model == "WSEGAN", model
            ws_lengths = (20000, 33000, 5000)
            ws_bodies = [_wav_body(n, SEED + 150 + i) for i, n in enumerate(ws_lengths)]
            got_w = [None] * 3
            _in_threads([lambda i=i: got_w.__setitem__(i, srv.post(
                f"/enhance?seed={600 + i}", ws_bodies[i])[0]) for i in range(3)])
            got = _expect_launches(K, before, passes, True, True)
            totals += got
            nw = len(passes)
        finally:
            srv.stop()
        want16 = refs(opts16, ckpt_b, [(b, 500 + i) for i, b in enumerate(bodies)])
        ctrl16 = refs(opts16, ckpt_a, [(b, 500 + i) for i, b in enumerate(bodies)])
        e16 = max(rel(answer(g), w) for g, w in zip(got16, want16))
        c16 = min(rel(answer(g), w) for g, w in zip(got16, ctrl16))
        print(f"reload bf16 A -> B in {wall16:.3f} s: 2 requests vs B's generate() rel err "
              f"{e16:.3e} (bound {SERVE_TOL['bfloat16']:g}), vs A's (control) {c16:.3e}; "
              f"{n16} G forwards, 5 launches each", flush=True)
        assert e16 <= SERVE_TOL["bfloat16"] < c16, (e16, c16)
        pads = [n + 1024 - n % 1024 for n in ws_lengths]
        want_w = refs(opts_w, ckpt_w, [(b, 600 + i) for i, b in enumerate(ws_bodies)], pads)
        ew = max(rel(answer(g), w) for g, w in zip(got_w, want_w))
        print(f"reload SEGAN+ bf16 -> WSEGAN fp32 by its cfg_file in {wall_w:.3f} s: "
              f"/healthz model WSEGAN; 3 concurrent requests vs generate_batch rel err "
              f"{ew:.3e} (bound {SERVE_TOL['float32']:g}); {nw} G forwards, launches "
              f"{tuple(int(v) for v in got)}", flush=True)
        assert ew <= SERVE_TOL["float32"], ew

        # 9c: the reload probe on the card (module level, no HTTP): three generations
        # built beside a kept one, exercised, closed and dropped
        report = reload_leak_probe.probe(str(ckpt_a), str(opts32), "cuda", iters=3,
                                         warm_seconds=0.5)
    finally:
        SEGAN.infer_G = infer
        unrecord()
        serve.RETIRE_SECONDS = retire
    rows, base = report["rows"], report["baseline"]
    col = {k: [round(r[k], 3) if isinstance(r[k], float) else r[k] for r in rows]
           for k in ("generation_bytes", "rss_kb", "load_s", "warm_s")}
    print(f"reload probe (python -m segan_pytorch_tpu_torch.tools.reload_leak_probe) on the "
          f"card: verdict {report['verdict']}; baseline {base}; after each generation "
          f"memory_allocated - baseline "
          f"{[r['memory_allocated'] - base['memory_allocated'] for r in rows]} B; "
          + "; ".join(f"{k} {v}" for k, v in col.items()) + f" ({smi})", flush=True)
    assert all(report["verdict"].values()), report["verdict"]

    # 9d: the kernel against its plain version at every layer shape the phase ran
    # (warm-ups, served passes, the references, the probe) that 8a did not hold
    ran = {c[:7] for c in calls}
    new = ran - checked
    print(f"reload: the kernel ran at {len(ran)} layer shapes in phase 9 ("
          f"{len(ran & checked)} held in 8a); the other {len(new)}, in fp32 and bf16:",
          flush=True)
    if new:
        _hold_kernel(new, SEED + 160)
    ws = "not installed"
    if importlib.util.find_spec("websockets") is not None:
        import websockets

        ws = websockets.__version__
    print(f"reload: TLS, mutual TLS and the WebSocket listener are host code (the ssl module"
          f" and the websockets package, here {ws}); the CPU tests "
          f"tests/test_torch_serve_reload.py and tests/test_torch_serve_ws.py hold them, "
          f"and this phase does not check them (phase 15g does)", flush=True)
    return tuple(int(v) for v in totals), float(np.mean(gens)), checked | new


# ---- phase 10: the step on a CUDA graph, and the profile -------------------------------
# 10a's bound, relative: each sub-step's losses, Genh, and all together the changes a call
# made to the parameters, the buffers (BatchNorm's statistics, spectral norm's u and v)
# and the optimizers' state, graph against eager steps, both under cudnn.deterministic
# (cuDNN's default algorithms sum in no fixed order: two eager engines of one state then
# read ~1e-2 apart in their losses after 4 SEGAN+ steps and ~0.2 in the parameters'
# changes, the step being ill-conditioned; printed as the phase runs). The Adam engines'
# eager twin steps with capturable optimizers too: Adam's capturable step takes its bias
# correction on the card, in other roundings than the host's (also printed). On an H100 at
# 700 W every reading was 0 (equal bit for bit), the controls (sub-steps 2 and 3 swapped)
# >= 4.7e-5 (AEWSEGAN's optimizer state; the losses >= 8.8e-4); the bound sits between.
GRAPH_TOL = 1e-6
# (label, engine, batch, dtype, flags): SEGAN+ as the script trains it, WSEGAN with its
# script's flags and batch, AEWSEGAN at the same batch
GRAPH_CASES = [
    ("SEGAN+ fp32", "segan", 300, "float32", dict(no_bias=True)),
    ("SEGAN+ bf16", "segan", 300, "bfloat16", dict(no_bias=True)),
    ("WSEGAN fp32", "wsegan", 150, "float32", WSEGAN_FLAGS),
    ("AEWSEGAN fp32", "aewsegan", 150, "float32", dict(aewsegan=True, opt="adam")),
]
GRAPH_PER_STEP = {"segan": 5, "wsegan": WS_PER_STEP, "aewsegan": 5}
KERNEL_RE = re.compile(r"\bconv1d_(mma|tf32|prelu|wgmma|wgmma_tf32)_kernel\b")
WGMMA_RE = re.compile(r"\bconv1d_wgmma(_tf32)?_kernel\b")


def _graph_engines(kind, cfg, seed, n):
    """`n` engines of one state on the card: the same weights and seed, so the same
    streams of draws."""
    import copy
    from segan_pytorch_tpu_torch.models.segan import SEGAN
    from segan_pytorch_tpu_torch.models.wsegan import AEWSEGAN, WSEGAN

    G, D = (_wsegan_models if kind == "wsegan" else _train_models)(cfg, seed)
    out = []
    for _ in range(n):
        if kind == "aewsegan":
            eng = AEWSEGAN(cfg, generator=copy.deepcopy(G), device="cuda")
        else:
            cls = WSEGAN if kind == "wsegan" else SEGAN
            eng = cls(cfg, generator=copy.deepcopy(G), discriminator=copy.deepcopy(D),
                      device="cuda")
        eng.init_train()
        out.append(eng)
    return out


def _engine_state(eng):
    """Clones of an engine's parameters, buffers and optimizer state, by name."""
    import torch

    out = {}
    for side, opt in (("G", eng.g_opt), ("D", eng.d_opt)):
        m = getattr(eng, side)
        if m is None:
            continue
        for n, t in list(m.named_parameters()) + list(m.named_buffers()):
            out[f"{side}.{n}"] = t.detach().clone()
        names = {id(p): n for n, p in m.named_parameters()}
        for p, st in opt.state.items():
            for k, v in st.items():
                if torch.is_tensor(v):
                    out[f"{side}.{names[id(p)]}.{k}"] = v.detach().to("cuda").clone()
    return out


def _noise_only(name: str) -> bool:
    """D's conv biases that feed a BatchNorm (true gradient 0: RMSprop turns their rounding
    noise into steps of ~10 lr), their optimizer state and the running means that take
    them in."""
    return name.startswith(tuple(f"D.enc_blocks.{i}.conv.bias" for i in range(5))
                           + tuple(f"D.enc_blocks.{i}.norm.running_mean" for i in range(5)))


def _graph_errs(got_losses, want_losses, got, want, before, batchnorm=True):
    """(max relative error of the losses, {category: relative L2 of the changes since
    `before`, all tensors of it together}, worst tensor by its own relative error); with
    `batchnorm` (SEGAN+'s D) the tensors of ``_noise_only`` are only checked finite."""
    import torch

    loss = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
               for g, w in zip(got_losses, want_losses) for k in w)
    num, den, worst = {}, {}, (0.0, "")
    for k, w in want.items():
        if batchnorm and _noise_only(k):
            assert torch.isfinite(got[k].float()).all(), k
            continue
        cat = ("optimizer" if k.rsplit(".", 1)[-1] in (
            "step", "square_avg", "exp_avg", "exp_avg_sq") else
               "buffers" if k.endswith(("running_mean", "running_var", "num_batches_tracked",
                                        "weight_u", "weight_v")) else "parameters")
        b = before[k].double() if k in before else 0.0  # optimizer state: made lazily
        dw, dg = w.double() - b, got[k].double() - b
        d2, w2 = float((dg - dw).norm()) ** 2, float(dw.norm()) ** 2
        num[cat] = num.get(cat, 0.0) + d2
        den[cat] = den.get(cat, 0.0) + w2
        e = (d2 ** 0.5) / max(w2 ** 0.5, 1e-30) if d2 > 0 else 0.0
        worst = max(worst, (e, k))
    return loss, {c: (num[c] / max(den[c], 1e-60)) ** 0.5 for c in num}, worst


def _losses(metrics_s):
    """train_step_multi's (S,) metrics as one dict of floats per sub-step."""
    rows = {k: v.double().cpu().tolist() for k, v in metrics_s.items()}
    return [dict(zip(rows, vals)) for vals in zip(*rows.values())]


def _profiled_replay(call, want):
    """The device kernels of `call` (a graphed call that only replays) under
    torch.profiler, synchronised before and after so that the window holds this call
    alone. CUPTI may drop records of a graph's kernel nodes (one session counted 3 of a
    SEGAN+ replay's 5, phase 10) but never invents one: while fewer than `want` of the
    kernel's launches show, the call is profiled again, three sessions at most. Returns
    (the device kernels' names of the last session, the kernel's count in each)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        counts.append(sum(1 for n in names if KERNEL_RE.search(n)))
        if counts[-1] >= want:
            break
    return names, counts


def _graph_inputs(kind, B, T, S):
    """S seeded batches of B rows for a graphed call, stacked on the card (the third
    ragged; WSEGAN's every second row 'additive'), and their L1 weights."""
    import torch

    cleans, noisies = zip(*(_train_batch(B, T, SEED + 171 + i) for i in range(S)))
    masks = torch.ones((S, B))
    masks[2, -1] = 0.0  # a ragged batch among them
    stacked = [torch.stack(cleans).cuda(), torch.stack(noisies).cuda(), masks.cuda()]
    if kind == "wsegan":
        stacked.append((torch.arange(B) % 2).float().expand(S, B).contiguous().cuda())
    l1s = [100.0 - 0.1 * i for i in range(S)] if kind == "segan" else [100.0] * S
    return stacked, l1s


class _CollectiveCount:
    """Counts torch.distributed.all_reduce calls while it is open (the port's
    ``parallel/sharding.py`` issues every collective of the step through it), apart by
    whether the current stream was capturing a CUDA graph."""

    def __enter__(self):
        import torch
        import torch.distributed as dist

        self.captured = self.eager = 0
        self._dist, self._orig = dist, dist.all_reduce

        def counted(*args, **kwargs):
            if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
                self.captured += 1
            else:
                self.eager += 1
            return self._orig(*args, **kwargs)

        dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        self._dist.all_reduce = self._orig
        return False

    def take(self):
        """(captured, eager) since the last take."""
        out = (self.captured, self.eager)
        self.captured = self.eager = 0
        return out


def _graph_vs_eager(label, kind, cfg, S, seed, smi, n_engines=2, exact=False,
                    between=None):
    """One case of phases 10 and 14a, under cudnn.deterministic (the caller's): engines of
    one state (``_graph_engines``) A (graphed) and E (eager, its Adam capturable as A's),
    and `n_engines` - 2 more for the caller. One ``train_step_multi`` call of S sub-steps
    on A against S ``train_step`` calls on E: losses, Genh and every parameter, buffer
    and optimizer change, within GRAPH_TOL (`exact`: bit for bit, every tensor held);
    2 x GRAPH_PER_STEP kernel launches in the first call (warm-up sub-step and capture),
    each on the route _route picks (bf16 on wgmma where the rule says, read from the
    counters and from the replay's device kernels). Then on A a call that only replays, under
    sync debug mode "error", with no counter moved, and one profiled
    (``_profiled_replay``): the kernel GRAPH_PER_STEP times; `between(A, E, stacked)`, if
    given, runs before that call (A and E still in step). In a process group (the
    engines' grid) the all-reduces that the capture recorded equal those of the warm-up
    sub-step and of each eager step, and are more than none. Prints one line, then
    checks; returns what the caller reads further."""
    import torch
    from segan_pytorch_tpu_torch.models import multistep
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K

    t0 = time.perf_counter()
    stacked, l1s = _graph_inputs(kind, cfg.batch_size, cfg.slice_size, S)
    engines = _graph_engines(kind, cfg, seed, n_engines)
    A, E = engines[:2]
    grouped = A.grid is not None
    adam = kind != "segan"
    if adam:
        for opt in E._optimizers():
            multistep.set_capturable(opt, True)
    before = _engine_state(E)
    with _CollectiveCount() as coll:
        K.launches = K.launches_mma = K.launches_tf32 = K.launches_wgmma = K.launches_rows = 0
        with _logged_launches() as log:
            ms, _, genh, _ = A.train_step_multi(*stacked, l1_w_s=l1s)
        first_call, routes, want = K.launches, _counters(K), _want_counts(K, log)
        captured, warm = coll.take()
        eager, peak = [], 0
        for i in range(S):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            m, g, _ = E.train_step(*[t[i] for t in stacked], l1s[i])
            eager.append({k: float(v) for k, v in m.items()})
            peak = max(peak, torch.cuda.max_memory_allocated() - held)
        per_step = coll.take()[1]
    got, after = _engine_state(A), _engine_state(E)
    loss_err, state_err, worst = _graph_errs(_losses(ms), eager, got, after, before,
                                             batchnorm=kind == "segan" and not exact)
    genh_err = rel_err(genh, g)
    n_equal = sum(torch.equal(got[k], after[k]) for k in after)
    same_genh = torch.equal(genh, g)
    if between is not None:
        between(A, E, stacked)
    # a call that only replays: nothing on the host waits, nothing runs eagerly
    one = [t[:1] for t in stacked]
    K.launches = K.launches_mma = K.launches_tf32 = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        A.train_step_multi(*one, l1_w_s=l1s[:1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    device, counts = _profiled_replay(lambda: A.train_step_multi(*one, l1_w_s=l1s[:1]),
                                      GRAPH_PER_STEP[kind])
    replay_counter = K.launches
    replay_wgmma = sum(1 for n in device if WGMMA_RE.search(n))
    collectives = {}
    for n in device:
        if "nccl" in n.lower():
            collectives[n] = collectives.get(n, 0) + 1
    print(f"{label} B={cfg.batch_size}, cudnn.deterministic: {S} graphed sub-steps vs {S} "
          f"{'grouped ' if grouped else ''}train_step calls"
          f"{' (capturable Adam)' if adam else ''}: losses {loss_err:.3g}, Genh "
          f"{genh_err:.3g}, changes " + ", ".join(f"{k} {v:.3g}" for k, v in
                                                 state_err.items())
          + f" (worst tensor {worst[1]} {worst[0]:.3g}); {n_equal} of {len(after)} state "
          f"tensors equal bit for bit; kernel launches in the first call {first_call} "
          f"(warm-up step and capture; {routes[3]} on wgmma); a replay: fused_conv1d_prelu "
          f"{counts[-1]} times, {replay_wgmma} of them wgmma (profiler device events; "
          f"sessions {counts}), counter {replay_counter}, no host sync"
          + (f"; all-reduces recorded by the capture {captured}, issued by the warm-up "
             f"sub-step {warm}, by each eager step {per_step / S:g}; collective kernels a "
             f"replay ran: {sum(collectives.values())} {collectives}" if grouped else "")
          + f"; graph pool {A._multi.pool_bytes / 2**30:.2f} GiB, eager step peak "
          f"{peak / 2**30:.2f} GiB; {time.perf_counter() - t0:.1f} s ({smi})", flush=True)
    if exact:
        assert loss_err == 0 and same_genh and n_equal == len(after), (
            loss_err, same_genh, state_err, worst)
    else:
        assert max(loss_err, genh_err, *state_err.values()) <= GRAPH_TOL, (
            loss_err, genh_err, state_err)
    assert first_call == 2 * GRAPH_PER_STEP[kind], first_call
    assert routes == want and (cfg.compute_dtype == "float32" or routes[2] == 0), (
        routes, want)
    assert replay_wgmma == routes[3] // 2 and routes[3] > 0, (replay_wgmma, routes)
    assert counts[-1] == GRAPH_PER_STEP[kind] >= max(counts) and replay_counter == 0, (
        counts, replay_counter)
    if grouped:
        assert captured == warm == per_step / S > 0, (captured, warm, per_step)
    else:
        assert captured == warm == per_step == 0, (captured, warm, per_step)
    return dict(engines=engines, stacked=stacked, l1s=l1s, eager=eager, before=before,
                after=after, launches=counts[-1], counts=counts, all_reduces=captured)


def _g_check(eng, x, z):
    """An eager G forward through the kernel (evaluate's path) against a CPU copy of G on
    the same weights (plain ops): the relative error, which must be within phase 4's."""
    import copy
    import torch

    got = eng.infer_G(x, z).cpu()
    G = copy.deepcopy(eng.G).cpu().eval()
    with torch.no_grad():
        want = G(torch.from_numpy(x), torch.from_numpy(z))
    return rel_err(got, want)


def _cache_trap():
    """The kernel captured while its weight cache holds an entry at the weight's version:
    consulted during capture (the control) a replay after an in-place update of the weight
    runs the weights of capture time; recorded (the port), it runs the new ones. Returns
    (the port's error, the control's) against the plain version."""
    import torch
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K

    gen = torch.Generator().manual_seed(SEED + 180)
    x = torch.randn(8, 256, 4 * 63 + 31, generator=gen).cuda()
    a = torch.rand(512, generator=gen).cuda() * 0.3
    errs = []
    for consult in (False, True):
        w = torch.nn.Parameter((torch.randn(512, 256, 31, generator=gen) * 0.02).cuda())
        K.fused_conv1d_prelu(x, w, None, a)  # an entry at w's version
        capturing = K._capturing
        if consult:
            K._capturing = lambda: False
        try:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                y, _ = K.fused_conv1d_prelu(x, w, None, a)
        finally:
            K._capturing = capturing
        with torch.no_grad():
            w.mul_(-0.5)
        graph.replay()
        want, _ = K.conv1d_prelu_plain(x, w.detach(), None, a, 4)
        errs.append(rel_err(y, want))
        del graph
    return tuple(errs)


def phase_graph(work: Path, smi: str, train_rates: dict):
    """10: the train step as a CUDA graph (train_step_multi) and --profile on the card.
    The bench entry's rates at batch 300 and one step per call are 5c's runs
    (`train_rates`). Returns the kernel's launches per replay of each case's step
    (profiler events)."""
    import gc
    import torch
    from segan_pytorch_tpu_torch import bench
    from segan_pytorch_tpu_torch.models import multistep
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.utils.config import SEGANConfig

    t_phase = time.perf_counter()
    S = 4
    replay_launches = {}
    for label, kind, B, dtype, flags in GRAPH_CASES:
        t0 = time.perf_counter()
        cfg = SEGANConfig(batch_size=B, compute_dtype=dtype, no_train_gen=True, **flags)
        T = cfg.slice_size
        stacked, l1s = _graph_inputs(kind, B, T, S)
        bn = kind == "segan"
        adam = kind != "segan"

        def eager_steps(eng, xs, ls):
            return [{k: float(v) for k, v in eng.train_step(
                *[s[i] for s in xs], ls[i])[0].items()} for i in range(len(ls))]

        def stale_check(A, E, stacked):
            """10b: no stale padded weight: an eager G forward after each graphed call,
            and an eager step (a ragged tail) between two graphed calls, all against the
            eager engine."""
            rng = np.random.RandomState(SEED + 175)
            xg = (rng.randn(4, T, 1) * 0.3).astype(np.float32)
            zg = rng.randn(4, T // 1024, 1024).astype(np.float32)
            g_errs = [_g_check(A, xg, zg)]
            two = [s[:2] for s in stacked]
            A.train_step_multi(*two, l1_w_s=[99.0, 98.9])
            eager_steps(E, two, [99.0, 98.9])
            g_errs.append(_g_check(A, xg, zg))
            tail = [s[2] for s in stacked]
            ma, _, _ = A.train_step(*tail, 98.8)
            me, _, _ = E.train_step(*tail, 98.8)
            before_b = _engine_state(E)
            other = [s[[3, 0]] for s in stacked]
            ms3, _, _, _ = A.train_step_multi(*other, l1_w_s=[98.7, 98.6])
            eager3 = eager_steps(E, other, [98.7, 98.6])
            tail_err = max(abs(float(ma[k]) - float(me[k])) / max(abs(float(me[k])), 1e-12)
                           for k in me)
            l3, s3, _ = _graph_errs(_losses(ms3), eager3, _engine_state(A),
                                    _engine_state(E), before_b)
            print(f"graph {label}: eager G forward after graphed calls vs a CPU copy of G "
                  f"(plain ops): " + ", ".join(f"{v:.3g}" for v in g_errs)
                  + f" (bound {SLICE_TOL}); an eager step between graphed calls: losses "
                  f"{tail_err:.3g}; the next graphed call: losses {l3:.3g}, changes "
                  + ", ".join(f"{k} {v:.3g}" for k, v in s3.items()), flush=True)
            assert all(e <= SLICE_TOL for e in g_errs), g_errs
            assert max(tail_err, l3, *s3.values()) <= GRAPH_TOL, (tail_err, l3, s3)

        if label == "SEGAN+ fp32":
            # cuDNN's default algorithms: the graph against eager steps, beside two eager
            # engines against each other (printed, no bound: the card's own noise)
            A, E, E2 = _graph_engines(kind, cfg, SEED + 170, 3)
            before = _engine_state(E)
            ms, _, _, _ = A.train_step_multi(*stacked, l1_w_s=l1s)
            eager, twin = eager_steps(E, stacked, l1s), eager_steps(E2, stacked, l1s)
            ga = _graph_errs(_losses(ms), eager, _engine_state(A), _engine_state(E), before)
            ee = _graph_errs(twin, eager, _engine_state(E2), _engine_state(E), before)
            print(f"graph {label} B={B}, cuDNN's default algorithms: graph vs eager losses "
                  f"{ga[0]:.3g}, changes " + ", ".join(f"{k} {v:.3g}" for k, v in
                                                      ga[1].items())
                  + f"; eager vs eager losses {ee[0]:.3g}, changes " + ", ".join(
                      f"{k} {v:.3g}" for k, v in ee[1].items()) + f" ({smi})", flush=True)
            A.release_multi_step()
            del A, E, E2
            gc.collect()
            torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic = True
        try:
            # 10a, 10b (between) and 10c: the graph against eager steps, no stale
            # padded weight, a call that only replays
            case = _graph_vs_eager(f"graph {label}", kind, cfg, S, SEED + 170, smi,
                                   n_engines=3, between=stale_check if label ==
                                   "SEGAN+ fp32" else None)
            A, E, C = case["engines"]
            eager, before, e4 = case["eager"], case["before"], case["after"]
            replay_launches[label] = case["launches"]
            del case
            if adam:  # the same steps with Adam's host-side bias correction
                (P,) = _graph_engines(kind, cfg, SEED + 170, 1)
                plain = eager_steps(P, stacked, l1s)
                pa = _graph_errs(plain, eager, _engine_state(P), e4, before, bn)
                print(f"graph {label}: eager steps with Adam's usual (host) step vs its "
                      f"capturable one: losses {pa[0]:.3g}, changes " + ", ".join(
                          f"{k} {v:.3g}" for k, v in pa[1].items()), flush=True)
                del P
            A.release_multi_step()
            del A
            gc.collect()
            # the control: the graph with sub-steps 2 and 3 swapped breaks the bound
            swapped = [s[[0, 2, 1, 3]] for s in stacked]
            msc, _, _, _ = C.train_step_multi(*swapped, l1_w_s=l1s)
            c_loss, c_state, _ = _graph_errs(_losses(msc), eager, _engine_state(C), e4,
                                             before, bn)
            C.release_multi_step()
        finally:
            torch.backends.cudnn.deterministic = False
        print(f"graph {label}: the control (sub-steps 2 and 3 swapped): losses "
              f"{c_loss:.3g}, changes " + ", ".join(f"{k} {v:.3g}" for k, v in
                                                   c_state.items())
              + f"; {time.perf_counter() - t0:.1f} s", flush=True)
        assert min(c_loss, *c_state.values()) > GRAPH_TOL, (c_loss, c_state)
        del C, E
        gc.collect()
        torch.cuda.empty_cache()
    # 10b's controls. The kernel's cache consulted during capture (an entry current at
    # the weight's version then feeds every replay the weights of capture time; the
    # engine never captures with one current, as its warm-up step's update comes
    # between). And the engine with both guards off, the wrapper as it was: the in-place
    # ops recorded at capture bump each weight's version once, so the first eager forward
    # after a graphed call misses the cache and stores an entry at that version, which
    # the next call's replays leave stale. At B = 16.
    port_err, trap_err = _cache_trap()
    cfg = SEGANConfig(batch_size=16, no_bias=True, no_train_gen=True)
    (A,) = _graph_engines("segan", cfg, SEED + 176, 1)
    clean, noisy = (v.cuda().expand((S,) + v.shape) for v in
                    _train_batch(16, cfg.slice_size, SEED + 177))
    rng = np.random.RandomState(SEED + 178)
    xg = (rng.randn(4, cfg.slice_size, 1) * 0.3).astype(np.float32)
    zg = rng.randn(4, 16, 1024).astype(np.float32)
    capturing, written = K._capturing, multistep.mark_written
    K._capturing, multistep.mark_written = (lambda: False), (lambda tensors: None)
    stale = []
    try:
        for _ in range(2):
            A.train_step_multi(clean, noisy, None, l1_w_s=[100.0] * S)
            stale.append(_g_check(A, xg, zg))
    finally:
        K._capturing, multistep.mark_written = capturing, written
    print(f"graph: a kernel captured with a current cache entry, replayed after its weight "
          f"changed: {port_err:.3g} against the plain version (the cache consulted during "
          f"capture: {trap_err:.3g}); the engine with both guards off, an eager G forward "
          f"after each of two graphed calls: " + ", ".join(f"{v:.3g}" for v in stale)
          + f" against its CPU copy (bound {SLICE_TOL})", flush=True)
    assert port_err <= FP32_TOL < trap_err, (port_err, trap_err)
    assert stale[1] > SLICE_TOL, stale
    A.release_multi_step()
    del A
    gc.collect()
    torch.cuda.empty_cache()

    # step_flops and rates: bench at S = 4 and S = 1, MFU from its JSON line
    seg = _graph_engines("segan", SEGANConfig(batch_size=300, no_bias=True), SEED, 1)[0]
    t0 = time.perf_counter()
    flops = seg.step_flops()
    flops_s = time.perf_counter() - t0
    del seg
    print(f"graph: step_flops() of SEGAN+ at batch 300: {flops} ({flops / 300 / 1e9:.3f} "
          f"GFLOP a slice), counted in {flops_s:.2f} s", flush=True)
    rates = {(300, dt, 1): [train_rates[f"bench {dt} run"]] for dt in ("bfloat16",
                                                                        "float32")}
    runs = [(300, "bfloat16", 4), (300, "float32", 4)] + [
        (16, dt, s) for dt in ("bfloat16", "float32") for s in (1, 4)]
    for B, dtype, s in runs:
        n = 1 if s > 1 else 4
        if B == 16:
            n *= 5
        res = bench.main(["--batch_size", str(B), "--compute_dtype", dtype,
                          "--steps_per_call", str(s), "--steps", str(n), "--warmup", "1"])
        rates.setdefault((B, dtype, s), []).append(res)
        gc.collect()
        torch.cuda.empty_cache()
    for B, dtype, s in sorted(rates):
        vals = [r["value"] for r in rates[(B, dtype, s)]]
        mfus = [r.get("mfu") for r in rates[(B, dtype, s)]]
        print(f"graph: bench B={B} {dtype} steps_per_call {s}: {vals} slices/s, mfu "
              f"{mfus} ({smi})", flush=True)
        assert all(m is not None and m > 0 for m in mfus), mfus
    # 10d: the loop with --steps_per_call 4 against single steps, and --profile
    _graph_loops(work)
    print(f"graph: phase 10 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return replay_launches


def _graph_loops(work: Path):
    """10d: `train.main` at batch 64 on 9 x 20 s synthetic pairs (342 slices: six batches,
    the last of 22) for two epochs, with --steps_per_call 4 and with 1: the same iterations
    logged at the same batches, the same checkpoint names; then --profile at batch 32 for
    one epoch of 11 batches: the trace, the two [profile] lines, the MFU in the log."""
    from segan_pytorch_tpu_torch import train as train_cli

    dirs = _write_corpus(work / "corpus", 9, 20.0, SEED + 179)
    base = ["--clean_trainset", dirs[0], "--noisy_trainset", dirs[1], "--cache_dir",
            str(work / "cache"), "--no_bias", "--save_freq", "1", "--no_train_gen",
            "--seed", str(SEED), "--device", "cuda"]
    out = {}
    for name, extra in (("s1", ["--epoch", "2", "--batch_size", "64"]),
                        ("s4", ["--epoch", "2", "--batch_size", "64", "--steps_per_call",
                                "4"]),
                        ("profile", ["--epoch", "1", "--batch_size", "32", "--profile"])):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            seg = train_cli.main(["--save_path", str(work / name)] + base + extra)
        out[name] = (buf.getvalue(), seg.step, time.perf_counter() - t0)
        del seg
    logged = {k: [tuple(int(v) for v in m[:4]) for m in LOG_RE.findall(out[k][0])]
              for k in out}
    want4 = [(4, 4, 6, 1), (5, 5, 6, 1), (6, 6, 6, 1), (10, 4, 6, 2), (11, 5, 6, 2),
             (12, 6, 6, 2)]
    assert logged["s4"] == want4 and set(want4) <= set(logged["s1"]), logged
    assert out["s1"][1] == out["s4"][1] == 12, (out["s1"][1], out["s4"][1])
    for index in ("EOE_G-checkpoints", "EOE_D-checkpoints"):
        a, b = ((work / k / index).read_text() for k in ("s1", "s4"))
        assert json.loads(a) == json.loads(b), (a, b)
    text = out["profile"][0]
    traces = list((work / "profile" / "profile").glob("trace_*.json"))
    mfus = [float(v) for v in re.findall(r", mfu: ([\d.]+)%", text)]
    print(f"graph: train.main --steps_per_call 4 logged iterations {[m[0] for m in logged['s4']]}"
          f" (single steps: {[m[0] for m in logged['s1']]}), checkpoint indices equal; "
          f"{out['s4'][2]:.1f} s against {out['s1'][2]:.1f} s; --profile: "
          f"{[line for line in text.splitlines() if line.startswith('[profile]')]}, trace "
          f"{[p.name for p in traces]} ({sum(p.stat().st_size for p in traces)} bytes), "
          f"mfu at batch 32 {mfus} %", flush=True)
    assert traces and "[profile] device trace written to" in text and \
        "[profile] memory: {'cuda:0'" in text, text[-2000:]
    assert len(mfus) == 11 - 2 and all(m > 0 for m in mfus), mfus


# ---- phase 11: the data options on the card --------------------------------------------
DATA_OPTS = ["--random_scale", "0.5", "1", "2", "--preemph_norm", "--shuffle_buffer", "256",
             "--loader_dtype", "bfloat16", "--compute_dtype", "bfloat16"]


def _write_noises(root: Path, n_files: int, seconds: float, seed: int) -> str:
    """int16 16 kHz noise wavs, longer than a slice: white, a 50 Hz hum with hiss, and
    white noise under a 3 Hz envelope. Returns the directory."""
    from scipy.io import wavfile

    rng = np.random.RandomState(seed)
    root.mkdir(parents=True)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    kinds = [0.2 * rng.randn(n), 0.3 * np.sin(2 * np.pi * 50 * t) + 0.05 * rng.randn(n),
             0.3 * rng.randn(n) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))]
    for i in range(n_files):
        wavfile.write(str(root / f"noise{i}.wav"), SR,
                      np.clip(kinds[i % 3] * 32767, -32768, 32767).astype(np.int16))
    return str(root)


def _timed_run(argv, check_batch=None, engine=None, echo=()):
    """`train.main(argv)` on the card, timed by wrapping the engine's methods (phases 6
    and 11): the data wait per step (the time in the prefetch stream's next()), the batch
    loop's seconds (the first batch asked for to the first evaluate or checkpoint save,
    after a sync), the seconds in evaluate and in the saves, G forwards (infer_G), each
    train_step's arguments and the training loader that train() was given;
    `check_batch(batch)` sees every device batch. Prints the run's own lines (RUN_LINES
    and `echo`), without its train.opts dump. Returns a dict."""
    import torch
    from segan_pytorch_tpu_torch import train as train_cli
    from segan_pytorch_tpu_torch.data import loader as loader_mod
    from segan_pytorch_tpu_torch.models.segan import SEGAN

    cls = engine or SEGAN
    marks = dict(wait=[], forwards=0, steps=[], eval=0.0, save=0.0)
    prefetch = loader_mod.device_prefetch
    wrapped = {(SEGAN, "infer_G"), (SEGAN, "evaluate"), (SEGAN, "save"),
               (cls, "train_step"), (cls, "train")}
    saved = {(c, name): c.__dict__.get(name) for c, name in wrapped}
    infer, evaluate, save, step, train = (getattr(c, name) for c, name in (
        (SEGAN, "infer_G"), (SEGAN, "evaluate"), (SEGAN, "save"), (cls, "train_step"),
        (cls, "train")))

    def timed_prefetch(iterator, device, size=2):
        stream = prefetch(iterator, device, size)
        while True:
            start = time.perf_counter()
            marks.setdefault("loop_start", start)
            batch = next(stream, None)
            if batch is None:
                return
            marks["wait"].append(time.perf_counter() - start)
            if check_batch is not None:
                check_batch(batch)
            yield batch

    def counted_infer(self, *a, **k):
        marks["forwards"] += 1
        return infer(self, *a, **k)

    def timed(fn, key):
        def run(self, *a, **k):
            if "loop_end" not in marks:
                torch.cuda.synchronize()
                marks["loop_end"] = time.perf_counter()
            start = time.perf_counter()
            try:
                return fn(self, *a, **k)
            finally:
                marks[key] += time.perf_counter() - start
        return run

    def recorded_step(self, *a, **k):
        marks["steps"].append(a)
        return step(self, *a, **k)

    def recorded_train(self, cfg, dloader, *a, **k):
        marks["dloader"] = dloader
        return train(self, cfg, dloader, *a, **k)

    out = io.StringIO()
    loader_mod.device_prefetch = timed_prefetch
    SEGAN.infer_G, SEGAN.evaluate, SEGAN.save = (counted_infer, timed(evaluate, "eval"),
                                                 timed(save, "save"))
    cls.train_step, cls.train = recorded_step, recorded_train
    start = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            seg = train_cli.main(argv)
    finally:
        loader_mod.device_prefetch = prefetch
        for (c, name), fn in saved.items():
            if fn is None:
                delattr(c, name)
            else:
                setattr(c, name, fn)
        print("\n".join(line for line in out.getvalue().splitlines()
                        if line.startswith(RUN_LINES + tuple(echo))), flush=True)
    torch.cuda.synchronize()
    marks.update(wall=time.perf_counter() - start, out=out.getvalue(), step=seg.step,
                 loop=marks["loop_end"] - marks["loop_start"])
    del seg
    return marks


def _host_build(dloader, epochs, additive=False):
    """The host's cost of each batch, as the loop's next() pays it with no card work
    beside it: `epochs` epochs of `dloader` drawn back to back, each batch timed from
    the loader's next() to its device fields made contiguous and pinned (as
    `device_prefetch` does; with `additive`, WSEGAN's additive mask from the names first).
    Returns (seconds, rows that are not padding) of each batch."""
    from segan_pytorch_tpu_torch.data.loader import DEVICE_KEYS, _host_tensor
    from segan_pytorch_tpu_torch.models.wsegan import additive_mask

    times = []
    for _ in range(epochs):
        it = iter(dloader)
        while True:
            start = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                break
            if additive:
                batch["additive_mask"] = additive_mask(batch["uttname"])
            for k in DEVICE_KEYS:
                if k in batch:
                    _host_tensor(batch[k]).pin_memory()
            times.append((time.perf_counter() - start, int(batch["mask"].sum())))
    return times


def _h5_run(work: Path, train_dirs, base):
    """11b: the port's tools/make_h5.py writes train.h5 and valid.h5, then `train.main
    --h5` for one epoch with validation. Returns the kernel's launches in the run."""
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.tools import make_h5

    valid_dirs = _write_corpus(work / "h5_valid", 2, 4.0, SEED + 213)
    h5 = work / "h5"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        for split, dirs in (("train", train_dirs), ("valid", valid_dirs)):
            make_h5.main(["--clean_dir", dirs[0], "--noisy_dir", dirs[1], "--out_dir",
                          str(h5), "--split", split])
    made = time.perf_counter() - t0
    K.launches = K.launches_mma = K.launches_tf32 = 0
    run = _timed_run(base + ["--save_path", str(work / "h5_ck"), "--h5", "--h5_data_root",
                             str(h5), "--clean_valset", valid_dirs[0], "--noisy_valset",
                             valid_dirs[1], "--epoch", "1", "--save_freq", "50"])
    launches = K.launches
    logged = LOG_RE.findall(run["out"])
    assert logged and np.isfinite([[float(v) for v in m[4:]] for m in logged]).all(), logged
    assert "Time to process eval with 12 samples" in run["out"], run["out"][-2000:]
    assert launches == 5 * (run["step"] + run["forwards"]), (launches, run["step"])
    print(f"data options: --h5 ran {run['step']} steps and a validation pass on train.h5 / "
          f"valid.h5 (written in {made:.2f} s); {launches} launches", flush=True)
    return launches


def _graph_on_cast_batches(work: Path, base):
    """11a': (a)'s options with --steps_per_call 3 against single steps, both under
    cudnn.deterministic: the epoch's three bf16 batches go through one graphed call
    (the eager warm-up, the capture and a replay), each up-cast exactly on the card
    before the graph's fp32 static buffers take it. The same parameters, buffers and
    optimizer state as the single-step run, and the same logged losses."""
    import torch
    from segan_pytorch_tpu_torch import train as train_cli
    from segan_pytorch_tpu_torch.models.segan import SEGAN

    multi = SEGAN.train_step_multi
    calls = []

    def recorded(self, *stacked, **k):
        calls.append((stacked[0].dtype, len(k["l1_w_s"])))
        return multi(self, *stacked, **k)

    states, losses = {}, {}
    torch.backends.cudnn.deterministic = True
    SEGAN.train_step_multi = recorded
    try:
        for S in (1, 3):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                seg = train_cli.main(base + DATA_OPTS + [
                    "--save_path", str(work / f"graph_s{S}"), "--cache_dir",
                    str(work / "cache"), "--epoch", "1", "--save_freq", "1",
                    "--steps_per_call", str(S)])
            assert seg.step == 3, seg.step
            states[S] = _engine_state(seg)
            losses[S] = LOG_RE.findall(out.getvalue())[-1][4:]
            del seg
    finally:
        torch.backends.cudnn.deterministic = False
        SEGAN.train_step_multi = multi
    assert calls == [(torch.bfloat16, 3)], calls
    errs = {k: float((states[3][k].double() - v.double()).abs().max())
            / max(float(v.double().abs().max()), 1e-30) for k, v in states[1].items()}
    equal = sum(torch.equal(states[3][k], v) for k, v in states[1].items())
    worst_k = max(errs, key=errs.get)
    print(f"data options (a'): --steps_per_call 3 on (a)'s bf16 batches (one graphed call "
          f"of 3 sub-steps) against 3 single steps, cudnn.deterministic: {equal} of "
          f"{len(errs)} state tensors equal bit for bit, worst {worst_k} {errs[worst_k]:.3g} "
          f"(bound {GRAPH_TOL}); last logged losses {', '.join(losses[3])} against "
          f"{', '.join(losses[1])}", flush=True)
    assert losses[3] == losses[1] and errs[worst_k] <= GRAPH_TOL, (losses, worst_k,
                                                                   errs[worst_k])


def phase_data_options(work: Path, rates) -> dict:
    """11: train.main's data options on the card at full width. (a) SEGAN+ at batch 300
    with DATA_OPTS (random scaling, pre-emphasis before normalisation, a streaming
    shuffle of 256, bf16 batches into a bf16 step) for one epoch of 912 slices: every
    device batch bf16 and equal to the host batch's bytes, n // 300 steps, finite losses,
    the sample rows written, 5 launches per step and G forward; (a') the same with
    --steps_per_call 3 against single steps; (b) the H5 run, where h5py is installed;
    (c) WSEGAN with the script's flags at batch 150 on 12 of the files
    (456 slices at stride 0.5: four steps, the last ragged) with --noises_dir and
    --snr_levels 0 5 10: every row additive, the additive L1 term nonzero, 25 launches a
    step. Prints slices/s and data wait per step beside phase 6's, and the host's cost of
    a batch of (a) and of (c) over 12 batches drawn with no card work beside them.
    Returns the launches by run."""
    import importlib.util
    import torch
    from segan_pytorch_tpu_torch.data.wav_io import read_wav_raw
    from segan_pytorch_tpu_torch.models.wsegan import WSEGAN
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K

    t_phase = time.perf_counter()
    train_dirs = _write_corpus(work / "train", 24, 20.0, SEED + 211)
    noises = _write_noises(work / "noises", 3, 2.0, SEED + 212)
    base = ["--clean_trainset", train_dirs[0], "--noisy_trainset", train_dirs[1],
            "--no_bias", "--batch_size", "300", "--seed", str(SEED), "--device", "cuda"]
    checked = []

    def bf16_batch(batch):
        for k in ("clean", "noisy"):
            dev, host = batch[k], batch["host"][k]
            assert dev.is_cuda and dev.dtype == torch.bfloat16 and dev.element_size() == 2
            assert torch.equal(dev.cpu().view(torch.int16), host.view(torch.int16)), k
        assert batch["mask"].dtype == torch.float32 and bool((batch["mask"] == 1).all())
        checked.append(tuple(batch["clean"].shape))

    # (a) every option of the loader and the dataset at once
    save = work / "opts"
    K.launches = K.launches_mma = K.launches_tf32 = 0
    a = _timed_run(base + DATA_OPTS + ["--save_path", str(save), "--cache_dir",
                                       str(work / "cache"), "--epoch", "1", "--save_freq",
                                       "1"], bf16_batch)
    launches_a = K.launches
    n = len(json.loads((work / "cache" / "train_idx2slice.json").read_text()))
    steps = n // 300
    logged = LOG_RE.findall(a["out"])
    assert a["step"] == steps == 3 and checked == [(300, 16384)] * steps, (n, a["step"],
                                                                            checked)
    assert [(int(m[1]), int(m[2])) for m in logged] == [(i, steps) for i in (1, 2, 3)], logged
    assert np.isfinite([[float(v) for v in m[4:]] for m in logged]).all(), logged
    assert "[data] train: batches gathered in Python" in a["out"], a["out"][-2000:]
    assert all(st[0].dtype == torch.bfloat16 for st in a["steps"]), a["steps"][0][0].dtype
    assert launches_a == 5 * (a["step"] + a["forwards"]), (launches_a, a["forwards"])
    for m in range(20):  # the training samples, from the bf16 host rows made fp32
        _, y = read_wav_raw(str(save / f"sample_1-{m}.wav"))
        assert y.shape == (16384,) and np.isfinite(y).all(), m
    print(f"data options (a): {' '.join(DATA_OPTS)} at batch 300: {a['step']} steps of "
          f"{n} slices (n // 300, the tail of {n % 300} dropped), every device batch bf16 "
          f"(2 bytes a sample) and equal to its host batch; fused_conv1d_prelu launches "
          f"{launches_a} for {a['step']} steps and {a['forwards']} G forwards", flush=True)
    host_a = _host_build(a.pop("dloader"), 4)
    _graph_on_cast_batches(work, base)

    # (b) the H5 dataset, where h5py is there
    if importlib.util.find_spec("h5py") is None:
        launches_b = 0
        print("data options (b): h5py is not installed on this machine, so the --h5 run "
              "does not take place here; the CPU tests hold SEH5Dataset and "
              "tools/make_h5.py against the JAX package", flush=True)
    else:
        launches_b = _h5_run(work, train_dirs, base + ["--cache_dir", str(work / "hcache")])

    # (c) augmentation under WSEGAN: noisy made from clean with noise on the host
    K.launches = K.launches_mma = K.launches_tf32 = 0
    c = _timed_run(["--clean_trainset", train_dirs[0], "--noisy_trainset", train_dirs[1],
                    "--seed", str(SEED), "--device", "cuda", "--save_path",
                    str(work / "aug"), "--cache_dir", str(work / "acache"), "--epoch", "1",
                    "--save_freq", "1", "--max_samples", "12"] + WSEGAN_ARGS
                   + ["--data_stride", "0.5", "--noises_dir", noises, "--snr_levels", "0",
                      "5", "10"], engine=WSEGAN)
    launches_c = K.launches
    logged = WS_LOG_RE.findall(c["out"])
    assert c["step"] == 4 and [int(m[0]) for m in logged] == [1, 2, 3, 4], (c["step"], logged)
    losses = np.array([[float(v) for v in m[3:]] for m in logged])
    assert np.isfinite(losses).all() and (losses[:, 3] > 0).all(), losses
    assert all(bool((st[3] == 1).all()) for st in c["steps"]), [st[3] for st in c["steps"]]
    assert "[augment] additive noise from" in c["out"], c["out"][-2000:]
    assert launches_c == WS_PER_STEP * c["step"], launches_c
    print(f"data options (c): WSEGAN with --noises_dir (3 noise files, SNR 0 5 10 dB) at "
          f"batch 150: {c['step']} steps, every row additive, den_loss "
          + ", ".join(f"{v:.4f}" for v in losses[:, 3]) + f"; fused_conv1d_prelu launches "
          f"{launches_c}", flush=True)
    host_c = _host_build(c.pop("dloader"), 3, additive=True)

    for label, run, host, b, k in (("(a) SEGAN+ bf16, the options above", a, host_a, 300, 3),
                                   ("(c) WSEGAN fp32 + augmentation", c, host_c, 150, 4)):
        full = [t for t, rows in host if rows == b]
        per_slice = sum(t for t, _ in host) / sum(rows for _, rows in host)
        print(f"data options {label}: {b * k / run['loop']:.2f} slices/s over its {k} "
              f"steps (batch loop {run['loop']:.3f} s); data wait per step "
              + ", ".join(f"{1e3 * w:.2f}" for w in run["wait"])
              + f" ms (mean {1e3 * np.mean(run['wait']):.2f}: the first next() builds two "
              f"batches, the last builds none; a window this short is indicative only); "
              f"the host's build of a batch, {len(host)} drawn back to back with no card "
              f"work: " + ", ".join(f"{1e3 * t:.2f}" for t, _ in host) + f" ms (full "
              f"batches of {b}: mean {1e3 * np.mean(full):.2f}, min {1e3 * min(full):.2f}, "
              f"max {1e3 * max(full):.2f}; {1e3 * per_slice:.3f} ms a slice)", flush=True)
    print(f"data options beside phase 6 (SEGAN+ fp32, native gather, warm run): "
          f"{rates['run slices/s']:.2f} slices/s, data wait {rates['run wait ms']:.2f} ms "
          f"per step", flush=True)
    print("data options: resuming a JAX run directory (--resume on the JAX trainer's npz "
          "checkpoints) is held by the CPU tests alone (tests/test_torch_resume_jax.py): "
          "JAX does not run on this machine", flush=True)
    print(f"data options: phase 11 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(total=launches_a + launches_b + launches_c, segan=launches_a, h5=launches_b,
                wsegan=launches_c)


# ---- phase 12 (A7a): a bnorm G, D's SincConv front end and the other blocks -------------
SINC_FLAGS = dict(sinc_conv=True, dpool_slen=64)  # four D blocks leave 64 of 16384 samples
SINC_WS_PER_STEP = 5 + 4 * 4  # G's five blocks once, the sinc D's four in each of 4 passes
# the kernels line's names of `_hold_d_shapes`' timed arms
SUM_KEYS = (("ms", "kernel"), ("fma_ms", "fma"), ("plain_ms", "plain"),
            ("library_ms", "cuDNN"))
STATS_TOL = 1e-4  # G's running statistics after one fp32 step, card vs float64


def _report_steps(label, r, flops, batch, smi):
    """One line of `_time_steps`' readings, with the MFU of the step's `flops`
    (``step_flops()``, the same in either dtype)."""
    from segan_pytorch_tpu_torch.utils.profiling import mfu

    step_mfu = mfu(flops, r["ms"] / 1e3)
    print(f"{label}: {r['rate']:.2f} slices/s, median {r['ms']:.3f} ms/step; split "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in r["split"].items())
          + f"; peak device memory {r['peak']:.2f} GiB; step_flops {flops / 1e9:.3f} GFLOP"
          f" ({flops / batch / 1e9:.3f} a slice), MFU "
          + (f"{step_mfu:.2%}" if step_mfu is not None else "not known for this card")
          + f"; fused_conv1d_prelu launches (all, tensor cores, 3xTF32) {r['counts']}; "
          "last losses " + ", ".join(f"{k} {v:.4f}" for k, v in r["losses"].items())
          + f" ({smi})", flush=True)


def _vs_float64(cls, cfg, seed, passes, extra=(), cpu=False, B=4):
    """One full-width fp32 step at batch B (the last row masked) on the card against the step
    in float64 on the CPU, and again with D's learning rate 0 for the losses that go
    through D' (g_adv, WSEGAN's g_loss): (relative error of each loss and of Genh,
    {run: {buffer: relative L2 error}} of G's and D's buffers after the step, for the
    card's step, the CPU's fp32 one and the card's with D's learning rate 0, the card
    step's launches (all, 3xTF32), seconds of the card's step and of the float64 one).
    The CPU's fp32 step only runs with `cpu`."""
    import copy
    import dataclasses
    import torch
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K

    G, D = (_wsegan_models if cls.name == "WSEGAN" else _train_models)(cfg, seed)
    clean, noisy = _train_batch(B, cfg.slice_size, seed + 1)
    mask = torch.ones(B)
    mask[-1] = 0.0
    z = torch.randn((B, 16, cfg.z_dim), generator=torch.Generator().manual_seed(seed + 2))
    draws = dict(z=z, phase=D.sample_phase(torch.Generator().manual_seed(seed + 3),
                                           passes=passes))
    if cls.name == "WSEGAN":
        draws["perm"] = torch.roll(torch.arange(B), 1)

    def step(device, dtype=torch.float32, c=cfg):
        seg = cls(c, generator=copy.deepcopy(G), discriminator=copy.deepcopy(D),
                  device=device)
        seg.compute_dtype = dtype
        with torch.backends.mkldnn.flags(enabled=False):
            m, genh, _ = seg.train_step(clean, noisy, mask, *extra, 100.0, **draws)
        bufs = {f"{side}.{n}": b.cpu().double() for side in ("G", "D")
                for n, b in getattr(seg, side).named_buffers()
                if not n.endswith("num_batches_tracked")}
        return {k: float(v) for k, v in m.items()}, genh.cpu().double(), bufs

    before = (K.launches, K.launches_tf32)
    t0 = time.perf_counter()
    card = step("cuda")
    torch.cuda.synchronize()
    secs = [time.perf_counter() - t0]
    launched = (K.launches - before[0], K.launches_tf32 - before[1])
    t0 = time.perf_counter()
    ref = step("cpu", torch.float64)
    secs.append(time.perf_counter() - t0)
    frozen = dataclasses.replace(cfg, d_lr=0.0)
    card0, ref0 = step("cuda", c=frozen), step("cpu", torch.float64, frozen)
    through_d = ("g_adv", "g_loss")
    losses = {k: abs(card[0][k] - ref[0][k]) / abs(ref[0][k]) for k in ref[0]
              if k not in through_d}
    losses.update({k: abs(card0[0][k] - ref0[0][k]) / abs(ref0[0][k])
                   for k in ref0[0] if k in through_d}, Genh=rel_err(card[1], ref[1]))
    runs = {"card": (card, ref), "card d_lr 0": (card0, ref0)}
    if cpu:
        runs["CPU"] = (step("cpu"), ref)
    bufs = {name: {k: float((v - r[2][k]).norm() / r[2][k].norm()) for k, v in a[2].items()}
            for name, (a, r) in runs.items()}
    return losses, bufs, launched, secs


def _hold_shapes(label, shapes, B, S, bias, smi, seed, pad=None):
    """The per-layer kernel at `shapes` [(Cin, Cout, T_in, T_out)] of stride S at batch B
    (with a bias or none), x random in contiguous rows or, with `pad` = (left, right), a
    random h padded into pitched rows as Generator1D's blocks pad it (``ops/conv.py``
    ``zero_pad_pitched``), against its plain version in NaN-filled outputs: fp32 (TF32
    off, <= FP32_TOL) and bf16 (<= BF16_TOL), on the route ``_route`` picks for the shape
    and x's layout, read from the counters, and for a tensor-core route also on the FMA
    route forced; then timed in turns with the plain version and cuDNN's F.conv1d alone
    (a wrapper call each), and the route's kernel and the FMA kernel through their entry
    points, 10 launches back to back (device ms). Prints a row a shape and returns the
    rows' sums by dtype, with the route's device ms summed by route."""
    import torch
    import torch.nn.functional as F
    from segan_pytorch_tpu_torch.ops.conv import zero_pad_pitched
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.tools.encoder_fused_bench import ms_in_turns

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(seed)
    Kw = 31
    sums = {"fp32_": {}, "": {}}
    print(f"{label:>14} {'x shape':>19} {'Cout':>5} | {'fp32':>8} {'fp32 fma':>8} "
          f"{'bf16':>8} {'bf16 fma':>8} | fp32 {'route':>5} {'ms':>8} {'fma ms':>8} "
          f"{'plain':>8} {'cuDNN':>8} {'bound':>7} {'device':>7} {'fma dev':>7} | bf16 "
          f"{'route':>5} {'ms':>8} {'fma ms':>8} {'plain':>8} {'cuDNN':>8} {'bound':>7} "
          f"{'device':>7} {'fma dev':>7}")
    for i, (cin, cout, t_in, t_out) in enumerate(shapes):
        if pad is None:
            x = torch.randn((B, cin, t_in), generator=g).cuda()
        else:
            x = torch.randn((B, cin, t_in - sum(pad)), generator=g).cuda()
        w = (torch.randn((cout, cin, Kw), generator=g) / (cin * Kw) ** 0.5).cuda()
        b = (torch.randn((cout,), generator=g) * 0.1).cuda() if bias else None
        a = (torch.rand((cout,), generator=g) * 0.3).cuda()
        shape = (B, cout, t_out)
        flops = 2.0 * B * t_out * cout * cin * Kw
        elems = (B * cin * t_in + cout * cin * Kw + (2 if bias else 1) * cout
                 + 2 * B * cout * t_out)
        row = {}
        for p, dt, tol, peak in (("fp32_", torch.float32, FP32_TOL, None),
                                 ("", torch.bfloat16, BF16_TOL, BF16_PEAK)):
            h = [v.to(dt) if v is not None else None for v in (x, w, b, a)]
            if pad is not None:  # cast, then pad: the pitched rows of the dtype
                h[0] = zero_pad_pitched(h[0], *pad)
            assert h[0].shape[-1] == t_in, (label, i)
            route = K._route(dt, B, cin, cout, Kw, S, t_out, _pitched(K, h[0]))
            before = _counters(K)
            y, pre = K._launch(*h, S, t_out, out=nan_outputs(shape, shape, dtype=dt))
            y_ref, pre_ref = K.conv1d_prelu_plain(*h, S)
            torch.cuda.synchronize()
            took = _took(K, before)
            assert took == route and K.launches_tf32 - before[2] == (
                route != "fma" and dt == torch.float32), f"{label} {i + 1} {dt}: {took}"
            err = worst([rel_err(y, y_ref), rel_err(pre, pre_ref)])
            e_abs = worst([float((y - y_ref).abs().max()),
                           float((pre - pre_ref).abs().max())])
            err_f = err
            arms = {"kernel": lambda: K.fused_conv1d_prelu(*h, S)}
            if route != "fma":
                yf, pref = K._launch(*h, S, t_out, force="fma",
                                     out=nan_outputs(shape, shape, dtype=dt))
                torch.cuda.synchronize()
                err_f = worst([rel_err(yf, y_ref), rel_err(pref, pre_ref)])
                del yf, pref
                arms["fma"] = lambda: K._launch(*h, S, t_out, force="fma")
            assert max(err, err_f) <= tol, (label, i, dt, route, err, err_f)
            del y, pre, y_ref, pre_ref
            arms.update(plain=lambda: K.conv1d_prelu_plain(*h, S),
                        cuDNN=lambda: F.conv1d(h[0], h[1], h[2], stride=S))
            t = ms_in_turns(arms, reps=6)
            t.setdefault("fma", t["kernel"])  # an FMA shape: the kernel is that route
            outs = nan_outputs(shape, shape, dtype=dt)
            dev = {n: v[0] for n, v in _in_turns(
                {n: _entry_arm(K, n, *h, S, t_out, outs) for n in {route, "fma"}},
                reps=DEVICE_REPS, calls=10).items()}
            del outs
            bound = (min(bound_ms(flops, 4 * elems, FP32_PEAK),
                         bound_ms(3 * flops, 4 * elems, TF32_PEAK))
                     if peak is None else bound_ms(flops, 2 * elems, peak))
            row[p] = (err, err_f, route, t, bound, dev[route], dev["fma"])
            for k, v in [(k, t[arm]) for k, arm in SUM_KEYS] + [
                    ("bound_ms", bound), ("device_ms", dev[route]),
                    ("fma_device_ms", dev["fma"]), (f"{route}_device_ms", dev[route])]:
                sums[p][k] = sums[p].get(k, 0.0) + v
            sums[p][f"{route}_launches"] = sums[p].get(f"{route}_launches", 0) + 1
            sums[p]["max_abs_err"] = worst([sums[p].get("max_abs_err", 0.0), e_abs])
            del h
        cols = []
        for p in ("fp32_", ""):
            _, _, route, t, bound, d, df = row[p]
            cols.append(f"{route:>5} {t['kernel']:8.4f} {t['fma']:8.4f} {t['plain']:8.4f} "
                        f"{t['cuDNN']:8.4f} {bound:7.4f} {d:7.4f} {df:7.4f}")
        print(f"{label + ' ' + str(i + 1):>14} {str((B, cin, t_in)):>19} {cout:>5} | "
              f"{row['fp32_'][0]:8.1e} {row['fp32_'][1]:8.1e} {row[''][0]:8.1e} "
              f"{row[''][1]:8.1e} | fp32 {cols[0]} | bf16 {cols[1]}", flush=True)
        del x, w, b, a
    print(f"{label}s B={B}, sums over the {len(shapes)}: " + "; ".join(
        f"{p[:-1] or 'bf16'} " + ", ".join(f"{k} {v:.4g}" for k, v in c.items())
        for p, c in sums.items()) + f" ({smi})", flush=True)
    return sums


def _hold_plans(label, shapes, B, S, seed, pad, smi):
    """Every plan of the tensor-core routes at `shapes` [(Cin, Cout, T_in, T_out)] of
    stride S at batch B, x padded into pitched rows by `pad` as ``_hold_shapes`` pads it,
    no bias: where a route takes a shape, the wgmma kernel of each dtype at each of its
    block tiles and 1-16 split-K slices of at least 4 channels, and the mma.sync kernels
    at warps_m 1, 2, 4 and 8 and 1, 2 or 4 slices, each through its entry point into
    NaN-filled outputs against the plain version (FP32_TOL, BF16_TOL). Prints each
    route's plans and worst error by dtype."""
    import torch
    from segan_pytorch_tpu_torch.ops.conv import zero_pad_pitched
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K

    g = torch.Generator().manual_seed(seed)
    Kw = 31
    worst_err = {}  # (route, dtype) -> (plans, worst relative error)
    for cin, cout, t_in, t_out in shapes:
        x = torch.randn((B, cin, t_in - sum(pad)), generator=g).cuda()
        w = (torch.randn((cout, cin, Kw), generator=g) / (cin * Kw) ** 0.5).cuda()
        a = (torch.rand((cout,), generator=g) * 0.3).cuda()
        shape = (B, cout, t_out)
        for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            xd = zero_pad_pitched(x.to(dt), *pad)
            wd, ad = w.to(dt), a.to(dt)
            plans = []
            if K._wgmma_shape(dt, cin, cout, Kw, S, t_out, _pitched(K, xd)):
                plans += [("wgmma", m, n) for m in K.WGMMA_TILES[dt]
                          for n in (1, 2, 3, 4, 6, 8, 12, 16) if n == 1 or cin // n >= 4]
            if K._tensor_core_shape(dt, cout, Kw, S, t_out):
                plans += [("mma", m, n) for m in (1, 2, 4, 8) for n in (1, 2, 4)
                          if n <= cin]
            if not plans:
                continue
            y_ref, pre_ref = K.conv1d_prelu_plain(xd, wd, None, ad, S)
            for route, m, n in plans:
                out = nan_outputs(shape, shape, dtype=dt)
                _entry_arm(K, route, xd, wd, None, ad, S, t_out, out, plan=(m, n))()
                torch.cuda.synchronize()
                err = worst([rel_err(out[0], y_ref), rel_err(out[1], pre_ref)])
                assert err <= tol, f"{label} {(cin, cout, t_out)} {dt} {route} {m},{n}: {err}"
                k = (route, str(dt)[6:])
                count, e = worst_err.get(k, (0, 0.0))
                worst_err[k] = (count + 1, worst([e, err]))
                del out
            del xd, wd, ad, y_ref, pre_ref
    print(f"{label}s B={B}, every tensor-core plan vs plain (plans, worst rel err): "
          + ", ".join(f"{r} {d} {c} {e:.1e}" for (r, d), (c, e) in worst_err.items())
          + f" ({smi})", flush=True)
    return worst_err


def _hold_d_shapes(B, smi):
    """The kernel at the four blocks of WSEGAN's D behind the sinc front end (Cin -> Cout
    64 -> 128 ... 512 -> 1024, T_out 4096 ... 64, bias; the block's reflect pad (14, 15)),
    all tensor-core shapes, as ``_hold_shapes`` holds and times them (one D pass)."""
    shapes = [(cin, cout, 4 * (4096 >> (2 * i)) + 29, 4096 >> (2 * i))
              for i, (cin, cout) in enumerate(((64, 128), (128, 256), (256, 512),
                                               (512, 1024)))]
    return _hold_shapes("sinc D block", shapes, B, 4, True, smi, SEED + 240)


def _time_sinc_front_end(smi):
    """The SincConv front end of a default D (32 filters of 251 taps over both channels)
    at batch 300: its conv alone as the port runs it (one conv of the 600 single-channel
    rows, fp32) beside the same conv in bf16 and as a grouped conv over the two channels,
    each with its error against float64 on 8 rows; then the front end forward alone and
    forward with the backward to its parameters (one pass of a D update), with fp32 and
    bf16 parameters and x. Times in turns."""
    import torch
    import torch.nn.functional as F
    from segan_pytorch_tpu_torch.models.modules import SincConv
    from segan_pytorch_tpu_torch.ops import conv as conv_ops
    from segan_pytorch_tpu_torch.tools.encoder_fused_bench import ms_in_turns

    sinc = SincConv(32, 251, 16e3, padding="SAME").cuda()
    x = (torch.randn((300, 2, 16384), generator=torch.Generator().manual_seed(SEED + 280))
         * 0.1).cuda()
    flops = 2.0 * 300 * 2 * 32 * 16384 * 251
    with torch.no_grad(), conv_ops.full_precision(torch.float32):
        bank = sinc.bank()
        rows = conv_ops.reflect_pad_1d(x.reshape(600, 1, 16384), 125, 125)
        rows16, bank16, pair = rows.bfloat16(), bank.bfloat16(), rows.reshape(300, 2, -1)
        ref = F.conv1d(rows[:8].double(), bank.double())
        convs = {"rows fp32": lambda: F.conv1d(rows, bank),
                 "rows bf16": lambda: F.conv1d(rows16, bank16),
                 "grouped fp32": lambda: F.conv1d(pair, bank.repeat(2, 1, 1), groups=2)}
        errs = {k: rel_err(f().reshape(600, 32, -1)[:8], ref) for k, f in convs.items()}
        t_conv = ms_in_turns(convs, reps=5)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        xx = x.to(dt)

        def fwd(backward):
            params = {n: p.to(dt) for n, p in sinc.named_parameters()}
            with conv_ops.full_precision(torch.float32):
                y = torch.func.functional_call(sinc, params, (xx,))
                if backward:
                    y.float().square().mean().backward()

        with torch.no_grad():
            fwd_only = ms_in_turns({"forward": lambda: fwd(False)}, reps=5)["forward"]
        both = ms_in_turns({"both": lambda: fwd(True)}, reps=5)["both"]
        out[str(dt).split(".")[-1]] = (fwd_only, both)
    print("SincConv front end, B=300, 32 filters x 251 taps over 2 channels (158 GFLOP a "
          "forward): its conv " + ", ".join(
              f"{k} {t_conv[k]:.3f} ms ({flops / t_conv[k] * 1e-9:.1f} TFLOP/s, vs float64 "
              f"{errs[k]:.1e})" for k in convs) + "; the front end " + "; ".join(
              f"{k} forward {f:.3f} ms, forward + backward {b:.3f} ms"
              for k, (f, b) in out.items()) + f" ({smi})", flush=True)
    out["conv"] = t_conv
    return out


def _blocks_card_vs_cpu(smi):
    """(d): the seven blocks and SincConv at widths a model uses, batch 8, on the card in
    fp32 (<= FP32_TOL) and on bf16 copies (parameters cast, BatchNorm's statistics fp32;
    <= BF16_TOL) against the same block on the CPU in fp32, on the same input and
    parameter values (for the bf16 copy both rounded to bf16: SincConv's band edges
    rounded to bf16 move its filters by ~2e-2 by themselves); BatchNorm blocks in train
    mode (batch statistics, running statistics moved)."""
    import copy
    import torch
    from segan_pytorch_tpu_torch.models import modules as M

    g = torch.Generator().manual_seed(SEED + 250)
    cases = [
        ("LayerNorm", M.LayerNorm(), (8, 64, 16384), False),
        ("ResBlock1D bnorm d=2", M.ResBlock1D(64, 128, 3, dilation=2, norm_type="bnorm",
                                              generator=g), (8, 64, 16384), True),
        ("ResARModule bnorm d=4", M.ResARModule(128, 256, 128, 3, 4, norm_type="bnorm",
                                                generator=g), (8, 128, 4096), True),
        ("SincConv 32 x 251 SAME", M.SincConv(32, 251, 16e3, padding="SAME"),
         (8, 2, 16384), False),
        ("CombFilter L=8", M.CombFilter(64, 64, 8, generator=g), (8, 64, 16384), False),
        ("PostProcessingCombNet", M.PostProcessingCombNet(64, 256, generator=g),
         (8, 64, 16384), False),
        ("Conv1DResBlock stride 4", M.Conv1DResBlock(64, 128, 3, generator=g),
         (8, 64, 16384), False),
        ("Conv1DResBlock transposed", M.Conv1DResBlock(128, 64, 5, transpose=True,
                                                       generator=g), (8, 128, 4096), False),
    ]
    out = []
    for label, blk, shape, train in cases:
        with torch.no_grad():
            for n, p in blk.named_parameters():
                if n.endswith(("act.weight", "acts.0.weight", "acts.1.weight")):
                    p.uniform_(0.0, 0.3, generator=g)
                elif n.endswith("skip_alpha"):
                    p.fill_(0.5)
        x = torch.randn(shape, generator=g) * 0.5
        blk.train(train)
        cpu, card32, card16 = blk, copy.deepcopy(blk).cuda(), copy.deepcopy(blk).cuda()
        for p in card16.parameters():
            p.data = p.data.bfloat16()
        x16 = x.bfloat16()
        cpu16 = copy.deepcopy(blk)  # the bf16 copy's parameter values, in fp32
        for p in cpu16.parameters():
            p.data = p.data.bfloat16().float()
        with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
            want, want16 = cpu(x), cpu16(x16.float())
            got32, got16 = card32(x.cuda()), card16(x16.cuda())
        if isinstance(want, tuple):  # ResARModule: (x + skip, res)
            e32 = worst(rel_err(a.cpu(), b) for a, b in zip(got32, want))
            e16 = worst(rel_err(a.cpu(), b) for a, b in zip(got16, want16))
        else:
            e32, e16 = rel_err(got32.cpu(), want), rel_err(got16.cpu(), want16)
        out.append((label, shape, e32, e16))
        assert e32 <= FP32_TOL and e16 <= BF16_TOL, (label, e32, e16)
    g16 = M.pos_code(torch.arange(8).cuda(), torch.zeros(8, 512, 4096, device="cuda"))
    want = M.pos_code(torch.arange(8), torch.zeros(8, 512, 4096))
    e = rel_err(g16.cpu(), want)
    assert e <= FP32_TOL, e
    out.append(("pos_code", (8, 512, 4096), e, float("nan")))
    print("blocks, card vs CPU (fp32 rel err, bf16 rel err): " + "; ".join(
        f"{label} {shape} {e32:.1e} {e16:.1e}" for label, shape, e32, e16 in out)
          + f" ({smi})", flush=True)


def phase_a7a(work: Path, smi: str) -> dict:
    """12 (A7a): a bnorm G and D's SincConv front end at full width, every check fatal.
    (a) SEGAN+ with --gnorm_type bnorm (--no_bias) at batch 300, fp32 and bf16: 3 warm-up
    and 5 timed steps (slices/s, phase split, peak memory, MFU), 0 launches of the kernel
    (a bnorm G takes the plain conv, as in JAX); one fp32 step at B = 4 vs float64 on the
    CPU (losses and Genh <= SLICE_TOL, G's running statistics <= STATS_TOL); --steps_per_call
    4 vs 4 eager steps under cudnn.deterministic (every state tensor, G's running
    statistics included, <= GRAPH_TOL); the trained G's checkpoint through `clean`
    (--device cuda) and generate() card vs a CPU copy (<= SLICE_TOL). (b) SEGAN+ with
    --sinc_conv --dpool_slen 64: the same timing, 5 launches a step on the tensor cores,
    one step vs float64, the front end timed alone. (c) WSEGAN with its script's flags and --sinc_conv --dpool_slen
    64 at batch 150: the kernel held at the sinc D's four new shapes and timed; 3 timed
    steps of 5 + 4 x 4 launches; one step at B = 3 (one row masked, one 'additive') vs
    float64 within phase 7a's bounds. (d) the
    blocks card vs CPU. Returns the launch counts and the D shapes' sums."""
    import copy
    import torch
    from segan_pytorch_tpu_torch import clean
    from segan_pytorch_tpu_torch.data.wav_io import read_wav_raw
    from segan_pytorch_tpu_torch.models.segan import SEGAN
    from segan_pytorch_tpu_torch.models.wsegan import WSEGAN
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.ops.signal import normalize_wave_minmax, pre_emphasize_np
    from segan_pytorch_tpu_torch.utils.checkpoint import save_generator
    from segan_pytorch_tpu_torch.utils.config import SEGANConfig, dump_train_opts

    t_phase = time.perf_counter()
    out = {}
    # (a) and (b): SEGAN+ at batch 300
    for case, flags, per_step in (("bnorm G", dict(gnorm_type="bnorm"), 0),
                                  ("sinc D", SINC_FLAGS, 5)):
        for dtype in ("float32", "bfloat16"):
            cfg = SEGANConfig(no_bias=True, compute_dtype=dtype, batch_size=300, **flags)
            G, D = _train_models(cfg, SEED + 200)
            seg = SEGAN(cfg, generator=G, discriminator=D, device="cuda")
            clean_b, noisy_b = (v.cuda() for v in _train_batch(300, cfg.slice_size,
                                                               SEED + 201))
            r = _time_steps(seg, (clean_b, noisy_b, torch.ones(300, device="cuda"), 100.0),
                            2, warm=1)
            flops = flops if dtype == "bfloat16" else seg.step_flops()
            _report_steps(f"A7a SEGAN+ {case} B=300 {dtype}", r, flops, 300, smi)
            _check_counts(r, 2 * per_step, dtype)
            out[f"{case} {dtype}"] = r
            if case == "bnorm G" and dtype == "float32":
                trained = copy.deepcopy(seg.G).cpu()
            del seg, G, D, clean_b, noisy_b
            torch.cuda.empty_cache()
        cfg = SEGANConfig(no_bias=True, **flags)
        losses, bufs, launched, secs = _vs_float64(SEGAN, cfg, SEED + 210, 3)
        g_stats = {k: v for k, v in bufs["card"].items() if k.startswith("G.")}
        print(f"A7a SEGAN+ {case}, one fp32 step B=4 vs float64 on the CPU (card {secs[0]:.1f}"
              f" s, float64 {secs[1]:.1f} s): losses (g_adv with d_lr = 0) and Genh "
              + ", ".join(f"{k} {v:.1e}" for k, v in losses.items())
              + (f"; G's running statistics, worst {max(g_stats.values()):.1e}"
                 if g_stats else "") + f"; launches (all, 3xTF32) {launched} "
              f"({time.perf_counter() - t_phase:.1f} s into the phase)", flush=True)
        assert worst(losses.values()) <= SLICE_TOL, losses
        # 3xTF32 but G's enc1 where its rows take the FMA kernel
        g_fma = _g_routes(K, torch.float32, 4, cfg.slice_size, False).count("fma")
        assert launched == (per_step, per_step - (g_fma if per_step else 0)), launched
        if case == "bnorm G":
            assert len(g_stats) == 20 and worst(g_stats.values()) <= STATS_TOL, g_stats
    out["sinc front end"] = _time_sinc_front_end(smi)
    # (a) the graphed step against eager steps, G's running statistics included
    cfg = SEGANConfig(no_bias=True, gnorm_type="bnorm", batch_size=300)
    cleans, noisies = zip(*(_train_batch(300, cfg.slice_size, SEED + 220 + i)
                            for i in range(4)))
    masks = torch.ones((4, 300))
    masks[2, -1] = 0.0
    stacked = [torch.stack(cleans).cuda(), torch.stack(noisies).cuda(), masks.cuda()]
    l1s = [100.0 - 0.1 * i for i in range(4)]
    torch.backends.cudnn.deterministic = True
    try:
        A, E = _graph_engines("segan", cfg, SEED + 221, 2)
        before = _engine_state(E)
        K.launches = 0
        ms, _, genh, _ = A.train_step_multi(*stacked, l1_w_s=l1s)
        first_call = K.launches
        eager = []
        for i in range(4):
            m, g_e, _ = E.train_step(*[s[i] for s in stacked], l1s[i])
            eager.append({k: float(v) for k, v in m.items()})
        loss_err, state_err, worst_t = _graph_errs(_losses(ms), eager, _engine_state(A),
                                                   _engine_state(E), before)
        genh_err = rel_err(genh, g_e)
        stats_moved = float((A.G.enc_blocks[2].norm.running_var
                             - before["G.enc_blocks.2.norm.running_var"]).abs().max())
        A.release_multi_step()
        del A, E
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    print(f"A7a bnorm G B=300 fp32, cudnn.deterministic: 4 graphed sub-steps vs 4 "
          f"train_step calls: losses {loss_err:.3g}, Genh {genh_err:.3g}, changes "
          + ", ".join(f"{k} {v:.3g}" for k, v in state_err.items())
          + f" (worst tensor {worst_t[1]} {worst_t[0]:.3g}); G's running variance moved "
          f"{stats_moved:.3g}; kernel launches in the call {first_call} "
          f"({time.perf_counter() - t_phase:.1f} s into the phase)", flush=True)
    assert first_call == 0 and stats_moved > 0, (first_call, stats_moved)
    assert max(loss_err, genh_err, *state_err.values()) <= GRAPH_TOL, (
        loss_err, genh_err, state_err)
    # (a) the trained bnorm G through clean, then generate() card vs a CPU copy
    cfg = SEGANConfig(no_bias=True, gnorm_type="bnorm", save_path=str(work))
    ckpt = work / "bnorm_g.ckpt"
    save_generator(trained, str(ckpt))
    opts = dump_train_opts(cfg, str(work))
    wav_dir, out_dir = work / "bnorm_noisy", work / "bnorm_out"
    wav_dir.mkdir()
    out_dir.mkdir()
    lengths = _write_wavs(wav_dir)[:4]
    for p in sorted(wav_dir.glob("*.wav"))[4:]:
        p.unlink()
    clean.main(clean.build_parser().parse_args([
        "--g_pretrained_ckpt", str(ckpt), "--cfg_file", opts, "--test_files",
        str(wav_dir), "--synthesis_path", str(out_dir), "--seed", str(SEED),
        "--device", "cuda"]))
    for i, n in enumerate(lengths):
        _, y = read_wav_raw(str(out_dir / f"utt{i}.wav"))
        assert y.shape == (n,) and np.isfinite(y).all(), (i, y.shape)
    card = SEGAN(cfg, generator=copy.deepcopy(trained), device="cuda")
    host = SEGAN(cfg, generator=copy.deepcopy(trained), device="cpu")
    _, pcm = read_wav_raw(str(wav_dir / "utt3.wav"))
    wav = pre_emphasize_np(normalize_wave_minmax(pcm), cfg.preemph)
    zrow = np.random.RandomState(SEED + 230).randn(1, 16, cfg.z_dim).astype(np.float32)
    y_card, _ = card.generate(wav, z=zrow)
    with torch.backends.mkldnn.flags(enabled=False):
        y_host, _ = host.generate(wav, z=zrow)
    e_gen = rel_err(torch.from_numpy(y_card), torch.from_numpy(y_host))
    print(f"A7a bnorm G: clean (--device cuda) enhanced {len(lengths)} wavs; generate() "
          f"card vs a CPU copy in eval mode {e_gen:.1e} (bound {SLICE_TOL}) "
          f"({time.perf_counter() - t_phase:.1f} s into the phase)", flush=True)
    assert e_gen <= SLICE_TOL and not card.G.training, e_gen
    del card, host
    # (c) WSEGAN with the sinc D at its script's batch
    sums = _hold_d_shapes(150, smi)
    for dtype in ("float32", "bfloat16"):
        cfg = SEGANConfig(**WSEGAN_FLAGS, **SINC_FLAGS, compute_dtype=dtype, batch_size=150)
        G, D = _wsegan_models(cfg, SEED + 260)
        seg = WSEGAN(cfg, generator=G, discriminator=D, device="cuda")
        clean_b, noisy_b = (v.cuda() for v in _train_batch(150, cfg.slice_size, SEED + 261))
        ones = torch.ones(150, device="cuda")
        r = _time_steps(seg, (clean_b, noisy_b, ones, torch.zeros_like(ones), 100.0), 2,
                        warm=1)
        flops = flops if dtype == "bfloat16" else seg.step_flops()
        _report_steps(f"A7a WSEGAN sinc D B=150 {dtype}", r, flops, 150, smi)
        _check_counts(r, 2 * SINC_WS_PER_STEP, dtype)
        out[f"wsegan sinc D {dtype}"] = r
        del seg, G, D, clean_b, noisy_b
        torch.cuda.empty_cache()
    cfg = SEGANConfig(**WSEGAN_FLAGS, **SINC_FLAGS)
    losses, bufs, launched, secs = _vs_float64(WSEGAN, cfg, SEED + 270, 4,
                                               (torch.tensor([0.0, 1.0, 0.0]),),
                                               cpu=True, B=3)
    # u and v after the step: with d_lr = 0 they follow W alone; after Adam's first step,
    # which moves each weight by lr sign(g), also the signs of gradients near 0, which
    # the CPU's fp32 step flips as the card's does: held as 7a holds D's gradients
    uv = {name: worst(b.values()) for name, b in bufs.items()}
    print(f"A7a WSEGAN sinc D, one fp32 step B=3 vs float64 on the CPU (card {secs[0]:.1f} s,"
          f" float64 {secs[1]:.1f} s): losses (g_adv and g_loss with d_lr = 0) and Genh "
          + ", ".join(f"{k} {v:.1e}" for k, v in losses.items()) + "; u and v, worst: "
          + ", ".join(f"{k} {v:.1e}" for k, v in uv.items())
          + f"; launches (all, 3xTF32) {launched} ({time.perf_counter() - t_phase:.1f} s "
          "into the phase)", flush=True)
    assert worst(losses.values()) <= WS_TOL and uv["card d_lr 0"] <= WS_TOL, (losses, uv)
    assert uv["card"] <= max(WS_TOL, 4 * uv["CPU"]), uv
    g_fma = _g_routes(K, torch.float32, 3, cfg.slice_size, True).count("fma")
    assert launched == (SINC_WS_PER_STEP, SINC_WS_PER_STEP - g_fma), launched
    # (d) the blocks
    _blocks_card_vs_cpu(smi)
    print(f"A7a: phase 12 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(bnorm_launches_per_step=0, sinc_segan_launches_per_step=5,
                sinc_wsegan_launches_per_step=SINC_WS_PER_STEP, sinc_d=sums)


# the SEGAN v1 paper's generator (Pascual et al. 2017, arXiv:1703.09452, section 4):
# 11 encoder layers of K = 31 at stride 2, 16384 samples -> 8 x 1024, z (B, 8, 1024)
G1D_V1 = dict(ninputs=1, enc_fmaps=[16, 32, 32, 64, 64, 128, 128, 256, 256, 512, 1024],
              kwidth=31, pooling=2, z_dim=1024, skip_merge="concat")
G1D_LAUNCHES = 11  # one per encoder layer, each on the route _route picks at stride 2
G1D_TOY = dict(ninputs=1, enc_fmaps=[8, 16, 32], kwidth=31, z_dim=16)
# the CPU tests' options (tests/test_torch_generator1d.py), as (pooling, options)
G1D_OPTIONS = ([(p, kw) for p in (4, 2) for kw in (
    {}, {"no_z": True}, {"rnn_core": True}, {"num_spks": 4}, {"linterp": True},
    {"use_pos_code": True}, {"post_proc": True}, {"out_gate": True},
    {"big_out_filter": True}, {"lnorm": True, "dropout": 0.2}, {"skip_blacklist": (0,)},
    {"skip_merge": "concat"}, {"aal": True}, {"aal_out": True}, {"convblock": True},
    {"snorm": True}, {"freeze_enc": True})]
    + [(2, {"z_all": True}), (4, {"pad_type": "reflect"}), (2, {"pad_type": "reflect"}),
       (4, {"skip_type": "conv"}), (4, {"skip_type": "constant"}), (2, {"post_skip": True}),
       (4, {"no_tanh": True}),
       (4, {"dec_fmaps": [16, 8, 8, 1], "up_poolings": [4, 4, 1, 4]}),
       (2, {"activations": "LeakyReLU", "dec_activations": ["ReLU", "PReLU", "Tanh"]})])


def _g1d(seed, **kw):
    """A Generator1D on the CPU, its conv weights N(0, 1 / fan-in) (a transposed conv's
    fan-in Cin K / stride) so that activations stay O(1) down 22 layers, PReLU slopes
    U(0, 0.3)."""
    import torch
    from segan_pytorch_tpu_torch.models.generator1d import Generator1D

    g = torch.Generator().manual_seed(seed)
    G = Generator1D(**kw, generator=g)
    with torch.no_grad():
        for name, p in G.named_parameters():
            if name.endswith("act.weight"):
                p.uniform_(0.0, 0.3, generator=g)
            elif p.dim() == 3 and ".deconv." in name:
                p.normal_(0.0, (p.shape[0] * p.shape[2] / G.up_poolings[0]) ** -0.5,
                          generator=g)
            elif p.dim() == 3:
                p.normal_(0.0, (p.shape[1] * p.shape[2]) ** -0.5, generator=g)
    return G


def _bf16_copy(model):
    """The bf16 copy that ``SEGAN._g()`` makes: the parameters cast, the buffers as they
    are; and the fp32 model with the copy's rounded parameter values."""
    import copy
    import torch

    c16, rounded = copy.deepcopy(model), copy.deepcopy(model)
    for p in c16.parameters():
        p.data = p.data.bfloat16()
    for p in rounded.parameters():
        p.data = p.data.bfloat16().float()
    return c16, rounded


def _g1d_vs_float64(G, x, z, target):
    """The fp32 forward and the gradients of an L1 loss on the card and on the CPU, and
    the same in float64 on the CPU: (card's output error, {parameter: card's relative L2
    gradient error}, the same for the CPU's fp32), all against float64."""
    import copy
    import torch
    from segan_pytorch_tpu_torch.ops import conv as conv_ops

    def run(device, dtype):
        m = copy.deepcopy(G).to(device, dtype)
        args = [v.to(device, dtype) for v in (x, z, target)]
        with conv_ops.full_precision(dtype), torch.backends.mkldnn.flags(enabled=False):
            y = m(*args[:2])
            (y - args[2]).abs().mean().backward()
        return y.detach().cpu().double(), {n: p.grad.cpu().double()
                                           for n, p in m.named_parameters()}

    (y_c, g_c), (y_h, g_h), (y_r, g_r) = (run("cuda", torch.float32),
                                          run("cpu", torch.float32),
                                          run("cpu", torch.float64))

    def l2(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    return (rel_err(y_c, y_r), {n: l2(g_c[n], g_r[n]) for n in g_r},
            {n: l2(g_h[n], g_r[n]) for n in g_r})


def _g1d_options_card_vs_cpu(smi):
    """(c): every option of the CPU tests at toy width, the same parameters on the card
    and on the CPU, fp32 (<= FP32_TOL); eval mode, but snorm in train mode (one power
    iteration from the same u, v: stored random ones make sigma tiny). Then rnn_core's
    bf16 copy on the card (cuDNN's LSTM in bf16) against the fp32 model of its rounded
    parameters."""
    import copy
    import torch

    x = torch.randn((2, 1024, 1), generator=torch.Generator().manual_seed(SEED + 310))
    spk = torch.tensor([1, 3])
    errs = {}
    for i, (pool, kw) in enumerate(G1D_OPTIONS):
        G = _g1d(SEED + 320 + i, pooling=pool, **G1D_TOY, **kw).train(bool(kw.get("snorm")))
        shape = (2, 2, 16) if kw.get("rnn_core") else (2, 1024 // pool ** 3, 16)
        z = torch.randn(shape, generator=torch.Generator().manual_seed(SEED + 321 + i))
        s = spk if kw.get("num_spks") else None
        card = copy.deepcopy(G).cuda()
        with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
            want = G(x, z, spkid=s)
            got = card(x.cuda(), z.cuda(), spkid=s.cuda() if s is not None else None)
        errs[f"p{pool} {','.join(f'{k}={v}' for k, v in kw.items()) or 'default'}"] = \
            rel_err(got.cpu(), want)
    bad = {k: v for k, v in errs.items() if not v <= FP32_TOL}
    G = _g1d(SEED + 350, pooling=2, rnn_core=True, **G1D_TOY).eval().cuda()
    g16, rounded = _bf16_copy(G)
    z = torch.randn((2, 2, 16), generator=torch.Generator().manual_seed(SEED + 351)).cuda()
    xc = x.cuda().bfloat16()
    with torch.no_grad():
        e16 = rel_err(g16(xc, z), rounded(xc.float(), z.bfloat16().float()))
    print(f"A7b options at toy width, card vs CPU (fp32, {len(errs)} cases): worst "
          f"{worst(errs.values()):.1e} ({max(errs, key=errs.get)}); rnn_core bf16 copy "
          f"(cuDNN LSTM in bf16) vs fp32 of its rounded parameters {e16:.1e} ({smi})",
          flush=True)
    assert not bad and e16 <= BF16_TOL, (bad, e16)


def _a7c_on_the_card_machine(work: Path):
    """(d): the host copies where there is no jax: STOI of 3 s, F0Evaluator on a spawned
    pool of two (ended here), one epoch of both random-chunk datasets over a synthetic
    corpus with .lf0 targets written by write_aco_file. Returns their seconds."""
    from scipy.io import wavfile
    from segan_pytorch_tpu_torch.data.aco import write_aco_file
    from segan_pytorch_tpu_torch.data.se_dataset import (RandomChunkSEDataset,
                                                         RandomChunkSEF0Dataset)
    from segan_pytorch_tpu_torch.metrics.f0 import F0Evaluator
    from segan_pytorch_tpu_torch.metrics.stoi import stoi

    rng = np.random.RandomState(SEED + 360)

    def speech(n):
        t = np.arange(n) / SR
        phase = 2 * np.pi * np.cumsum(120 + 40 * np.sin(2 * np.pi * 0.7 * t)) / SR
        x = sum(a * np.sin(k * phase) for k, a in ((1, 0.4), (2, 0.2), (3, 0.1)))
        return x * (0.6 + 0.4 * np.sin(2 * np.pi * 2 * t)) + 0.01 * rng.randn(n)

    secs = {}
    t0 = time.perf_counter()
    ref = speech(3 * SR)
    d = stoi(ref, ref + 0.1 * rng.randn(ref.size))
    secs["stoi"] = time.perf_counter() - t0
    assert 0 < d < 1, d
    t0 = time.perf_counter()
    ev = F0Evaluator(num_proc=2)
    wavs = np.stack([speech(SR), speech(SR)]).astype(np.float32)
    try:
        kld, mae, acc = ev(wavs, wavs[::-1].copy())
    finally:
        if ev.pool is not None:
            ev.pool.terminate()
            ev.pool.join()
    secs["F0Evaluator"] = time.perf_counter() - t0
    assert np.isfinite(mae).all() and ((0 <= acc) & (acc <= 1)).all(), (mae, acc)
    for sub in ("clean", "noisy", "lf0"):
        (work / "a7c" / sub).mkdir(parents=True)
    for i in range(8):
        n = int(SR * (0.5 + i * 0.25))
        x = speech(n)
        for sub, y in (("clean", x), ("noisy", x + 0.05 * rng.randn(n))):
            wavfile.write(str(work / "a7c" / sub / f"u{i}.wav"), SR,
                          (np.clip(y, -1, 1) * 30000).astype(np.int16))
        lf0 = np.log(100 + 50 * rng.rand(n // 80)).astype(np.float32)
        lf0[::5] = -1e10
        write_aco_file(str(work / "a7c" / "lf0" / f"u{i}.lf0"), lf0)
    for name, ds in (("RandomChunkSEDataset", RandomChunkSEDataset(
            str(work / "a7c" / "clean"), str(work / "a7c" / "noisy"), 0.95)),
                     ("RandomChunkSEF0Dataset", RandomChunkSEF0Dataset(
            str(work / "a7c" / "clean"), str(work / "a7c" / "lf0"), 0.95))):
        t0 = time.perf_counter()
        items = [ds[i] for i in range(len(ds))]
        secs[name] = time.perf_counter() - t0
        assert len(items) == 8 and all(
            it["clean"].shape == (16384,) and np.isfinite(it["clean"]).all() for it in items)
    print("A7c on the card machine: STOI of 3 s " + f"{d:.4f}; " + ", ".join(
        f"{k} {v:.3f} s" for k, v in secs.items())
          + " (F0Evaluator: a spawned pool of two, its first call, then terminated; the "
          "datasets: one epoch of 8 utterances)", flush=True)
    return secs


def phase_a7bc(work: Path, smi: str) -> dict:
    """13 (A7b, A7c): Generator1D and the host copies, every check fatal. (a) the SEGAN v1
    paper's Generator1D (G1D_V1) at 64 chunks of 16384 samples, fp32 and its bf16 copy:
    one forward each with the kernel's counters set to 0 just before and read just after
    (11 launches, each on the route _route picks, the tensor cores from the second layer
    on), the forward and a forward + backward of an L1 loss timed in
    turns, FLOPs (the encoder's from its shapes, the rest by FlopCounterMode); at B = 2
    the fp32 forward and gradients card and CPU vs float64 on the CPU (output <=
    SLICE_TOL, each gradient's relative L2 error <= max(1e-3, 4 x the CPU fp32's)); the
    bf16 copy vs the fp32 model of its rounded parameters (<= BF16_TOL). (b) the kernel at
    that encoder's 11 stride-2 shapes at B = 64 (``_hold_shapes``), then at every plan of
    its tensor-core routes there (``_hold_plans``). (c) the options at toy width, card vs
    CPU. (d) the A7c copies. Returns the launch count, the counters by dtype and (b)'s
    sums."""
    import copy
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from segan_pytorch_tpu_torch.ops import conv as conv_ops
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.tools.encoder_fused_bench import ms_in_turns

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    B, T = 64, 16384
    G = _g1d(SEED + 300, **G1D_V1).eval()
    n_params = sum(p.numel() for p in G.parameters())
    gen = torch.Generator().manual_seed(SEED + 301)
    x = torch.randn((B, T, 1), generator=gen) * 0.5
    z = torch.randn((B, T >> 11, 1024), generator=gen)
    target = torch.randn((B, T, 1), generator=gen) * 0.1
    card = copy.deepcopy(G).cuda()
    c16, rounded = _bf16_copy(card)
    xc, zc, tc = x.cuda(), z.cuda(), target.cuda()
    x16, z16 = xc.bfloat16(), zc.bfloat16()
    launched, routes = {}, {}
    with torch.no_grad():
        for name, model, args in (("fp32", card, (xc, zc)), ("bf16", c16, (x16, z16))):
            with _logged_launches() as log:
                K.launches = K.launches_mma = K.launches_tf32 = K.launches_wgmma = K.launches_rows = 0
                y = model(*args)
                torch.cuda.synchronize()
                launched[name] = _counters(K)
            assert y.shape == (B, T, 1) and torch.isfinite(y).all(), name
            # the counters against _route's picks for the logged calls, x in pitched rows
            routes[name] = [K._route(dt, b, cin, cout, k, s, (t_in - k) // s + 1, p)
                            for dt, b, cin, t_in, cout, k, s, p in log]
            assert len(log) == G1D_LAUNCHES and all(e[-1] for e in log), (name, log)
            assert launched[name] == _want_counts(K, log), (name, launched[name], routes)
            # every layer on the tensor cores but the first (Cin 1), whose route is the
            # stride's enc1 rule
            assert "fma" not in routes[name][1:], (name, routes[name])
        e16 = rel_err(c16(x16, z16), rounded(x16.float(), z16.float()))
        with FlopCounterMode(display=False) as fc:
            card(xc, zc)
    enc_shapes = [(cin, cout, (T >> i) + 30, T >> (i + 1)) for i, (cin, cout) in
                  enumerate(zip([1] + G1D_V1["enc_fmaps"][:-1], G1D_V1["enc_fmaps"]))]
    enc_flops = sum(2.0 * B * t_out * cout * cin * 31 for cin, cout, _, t_out in enc_shapes)
    flops = enc_flops + fc.get_total_flops()

    def fwd_bwd(model, xx, zz):
        model.zero_grad(set_to_none=True)
        with conv_ops.full_precision(xx.dtype):
            (model(xx, zz).float() - tc).abs().mean().backward()

    with torch.no_grad():
        t_fwd = ms_in_turns({"fp32": lambda: card(xc, zc), "bf16": lambda: c16(x16, z16)},
                            reps=5, warmup=2)
    t_fb = ms_in_turns({"fp32": lambda: fwd_bwd(card, xc, zc),
                        "bf16": lambda: fwd_bwd(c16, x16, z16)}, reps=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del card, c16, rounded, xc, zc, tc, x16, z16
    torch.cuda.empty_cache()
    e_out, g_card, g_cpu = _g1d_vs_float64(G, x[:2], z[:2], target[:2])
    bad = {n: (g_card[n], g_cpu[n]) for n in g_card
           if not g_card[n] <= max(1e-3, 4 * g_cpu[n])}
    print(f"A7b Generator1D, the v1 paper's widths ({n_params / 1e6:.2f}M parameters), "
          f"B={B} x {T}: forward fp32 {t_fwd['fp32']:.3f} ms ({B / t_fwd['fp32'] * 1e3:.1f}"
          f" chunks/s), bf16 {t_fwd['bf16']:.3f} ms ({B / t_fwd['bf16'] * 1e3:.1f} chunks/s)"
          f"; forward + backward of an L1 loss fp32 {t_fb['fp32']:.3f} ms, bf16 "
          f"{t_fb['bf16']:.3f} ms; {flops / 1e9:.2f} GFLOP a forward ({enc_flops / B / 1e9:.3f}"
          f" encoder, {(flops - enc_flops) / B / 1e9:.3f} the rest a slice); launches a "
          f"forward (all, tensor cores, fp32 of those, wgmma) {launched}, by layer "
          f"{routes}; peak {peak:.2f} GiB; bf16 copy vs fp32 "
          f"of its rounded parameters {e16:.1e}; B=2 vs float64: output {e_out:.1e}, "
          f"gradients worst {worst(g_card.values()):.1e} (the CPU's fp32 "
          f"{worst(g_cpu.values()):.1e}) ({time.perf_counter() - t_phase:.1f} s into the "
          f"phase; {smi})", flush=True)
    assert e_out <= SLICE_TOL and not bad and e16 <= BF16_TOL, (e_out, bad, e16)
    del G
    sums = _hold_shapes("G1D enc", enc_shapes, B, 2, False, smi, SEED + 330, pad=(15, 15))
    _hold_plans("G1D enc", enc_shapes, B, 2, SEED + 331, (15, 15), smi)
    _g1d_options_card_vs_cpu(smi)
    host = _a7c_on_the_card_machine(work)
    print(f"A7b/A7c: phase 13 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(launches_per_forward=G1D_LAUNCHES, enc=sums, launched=launched,
                ms={k: (t_fwd[k], t_fb[k]) for k in t_fwd}, host=host)


# -- phase 14: multi-GPU training (A8) on the one card -----------------------------------
P14_SEED = SEED + 1400
P14_B, P14_VALID = 64, 50  # 14b: the global batch and its valid rows (zeros on rank 1)
P14_WS_B = 16              # 14c: the global batch of the dp 2 x mp 2 WSEGAN step
P14_A_B, P14_A_VALID = 8, 6  # 14a
P14_DETERMINISTIC = ("bfloat16",)  # 14b's dtypes on cuDNN's deterministic algorithms
P14_TIMEOUT_S = 240        # a group not done by then is killed and the phase fails
P14_ENHANCE_TOL = 1e-5
# 14a's graphed grouped step: (label, engine, global batch, dtype, flags), S sub-steps a
# call, and the batches at which the grouped step is timed graphed and eager
P14_GRAPH_CASES = [
    ("SEGAN+ fp32", "segan", 300, "float32", dict(no_bias=True)),
    ("SEGAN+ bf16", "segan", 300, "bfloat16", dict(no_bias=True)),
    ("WSEGAN fp32", "wsegan", 150, "float32", WSEGAN_FLAGS),
]
P14_GRAPH_S = 4
P14_RATE_CALLS = {300: 1, 16: 3}  # timed graphed calls of S sub-steps (S x as many eager)


def _p14_engine(kind, dtype, B, dp=1, mp=1):
    """A full-width engine on the card: SEGAN+ ('segan', --no_bias) or WSEGAN ('wsegan',
    the script's flags), D's learning rate 0 (D' = D, so the losses and G's gradients
    that go through D' compare without Adam's or RMSprop's sign steps), seeded weights."""
    import torch
    from segan_pytorch_tpu_torch.models.segan import SEGAN
    from segan_pytorch_tpu_torch.models.wsegan import WSEGAN
    from segan_pytorch_tpu_torch.utils.config import SEGANConfig

    flags = WSEGAN_FLAGS if kind == "wsegan" else dict(no_bias=True)
    cfg = SEGANConfig(batch_size=B, d_lr=0.0, dp=dp, mp=mp,
                      compute_dtype="bfloat16" if dtype == torch.bfloat16 else "float32",
                      **flags)
    G, D = (_wsegan_models if kind == "wsegan" else _train_models)(cfg, P14_SEED)
    cls = WSEGAN if kind == "wsegan" else SEGAN
    seg = cls(cfg, generator=G, discriminator=D, device="cuda")
    seg.init_train()
    return seg


def _p14_step(seg, kind, B, valid):
    """One step of `seg` on this process's rows of a seeded global batch of B (rows from
    `valid` on masked out; WSEGAN: every third row 'additive') with seeded global draws.
    Returns (losses, Genh rows, {name: gradient}, {name: buffer}, launches, seconds)."""
    import torch
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K

    clean, noisy = _train_batch(B, 16384, P14_SEED + 1)
    mask = (torch.arange(B) < valid).float()
    gen = torch.Generator().manual_seed(P14_SEED + 2)
    draws = dict(z=torch.randn((B, 16, 1024), generator=gen),
                 phase=seg.D.sample_phase(gen, passes=seg.n_d_passes()))
    args = [clean, noisy, mask]
    if kind == "wsegan":
        draws["perm"] = torch.randperm(B, generator=gen)
        args.append((torch.arange(B) % 3 == 0).float())
    rows = seg.grid.rows(B // seg._dp()) if seg.grid is not None else slice(None)
    torch.cuda.synchronize()
    K.launches = 0
    t0 = time.perf_counter()
    m, genh, _ = seg.train_step(*(a[rows] for a in args), 100.0, **draws)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    grads = {f"{side}.{n}": p.grad.detach().float().cpu() for side in ("G", "D")
             for n, p in getattr(seg, side).named_parameters()}
    bufs = {f"{side}.{n}": b.detach().cpu() for side in ("G", "D")
            for n, b in getattr(seg, side).named_buffers()
            if not n.endswith("num_batches_tracked")}
    return ({k: float(v) for k, v in m.items()}, genh.cpu(), grads, bufs, K.launches, secs)


def _p14_errors(got, ref, seg):
    """Errors of one process's step against the one-process step: each loss, Genh (this
    process's rows), each gradient and buffer (D's split head against its part of the
    whole), relative in L2; the gradients of G and of D all together too."""
    from segan_pytorch_tpu_torch.parallel.sharding import _tp_spec

    rows = seg.grid.rows(got[1].shape[0]) if seg.grid is not None else slice(None)

    def part(name, full):
        side, n = name.split(".", 1)
        dim = _tp_spec(n, full.shape) if side == "D" and seg._model is not None else None
        if dim is None or seg._model.size == 1:
            return full
        p = seg._model.part(full.shape[dim])
        return full.narrow(dim, p.start, p.stop - p.start)

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300))

    # D's conv biases that feed a BatchNorm have a true gradient of 0: held apart
    apart = BIAS_BEFORE_BN if seg.cfg.dnorm_type == "bnorm" else ()
    out = {"losses": {k: abs(v - ref[0][k]) / abs(ref[0][k]) for k, v in got[0].items()},
           "Genh": rel(got[1], ref[1][rows])}
    for i, kind in ((2, "grads"), (3, "bufs")):
        out[kind] = {k: rel(v, part(k, ref[i][k])) for k, v in got[i].items()}
    for side in ("G", "D"):
        keys = [k for k in got[2] if k.startswith(side + ".") and
                not (side == "D" and k.split(".", 1)[1] in apart)]
        num = sum(float((got[2][k].double() - part(k, ref[2][k]).double()).norm()) ** 2
                  for k in keys)
        den = sum(float(part(k, ref[2][k]).double().norm()) ** 2 for k in keys)
        out[f"{side} all"] = (num / max(den, 1e-300)) ** 0.5
    out["apart"] = [f"D.{k}" for k in apart]
    out["checksum"] = sum(float(v.double().sum()) for v in got[2].values())
    return out


def _p14_rank(rank, nprocs, mp, kind, dtypes, B, valid, work):
    """One process of a group sharing the card over gloo: for each dtype the engine at
    dp x mp, one step on its rows, its errors against the one-process step written by
    the parent (``{work}/{kind}_ref.pt``); results to ``{work}/{kind}_rank{rank}.json``."""
    import torch
    from segan_pytorch_tpu_torch.parallel import mesh

    mesh.initialize_distributed(f"file://{work}/{kind}_rendezvous", nprocs, rank, "cuda",
                                backend="gloo", timeout_s=P14_TIMEOUT_S / 2)
    refs = torch.load(f"{work}/{kind}_ref.pt", weights_only=False)
    out = {}
    for name in dtypes:
        # cuDNN's algorithms as the parent's references (_p14_group)
        torch.backends.cudnn.deterministic = name in P14_DETERMINISTIC
        seg = _p14_engine(kind, getattr(torch, name), B, nprocs // mp, mp)
        got = _p14_step(seg, kind, B, valid)
        err = _p14_errors(got, refs[name], seg)
        if name == dtypes[0]:
            err["gloo_s2"] = _p14_gloo_refused(seg)
        if name == "bfloat16":  # also against the one-process fp32 step
            err["vs fp32"] = _p14_errors(got, refs["float32 deterministic"], seg)
        out[name] = dict(err, launches=got[4], seconds=got[5], backend=torch.distributed
                         .get_backend(), device=str(seg.device), grid=list(
                             (seg.grid.dp, seg.grid.mp, seg.grid.dp_index, seg.grid.mp_index)))
        del seg, got
        torch.cuda.empty_cache()
    mesh.shutdown_distributed()
    Path(f"{work}/{kind}_rank{rank}.json").write_text(json.dumps(out))


def _p14_gloo_refused(seg):
    """A grouped call of two sub-steps on a gloo group over CUDA tensors: gloo's
    all-reduce waits on the host, so the step's graph cannot hold it, and the call must
    raise, naming the backend, before it launches anything. Returns (the message, the
    kernel's launches in the call)."""
    import torch
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K

    B = seg.cfg.batch_size // seg._dp()
    stacked = [torch.zeros((2, B, 16384, 1)), torch.zeros((2, B, 16384, 1)),
               torch.ones((2, B))] + ([torch.zeros((2, B))] if len(seg.batch_keys) == 4
                                      else [])
    K.launches = 0
    try:
        seg.train_step_multi(*stacked, l1_w_s=[100.0, 100.0])
    except RuntimeError as e:
        return str(e), K.launches
    return None, K.launches


def _p14_spread(kind, name, B, valid):
    """The one-process step again, a second engine of the same state, with the kernel's
    split-K planned for half the SMs: it sums in another order, as the ranks' smaller
    batches make it do, and cuDNN's default algorithms fix no order either. How far this
    lands from the first step is the step's own sensitivity to the order of its sums (a
    last-bit change of a pre-activation at a PReLU kink flips its slope), the reference
    error of the ranks' bounds, as 5b and 7a take the CPU's."""
    import torch
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K

    sm_count, records = K._sm_count, K._records
    K._sm_count = lambda index: max(1, sm_count(index) // 2)
    K._records = {}  # the wrapper's records hold the plans: none read or kept meanwhile
    try:
        return _p14_step(_p14_engine(kind, getattr(torch, name), B), kind, B, valid)
    finally:
        K._sm_count, K._records = sm_count, records


def _p14_group(work: Path, nprocs, mp, kind, dtypes, B, valid):
    """The one-process step of each dtype (the reference, saved for the group), then a
    group of `nprocs` processes on the card (``_p14_rank``), started and not waited for.
    Returns (the reference's losses and launches by dtype, a join() that waits for the
    group with a deadline and returns each rank's results)."""
    import torch
    import torch.multiprocessing as tmp

    refs, summary = {}, {}
    # fp32 on cuDNN's default algorithms, as users train. Those sum in no fixed order, so
    # two runs of a bf16 step differ by up to ~4x its distance from fp32 in a scalar such
    # as D.fc.4.bias: the bf16 steps and the fp32 step they are held against take the
    # deterministic algorithms (P14_DETERMINISTIC), so each run reads what the last read
    prev = torch.backends.cudnn.deterministic
    try:
        for name in dtypes:
            torch.backends.cudnn.deterministic = name in P14_DETERMINISTIC
            seg = _p14_engine(kind, getattr(torch, name), B)
            ref = _p14_step(seg, kind, B, valid)
            refs[name] = ref[:4]
            summary[name] = dict(losses=ref[0], launches=ref[4], seconds=ref[5])
            if name == "bfloat16":  # the one-process bf16 step's own distance from fp32
                torch.backends.cudnn.deterministic = True
                ref32 = _p14_step(_p14_engine(kind, torch.float32, B), kind, B, valid)
                refs["float32 deterministic"] = ref32[:4]
                summary[name]["vs fp32"] = _p14_errors(ref, ref32, seg)
                del ref32
            else:
                summary[name]["spread"] = _p14_errors(_p14_spread(kind, name, B, valid),
                                                      ref, seg)
            del seg
    finally:
        torch.backends.cudnn.deterministic = prev
    torch.save(refs, work / f"{kind}_ref.pt")
    del refs
    torch.cuda.empty_cache()
    ctx = tmp.start_processes(_p14_rank, args=(nprocs, mp, kind, dtypes, B, valid,
                                                str(work)),
                              nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.time() + P14_TIMEOUT_S

    def join():
        try:
            while not ctx.join(timeout=5):
                if time.time() > deadline:
                    raise TimeoutError(f"14: the {kind} group of {nprocs} did not finish "
                                       f"in {P14_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        return [json.loads((work / f"{kind}_rank{r}.json").read_text())
                for r in range(nprocs)]

    return summary, join


def _p14_world_of_one(work: Path, smi):
    """14a: NCCL at a world size of 1, joined by the CLI's own initialisation
    (``initialize_distributed`` with a coordinator): one full-width SEGAN+ fp32 step
    through the grouped code (global counts, the BatchNorms' and the losses' all-reduces,
    the summed gradients) against the same step of an engine without a group, under
    cudnn.deterministic: losses, Genh, every gradient and buffer bit for bit. Then the
    graphed grouped step (``_p14_graphed``) in a spawned process of its own; returns its
    launches per replay by case."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as tmp
    from segan_pytorch_tpu_torch.parallel import mesh

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain = _p14_step(_p14_engine("segan", torch.float32, P14_A_B), "segan", P14_A_B,
                          P14_A_VALID)
        dev = mesh.initialize_distributed(f"file://{work}/nccl_rendezvous", 1, 0, "cuda")
        try:
            backend = dist.get_backend()
            seg = _p14_engine("segan", torch.float32, P14_A_B)
            assert seg.grid is not None and (seg.grid.dp, seg.grid.mp) == (1, 1)
            grouped = _p14_step(seg, "segan", P14_A_B, P14_A_VALID)
            del seg
        finally:
            mesh.shutdown_distributed()
    finally:
        torch.backends.cudnn.deterministic = prev
    same = (plain[0] == grouped[0] and torch.equal(plain[1], grouped[1])
            and all(torch.equal(plain[i][k], grouped[i][k]) for i in (2, 3)
                    for k in plain[i]))
    print(f"14a NCCL ({backend}) at a world size of 1 on {dev}: the grouped SEGAN+ step "
          f"at B={P14_A_B} ({P14_A_VALID} valid) vs the ungrouped one under "
          f"cudnn.deterministic: bit for bit {same} over {len(plain[2])} gradients and "
          f"{len(plain[3])} buffers; launches {plain[4]} / {grouped[4]} ({smi})", flush=True)
    assert backend == "nccl" and same, (backend, plain[0], grouped[0])
    assert plain[4] == grouped[4] == 5, (plain[4], grouped[4])
    # the graphed grouped step in a process of its own, so that this one holds no
    # captured collectives and no communicator after 14a
    torch.cuda.empty_cache()
    ctx = tmp.start_processes(_p14_graphed_proc, args=(str(work), smi), nprocs=1,
                              join=False, start_method="spawn")
    deadline = time.time() + P14_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                raise TimeoutError(f"14a: the graphed process did not finish in "
                                   f"{P14_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return json.loads((work / "p14_graphed.json").read_text())


def _p14_rates(A, E, dtype, T):
    """The grouped SEGAN+ step's slices/s on the engines A (graphed) and E (eager) at
    each batch of P14_RATE_CALLS, with cuDNN's default algorithms: a first graphed call
    (warm-up step, capture) and an eager step untimed, then the timed calls of S
    sub-steps and as many eager steps. Returns {(batch, dtype): (graphed, eager)}."""
    import torch

    S, out = P14_GRAPH_S, {}
    for B, n in P14_RATE_CALLS.items():
        stacked, l1s = _graph_inputs("segan", B, T, S)
        A.train_step_multi(*stacked, l1_w_s=l1s)
        E.train_step(*[t[0] for t in stacked], l1s[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            A.train_step_multi(*stacked, l1_w_s=l1s)
        torch.cuda.synchronize()
        graphed = B * S * n / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(n):
            for i in range(S):
                E.train_step(*[t[i] for t in stacked], l1s[i])
        torch.cuda.synchronize()
        out[(B, dtype)] = (graphed, B * S * n / (time.perf_counter() - t0))
        A.release_multi_step()
    return out


def _p14_graphed(smi):
    """14a, in an NCCL group of one: the grouped step as a CUDA graph. For each case,
    under cudnn.deterministic, phase 10's check (``_graph_vs_eager``) read as equality:
    one ``train_step_multi`` call of S sub-steps against S eager grouped ``train_step``
    calls of a twin engine from the same state, losses, Genh and every parameter,
    buffer and optimizer tensor bit for bit; the all-reduces that the capture recorded
    against those of an eager grouped step; a call that only replays, with no host sync
    and the kernel's counter unmoved; from the profiler's device events the kernel's
    launches per replay (5 SEGAN+, 25 WSEGAN) and the collective kernels the replay
    ran. Then, with cuDNN's default algorithms, the grouped SEGAN+ step's slices/s
    graphed and eager at batch 300 and 16. Returns the kernel's launches per replay by
    case."""
    import gc
    import torch
    from segan_pytorch_tpu_torch.utils.config import SEGANConfig

    S = P14_GRAPH_S
    replay_launches, rates = {}, {}
    for label, kind, B, dtype, flags in P14_GRAPH_CASES:
        cfg = SEGANConfig(batch_size=B, compute_dtype=dtype, no_train_gen=True, **flags)
        torch.backends.cudnn.deterministic = True
        try:
            case = _graph_vs_eager(f"14a graphed grouped {label} (NCCL, world size 1)",
                                   kind, cfg, S, SEED + 1410, smi, exact=True)
        finally:
            torch.backends.cudnn.deterministic = False
        A, E = case["engines"]
        assert A.grid is not None and E.grid is not None
        replay_launches[f"grouped {label}"] = case["launches"]
        del case
        A.release_multi_step()
        if kind == "segan":  # the grouped step's speed, graphed and eager
            rates.update(_p14_rates(A, E, dtype, cfg.slice_size))
        del A, E
        gc.collect()
        torch.cuda.empty_cache()
    print("14a the grouped SEGAN+ step (NCCL, world size 1), slices/s graphed "
          f"(--steps_per_call {S}) vs eager: " + "; ".join(
              f"B={B} {dt} {g:.2f} vs {e:.2f} ({100 * (g / e - 1):+.1f} %) over "
              f"{S * P14_RATE_CALLS[B]} steps"
              for (B, dt), (g, e) in sorted(rates.items())) + f" ({smi})", flush=True)
    assert all(g > 0 and e > 0 for g, e in rates.values()), rates
    return replay_launches


def _p14_graphed_proc(_rank, work, smi):
    """``_p14_graphed`` in a process of its own, in an NCCL group of one joined as the
    CLI joins: its graphs and communicators end with it. Its result goes to
    work/p14_graphed.json."""
    from segan_pytorch_tpu_torch.parallel import mesh

    mesh.initialize_distributed(f"file://{work}/nccl_graph_rendezvous", 1, 0, "cuda")
    try:
        out = _p14_graphed(smi)
    finally:
        mesh.shutdown_distributed()
    (Path(work) / "p14_graphed.json").write_text(json.dumps(out))


def _p14_gloo_show(label, ranks, name):
    """Every rank's grouped call of two sub-steps on the gloo group refused, naming the
    backend, with nothing launched."""
    refusals = [r[name]["gloo_s2"] for r in ranks]
    print(f"{label} --steps_per_call 2 on the gloo group over CUDA tensors: every rank "
          f"refused ({refusals[0][0]!r}), kernel launches {[n for _, n in refusals]}",
          flush=True)
    assert all(msg is not None and "gloo" in msg and n == 0 for msg, n in refusals), \
        refusals


def _p14_tightest(grads, own, floor, apart=()):
    """D's tensors of `grads` (name: error) with their bounds, each max(floor, 4 x its
    error in `own`), the nearest to its bound first: [(name, error, bound)]."""
    rows = [(k, v, max(floor, 4 * own[k])) for k, v in grads.items()
            if k.startswith("D.") and k not in apart]
    return sorted(rows, key=lambda r: -r[1] / r[2])


def _p14_tight_show(label, rows, deterministic):
    print(f"{label}: D's tensors nearest their bounds: " + ", ".join(
        f"{k} {v:.3g} (bound {b:.3g})" for k, v, b in rows[:3])
        + f" (cuDNN's {'deterministic' if deterministic else 'default'} algorithms)",
        flush=True)


def _p14_show(label, summary, ranks, smi):
    for name, ref in summary.items():
        if "spread" in ref:
            spread = ref["spread"]
            print(f"{label} {name}, the one-process step against itself summed in another"
                  f" order (_p14_spread): losses worst "
                  f"{worst(spread['losses'].values()):.1e}, Genh {spread['Genh']:.1e}, "
                  f"gradients G all {spread['G all']:.1e}, D all {spread['D all']:.1e}",
                  flush=True)
        if "vs fp32" in ref:
            own = ref["vs fp32"]
            print(f"{label} {name}, one process vs its fp32 step: gradients G all "
                  f"{own['G all']:.1e}, D all {own['D all']:.1e}; the ranks' vs that fp32 "
                  "step: " + ", ".join(f"G all {r[name]['vs fp32']['G all']:.1e}, D all "
                                       f"{r[name]['vs fp32']['D all']:.1e}" for r in ranks),
                  flush=True)
        for r, res in enumerate(ranks):
            e = res[name]
            top = sorted(e["grads"], key=lambda k: -e["grads"][k])[:2]
            print(f"{label} {name} rank {r} (grid dp, mp, d, m = {e['grid']}, {e['backend']}"
                  f" on {e['device']}): losses " + ", ".join(
                      f"{k} {v:.1e}" for k, v in e["losses"].items())
                  + f"; Genh {e['Genh']:.1e}; gradients G all {e['G all']:.1e}, D all "
                  f"{e['D all']:.1e}, worst " + ", ".join(f"{k} {e['grads'][k]:.1e}"
                                                         for k in top)
                  + f"; launches {e['launches']} (one process: {ref['launches']}); the step "
                  f"{e['seconds']:.3f} s with the processes sharing one card (one process "
                  f"alone: {ref['seconds']:.3f} s; not a speed figure) ({smi})", flush=True)


def phase_dp(work: Path, smi: str) -> dict:
    """14 (A8, multi-GPU training) on the one card, every check fatal. (a) NCCL at a
    world size of 1 (``_p14_world_of_one``). (b) two processes sharing the card over
    gloo on CUDA tensors, SEGAN+ at full width, global batch 64 (50 valid rows, the
    mask's zeros on rank 1), fp32 and bf16 (cuDNN's algorithms: default in fp32,
    deterministic in bf16, P14_DETERMINISTIC): each rank's step against the one-process
    step of the same global batch and draws, D's learning rate 0: fp32 losses and Genh
    <= SLICE_TOL, D's gradients all together within max(SLICE_TOL, 4 x) and each within
    max(10 x SLICE_TOL, 4 x) the one-process step's own spread under another order of
    its sums (``_p14_spread``; 5b's form, the conv biases that feed a BatchNorm held
    apart), G's all together <= KINK_TOL, the
    running statistics <= SLICE_TOL; bf16 losses and Genh <= BF16_TOL, and, as 5b holds
    gradients to a reference's own error, each rank's gradients against the one-process
    fp32 step within 4 x the one-process bf16 step's distance from it (D's and G's all
    together, floors SLICE_TOL and KINK_TOL, each of D's, floor 10 x SLICE_TOL); both
    ranks' gradients equal (their checksums); 5 launches per rank. (c) four processes, dp 2 x
    mp 2, WSEGAN with its script's flags (spectral norm, the misaligned pair) at full
    width, global batch 16, fp32, D's head split: losses, Genh, u and v <= WS_TOL; D's
    gradients all together within max(WS_TOL, 4 x), each within max(10 x WS_TOL, 4 x),
    and G's all together within max(WS_G_TOL, 4 x) the one-process step's own spread
    (``_p14_spread``: 7a's form); 25 launches per rank. (d) ``enhance_sharded`` over two G replicas on
    cuda:0 against ``generate`` (fp32, 5 s: 5 chunks padded to 8) within
    P14_ENHANCE_TOL, 10 launches. Returns the launch counts."""
    import torch
    from segan_pytorch_tpu_torch.models.segan import SEGAN
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.parallel.inference import enhance_sharded
    from segan_pytorch_tpu_torch.utils.config import SEGANConfig

    t_phase = time.perf_counter()
    graphed = _p14_world_of_one(work, smi)
    t_a = time.perf_counter() - t_phase

    # the two groups run together (their steps' times are no speed figure): 14c's
    # one-process references are computed while 14b's processes run
    summary, join_b = _p14_group(work, 2, 1, "segan", ("float32", "bfloat16"), P14_B,
                                 P14_VALID)
    try:
        summary_c, join_c = _p14_group(work, 4, 2, "wsegan", ("float32",), P14_WS_B,
                                       P14_WS_B - 2)
    except BaseException:
        join_b()
        raise
    try:
        ranks = join_b()
    finally:
        ranks_c = join_c()
    _p14_show("14b SEGAN+ dp 2", summary, ranks, smi)
    _p14_gloo_show("14b", ranks, "float32")
    for name in ("float32", "bfloat16"):
        errs = [r[name] for r in ranks]
        assert all(e["launches"] == 5 for e in errs), [e["launches"] for e in errs]
        assert errs[0]["checksum"] == errs[1]["checksum"], name
        for e in errs:
            if name == "float32":
                # 5b's form: D's gradients against a reference within max(floor, 4 x the
                # reference's own error), here the one-process step's run-to-run spread
                own = summary[name]["spread"]
                assert worst(list(e["losses"].values()) + [e["Genh"]]) <= SLICE_TOL, e
                assert e["D all"] <= max(SLICE_TOL, 4 * own["D all"]), (e, own["D all"])
                assert e["G all"] <= KINK_TOL, e
                rows = _p14_tightest(e["grads"], own["grads"], 10 * SLICE_TOL, e["apart"])
                _p14_tight_show(f"14b SEGAN+ dp 2 {name}", rows,
                                name in P14_DETERMINISTIC)
                bad = {k: (v, own["grads"][k]) for k, v, b in rows if not v <= b}
                # the running statistics, from the global batch's count and sums
                bad.update({k: v for k, v in e["bufs"].items() if not v <= SLICE_TOL})
                assert not bad, bad
            else:
                # two bf16 steps of the ill-conditioned D differ as much as each differs
                # from fp32 (rounded gradients through sums that cancel): the ranks' bf16
                # gradients are held against the one-process fp32 step, as 5b holds the
                # card's, within 4 x the one-process bf16 step's own distance from it
                own, e32 = summary[name]["vs fp32"], e["vs fp32"]
                assert worst(list(e["losses"].values()) + [e["Genh"]]) <= BF16_TOL, e
                for side, floor in (("D all", SLICE_TOL), ("G all", KINK_TOL)):
                    assert e32[side] <= max(floor, 4 * own[side]), (side, e32, own)
                rows = _p14_tightest(e32["grads"], own["grads"], 10 * SLICE_TOL,
                                     e32["apart"])
                _p14_tight_show(f"14b SEGAN+ dp 2 {name} (vs the fp32 step)", rows,
                                name in P14_DETERMINISTIC)
                bad = {k: (v, own["grads"][k]) for k, v, b in rows if not v <= b}
                assert not bad, bad
    t_b = time.perf_counter() - t_phase - t_a

    summary, ranks = summary_c, ranks_c
    _p14_show("14c WSEGAN dp 2 x mp 2", summary, ranks, smi)
    _p14_gloo_show("14c", ranks, "float32")
    own = summary["float32"]["spread"]
    for e in (r["float32"] for r in ranks):
        assert e["launches"] == WS_PER_STEP, e["launches"]
        assert worst(list(e["losses"].values()) + [e["Genh"]]) <= WS_TOL, e
        assert e["D all"] <= max(WS_TOL, 4 * own["D all"]), (e["D all"], own["D all"])
        assert e["G all"] <= max(WS_G_TOL, 4 * own["G all"]), (e["G all"], own["G all"])
        rows = _p14_tightest(e["grads"], own["grads"], 10 * WS_TOL)
        _p14_tight_show("14c WSEGAN dp 2 x mp 2 float32", rows, False)
        bad = {k: (v, own["grads"][k]) for k, v, b in rows if not v <= b}
        bad.update({k: v for k, v in e["bufs"].items() if not v <= WS_TOL})
        assert not bad, bad

    G, _ = _train_models(SEGANConfig(no_bias=True), P14_SEED + 3)
    seg = SEGAN(SEGANConfig(no_bias=True), generator=G, device="cuda")
    rng = np.random.RandomState(P14_SEED + 4)
    wav = (rng.randn(5 * SR) * 0.1).astype(np.float32)
    z = rng.randn(1, 16, 1024).astype(np.float32)
    want, _ = seg.generate(wav, z=z)
    K.launches = 0
    got = enhance_sharded(seg, wav, devices=["cuda:0", "cuda:0"], z=z)
    torch.cuda.synchronize()
    d_launches = K.launches
    err = rel_err(torch.from_numpy(got), torch.from_numpy(want))
    print(f"14d enhance_sharded over two G replicas on cuda:0, fp32, 5 s (5 chunks, 8 rows)"
          f" vs generate: {err:.1e}, launches {d_launches} ({smi})", flush=True)
    assert got.shape == want.shape and err <= P14_ENHANCE_TOL and d_launches == 10, (
        err, d_launches)
    print(f"14: phase 14 took {time.perf_counter() - t_phase:.1f} s (a {t_a:.1f}, b and c "
          f"together {t_b:.1f}); NCCL ran at a world size of 1 only: it refuses two "
          "processes on one card", flush=True)
    return dict(segan=5, wsegan=WS_PER_STEP, enhance=d_launches, graph=graphed)


# ---- phase 15: the user tools on the card ----------------------------------------------
TOOLS_TRAIN_FILES = 150  # of 3 s: 4 slices of 16384 each at stride 0.5, two batches of 300
TOOLS_TEST_FILES = 4
# the soak's bounds. The card's memory.used may exceed its first sample (no reload yet) by
# a generation (the fp32 G's weights and the kernel's split copies: phase 9a measures it)
# for each replaced generation not yet retired (serve.RETIRE_SECONDS, 150 s in service,
# is longer than the soak) and one being built, plus SOAK_MARGIN_MIB for the caching
# allocator's rounding and cuDNN's workspaces. A replaced generation keeps its
# MicroBatcher's and WindowBatcher's threads and its retire thread until retirement.
SOAK_MARGIN_MIB = 512
SOAK_FD_DRIFT = 8
SOAK_THREADS_PER_RELOAD = 3
SOAK_THREAD_SLACK = 8  # the handler threads of requests in flight


class _LogTail:
    """The records of a logger and its children at DEBUG while open, with their seconds
    from the opening, for a failure's message."""

    def __init__(self, name):
        import logging

        self.logger, self.records = logging.getLogger(name), []
        tail = self

        class Keep(logging.Handler):
            def emit(self, record):
                tail.records.append(f"{record.created - tail.t0:8.3f} {record.name} "
                                    f"{record.levelname} {record.getMessage()}")

        self.handler = Keep()

    def __enter__(self):
        self.t0, self.level = time.time(), self.logger.level
        self.logger.addHandler(self.handler)
        self.logger.setLevel("DEBUG")
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)
        return False

    def text(self, last=60):
        return "\n".join(self.records[-last:]) or "(nothing logged)"


def _tool_run(work: Path, name: str, argv, timeout):
    """`argv` (a command line) in a subprocess from the checkout, in a session of its own
    (a tool's server is its child: on a timeout the whole group is killed), its output in
    work/<name>.log. Returns (output text, seconds); fails on a non-zero exit."""
    import signal as signal_mod

    argv = [str(a) for a in argv]
    log = work / f"{name}.log"
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen(argv, cwd=str(ROOT), stdout=f, stderr=subprocess.STDOUT,
                                env=dict(os.environ, PYTHONPATH=str(ROOT)),
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal_mod.SIGKILL)
            proc.wait(timeout=30)
            raise AssertionError(f"{name} ran over {timeout} s:\n" + log.read_text()[-3000:])
    text = log.read_text()
    assert rc == 0, f"{name} exited {rc}:\n{text[-3000:]}"
    return text, time.perf_counter() - t0


def _last_json(text: str) -> dict:
    return json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])


def _tools_checkpoints(work: Path):
    """A full-width SEGAN+ G (--no_bias, `_served_g`) and D (its PReLU slopes U(0, 0.3),
    BatchNorm's running statistics moved from their initial values), saved as
    reference-format .ckpt files, with train.opts. Returns (cfg, G, D, G.ckpt, D.ckpt,
    train.opts)."""
    import torch
    from segan_pytorch_tpu_torch.models.discriminator import build_discriminator
    from segan_pytorch_tpu_torch.utils.checkpoint import save_discriminator, save_generator
    from segan_pytorch_tpu_torch.utils.config import SEGANConfig, dump_train_opts

    cfg = SEGANConfig(no_bias=True, save_path=str(work))
    g = torch.Generator().manual_seed(SEED + 170)
    G, D = _served_g(cfg, g), build_discriminator(cfg, g)
    with torch.no_grad():
        for name, p in D.named_parameters():
            if name.endswith("act.weight") or name in ("fc.1.weight", "fc.3.weight"):
                p.uniform_(0.0, 0.3, generator=g)
        for name, b in D.named_buffers():
            if name.endswith("running_mean"):
                b.normal_(0.0, 0.1, generator=g)
            elif name.endswith("running_var"):
                b.uniform_(0.5, 1.5, generator=g)
    save_generator(G, str(work / "g.ckpt"))
    save_discriminator(D, str(work / "d.ckpt"))
    opts = dump_train_opts(cfg, str(work / "opts"))
    return cfg, G, D, work / "g.ckpt", work / "d.ckpt", opts


def phase_tools(work: Path, smi: str, rates: dict, checked: set, gen_bytes: float) -> dict:
    """15: the user tools at full SEGAN+ width on the card (see the module docstring).
    `rates` are phase 5c's and 6's slices/s, `checked` the layer shapes phases 3, 8 and 9
    held, `gen_bytes` 9a's generation. Returns the kernel's launches in the phase's
    in-process parts, by part."""
    import importlib.util
    import shutil
    import ssl
    import urllib.request
    import torch
    from scipy.io import wavfile
    from segan_pytorch_tpu_torch import eval_noisy_performance, weight_converter
    from segan_pytorch_tpu_torch.models.discriminator import build_discriminator
    from segan_pytorch_tpu_torch.models.generator import build_generator
    from segan_pytorch_tpu_torch.ops.kernels import conv1d_prelu as K
    from segan_pytorch_tpu_torch.tools import ab_parity, make_demo_corpus
    from segan_pytorch_tpu_torch.utils.checkpoint import load_discriminator, load_generator
    from segan_pytorch_tpu_torch.utils.engine import build_enhancement_engine

    t_phase = time.perf_counter()
    launches = {}
    calls = set()  # (B, Cin, T_in, Cout, K, stride, bias, dtype) of the in-process parts
    unrecord = _record_launches(calls)
    try:
        # 15a: the demo corpus, and the noisy test split scored
        corpus = work / "corpus"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            make_demo_corpus.main(["--out", str(corpus), "--n_train", str(TOOLS_TRAIN_FILES),
                                   "--n_test", str(TOOLS_TEST_FILES), "--seed", str(SEED)])
            t_corpus = time.perf_counter() - t0
            means = eval_noisy_performance.main([
                "--test_wavs", str(corpus / "noisy_testset"), "--clean_wavs",
                str(corpus / "clean_testset"), "--logfile", str(work / "noisy.log")])
        lines = (work / "noisy.log").read_text().splitlines()
        assert lines[0] == "FILE CSIG CBAK COVL PESQ SSNR", lines[:1]
        assert len(lines) == 1 + TOOLS_TEST_FILES, lines
        assert all(np.isfinite(v) for v in means.values()), means
        print(f"tools 15a: make_demo_corpus wrote {TOOLS_TRAIN_FILES} + {TOOLS_TEST_FILES} "
              f"pairs of 3 s in {t_corpus:.2f} s; eval_noisy_performance on the test split "
              f"in {time.perf_counter() - t0 - t_corpus:.2f} s: means "
              + ", ".join(f"{k.upper()} {v:.4f}" for k, v in means.items()), flush=True)

        # 15b: the converter round trip of a full-width G and D, bit for bit
        cfg, G, D, g_ckpt, d_ckpt, opts = _tools_checkpoints(work)
        t0 = time.perf_counter()
        shape = ["--dpool_slen", str(cfg.dpool_slen), "--last_fmaps", str(cfg.denc_fmaps[-1])]
        with contextlib.redirect_stdout(io.StringIO()):
            for which, src in (("G", g_ckpt), ("D", d_ckpt)):
                extra = ["--which", which] + (shape if which == "D" else [])
                weight_converter.main([str(src), "--out", f"{src}.npz", *extra])
                weight_converter.main([f"{src}.npz", "--to_torch", "--out", f"{src}.back",
                                       *extra])
        t_conv = time.perf_counter() - t0
        G2, D2 = build_generator(cfg), build_discriminator(cfg)
        load_generator(G2, f"{g_ckpt}.back")  # strictly
        load_discriminator(D2, f"{d_ckpt}.back")
        for a, b in ((G, G2), (D, D2)):
            sa, sb = a.state_dict(), b.state_dict()
            assert list(sa) == list(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
        g = torch.Generator().manual_seed(SEED + 171)
        x = (0.3 * torch.randn((4, cfg.slice_size, 1), generator=g)).cuda()
        z = G.sample_z((4, cfg.slice_size, 1), g).cuda()
        pair = (0.3 * torch.randn((4, 2, cfg.slice_size), generator=g)).cuda()
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True  # cuDNN's deconvs in a fixed order
        try:
            before = K.launches
            with torch.no_grad():
                y1, y2 = (m.cuda().eval()(x, z) for m in (G, G2))
                d1, d2 = (m.cuda().eval()(pair) for m in (D, D2))
            torch.cuda.synchronize()
            launches["convert"] = K.launches - before
        finally:
            torch.backends.cudnn.deterministic = deterministic
        d1, d2 = (d[0] if isinstance(d, tuple) else d for d in (d1, d2))
        assert launches["convert"] == 10, launches
        assert torch.equal(y1, y2) and torch.equal(d1, d2)
        print(f"tools 15b: weight_converter round trip (.ckpt -> npz -> .ckpt) of a "
              f"full-width G and D in {t_conv:.2f} s: strict loads, every tensor equal, "
              f"and on the card G's forward at B=4 ({launches['convert'] // 2} launches) and "
              f"D's equal the originals' bit for bit under cudnn.deterministic", flush=True)
        del G, G2, D, D2, y1, y2, d1, d2, x, z, pair

        # 15c: ab_parity on the test split, fp32 on the card
        before = _counters(K)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            report = ab_parity.main([
                "--g_ckpt", str(g_ckpt), "--cfg_file", opts, "--clean_test",
                str(corpus / "clean_testset"), "--noisy_test", str(corpus / "noisy_testset"),
                "--out", str(work / "parity.json"), "--seed", str(SEED)])
        t_ab = time.perf_counter() - t0
        # one G forward of 3 chunks per 3-s utterance, 5 launches each, 3xTF32 on the
        # tensor cores but enc1's FMA rows
        got = (K.launches - before[0], K.launches_mma - before[1],
               K.launches_tf32 - before[2])
        want = 5 * TOOLS_TEST_FILES
        tc = want - TOOLS_TEST_FILES * _g_routes(K, torch.float32, 3, 16384, False).count(
            "fma")
        assert got == (want, tc, tc), got
        launches["ab_parity"] = got[0]
        assert report["n_files"] == TOOLS_TEST_FILES and list(report["means"]) == [
            "noisy", "enh"], report["means"]
        assert all(np.isfinite(v) for row in report["rows"] for side in ("noisy", "enh")
                   for v in row[side].values())
        print(f"tools 15c: ab_parity (fp32, on the card) on {report['n_files']} files in "
              f"{t_ab:.2f} s, {got[0]} launches; means " + "; ".join(
                  f"{side} " + ", ".join(f"{k} {v:.3f}" for k, v in m.items())
                  for side, m in report["means"].items()) + " (random weights: no quality "
              "figure)", flush=True)
    finally:
        unrecord()

    # 15d: serving_bench against its own server process
    text, took = _tool_run(work, "serving_bench", [
        sys.executable, "-m", "segan_pytorch_tpu_torch.tools.serving_bench", "--g_ckpt",
        g_ckpt, "--cfg_file", opts, "--port", _free_port(), "--device", "cuda", "--dur",
        "2.0", "--reps", "8", "--concurrency", "4", "--window", "4096", "--stream_windows",
        "8", "--stream_concurrency", "2", "--startup_timeout", "120", "--log",
        work / "bench_server.log"], timeout=180)
    bench = _last_json(text)
    assert bench["metric"] == "serving_latency" and bench["enhance_p50_ms"] > 0, bench
    assert 1 <= bench["concurrent_device_passes"] <= 4, bench
    print(f"tools 15d: serving_bench (fp32, full width) in {took:.1f} s: {json.dumps(bench)} "
          f"({smi})", flush=True)

    # 15e: the soak, reloads every 4 s, samples every 2 s
    text, took = _tool_run(work, "serving_soak", [
        sys.executable, "-m", "segan_pytorch_tpu_torch.tools.serving_soak", "--g_ckpt",
        g_ckpt, "--cfg_file", opts, "--port", _free_port(), "--device", "cuda",
        "--minutes", "0.2", "--sample_s", "2", "--reload_s", "4", "--startup_timeout",
        "120", "--log", work / "soak_server.log", "--out", work / "soak.json"], timeout=180)
    soak = json.loads((work / "soak.json").read_text())
    v, counts, samples = soak["verdicts"], soak["counts"], soak["samples"]
    reloads = counts["reloads"]
    mem = np.array([s["card_memory_used_mib"] for s in samples], float)
    unretired = np.array([s["generations_unretired"] for s in samples])
    base = mem[unretired == 0][0]
    gen_mib = gen_bytes / 2 ** 20
    bound = base + (unretired + 1) * gen_mib + SOAK_MARGIN_MIB
    per_reload = (float(np.polyfit(unretired, mem, 1)[0]) if len(set(unretired)) > 1
                  else float("nan"))
    print(f"tools 15e: serving_soak of {soak['duration_min'] * 60:.0f} s in {took:.1f} s: "
          f"counts {counts}; verdicts {json.dumps(v)}; the card's memory.used (MiB, "
          f"generations not yet retired) "
          + ", ".join(f"{int(m)} ({u})" for m, u in zip(mem, unretired))
          + f"; least squares {per_reload:.1f} MiB per unretired generation (phase 9a's "
          f"generation {gen_mib:.1f} MiB); bound base + (unretired + 1) x generation + "
          f"{SOAK_MARGIN_MIB} MiB ({smi})", flush=True)
    assert sum(v["errors"].values()) == 0 and v["metrics_monotonic"], v
    assert reloads >= 2 and counts["enhance_ok"] > 0 and counts["stream_ok"] > 0, counts
    assert counts["auth401"] > 0, counts
    assert v["fd_drift"] <= SOAK_FD_DRIFT, v
    assert v["thread_drift"] <= SOAK_THREADS_PER_RELOAD * reloads + SOAK_THREAD_SLACK, v
    assert (mem <= bound).all(), list(zip(mem, bound))

    # 15f: train_throughput_bench at batch 300 on the demo corpus
    text, took = _tool_run(work, "train_throughput_bench", [
        sys.executable, "-m", "segan_pytorch_tpu_torch.tools.train_throughput_bench",
        "--corpus", corpus, "--batch_size", "300", "--epoch", "3", "--skip_epochs", "1",
        "--device", "cuda", "--save_path", work / "ttb"], timeout=300)
    ttb = _last_json(text)
    assert ttb["value"] > 0 and ttb["num_batches_per_epoch"] == 2, ttb
    print(f"tools 15f: train_throughput_bench (bf16, --steps_per_call 4, loader bf16) in "
          f"{took:.1f} s: {ttb['value']:.2f} slices/s over {ttb['steady_state_steps']} steps "
          f"(epochs 2-3, from epoch 1's last log line) beside phase 6's warm loop "
          f"{rates.get('run slices/s', float('nan')):.2f} (fp32, 3 steps) and 5c's bare bf16 "
          f"step {rates.get('bfloat16', float('nan')):.2f}; {json.dumps(ttb)} ({smi})",
          flush=True)

    # 15g: TLS /enhance and a WebSocket stream (root tools/ws_client.py) on the card
    have_tls = shutil.which("openssl") is not None
    have_ws = importlib.util.find_spec("websockets") is not None
    if not have_tls:
        print("tools 15g: the openssl command line is not installed on this machine: no "
              "certificate to serve TLS with, so the HTTPS request is left out", flush=True)
    if not have_ws:
        print("tools 15g: the websockets package is not installed on this machine: the "
              "WebSocket stream is left out", flush=True)
    launches["tls_ws"] = 0
    if have_tls or have_ws:
        extra = ["--warm_seconds", "0.5"]
        if have_tls:
            cert, key = work / "cert.pem", work / "key.pem"
            subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
                            "-keyout", str(key), "-out", str(cert), "-days", "1", "-subj",
                            "/CN=localhost"], check=True, capture_output=True, timeout=60)
            extra += ["--tls_cert", str(cert), "--tls_key", str(key)]
        if have_ws:
            ws_port = _free_port()
            extra += ["--ws_port", str(ws_port)]
        srv = _Served(g_ckpt, opts, *extra)
        try:
            srv.passes.clear()
            before = _counters(K)
            if have_tls:
                ctx = ssl.create_default_context()
                ctx.check_hostname, ctx.verify_mode = False, ssl.CERT_NONE
                body = _wav_body(40000, SEED + 180)
                with urllib.request.urlopen(urllib.request.Request(
                        f"https://{srv.host}/enhance?seed=31", data=body), context=ctx,
                        timeout=120) as r:
                    assert r.status == 200, r.status
                    answer = wavfile.read(io.BytesIO(r.read()))[1]
            if have_ws:
                pcm = _pcm(48000, SEED + 181)
                wavfile.write(str(work / "ws_in.wav"), SR, pcm)
                with _LogTail("websockets") as ws_log:  # the server's side, on a failure
                    try:
                        text, _ = _tool_run(work, "ws_client", [
                            sys.executable, ROOT / "tools" / "ws_client.py", "--url",
                            f"{'wss' if have_tls else 'ws'}://127.0.0.1:{ws_port}"
                            "/enhance_stream", "--in", work / "ws_in.wav", "--out",
                            work / "ws_out.wav", "--seed", "32", "--window", "16384",
                            "--overlap", "0.25", *(["--insecure"] if have_tls else [])],
                            timeout=120)
                    except AssertionError as e:
                        raise AssertionError(f"{e}\nthe server's websockets log (seconds "
                                             "from the client's start):\n"
                                             + ws_log.text()) from None
                info = _last_json(text)
                streamed = wavfile.read(str(work / "ws_out.wav"))[1]
            passes = [(r, n) for _, r, n, _ in srv.passes]
            launches["tls_ws"] = int(_expect_launches(K, before, passes, False, True)[0])
        finally:
            srv.stop()
        calls |= srv.calls
        _, ref = build_enhancement_engine(opts, str(g_ckpt), SEED, device="cuda")
        if have_tls:
            pw = _prep(body, ref.preemph)
            e = _rel_beyond(answer, ref.generate(pw, z=_seed_z(ref.G, 31))[0])
            ctrl = _rel_beyond(answer, ref.generate(pw, z=_seed_z(ref.G, 32))[0])
            print(f"tools 15g: HTTPS /enhance (2.5 s, a self-signed certificate from openssl)"
                  f" vs generate() with its z rel err {e:.3e} (bound "
                  f"{SERVE_TOL['float32']:g}; control, another seed's z, {ctrl:.3e})",
                  flush=True)
            assert answer.shape == (40000,) and e <= SERVE_TOL["float32"] < ctrl, (e, ctrl)
        if have_ws:
            import websockets

            want = _offline_pcm(ref, pcm, 16384, 0.25, 32)
            e = _rel_beyond(streamed, want, step=1)
            ctrl = _rel_beyond(streamed, _offline_pcm(ref, pcm, 16384, 0.25, 33), step=1)
            print(f"tools 15g: WebSocket stream ({'wss' if have_tls else 'ws'}, websockets "
                  f"{websockets.__version__}) through tools/ws_client.py, 3 s in "
                  f"{info['wall_seconds']} s: vs the offline path rel err {e:.3e} beyond 1 "
                  f"LSB (bound {STREAM_TOL['float32']:g}; control {ctrl:.3e}); {passes} G "
                  f"forwards (rows, samples), {launches['tls_ws']} launches", flush=True)
            assert streamed.shape == pcm.shape and info["samples_out"] == pcm.size
            assert e <= STREAM_TOL["float32"] < ctrl, (e, ctrl)
        del ref

    # 15h: the kernel at every layer shape the tools reached that phases 3, 8 and 9 did
    # not hold: the tools' own server processes run G forwards of 1-8 rows of 16384
    # (warm-ups of 1, 2, 4 and 8 rows, coalesced requests of up to 4 x 2 chunks) and
    # stream windows of 4096 at 1-2 rows; their trainer the batch-300 step
    tools = ({l for b in range(1, 9) for l in _g_layers(b, 16384, False)}
             | {l for b in (1, 2) for l in _g_layers(b, 4096, False)}
             | set(_g_layers(300, 16384, False)))
    held3 = {l for b in (1, 8, 64, 300) for l in _g_layers(b, 16384, False)}
    ran = {c[:7] for c in calls}
    new = (tools | ran) - checked - held3
    print(f"tools 15h: the tools reach {len(tools | ran)} layer shapes ({len(ran)} recorded "
          f"in this process); {len(new)} were not held by phases 3, 8 and 9, in fp32 and "
          f"bf16:", flush=True)
    if new:
        _hold_kernel(new, SEED + 190)
    print(f"tools: phase 15 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def _phase(label, fn, *args, workdir=False):
    """fn(*args) (with a new work directory under build/ first when `workdir`), its
    seconds printed and kept for the total."""
    t0 = time.perf_counter()
    if workdir:
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
            out = fn(Path(work), *args)
    else:
        out = fn(*args)
    PHASE_SECONDS[label] = time.perf_counter() - t0
    print(f"[time] phase {label}: {PHASE_SECONDS[label]:.1f} s", flush=True)
    return out


PHASE_SECONDS = {}


def main():
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import segan_pytorch_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = _phase("1", phase_device)
    _phase("2", phase_build)
    per_layer, wgmma64, wgmma64_tf32, rows3 = _phase("3", phase_kernel)
    enc23_abs, enc23_ms, enc23_device = _phase("3b", phase_enc23)
    tool, tool_launches = _phase("3c", phase_tool)
    _phase("3d", phase_tf32)
    launches, launches_mma, launches_tf32, wgmma_bf16, wgmma_fp32, rows_bf16 = _phase(
        "4", phase_slice, workdir=True)
    _phase("5a", phase_train_kernel)
    _phase("5b", phase_train_parity)
    train_per_step, train_rates, train_wgmma = _phase("5c", phase_train_b300)
    train_run = _phase("6", phase_train_run, train_rates, workdir=True)
    _phase("7a", phase_wsegan_parity)
    ws_per_step, ws_times = _phase("7b", phase_wsegan_b150, {
        "float32": per_layer["fp32_wsegan_step_kernel_ms"],
        "bfloat16": per_layer["wsegan_step_kernel_ms"]})
    ws_run = _phase("7c", phase_wsegan_run, workdir=True)

    def serve_and_reload(work):
        ckpts = _serving_checkpoints(work)
        serve, checked = _phase("8", phase_serve, work, smi, ckpts)
        reload, gen_bytes, checked = _phase("9", phase_reload, work, smi, ckpts, checked)
        return serve, reload, gen_bytes, checked

    serve_launches, reload_launches, gen_bytes, checked = _phase(
        "8-9", serve_and_reload, workdir=True)
    graph = _phase("10", phase_graph, smi, train_rates, workdir=True)
    data_opts = _phase("11", phase_data_options, train_rates, workdir=True)
    a7a = _phase("12", phase_a7a, smi, workdir=True)
    a7bc = _phase("13", phase_a7bc, smi, workdir=True)
    p14 = _phase("14", phase_dp, smi, workdir=True)
    tools = _phase("15", phase_tools, smi, train_rates, checked, gen_bytes, workdir=True)
    print("[time] " + ", ".join(f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items()
                                if k not in ("8", "9"))
          + f"; total {time.perf_counter() - t_start:.1f} s ({smi})", flush=True)
    # the tool's shapes, batch 300 with biases; cuDNN's two convs and the FMA kernel
    # forced at batch 300 from phase 3b
    flops, nbytes = enc23_work(300, 4096, 64, 128, 256, True, 2)
    bf16, fp32 = (enc23_ms[torch.bfloat16][300], enc23_ms[torch.float32][300])
    bound_fp32 = min(bound_ms(flops, 2 * nbytes, FP32_PEAK),
                     bound_ms(3 * flops, 2 * nbytes, TF32_PEAK))
    measured = [
        dict(launches=launches, launches_mma=launches_mma, launches_tf32=launches_tf32,
             launches_wgmma=wgmma_bf16 + wgmma_fp32, train_launches_per_step=train_per_step, train_run_launches=train_run,
             wsegan_train_launches_per_step=ws_per_step, wsegan_run_launches=ws_run,
             serve_launches=serve_launches[0], serve_launches_mma=serve_launches[1],
             serve_launches_tf32=serve_launches[2], serve_launches_wgmma=serve_launches[3],
             reload_launches=reload_launches[0], reload_launches_mma=reload_launches[1],
             reload_launches_tf32=reload_launches[2],
             reload_launches_wgmma=reload_launches[3], launches_rows=rows_bf16,
             serve_launches_rows=serve_launches[4], reload_launches_rows=reload_launches[4],
             graph_launches_per_replay=dict(graph, **p14["graph"]),
             data_options_launches=data_opts["total"],
             data_options_launches_segan=data_opts["segan"],
             data_options_launches_h5=data_opts["h5"],
             data_options_launches_wsegan=data_opts["wsegan"],
             **{f"{p}wsegan_step_{k}": v for p, dt in (("", "bfloat16"), ("fp32_", "float32"))
                for k, v in ws_times[dt].items()},
             a7a_bnorm_launches_per_step=a7a["bnorm_launches_per_step"],
             a7a_sinc_segan_launches_per_step=a7a["sinc_segan_launches_per_step"],
             a7a_sinc_wsegan_launches_per_step=a7a["sinc_wsegan_launches_per_step"],
             **{f"{p}sinc_d_{k}": v for p, c in a7a["sinc_d"].items()
                for k, v in c.items()},
             a7b_g1d_launches_per_forward=a7bc["launches_per_forward"],
             a7b_g1d_launched=a7bc["launched"],
             **{f"{p}g1d_enc_{k}": v for p, c in a7bc["enc"].items() for k, v in c.items()},
             p14_segan_launches_per_rank_step=p14["segan"],
             p14_wsegan_launches_per_rank_step=p14["wsegan"],
             p14_enhance_sharded_launches=p14["enhance"],
             tools_launches=sum(tools.values()),
             **{f"tools_{k}_launches": v for k, v in tools.items()},
             **per_layer),
        # encoder_fused.cu: on the tool's path forced onto mma.sync in both dtypes (3c:
        # fp32 enc23_tf32_kernel, its times); bf16 mma.sync forced at batch 300 (3b)
        dict(launches=tool_launches["fused_enc23_fwd mma.sync"],
             launches_tf32=tool_launches["fused_enc23_fwd tf32"],
             max_abs_err=enc23_abs["tf32 forced"], ms=tool["float32"]["ms"]["fused mma.sync"],
             plain_ms=tool["float32"]["ms"]["plain chain"], bound_ms=bound_fp32,
             bound_by="operations", library_ms=fp32["cuDNN x2"], fma_ms=fp32["fma"],
             device_ms=enc23_device[torch.float32][300]["fused tf32"],
             bf16_mma_ms=bf16["mma.sync"],
             bf16_mma_device_ms=enc23_device[torch.bfloat16][300]["fused mma.sync"]),
        # the wgmma kernels, bf16 and fp32: phase 4's launches, and 5c's in five train
        # steps at batch 300; their layers of G at 64 chunks (phase 3)
        dict(launches=wgmma_bf16, train_launches=train_wgmma["bfloat16"], **wgmma64,
             g1d_launches_per_forward=a7bc["launched"]["bf16"][3],
             g1d_device_ms=a7bc["enc"][""].get("wgmma_device_ms", 0.0)),
        dict(launches=wgmma_fp32, train_launches=train_wgmma["float32"], **wgmma64_tf32,
             g1d_launches_per_forward=a7bc["launched"]["fp32"][3],
             g1d_device_ms=a7bc["enc"]["fp32_"].get("wgmma_device_ms", 0.0)),
        # encoder_fused_wgmma.cu: the tool's bf16 run at batch 300 (phase 3c); device_ms
        # from phase 3b's CUDA graphs, beside the pitched per-layer pair's and cuDNN's
        dict(launches=tool_launches["fused_enc23_fwd wgmma"],
             max_abs_err=enc23_abs[torch.bfloat16], ms=tool["bfloat16"]["ms"]["fused 2+3"],
             plain_ms=tool["bfloat16"]["ms"]["plain chain"],
             bound_ms=bound_ms(flops, nbytes, BF16_PEAK), bound_by="operations",
             library_ms=bf16["cuDNN x2"], kernel_x2_ms=tool["bfloat16"]["ms"]["kernel x2"],
             **{f"{pre}{arm}device_ms": enc23_device[torch.bfloat16][b][name]
                for b, pre in ((300, ""), (64, "b64_"), (1, "b1_"))
                for name, arm in (("fused wgmma", ""), ("fused mma.sync", "mma_"),
                                  ("kernel x2", "kernel_x2_"), ("cuDNN x2", "library_"))}),
        # conv1d_rows.cu: phase 4's bf16 launches (one-chunk passes' enc3-5), the served
        # passes' (phases 8 and 9); its times one chunk's enc3-5 summed (phase 3)
        dict(launches=rows_bf16, serve_launches=serve_launches[4],
             reload_launches=reload_launches[4], **rows3),
        # encoder_fused_wgmma_tf32.cu: the tool's fp32 run at batch 300 (phase 3c: its
        # call, enc23_tf32_kernel's as tf32_ms); at 1 and 64 chunks calls in turns, and
        # device_ms at 300, 64 and 1 beside enc23_tf32_kernel's, the pitched per-layer
        # pair's and cuDNN's, from 3b
        dict(launches=tool_launches["fused_enc23_fwd wgmma_tf32"],
             max_abs_err=enc23_abs[torch.float32], ms=tool["float32"]["ms"]["fused 2+3"],
             plain_ms=tool["float32"]["ms"]["plain chain"], bound_ms=bound_fp32,
             bound_by="operations", library_ms=fp32["cuDNN x2"],
             kernel_x2_ms=tool["float32"]["ms"]["kernel x2"],
             tf32_ms=tool["float32"]["ms"]["fused mma.sync"],
             **{f"b{b}_{key}": enc23_ms[torch.float32][b][arm] for b in (1, 64)
                for key, arm in (("ms", "fused 2+3"), ("tf32_ms", "tf32"),
                                 ("plain_ms", "plain chain"), ("library_ms", "cuDNN x2"),
                                 ("bound_ms", "bound"))},
             **{f"{pre}{arm}device_ms": enc23_device[torch.float32][b][name]
                for b, pre in ((300, ""), (64, "b64_"), (1, "b1_"))
                for name, arm in (("fused wgmma_tf32", ""), ("fused tf32", "tf32_"),
                                  ("kernel x2", "kernel_x2_"), ("cuDNN x2", "library_"))}),
    ]
    print(json.dumps({"kernels": [dict(k, **m) for k, m in zip(KERNELS, measured)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
