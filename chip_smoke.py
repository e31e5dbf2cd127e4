#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``theanompi_tpu_torch``) on one
NVIDIA card, driven through the port's own entry points.

    python3 chip_smoke.py          # from the repository root; one card

Phases (each one fails the run, with a non-zero exit, if it fails):

1. Device: the card's name and power limit (nvidia-smi).  No card: exit.
2. Build: compile every kernel under ``theanompi_tpu_torch/csrc/`` with
   nvcc for sm_90a (one nvcc per source, in parallel); print each
   ``-Xptxas -v`` report, the build seconds and each max-pool kernel
   instance's and each K1c/K1d instance's registers and spills (a K2b,
   K2c, K1c or K1d spill fails the run).
3. Kernels against their plain PyTorch versions on the card, at the
   shapes one batch-32 ResNet-50 forward gives them: the fused BN
   epilogue K1a/K1b at every (rows, C) the forward launches (bf16) plus
   a ragged f32 case, tolerance 1 ulp (the kernel rounds after each op,
   as the plain version does, so it is expected to be bit-exact); the
   stem max-pool K2a at (32, 112, 112, 64) bf16 with NaNs and an
   all-(-inf) window, exact.  Device times from CUDA graphs of many
   launches, timed with CUDA events.
4. The slice: a full-width ResNet-50 (stages (3, 4, 6, 3), width 64,
   1000 classes, conv7 stem, bf16) with random weights from a seed,
   exported with ``export_model`` and served by ``InferenceServer`` on
   the card; a few dozen 1-4 row uint8 224x224 requests from several
   threads.  Checks: coalescing (``max_occupancy > 1``), the launch
   counts of the run (K1a = 37, K1b = 16, K2a = 1 per batch), and the
   answers of a subset of rows against the same weights in f32 through
   the plain versions on the CPU (per-row relative L2 error <= 0.05 and
   top-1 agreement on >= 90% of rows: bf16 keeps 8 bits of mantissa
   through 53 layers).
   Then one batch-32 ``InferenceSession.infer`` is timed on the host
   clock and traced with ``torch.profiler`` (device time by kernel
   family; device idle share against the unprofiled host time).
5. The training kernels against their plain versions on the card, at
   the shapes one batch-128 ResNet-50 training step gives them: the BN
   epilogue backward K1c/K1d at every (rows, C) of the step (bf16) plus
   a ragged f32 case, dx and dres bit-exact and ds/db per channel
   within 1e-5 of the sum of |g*x| (|g|) (the kernel and the plain
   version sum in different orders), and ds/db bit-identical when the
   same inputs are launched again and once on each of two streams at
   the same time (one launch a call, its reduction order fixed by
   (rows, C, dtype)); the argmax pool K2b and the
   gather backward K2c at (128, 112, 112, 64) bf16 with ties, NaNs and
   an all-(-inf) window, and at ``K2_EDGE_SHAPES`` (the edges of their
   tiles) in bf16 and f32 with pixels whose gradient sum depends on the
   order, y's bits, idx and dx exact.  Times as in phase 3, beside each
   kernel's byte bound, its plain version and, where one PyTorch call
   computes the same function, that call (never used by the port).
   The forward K1a/K1b are timed again at the batch-128 shapes.
6. The training slice.
   (a) Gradient check: seeded weights on a full-width bf16 ResNet-50 on
   the card, and in f32 and in bf16 on the CPU (plain versions), one
   BSP step each on the same 8 uint8 images with the same explicit crop
   offsets and flips.  At exit-BN scales 0.05-0.1: loss within relative
   1e-2 and the updated BN running statistics within relative L2 0.05
   of f32; relative L2 error of the flattened gradient <= 0.1 against
   f32 and against the CPU's bf16 step (bf16 itself is about 0.05 from
   f32 there; see ``grad_check``).  Phase 4's weights are measured too.
   (b) ``run_bsp_session`` on a one-rank NCCL process group: ResNet-50
   at batch 128, bf16, synthetic ImageNet (pool 64, store 256,
   on-device augment), 24 steps in one epoch and a 2-batch validation.
   Checks: launches per training step exactly K1a 37, K1b 16, K1c 37,
   K1d 16, K2b 1, K2c 1, K2a 0, and K2a once per validation batch;
   every loss finite.  Prints images/s and ms per step and the
   gradient copies the K1 backward made.
   (c) One training step on a staged batch, timed (the device-step
   leg) and traced with ``torch.profiler``: device time by family and
   the idle share against the unprofiled step; exactly 37 K1c and 16
   K1d kernel events a step, and no other kernel filed under the K1
   backward family; the step's memsets (events and ms) beside that
   family, since each K1c/K1d call zeroes its tickets with one.
7. The LRN kernels K3a/K3b against their plain versions on the card, at
   AlexNet's batch-128 shapes (128x55x55x96 and 128x27x27x256) in bf16
   and f32, n=3 at C=32, n=4 (the adjoint window), a ragged row count, a
   C that is not a multiple of the vector width, a misaligned tensor, a
   16-byte aligned one that does not start its buffer, C 1, 7, 9 and
   4096 with n from 1 to 9 and wider than 2C + 1, one row, and the
   kernels' rows per tile less and plus one: 0 ulp (the kernels do the
   plain versions' f32 operations in their order and round once).
   Times at the bf16 AlexNet shapes beside the byte bound, the plain
   versions and ``F.local_response_norm``, and each kernel instance's
   registers and spills from phase 2.
8. One AlexNet BSP step (batch 8, 227 crops, dropout off) as bf16 on
   the card and as f32 and bf16 on the CPU (plain versions): loss within
   relative 1e-2, the flattened gradient within relative L2 0.1 of f32
   and of the CPU's bf16 step.
9. The AlexNet slice through the launcher a user runs: ``python -m
   theanompi_tpu_torch.launcher BSP -D 1 -m
   theanompi_tpu_torch.models.alex_net -c AlexNet`` (one worker, a
   one-rank NCCL group, batch 128, bf16, the default synthetic pool, two
   epochs of 64 steps).  Checks: per training step exactly K3a 2 and
   K3b 2 launches and none of K1/K2, K3a 2 per validation batch, every
   loss finite.  Prints ms per step and images/s of the second epoch.
10. One AlexNet training step on a staged batch, timed and traced as in
   6c: device time by family and the idle share.
11. Result lines: a ``{"kernels": [...]}`` JSON line (every kernel with
   its id K1a .. K4b; K4b is two kernels, its row and column pass), the
   card line, and last ``{"ok": true, "device": {...}}``.
12. The attention kernels K4a (forward) and K4b (backward: row pass for
   dq, column pass for dk and dv) against their plain versions on the
   card: the slice's (8, 1024, 12, 64) causal in bf16 (the tensor-core
   route) and f32 (the CUDA-core route), a non-causal case, Tq != Tk
   with global positions, rows that see no key, ragged T (1000, 77),
   d_head 32, shuffled positions, a query tile straddling the no-key
   border, a ragged Tk (130 against Tq 65), d_head 40, d_head 20 (not a
   multiple of 8: plain loads instead of cp.async) and 66 000 keys (the
   bf16 kernels plan 1024 key tiles at a time), within the limits of
   ``attention.tolerance_excess``.  Times at the slice's bf16 shape
   beside each kernel's bound (bf16 tensor-core rate), the plain versions
   and ``F.scaled_dot_product_attention``, and the same kernels' times
   without the causal mask (what causal tile skipping saves).
13. One BSP step of a seeded full-width TransformerLM (12 layers,
   d_model 768, 12 heads, vocab 256) as bf16 on the card and as f32
   and bf16 on the CPU (plain attention), on the same 2 x 1024 tokens:
   loss within relative 1e-2, the flattened gradient within relative L2
   0.1 of f32 and of the CPU's bf16 step.
14. The transformer slice: ``run_bsp_session`` on the one-rank NCCL
   group, ``tools/bench_lm.py``'s recipe (batch 8 of 1024 tokens, bf16
   on f32 master weights, AdamW 1e-3, weight decay 0.01, constant) on
   ``SeqLM_data(vocab=256, seq_len=1024, n_train=256, n_val=16)``: one
   epoch of 32 steps and 2 validation batches.  Checks: per training
   step exactly 12 K4a and 12 of each K4b kernel, 12 K4a per validation
   batch, none of K1/K2/K3; every loss finite and the last below the
   first.  Prints tokens/s per card, ms per step and TFLOP/s (from
   ``train_flops_per_sample``).
15. One TransformerLM training step on a staged batch, timed and traced
   as in 6c: device time by family, the idle share and peak memory.
16. Checkpoint and resume on the card, through the launcher a user runs
   (``python -m theanompi_tpu_torch.launcher BSP -D 1 -m
   theanompi_tpu_torch.models.resnet50 -c ResNet50``): full-width
   ResNet-50 at batch 128, bf16 on f32 master weights, on shard files of
   8 training and 2 validation batches cut from the synthetic pool
   (``--set data_dir=...``), ``n_epochs=3``, a checkpoint per epoch.
   The port's ``prepare_imagenet_shards`` writes that tree, first as npz
   and again as npy pairs: no npz shard may be left, and the manifest's
   counts must be the arrays'.
   (a) Unbroken, twice; the first with ``THEANOMPI_TPU_PROFILE`` over 3
   steps.  (b) ``--epochs 2`` with a fault plan that truncates epoch 1's
   checkpoint after its manifest is written, then ``--resume --epochs
   2``: epoch 1 is found corrupt and quarantined, epoch 0 restored,
   epochs 1-2 run again and epoch 1 saved again, verifying.  (c)
   ``--max-restarts 1`` with ``CrashOnceResNet50`` (this script's model
   class: it raises at step 3 of epoch 1 in its first life only): the
   launcher restarts the group with ``--resume``.  (a), (b)'s first run
   and (c) go side by side on the card, then (b)'s resume.  Checks: (b)
   and (c)
   end with epochs 0-2 in their records and ``epochs_run`` 2 (a: 3),
   finite losses and the launches of phase 6b per step and per
   validation batch; each restore's state digest (parameters, buffers,
   momentum, step) equals the one taken at save; the final state
   digests of (b) and (c) equal (a)'s when the two unbroken runs agree
   bit for bit, else their final states are within ``CKPT_MARGIN``
   times the two unbroken runs' relative L2 of (a)'s; the profiler's
   trace names K1a-K1d, K2b and K2c among its kernel events.  Prints
   the training thread's pause per save, the background write and
   manifest digest seconds, the restore seconds and the checkpoint's MB.

17. The rest of the BSP step on the card: full-width ResNet-50 at batch
   128, bf16 on f32 master weights, seeded weights, on a one-rank NCCL
   group, the model's steps driven on staged synthetic batches.
   (a) Exchange modes, one model each from the same weights: after
   1 + ``P17_ROUNDS`` steps f32 at 4 buckets (overlapped with the
   backward) ends bit-identical to f32 at 1 bucket, and so does
   ``exchange_what='params'`` (one rank); the bf16 wire's exchanged
   gradients equal bf16->f32 of the captured gradients on step 1, bit for
   bit; with error feedback at 1 and at 4 buckets the residual after step
   1 is ``g - bf16(g)`` exactly and the two end bit-identical.  Where two
   f32 one-bucket models differ, their difference is the limit, and the
   phase says so.  (b) adam, rmsprop and lars (momentum 0.9, weight
   decay 5e-5): after each of ``P17_OPT_STEPS`` steps the card's
   parameters are within ``P17_OPT_REL`` of each parameter's largest
   value of the same optimizer class run on the CPU from the card's own
   gradients; losses finite.  (c) ``steps_per_call = 4`` over
   ``P17_BATCHES`` batches ends bit-identical to as many single calls;
   ``grad_accum_steps = 2`` at microbatch 64 takes 4 updates with finite
   losses and launches, per
   update, exactly twice phase 6b's per-step counts of K1a-K1d, K2b and
   K2c.  (e) Times: every model of (a)-(c) takes its next dispatch in
   turn, ``P17_ROUNDS`` rounds, each between synchronises; medians per
   step of the host enqueue, the host wall and the CUDA event span; the
   f32 4-bucket run's host enqueue less the 1-bucket run's is what the
   161 gradient hooks cost the host (one rank: no overlap to show).
   (d) The launcher with
   lars, ``grad_accum_steps=2``, the bf16 wire, error feedback and 4
   buckets on phase 16's shard files (2 epochs of 4 updates): stopped
   after epoch 0 and resumed, it ends with the unbroken run's state
   digests, residual included (the unbroken run and the first life run
   side by side on the card).

18. The classifier zoo, on one card.  (a) One BSP step of seeded
   full-width VGG16 and GoogLeNet (batch 8, their recipes' inits and
   SGD, dropout off, GoogLeNet's loss with both aux terms) in f32 and
   in bf16 on the card, each through a training step's K1 (and K3)
   launches, and in f32 and bf16 on the CPU (plain versions), on the
   same 8 uint8 images, crops and flips.  The f32 card step against the
   f32 CPU step: loss within relative 1e-5, the flattened gradient
   within relative L2 2e-3 and each parameter's within 0.05.  The bf16
   card step: loss within relative 1e-2 of f32, the flattened gradient
   within relative L2 0.1 of both CPU steps.  (b)
   ``run_bsp_session`` on a one-rank NCCL group: VGG16 and GoogLeNet at
   batch 64, bf16, synthetic ImageNet with on-device augment, 16 steps;
   Cifar10 at batch 128, f32, its synthetic pool (32 steps); and 8 steps
   each of VGG16 with ``batch_norm``, AlexNet with ``batch_norm`` (batch
   128), ResNet-101 and ``resnet50_large`` (batch 128).  Each run: exact
   launches per training step and per validation batch (VGG16 13 K1a +
   13 K1c; GoogLeNet 59 K1a + 59 K1c + 2 K3a + 2 K3b, eval 57 K1a + 2
   K3a; Cifar10 2 K3a + 2 K3b; BN AlexNet 5 + 5 K1 and 2 + 2 K3;
   ResNet-101 71/33/71/33 of K1a-K1d and K2b/K2c 1; resnet50_large
   ResNet-50's), every loss finite; images/s and ms per step.  (c) The
   launcher: ``python -m theanompi_tpu_torch.launcher BSP -D 1 -m
   theanompi_tpu_torch.models.googlenet -c GoogLeNet`` and ``-m
   theanompi_tpu_torch.models.cifar10 -c Cifar10_model``, one epoch of
   the default recipe and data each, side by side on the card, with the
   launches of (b) per step and per validation batch and finite losses.
   (d) K1a/K1c at unit
   scale at every (rows, C) of a batch-64 VGG16 and GoogLeNet training
   forward, y and dx exact against the plain versions (K1c's ds/db as
   in phase 5, bit-identical over repeated and two-stream launches), and
   K3a/K3b at GoogLeNet's (64, 56, 56, 64/192) bf16 n = 5 and Cifar10's
   (128, 15/7, 15/7, 32) f32 n = 3 shapes, 0 ulp; summed per training
   step beside the byte bound, the plain versions and (K3)
   ``F.local_response_norm``.

19. The WGAN, the npz snapshots and ``sync_bn``, on one card.  (a) One
   round of a seeded full-width WGAN (width 64, batch 64 a critic slice,
   n_critic 5, f32) on the card and on the CPU (and in f64 there) from
   the same weights, real rows and noise: both losses within relative
   1e-5, each network's update within ``WGAN_LIMITS`` in relative L2,
   every critic weight within 0.01, none of the 11 kernels launched;
   then ms per round on the card (median of timed rounds).  (b)
   ``python -m theanompi_tpu_torch.launcher BSP -D 1 -m
   theanompi_tpu_torch.models.wasserstein_gan -c Wasserstein_GAN
   --epochs 1`` on the synthetic CIFAR pool: finite losses, no kernel
   launched, the clip held in its checkpoint, ms per round and images/s;
   that model's ``save``, ``load`` into a fresh one and ``generate(8,
   seed=1)`` bit for bit, the npz holding the flax paths and shapes of
   ``WGAN_NPZ``.  (c) On a one-rank NCCL group: ResNet-50 at batch 128,
   bf16, ``SYNC_BN_STEPS`` steps with ``sync_bn`` bit-identical to the
   same steps without it and with phase 6's launches per step, then ms
   per step both ways; and 8 steps of VGG16 with ``batch_norm`` and
   ``sync_bn`` through ``run_bsp_session`` with phase 18's launches.

20. ZeRO-1 and FSDP, on one card and a one-rank NCCL group.  (a) The
   ResNet-50 recipe (batch 128, bf16, seeded weights, staged batches)
   under ``P20_RUNS``: ZeRO at 1 and 4 buckets, with the bf16 wire and
   error feedback at 4, with adam, with ``grad_accum_steps = 2``; FSDP at
   1 and 4 buckets, with lars, with ``steps_per_call = 2``; each
   ``P20_STEPS`` steps beside its plain-BSP twin of ``P20_TWINS``, and
   bit-identical to it: parameters, BN running statistics, per-parameter
   optimizer state (ZeRO's shard gathered and cut into parameters) and
   residual.  Launches exactly phase 6b's per step (twice per
   accumulated update).  Each run's bytes a rank (parameters, optimizer
   state, residual), resident memory and peak above it; then
   ``P20_ROUNDS`` rounds of every run's next dispatch, ms per step (host
   wall, CUDA events).  (b) ``python -m theanompi_tpu_torch.launcher BSP
   -D 1`` on phase 16's shard files under each knob of ``P20_SETS`` (2
   epochs of 4 updates): unbroken, and stopped after epoch 0 and
   resumed, the two ending on the same state digests; the ZeRO
   checkpoint resumed under ``exchange_buckets=2`` must exit non-zero on
   the layout's shape.  Runs that need no other's checkpoint go side by
   side on the card.
21. The async rules, in this process with no process group.  (a)
   EASGD (tau 4), ASGD and GOSGD (p_push 0.5) through the rule API on
   AlexNet's recipe (batch 128, bf16, 227 crops, synthetic ImageNet,
   on-device augment) as two workers sharing the card
   (``devices=["cuda:0", "cuda:0"]``, a stream each), ``P21_ITERS``
   iterations a worker, then a 2-batch validation.  Launch counts set to
   0 before each session and read after it: exactly 2 K3a + 2 K3b an
   iteration over both workers and 2 K3a a validation batch, no other
   kernel; EASGD's exchanges and ASGD's updates as the iteration counts
   give, GOSGD's weights summing to 1 within 1e-6, every loss finite.
   ms per worker iteration, images/s over both workers, each exchange
   span's host ms; then each store operation alone at AlexNet's size
   (EASGD exchange, ASGD push_pull, GOSGD push and merge) with its bytes.
   (b) The CPU tests' round-robin EASGD and ASGD schedules in f32 at
   batch 8 on the card and on the CPU: the center's and each worker's
   displacement from the initial parameters within relative L2 2e-3.
   (c) ``python -m theanompi_tpu_torch.launcher EASGD -D 1 --tau 4`` on
   AlexNet's defaults with ``--result-json``, beside (b): 64
   iterations, 17 exchanges, the K3 launches, a finite validation.
22. The async rules' remote paths.  Two port services, ``python -m
   theanompi_tpu_torch.parallel.service`` on their default device (this
   card), one for the launchers and one for this process.  (c) first,
   alone: one exchange of AlexNet's 61.0 M f32 parameters each way
   (worker to service: a gossip push; service to worker: its drain) and
   an EASGD exchange round trip, over TCP in-band, over the
   shared-memory lane and on the bf16 wire, the in-process stores
   beside them; each with its bytes before and after the wire, the wire
   ratio (0.5 on the bf16 wire, 1 over TCP), ``shm/oob_bytes_total``
   and the path it took, and the size of ``/dev/shm``.  Then (b) the
   launchers run side by side on the card: ``EASGD -D 1
   --server-addr``, ``ASGD -D 1 --shards 2`` (its two shard processes
   on the card too) and two ``GOSGD -D 1`` sharing one hub
   (``--n-total-workers 2 --rank-offset 0/1 --session-id``),
   ``P22_ITERS`` iterations each of ``P22AlexNet``, each with exact K3
   totals; while they run, (a) phase 21 (b)'s EASGD
   and ASGD schedules on the card through the service on the f32 wire,
   bit-identical to the in-process run (center and workers; cuDNN's
   deterministic algorithms), EASGD's also on the bf16 wire within
   ``P22_BF16_LIMIT`` of the f32 wire's parameters and not at 0, and
   a threaded two-worker EASGD with ``local_aggregation`` through the
   service: one aggregate wire exchange a period, zero fallbacks.
24. The LM family's parallel variants, at ``LM_DIMS`` on a one-rank NCCL
   group with a mesh whose axes all have degree 1 (no collective of the
   mesh is issued).  (a) ``sequence_attention`` for each strategy at
   ``P24_ATTN`` bf16 causal, forward and backward: all-gather and
   Ulysses launch K4a 1 and one of each K4b pass, ring none; each
   within ``ops/attention.tolerance_excess`` of K4's plain twins (ring:
   of the f32 plain path).  (b) ``TransformerLM_TP`` (tp 1) and
   ``TransformerLM_PP`` (one stage, ``P24_MICRO`` microbatches) from the
   DP model's weights, ``P24_STEPS`` f32 SGD steps: losses and the first
   gradient within ``P24_LIMITS`` of DP's, K4 launches per step exactly
   ``P24_LAUNCHES``.  (c) ``TransformerLM_MoE`` (8 experts) cut to
   ``P24_MOE_LAYERS`` layers at full width, one f32 step on the card, on
   the CPU and on the CPU replaying the card's routes and ReLU gates:
   the decisions that flipped, the replayed step within ``P24_LIMITS`` of
   the card's, the CPU's own within them too unless a decision flipped,
   then within ``P24_MOE_LIMITS``.  (d) ``remat`` against plain,
   bf16: every gradient and updated parameter bit for bit, K4a 24 a
   step.  (e) ms a step (CUDA events) and peak memory of DP, remat, TP,
   PP and MoE at the recipe, their K4 launches per step exact.
25. The rest of serving and autoregressive decode, in this process (TF32
   off, the shm lane off: every byte in-band over loopback TCP).  (a)
   ResNet-50 at full width with seeded weights exported f32, bf16 and
   int8, each behind ``serve()`` and queried with
   ``InferenceClient.infer`` at batch 32: exactly K1a 37, K1b 16, K2a 1
   launches per batch; f32 bit-identical to the in-process
   ``InferenceServer.submit`` of the same batch, a ``reload`` to v1, a
   ``serve_rpc`` fault the client survives; bf16 and int8 within
   ``P25_QUANT_LIMITS`` of f32 (max logit difference, top-1 agreement);
   ms per ``infer``.  (b) The LM at ``LM_DIMS`` in f32 exported f32, bf16
   and int8 and served with the launcher's ``--decode`` defaults: 8
   concurrent ``generate`` streams (``P25_PROMPT_LENS``, spanning the
   prefill buckets, ``P25_MAX_NEW`` tokens; the 100-token prompt decodes
   past the 128-token window), after a serial and a concurrent warm
   pass; the f32 tokens equal the argmax of the card's
   ``full_forward(window=128)`` over each growing sequence, a difference
   allowed only where the oracle's top-2 margin is below ``P25_TIE``
   (printed); tokens/s (``token_throughput``) and inter-token p50/p99; the
   bf16 and int8 exports' tokens/s and first token off f32.  (c) A
   2-layer draft cut from the target (k = 4): tokens equal to (b)'s f32
   tokens; the accept rate.  (d) A repeated 40-token prompt hits the
   prefix cache with the cold run's tokens; a stream drained
   (``drain_migrate``) from a second replica mid-flight and ``adopt``-ed
   by the first ends on the in-place tokens.  (e) Between the warm pass
   and the measured one: no new bucket key, the page tensors' ``data_ptr``
   kept, ``torch.cuda.memory_reserved()`` flat, and no kernel launched.
26. Disaggregated serving and the fleet prefix cache, from a router
   process of its own (``p26_router``: it holds no model and never
   initializes CUDA), over phase 25's f32 export (run alone, it exports
   the same seeded LM itself): ``DisaggregatedFleet(
   prefill=2, decode=2, device="cuda")`` with the ``--decode`` defaults
   (pages of 16 tokens, 8 a sequence, 8 sequences, prefill batch 8), four
   child processes on the card (the authority first, then the other
   three at once); their start-up seconds.
   (a) Phase 25 (b)'s 8 prompts as concurrent ``RouterClient.generate``
   streams with its lengths: the tokens equal phase 25's single-role
   tokens and the ``full_forward(window=128)`` oracle, apart only where
   the top-2 margin is below ``P25_TIE``; page bytes a stream (manifest,
   k, v), ``frontdoor/migrate_ms`` p50/p99, tokens/s, time to first token
   (8 concurrent one-token streams), the router's ``stats()`` with 0
   shed.  (b) ``nvidia-smi --query-compute-apps``: each child holds memory
   on the card and the router does not (by pid where the card's
   nvidia-smi sees this machine's pids, else by the count of compute
   processes and the card's used memory).  (c) A prompt of a 32-token
   prefix and an 8-token suffix prefilled cold by the non-authority
   prefill replica registers the prefix with the authority; the same
   prefix with another suffix hits that replica's own cache, and a decode
   replica's ``generate`` of it fetches the prefix from the authority (a
   fleet hit, leases back to 0); its tokens equal a cold run's.  (d) A
   decode replica killed (``decode_group.kill``) with 4 streams in
   flight: every stream ends on (a)'s tokens, at least one failover, 0
   shed; the watcher relaunches it.  (e) The decode role grown by one
   (``grow`` + ``add_backend``; 8 streams, some on the new replica), then
   shrunk by the autoscaler's drain-first scale-down while 8 streams run:
   the streams on the drained replica migrate and every stream ends on
   (a)'s tokens; the drained child exits.  Every child and its port are
   released before the phase returns (the router's process group is
   killed, pass or fail); no ``tmshm_*`` segment is left.
27. The last modules: (a) the port's static checker suite,
   ``theanompi_tpu_torch/tools/tmlint.py --gate`` (no JAX here): exit 0,
   no new finding, the counts by check.  (b) ``entry(device="cuda")``:
   the bf16 full ResNet-50 forward at (8, 224, 224, 3) on a seeded
   batch against the same weights in f32 on the CPU (per-row relative L2
   <= ``P27_ENTRY_LIMIT``), exactly K1a 37, K1b 16 and K2a 1 launches a
   call.  (c) ``dryrun_multichip(1, device="cuda")`` (one rank process,
   a one-rank NCCL group): plain BSP, ``sync_bn``, ZeRO-1 and FSDP with
   ``steps_per_call=2`` and ``grad_accum_steps=2`` on the tiny ResNet-50;
   every loss finite and each leg's K1a-K1d, K2b and K2c launches
   exactly the tiny module's per step (``entry.resnet_launches``: 13, 4,
   13, 4, 1, 1) times its batches.  (d) The native host augment on this
   machine's host: bitwise equal to the numpy path on a batch-128
   ImageNet crop (256 -> 224) and a CIFAR batch; host ms a batch of
   each path with the thread count and ``os.cpu_count()``; a Cifar10
   step fed by the native path bit-identical to one fed by the numpy
   path, exactly K3a 2 and K3b 2 launches each, native calls above 0.
   (e) ``--compilation-cache-dir``: phase 2's libraries but lrn's copied
   into a fresh directory, one launcher epoch of Cifar10 on it: only lrn
   is built, under ``library_path``'s digest name (its nvcc seconds
   printed), the copies untouched, every library then loads from the
   directory as cached.  (c)'s process and (e)'s launcher start with
   phase 18 (c)'s launchers and run beside them (times shared, as
   theirs are); (d) runs last, alone, for its host times.

Phases 7, 8, 12 and 13 run after 6a; 6b, 6c, 9, 10, 14 and 15 share one
one-rank NCCL process group in this process (the launchers' workers make
their own); 16 runs after it, then 17 on a one-rank group of its own
(its launcher runs after that group ends), then 18 (18a before its own
one-rank group, 18c's launchers after it), then 19 ((a) and (b) before
its own one-rank group, (c) on it), then 20 ((a) on its own one-rank
group, (b) after it, on phase 16's shard files), then 21 and 22 (no group),
then 24 on a one-rank group of its own, then 25 and 26 (no group), then
27 ((c) in a rank process of its own and (e) in a launcher, both started
with 18 (c); (d) on a one-rank group of its own).  Phase 9
checkpoints each epoch, as the launcher does; 6b and 14 call
``run_bsp_session`` without checkpoints.

Full results (per-shape kernel times, the traces) go to
``build/chip_smoke.json``.
"""

from __future__ import annotations

import atexit
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12              # same sheet: f32 outside the tensor cores
BF16_OPS_PER_S = 989e12            # same sheet: dense bf16 tensor cores
BATCH = 32
TRAIN_BATCH = 128
TRAIN_STEPS = 24
CHECK_ROWS = 16
GRAD_CHECK_IMAGES = 8
#: exit-BN scale ranges of the seeded weights: phase 4's, and phase 6a's
#: (see grad_check for why the gradient check needs smaller ones)
SERVE_EXIT_SCALES = (0.2, 0.5)
GRAD_CHECK_EXIT_SCALES = (0.05, 0.1)
#: phase 6a limits: relative error of the loss and of the updated BN
#: running statistics against f32, and relative L2 error of the whole
#: flattened gradient against f32 and against bf16 on the CPU
GRAD_CHECK_LIMITS = {"loss_rel": 1e-2, "stats": 0.05, "grad_vs_f32": 0.1,
                     "grad_vs_cpu_bf16": 0.1}
#: phase 8 limits (AlexNet has no running statistics)
ALEX_GRAD_LIMITS = {"loss_rel": 1e-2, "grad_vs_f32": 0.1,
                    "grad_vs_cpu_bf16": 0.1}
KERNEL_SOURCES = {
    "scale_bias_act": ("theanompi_tpu_torch/csrc/fused_bn.cu",
                       "theanompi_tpu/ops/fused_bn.py:138"),
    "scale_bias_act_res": ("theanompi_tpu_torch/csrc/fused_bn.cu",
                           "theanompi_tpu/ops/fused_bn.py:182"),
    "scale_bias_act_bwd": ("theanompi_tpu_torch/csrc/fused_bn.cu",
                           "theanompi_tpu/ops/fused_bn.py:154"),
    "scale_bias_act_res_bwd": ("theanompi_tpu_torch/csrc/fused_bn.cu",
                               "theanompi_tpu/ops/fused_bn.py:199"),
    "maxpool3x3s2": ("theanompi_tpu_torch/csrc/maxpool.cu",
                     "theanompi_tpu/ops/maxpool_pallas.py:153"),
    "maxpool3x3s2_argmax": ("theanompi_tpu_torch/csrc/maxpool.cu",
                            "theanompi_tpu/ops/maxpool_pallas.py:169"),
    "maxpool3x3s2_bwd": ("theanompi_tpu_torch/csrc/maxpool.cu",
                         "theanompi_tpu/ops/maxpool_pallas.py:195"),
    "lrn": ("theanompi_tpu_torch/csrc/lrn.cu",
            "theanompi_tpu/ops/lrn_pallas.py:55"),
    "lrn_bwd": ("theanompi_tpu_torch/csrc/lrn.cu",
                "theanompi_tpu/ops/lrn_pallas.py:55"),
    "attention": ("theanompi_tpu_torch/csrc/attention.cu",
                  "theanompi_tpu/ops/attention.py:107"),
    "attention_bwd_dq": ("theanompi_tpu_torch/csrc/attention.cu",
                         "theanompi_tpu/ops/attention.py:249"),
    "attention_bwd_dkdv": ("theanompi_tpu_torch/csrc/attention.cu",
                           "theanompi_tpu/ops/attention.py:249"),
}
#: the kernel table's ids (K4b is two kernels: its row and column pass)
KERNEL_IDS = {"scale_bias_act": "K1a", "scale_bias_act_res": "K1b",
              "scale_bias_act_bwd": "K1c", "scale_bias_act_res_bwd": "K1d",
              "maxpool3x3s2": "K2a", "maxpool3x3s2_argmax": "K2b",
              "maxpool3x3s2_bwd": "K2c", "lrn": "K3a", "lrn_bwd": "K3b",
              "attention": "K4a", "attention_bwd_dq": "K4b",
              "attention_bwd_dkdv": "K4b"}
#: launches of each kernel per batch-128 ResNet-50 training step
TRAIN_LAUNCHES = {"scale_bias_act": 37, "scale_bias_act_res": 16,
                  "scale_bias_act_bwd": 37, "scale_bias_act_res_bwd": 16,
                  "maxpool3x3s2_argmax": 1, "maxpool3x3s2_bwd": 1,
                  "maxpool3x3s2": 0, "lrn": 0, "lrn_bwd": 0, "attention": 0,
                  "attention_bwd_dq": 0, "attention_bwd_dkdv": 0}
#: launches of each kernel per AlexNet training step and per validation
#: batch (LRN after conv1 and conv2)
ALEX_TRAIN_LAUNCHES = {**{k: 0 for k in TRAIN_LAUNCHES}, "lrn": 2,
                       "lrn_bwd": 2}
ALEX_VAL_LAUNCHES = {**{k: 0 for k in TRAIN_LAUNCHES}, "lrn": 2}
#: the AlexNet session through the launcher: epochs of the default
#: synthetic pool (8192 images: 64 steps of 128, 4 validation batches);
#: the second epoch's steps are the timed ones
ALEX_EPOCHS = 2
#: K2b/K2c edge cases beside the batch-128 stem shape, each in bf16 and
#: f32 (N, H, W, C; C None: one 16-byte vector, 8 bf16 or 4 f32): H = W
#: = 2; N = 1 with OH = 5, not a multiple of a strip's 2 rows; C = 256,
#: whose K2b tiles split OW = 15 into 8 + 7 columns; a row K2c's tiles
#: cut short (OW = 113 in tiles of 29 in bf16); C = 320, split into
#: channel tiles (2 in bf16, 3 in f32); an odd C of three bf16 vectors
K2_EDGE_SHAPES = [(2, 2, 2, None), (1, 10, 12, 64), (3, 16, 12, 32),
                  (2, 18, 30, 256), (1, 6, 226, 256), (1, 10, 30, 320),
                  (2, 12, 14, 24)]
#: LRN activations ~ N(0, 20^2) in the kernel check, so a*W(x^2) is live
LRN_SCALE = 20.0
#: the transformer slice: tools/bench_lm.py's recipe (GPT-2-small widths,
#: seq 1024, vocab 256, batch 8 per card, bf16 on f32 master weights,
#: AdamW at 1e-3 with weight decay 0.01, constant schedule)
LM_DIMS = dict(vocab=256, seq_len=1024, n_layers=12, d_model=768,
               n_heads=12)
LM_BATCH = 8
#: one epoch of 32 steps and 2 validation batches (the data cut)
LM_TRAIN_STEPS, LM_VAL_BATCHES = 32, 2
#: launches per LM training step and per validation batch (12 blocks)
LM_TRAIN_LAUNCHES = {**{k: 0 for k in TRAIN_LAUNCHES}, "attention": 12,
                     "attention_bwd_dq": 12, "attention_bwd_dkdv": 12}
LM_VAL_LAUNCHES = {**{k: 0 for k in TRAIN_LAUNCHES}, "attention": 12}
#: phase 13: tokens of the gradient check and its limits
LM_GRAD_CHECK = (2, 1024)
LM_GRAD_LIMITS = {"loss_rel": 1e-2, "grad_vs_f32": 0.1,
                  "grad_vs_cpu_bf16": 0.1}
#: phase 16: ResNet-50 through the launcher at batch 128 on shard files
#: cut from the synthetic pool: CKPT_STEPS steps and CKPT_VAL_BATCHES
#: validation batches an epoch, CKPT_EPOCHS epochs; the profiled run
#: traces CKPT_PROFILE_STEPS steps; (c) crashes at step CKPT_CRASH_STEP
#: of epoch 1 in its first life
CKPT_STEPS, CKPT_VAL_BATCHES, CKPT_EPOCHS = 8, 2, 3
CKPT_PROFILE_STEPS, CKPT_CRASH_STEP = 3, 3
#: launches per validation batch of the ResNet-50 forward
RESNET_VAL_LAUNCHES = {**{k: 0 for k in TRAIN_LAUNCHES},
                       "scale_bias_act": 37, "scale_bias_act_res": 16,
                       "maxpool3x3s2": 1}
#: phase 16, when two unbroken runs end apart (a nondeterministic
#: kernel, e.g. a cuDNN backward that sums with atomics): a resumed run's
#: final state may be this many times as far (relative L2) from the
#: first unbroken run's as the second unbroken run is; a resume at the
#: wrong epoch, with stale momentum or the wrong LR, moves the state by
#: a whole epoch's training, far more
CKPT_MARGIN = 10.0
#: phase 17: staged batches, checked steps per optimizer and their limit
#: (relative to each parameter's largest value), timed rounds (each run's
#: next dispatch in turn), and each optimizer's learning rate (momentum
#: 0.9, weight decay 5e-5)
P17_BATCHES, P17_OPT_STEPS, P17_OPT_REL, P17_ROUNDS = 4, 3, 1e-6, 3
P17_OPTIMIZERS = {"adam": 1e-3, "rmsprop": 1e-4, "lars": 0.1}
#: phase 17 (d): the launcher's --set of the rest of the BSP step
P17_SETS = ("optimizer=lars", "momentum=0.9", "weight_decay=5e-5",
            "learning_rate=0.1", "grad_accum_steps=2",
            "exchange_dtype=bf16", "exchange_error_feedback=true",
            "exchange_buckets=4", "n_epochs=2")
#: phase 18: the zoo's per-card batch (VGG16 and GoogLeNet recipes), steps
#: of its long and its short sessions, and the gradient check's limits.
#: The f32 card step against the f32 CPU step: the loss, the whole
#: gradient and the farthest parameter's gradient in relative L2 (on an
#: H100 they read 6.9e-8 / 0, 6.0e-4 / 1.8e-4 and 4.3e-3 / 8.2e-3 for
#: VGG16 / GoogLeNet, the first layers farthest; a gradient that a kernel
#: drops reads 1).  Then the bf16 card step, the recipe's, against both
#: CPU steps within bf16 rounding (VGG16's CPU bf16 step alone reads
#: 0.097 from f32).
ZOO_BATCH, ZOO_STEPS, ZOO_SHORT_STEPS = 64, 16, 8
ZOO_GRAD_LIMITS = {"f32_loss_rel": 1e-5, "f32_grad_vs_f32": 2e-3,
                   "f32_worst_tensor": 0.05, "loss_rel": 1e-2,
                   "grad_vs_f32": 0.1, "grad_vs_cpu_bf16": 0.1}
#: phase 19 (a): one seeded full-width WGAN round (width 64, batch 64 a
#: critic slice, n_critic 5, f32, TF32 off) on the card and on the CPU
#: from the same weights, real rows and noise.  The two losses within
#: relative 1e-5.  Each network's update over the round (parameters
#: after less before; the parameters themselves move by far less than
#: their norm) in relative L2: the generator's within 2e-2 and the
#: critic's within 1e-3.  Reason: f32 itself lies 2.1e-3 (generator)
#: and 4.2e-5 (critic) from an f64 round of the same inputs on the CPU
#: (measured before this phase first ran; the phase reads it again);
#: the generator's gradient reaches it through a critic clipped to
#: 0.01, so it is small and cancels, and RMSprop's update carries at
#: most the gradient's relative error; the card sums in other orders,
#: so 10x (generator) and about 25x (critic) that distance.
WGAN_WIDTH, WGAN_BATCH, WGAN_N_CRITIC = 64, 64, 5
WGAN_WARMUP_ROUNDS, WGAN_TIMED_ROUNDS = 3, 10
WGAN_LIMITS = {"loss_rel": 1e-5, "generator_update": 2e-2,
               "critic_update": 1e-3}
#: the WGAN's npz snapshot at width 64 (both networks at 128): flax's
#: paths in its flattening order, and their shapes (HWIO convs, flax's
#: (kh, kw, in, out) transposed-conv kernels, (in, out) dense kernels)
WGAN_NPZ = {
    "critic/Conv_0/Conv_0/bias": (64,),
    "critic/Conv_0/Conv_0/kernel": (4, 4, 3, 64),
    "critic/Conv_1/Conv_0/bias": (128,),
    "critic/Conv_1/Conv_0/kernel": (4, 4, 64, 128),
    "critic/Conv_2/Conv_0/bias": (256,),
    "critic/Conv_2/Conv_0/kernel": (4, 4, 128, 256),
    "critic/Dense_0/Dense_0/bias": (1,),
    "critic/Dense_0/Dense_0/kernel": (4096, 1),
    "generator/ConvTranspose_0/bias": (256,),
    "generator/ConvTranspose_0/kernel": (4, 4, 256, 256),
    "generator/ConvTranspose_1/bias": (128,),
    "generator/ConvTranspose_1/kernel": (4, 4, 256, 128),
    "generator/ConvTranspose_2/bias": (3,),
    "generator/ConvTranspose_2/kernel": (4, 4, 128, 3),
    "generator/Dense_0/Dense_0/bias": (4096,),
    "generator/Dense_0/Dense_0/kernel": (100, 4096)}
#: phase 19 (c): ResNet-50 steps with and without sync_bn on staged
#: batches (bit-identical at one rank), then timed rounds of one step
#: each
SYNC_BN_STEPS, SYNC_BN_ROUNDS = 4, 8
#: phase 20 (a): checked steps of each run, timed rounds, the settings
#: every run shares, the plain-BSP twins and each ZeRO/FSDP run with its
#: twin and its own settings (at one rank each is its twin bit for bit)
P20_STEPS, P20_ROUNDS = 4, 3
P20_BASE = dict(momentum=0.9, weight_decay=5e-5)
P20_TWINS = {
    "plain": {},
    "plain-ef-b4": dict(exchange_dtype="bf16", exchange_error_feedback=True,
                        exchange_buckets=4),
    "plain-adam": dict(optimizer="adam", learning_rate=1e-3),
    "plain-accum": dict(grad_accum_steps=2, batch_size=TRAIN_BATCH // 2),
    "plain-lars": dict(optimizer="lars", learning_rate=0.1),
    "plain-multi": dict(steps_per_call=2)}
P20_RUNS = {
    "zero-b1": ("plain", dict(zero_sharding=True)),
    "zero-b4": ("plain", dict(zero_sharding=True, exchange_buckets=4)),
    "zero-ef-b4": ("plain-ef-b4", dict(zero_sharding=True)),
    "zero-adam": ("plain-adam", dict(zero_sharding=True)),
    "zero-accum": ("plain-accum", dict(zero_sharding=True)),
    "fsdp-b1": ("plain", dict(fsdp_sharding=True)),
    "fsdp-b4": ("plain", dict(fsdp_sharding=True, exchange_buckets=4)),
    "fsdp-lars": ("plain-lars", dict(fsdp_sharding=True)),
    "fsdp-multi": ("plain-multi", dict(fsdp_sharding=True))}
#: phase 20 (b): the launcher's --set under each knob on phase 16's shard
#: files (2 epochs of 4 updates)
P20_SETS = {
    "zero": ("zero_sharding=true", "exchange_buckets=4",
             "grad_accum_steps=2", "n_epochs=2"),
    "fsdp": ("fsdp_sharding=true", "exchange_buckets=4", "optimizer=lars",
             "momentum=0.9", "weight_decay=5e-5", "learning_rate=0.1",
             "grad_accum_steps=2", "n_epochs=2")}


#: phase 21: the async rules on one card.  (a) AlexNet's recipe as two
#: workers sharing the card: iterations a worker, EASGD's period, GOSGD's
#: push probability, validation images, the span each rule's exchange
#: runs under; the store operations' timed calls.  (b) the CPU tests'
#: round-robin schedules ((epochs, iterations a worker an epoch)), their
#: batch, and the limit on the card's center against the CPU's
P21_ITERS = {"EASGD": 32, "ASGD": 16, "GOSGD": 32}
P21_TAU, P21_P_PUSH, P21_VAL_IMAGES = 4, 0.5, 2 * TRAIN_BATCH
P21_SPANS = {"EASGD": "easgd/exchange", "ASGD": "asgd/push_pull",
             "GOSGD": "gosgd/push"}
P21_OP_REPS = 5
P21_SCHEDULES = {"EASGD": (1, 8), "ASGD": (2, 3)}
P21_CHECK_BATCH, P21_CENTER_LIMIT = 8, 2e-3
#: phase 22: iterations of each launcher run (``P22AlexNet``'s synthetic
#: set at batch 128; the aggregated session's two workers share them);
#: EASGD's period in the launcher (the aggregated session exchanges every
#: iteration) and GOSGD's push probability; timed calls of each exchange
#: after a warm-up; the bf16
#: wire's limit on the parameters' relative L2 distance from the f32
#: wire's (PERF.md: each crossing rounds to bf16, at most 2^-9
#: relative, twice an exchange, and the elastic pull halves what came
#: before: 2 * 2^-8)
P22_ITERS, P22_TAU, P22_P_PUSH, P22_REPS = 2, 2, 0.5, 1
P22_BF16_LIMIT = 2.0 ** -7
#: phase 22 (a)'s round-robin schedules ((epochs, iterations a worker an
#: epoch) of phase 21 (b)'s, shortened: each remote exchange moves the
#: whole parameter set both ways)
P22_SCHEDULES = {"EASGD": (1, 2), "ASGD": (2, 1)}
#: phase 23: readers in the ingest fleet; steps of (a)'s in-process runs
#: (phase 16's shard tree holds CKPT_STEPS batches); the batch index of
#: (d)'s injected ``ingest_pull`` fault; fenced-span repetitions of (c)
P23_READERS, P23_STEPS, P23_FAULT_INDEX, P23_SPAN_REPS = 2, 8, 2, 3

def _launches(**per_step) -> dict:
    return {**{k: 0 for k in TRAIN_LAUNCHES}, **per_step}


#: launches per training step and per validation batch of the zoo: VGG16
#: 13 BiasAct; GoogLeNet 3 stem + 9 x 6 inception + 1 per aux head
#: BiasAct (57 without the aux heads) and 2 LRN; Cifar10 2 LRN; BN AlexNet
#: 5 BatchNormAct and 2 LRN; ResNet-101 1 + 2 per block + 4 projections
#: (71) and 1 per block (33) of K1, and the stem pool
VGG_TRAIN_LAUNCHES = _launches(scale_bias_act=13, scale_bias_act_bwd=13)
#: launches of a ResNet-50 validation batch
RESNET_VAL_LAUNCHES = _launches(scale_bias_act=37, scale_bias_act_res=16,
                                maxpool3x3s2=1)
VGG_VAL_LAUNCHES = _launches(scale_bias_act=13)
GOOGLENET_TRAIN_LAUNCHES = _launches(scale_bias_act=59,
                                     scale_bias_act_bwd=59, lrn=2, lrn_bwd=2)
GOOGLENET_VAL_LAUNCHES = _launches(scale_bias_act=57, lrn=2)
CIFAR_TRAIN_LAUNCHES = _launches(lrn=2, lrn_bwd=2)
CIFAR_VAL_LAUNCHES = _launches(lrn=2)
ALEX_BN_TRAIN_LAUNCHES = _launches(scale_bias_act=5, scale_bias_act_bwd=5,
                                   lrn=2, lrn_bwd=2)
ALEX_BN_VAL_LAUNCHES = _launches(scale_bias_act=5, lrn=2)
RESNET101_TRAIN_LAUNCHES = _launches(
    scale_bias_act=71, scale_bias_act_res=33, scale_bias_act_bwd=71,
    scale_bias_act_res_bwd=33, maxpool3x3s2_argmax=1, maxpool3x3s2_bwd=1)
RESNET101_VAL_LAUNCHES = _launches(scale_bias_act=71, scale_bias_act_res=33,
                                   maxpool3x3s2=1)
#: kernel names in a torch.profiler trace -> the kernel table's ids:
#: demangled (``<__nv_bfloat16, true, true>``) or mangled (``Lb1E``),
#: the first bool template argument being RES
TRACE_KERNELS = {
    "K1a": r"scale_bias_act_kernel(<[^,<>]+,\s*false|I\w*?Lb0E)",
    "K1b": r"scale_bias_act_kernel(<[^,<>]+,\s*true|I\w*?Lb1E)",
    "K1c": r"scale_bias_act_bwd_cluster_kernel(<[^,<>]+,\s*false|I\w*?Lb0E)",
    "K1d": r"scale_bias_act_bwd_cluster_kernel(<[^,<>]+,\s*true|I\w*?Lb1E)",
    "K2b": r"maxpool3x3s2_argmax_tile_kernel",
    "K2c": r"maxpool3x3s2_bwd_tile_kernel"}


#: when the script started (phase headers print the seconds since)
_STARTED = time.monotonic()


def log(msg: str) -> None:
    if msg.startswith("phase "):
        msg += f"  [{time.monotonic() - _STARTED:.1f} s]"
    print(msg, flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit of the one card the run uses."""
    out = subprocess.run(
        ["nvidia-smi", "-i", os.environ["CUDA_VISIBLE_DEVICES"],
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def graph_ms(torch, fns, reps: int) -> float:
    """Device ms per call of ``fns`` (round-robin), from one CUDA graph
    of ``reps`` rounds replayed three times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            for f in fns:
                f()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (3 * reps * len(fns))
    del graph
    return ms


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = F32_OPS_PER_S) -> float:
    """Least time the card could take: the larger of the bytes over the
    HBM rate and the operations over their peak rate (f32 unless
    given)."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s) * 1e3


def bound_by(nbytes: float, ops: float,
             ops_per_s: float = F32_OPS_PER_S) -> str:
    return ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / ops_per_s
            else "operations")


def copies_for(nbytes: int) -> int:
    """Distinct buffers to cycle so the working set exceeds the 50 MB L2
    (the main path finds a BN input written by the conv before it)."""
    return max(1, min(16, math.ceil(128e6 / max(nbytes, 1))))


def ulp_distance(torch, a, b) -> int:
    """Largest distance in units of last place between two float
    tensors of one dtype (sign-magnitude bits mapped to ordered ints)."""
    itype, mask = ((torch.int16, 0x7FFF) if a.dtype == torch.bfloat16
                   else (torch.int32, 0x7FFFFFFF))
    ia, ib = (t.contiguous().view(itype).long() for t in (a, b))
    ia = torch.where(ia < 0, -(ia & mask), ia)
    ib = torch.where(ib < 0, -(ib & mask), ib)
    return int((ia - ib).abs().max().item()) if a.numel() else 0


def same_bits(torch, a, b) -> bool:
    """Two float tensors of one dtype hold the same bits (NaNs too)."""
    itype = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return bool(torch.equal(a.contiguous().view(itype),
                            b.contiguous().view(itype)))


# -- phase 3: kernels against their plain versions --------------------------

def k1_cases(torch, module, x, train: bool = False):
    """(rows, C, residual?, act) -> launches per forward, recorded with
    forward hooks on every BatchNormAct and BiasAct of one forward (with
    ``train``, of the training forward: GoogLeNet's aux heads run)."""
    from theanompi_tpu_torch.models.layers import BatchNormAct, BiasAct

    cases: dict[tuple, int] = {}

    def hook(mod, args, kwargs, out):
        rows = args[0].numel() // args[0].shape[-1]
        key = (rows, args[0].shape[-1],
               kwargs.get("residual") is not None, mod.act)
        cases[key] = cases.get(key, 0) + 1

    hooks = [m.register_forward_hook(hook, with_kwargs=True)
             for m in module.modules()
             if isinstance(m, (BatchNormAct, BiasAct))]
    with torch.inference_mode():
        if train:
            module.train()(x, train=True,
                           rng=torch.Generator(x.device).manual_seed(0))
            module.eval()
        else:
            module(x)
    for h in hooks:
        h.remove()
    return cases


def check_k1(torch, cases, unit_scale: bool = False) -> dict:
    """K1a/K1b at every (rows, C) of ``cases`` (bf16) plus a ragged f32
    case, against the plain version (at most 1 ulp) and timed; with
    ``unit_scale`` the scale is the constant 1 of ``layers.BiasAct``
    (``x * 1`` is exact, so 0 ulp) and the ragged case is left out."""
    from theanompi_tpu_torch.ops import fused_bn

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows_out, worst = [], {"scale_bias_act": 0.0, "scale_bias_act_res": 0.0}
    # per forward: kernel ms, plain ms, bytes, operations
    fwd = {"scale_bias_act": [0.0, 0.0, 0.0, 0.0],
           "scale_bias_act_res": [0.0, 0.0, 0.0, 0.0]}
    all_cases = [(k, n, torch.bfloat16) for k, n in sorted(cases.items())]
    if not unit_scale:
        all_cases.append(((1000 * 3 + 7, 64, True, "relu"), 0,
                          torch.float32))
    for (rows, c, has_res, act), per_fwd, dtype in all_cases:
        name = "scale_bias_act_res" if has_res else "scale_bias_act"
        elt = torch.tensor([], dtype=dtype).element_size()
        nbytes = rows * c * elt * (3 if has_res else 2) + 2 * c * 4
        n = copies_for(nbytes)
        xs = [torch.randn(rows, c, generator=gen, device="cuda").to(dtype)
              for _ in range(n)]
        rs = [torch.randn(rows, c, generator=gen, device="cuda").to(dtype)
              if has_res else None for _ in range(n)]
        s = (torch.ones(c, device="cuda") if unit_scale else
             torch.rand(c, generator=gen, device="cuda") + 0.5)
        b = torch.randn(c, generator=gen, device="cuda") * 0.1
        y = fused_bn.scale_bias_act(xs[0], s, b, rs[0], act, dtype)
        ref = fused_bn.scale_bias_act_plain(xs[0], s, b, rs[0], act, dtype)
        torch.cuda.synchronize()
        ulp = ulp_distance(torch, y, ref)
        err = float((y.float() - ref.float()).abs().max().item())
        if ulp > (0 if unit_scale else 1):
            raise AssertionError(f"K1 {name} ({rows}, {c}) {dtype}: kernel "
                                 f"is {ulp} ulp from its plain version")
        worst[name] = max(worst[name], err)
        k_ms = graph_ms(torch, [
            (lambda i=i: fused_bn.scale_bias_act(xs[i], s, b, rs[i], act,
                                                 dtype)) for i in range(n)],
            reps=max(2, 40 // n))
        p_ms = graph_ms(torch, [
            (lambda i=i: fused_bn.scale_bias_act_plain(xs[i], s, b, rs[i],
                                                       act, dtype))
            for i in range(n)], reps=max(2, 20 // n))
        # mul + add (+ add) (+ compare) per element
        ops = rows * c * (2 + has_res + (act == "relu"))
        bound = bound_ms(nbytes, ops)
        for i, v in enumerate((k_ms, p_ms, nbytes, ops)):
            fwd[name][i] += per_fwd * v
        rows_out.append({"kernel": name, "rows": rows, "C": c,
                         "dtype": str(dtype).replace("torch.", ""),
                         "act": act, "per_forward": per_fwd, "ulp": ulp,
                         "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound})
        log(f"  K1 {name:18s} rows={rows:7d} C={c:5d} "
            f"{str(dtype)[6:]:8s} act={act!s:5s} x{per_fwd:2d}/fwd "
            f"ulp={ulp} kernel {k_ms * 1e3:8.2f} us  plain "
            f"{p_ms * 1e3:8.2f} us  bound {bound * 1e3:8.2f} us")
        del xs, rs
    per_forward = {
        name: {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms(nb, ops),
               "bound_by": bound_by(nb, ops)}
        for name, (k_ms, p_ms, nb, ops) in fwd.items()}
    return {"cases": rows_out, "max_abs_err": worst,
            "per_forward": per_forward}


def check_k2(torch) -> dict:
    import torch.nn.functional as F

    from theanompi_tpu_torch.ops import maxpool

    gen = torch.Generator(device="cuda").manual_seed(2)
    shape = (BATCH, 112, 112, 64)
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    bad = x.clone()
    bad[0, 0:2, 0:2, :] = float("-inf")       # all-(-inf) window at (0, 0)
    bad[1, 5, 7, :8] = float("nan")
    bad[3, 50:52, 60, 3] = float("nan")
    errs = []
    for t in (x, bad):
        y = maxpool.maxpool3x3s2(t)
        ref = maxpool.maxpool3x3s2_plain(t)
        torch.cuda.synchronize()
        same_nan = bool(torch.equal(torch.isnan(y), torch.isnan(ref)))
        fin = ~torch.isnan(ref)
        if not same_nan or not torch.equal(y[fin], ref[fin]):
            raise AssertionError("K2 maxpool3x3s2 differs from its plain "
                                 "version")
        errs.append(float((y[fin].float() - ref[fin].float()).abs().max()))
    if not bool(torch.isneginf(maxpool.maxpool3x3s2(bad)[0, 0, 0]).all()):
        raise AssertionError("K2: all-(-inf) window did not give -inf")
    nbytes = x.numel() * 2 + x.numel() // 4 * 2
    n = copies_for(nbytes)
    xs = [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
          for _ in range(n)]
    k_ms = graph_ms(torch, [(lambda i=i: maxpool.maxpool3x3s2(xs[i]))
                            for i in range(n)], reps=max(2, 40 // n))
    p_ms = graph_ms(torch, [(lambda i=i: maxpool.maxpool3x3s2_plain(xs[i]))
                            for i in range(n)], reps=max(2, 20 // n))
    lib_ms = graph_ms(torch, [
        (lambda i=i: F.max_pool2d(xs[i].permute(0, 3, 1, 2), 3, 2, 1))
        for i in range(n)], reps=max(2, 40 // n))
    ops = 9 * x.numel() // 4                      # 9 compares per output
    bound = bound_ms(nbytes, ops)
    log(f"  K2 maxpool3x3s2 {shape} bf16 exact (NaN, -inf windows) kernel "
        f"{k_ms * 1e3:.2f} us  plain {p_ms * 1e3:.2f} us  F.max_pool2d "
        f"{lib_ms * 1e3:.2f} us  bound {bound * 1e3:.2f} us")
    return {"max_abs_err": max(errs), "ms": k_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": bound_by(nbytes, ops)}


# -- phase 5: the training kernels against their plain versions -------------

def check_k1_bwd(torch, cases, unit_scale: bool = False) -> dict:
    """K1c/K1d at every (rows, C) of a batch-128 step (bf16) and a ragged
    f32 case: dx/dres 0 ulp, ds/db within 1e-5 of sum|g*x| / sum|g| and
    bit-identical over repeated and two-stream launches
    (:func:`k1_bwd_deterministic`); ``unit_scale`` as :func:`check_k1`."""
    from theanompi_tpu_torch.ops import fused_bn

    gen = torch.Generator(device="cuda").manual_seed(4)
    names = {False: "scale_bias_act_bwd", True: "scale_bias_act_res_bwd"}
    rows_out = []
    worst = {n: 0.0 for n in names.values()}
    step = {n: [0.0, 0.0, 0.0, 0.0] for n in names.values()}
    all_cases = [(k, n, torch.bfloat16) for k, n in sorted(cases.items())]
    if not unit_scale:
        all_cases.append(((1000 * 3 + 7, 64, True, "relu"), 0,
                          torch.float32))
    for (rows, c, has_res, act), per_step, dtype in all_cases:
        name = names[has_res]
        relu = act == "relu"
        elt = torch.tensor([], dtype=dtype).element_size()
        # x, g read and dx written (+ res read and dres written)
        nbytes = rows * c * elt * (5 if has_res else 3) + 4 * c * 4
        n = copies_for(nbytes)

        def rand():
            return torch.randn(rows, c, generator=gen,
                               device="cuda").to(dtype)

        xs = [rand() for _ in range(n)]
        gs = [rand() for _ in range(n)]
        rs = [rand() if has_res else None for _ in range(n)]
        s = (torch.ones(c, device="cuda") if unit_scale else
             torch.rand(c, generator=gen, device="cuda") + 0.5)
        b = torch.randn(c, generator=gen, device="cuda") * 0.1
        got = fused_bn.scale_bias_act_bwd(xs[0], s, b, gs[0], rs[0], relu)
        want = fused_bn._bwd_plain(xs[0], s, b, rs[0], gs[0], relu)
        torch.cuda.synchronize()
        ulp = ulp_distance(torch, got[0], want[0])
        if has_res:
            ulp = max(ulp, ulp_distance(torch, got[1], want[1]))
        gm = gs[0].float()
        if relu:
            z = xs[0].float() * s + b + (rs[0].float() if has_res else 0)
            gm = torch.where(z > 0, gm, 0)
        ds_err = (got[2] - want[2]).abs()
        db_err = (got[3] - want[3]).abs()
        ds_rel = float((ds_err / (gm * xs[0].float()).abs().sum(0)
                        .clamp_min(1e-30)).max())
        db_rel = float((db_err / gm.abs().sum(0).clamp_min(1e-30)).max())
        if ulp or ds_rel > 1e-5 or db_rel > 1e-5:
            raise AssertionError(
                f"K1 {name} ({rows}, {c}) {dtype}: dx/dres {ulp} ulp, "
                f"ds {ds_rel:.3g} and db {db_rel:.3g} of their magnitude "
                "sums (limits 0, 1e-5, 1e-5)")
        k1_bwd_deterministic(torch, got, xs[0], s, b, gs[0], rs[0], relu,
                             f"K1 {name} ({rows}, {c}) {dtype}")
        worst[name] = max(worst[name], float(ds_err.max()),
                          float(db_err.max()))
        k_ms = graph_ms(torch, [
            (lambda i=i: fused_bn.scale_bias_act_bwd(xs[i], s, b, gs[i],
                                                     rs[i], relu))
            for i in range(n)], reps=max(2, 40 // n))
        p_ms = graph_ms(torch, [
            (lambda i=i: fused_bn._bwd_plain(xs[i], s, b, rs[i], gs[i],
                                             relu))
            for i in range(n)], reps=max(2, 10 // n))
        # mask: mul, add (, add), compare; g*s; g*x and two sums
        ops = rows * c * (4 + has_res + 3)
        bound = bound_ms(nbytes, ops)
        for i, v in enumerate((k_ms, p_ms, nbytes, ops)):
            step[name][i] += per_step * v
        rows_out.append({"kernel": name, "rows": rows, "C": c,
                         "dtype": str(dtype).replace("torch.", ""),
                         "act": act, "per_step": per_step, "ulp": ulp,
                         "ds_rel": ds_rel, "db_rel": db_rel, "ms": k_ms,
                         "plain_ms": p_ms, "bound_ms": bound})
        log(f"  K1 {name:22s} rows={rows:7d} C={c:5d} "
            f"{str(dtype)[6:]:8s} act={act!s:5s} x{per_step:2d}/step "
            f"ulp={ulp} ds {ds_rel:.1e} db {db_rel:.1e} kernel "
            f"{k_ms * 1e3:8.2f} us  plain {p_ms * 1e3:8.2f} us  bound "
            f"{bound * 1e3:8.2f} us")
        del xs, gs, rs, got, want
    per_step_out = {
        name: {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms(nb, ops),
               "bound_by": bound_by(nb, ops)}
        for name, (k_ms, p_ms, nb, ops) in step.items()}
    return {"cases": rows_out, "max_abs_err": worst,
            "per_step": per_step_out}


def k1_bwd_deterministic(torch, got, x, s, b, g, r, relu, label) -> None:
    """The same inputs launched again, and once on each of two side
    streams at the same time (each call has its own tickets and scratch),
    give ds and db bit-identical to ``got``'s."""
    from theanompi_tpu_torch.ops import fused_bn

    main = torch.cuda.current_stream()
    outs = [fused_bn.scale_bias_act_bwd(x, s, b, g, r, relu)]
    side = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in side:
        st.wait_stream(main)
    for st in side:
        with torch.cuda.stream(st):
            outs.append(fused_bn.scale_bias_act_bwd(x, s, b, g, r, relu))
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        if not (same_bits(torch, out[2], got[2])
                and same_bits(torch, out[3], got[3])):
            raise AssertionError(
                f"{label}: ds/db of launch {i + 2} "
                f"({'again' if i == 0 else f'side stream {i}'}) differ in "
                "their bits from the first launch's")


def k2_edge_case(torch, shape, dtype, gen):
    """x and g of one K2b/K2c case with every rule in play: an
    all-(-inf) window at (0, 0), two NaNs in one window, ties, and quads
    whose odd/odd pixel wins all four of its windows (at input (3, 3),
    (7, 7) and, where K2c's tiles split the columns, at the first tile's
    last column), with g of those windows (-1, eps, eps, 1) for
    ((oy, ox), (oy, ox + 1), (oy + 1, ox), (oy + 1, ox + 1)), eps half
    an ulp of 1: summed in the plain version's order, (oy + 1, ox + 1)
    first, they give 0, and 2 eps in the opposite order.  Returns (x, g,
    the quads' input pixels)."""
    from theanompi_tpu_torch.ops import maxpool

    n, h, w, c = shape
    if c is None:
        c = 16 // torch.empty((), dtype=dtype).element_size()
    x = torch.randn((n, h, w, c), generator=gen, device="cuda").to(dtype)
    g = torch.randn((n, h // 2, w // 2, c), generator=gen,
                    device="cuda").to(dtype)
    x[0, 0:2, 0:2, :] = float("-inf")
    x[-1, -3:, -3:, :] = 1.0
    x[-1, -2:, -1, :2] = float("nan")      # taps 5 and 8 of one window
    eps = 2.0 ** (-8 if dtype == torch.bfloat16 else -24)
    geo = maxpool.train_geometry_plain(True, dtype, h, w, c)
    quads = [(3, 3), (7, 7)] + ([(3, 2 * geo["cols"] - 1)]
                                if geo["col_tiles"] > 1 else [])
    quads = [(iy, ix) for iy, ix in quads if iy + 3 <= h and ix + 3 <= w]
    for iy, ix in quads:
        oy, ox = iy // 2, ix // 2
        x[0, iy, ix, :] = 100.0
        g[0, oy, ox], g[0, oy, ox + 1] = -1.0, eps
        g[0, oy + 1, ox], g[0, oy + 1, ox + 1] = eps, 1.0
    return x, g, quads


def k2_instances(log: str) -> dict[str, dict]:
    """Phase 2's registers and spills of each max-pool kernel instance,
    named by kernel id and dtype."""
    ids = {"": "K2a", "_argmax_tile": "K2b", "_bwd_tile": "K2c"}
    out = {}
    for name, use in ptxas_usage(log).items():
        m = re.search(r"maxpool3x3s2(|_argmax_tile|_bwd_tile)_kernelI"
                      r"(13__nv_bfloat16|f)E", name)
        if m:
            out[f"{ids[m.group(1)]} "
                f"{'f32' if m.group(2) == 'f' else 'bf16'}"] = use
    return out


def k1_bwd_instances(log: str) -> dict[str, dict]:
    """Phase 2's registers and spills of each instance of the K1c/K1d
    kernel ``scale_bias_act_bwd_cluster_kernel<T, RES, RELU>``, named by
    kernel id, dtype and activation."""
    out = {}
    for name, use in ptxas_usage(log).items():
        m = re.search(r"scale_bias_act_bwd_cluster_kernelI"
                      r"(13__nv_bfloat16|f)Lb([01])ELb([01])E", name)
        if m:
            dtype, res, relu = m.groups()
            out[f"{'K1d' if res == '1' else 'K1c'} "
                f"{'f32' if dtype == 'f' else 'bf16'} "
                f"{'relu' if relu == '1' else 'none'}"] = use
    return out


def check_k2_train(torch) -> dict:
    """K2b and K2c at (128, 112, 112, 64) bf16 with ties, NaNs and an
    all-(-inf) window, and at ``K2_EDGE_SHAPES`` in bf16 and f32
    (``k2_edge_case``): y's bits (NaNs too), idx and dx exact, and each
    order-sensitive quad's pixel 0, as the plain version sums it."""
    import torch.nn.functional as F

    from theanompi_tpu_torch.ops import maxpool

    gen = torch.Generator(device="cuda").manual_seed(5)
    n_quads = 0
    for dtype in (torch.bfloat16, torch.float32):
        for edge in K2_EDGE_SHAPES:
            x, g, quads = k2_edge_case(torch, edge, dtype, gen)
            y, idx = maxpool.maxpool3x3s2_argmax(x)
            dx = maxpool.maxpool3x3s2_bwd(g, idx)
            want_y, want_idx = maxpool.maxpool3x3s2_argmax_plain(x)
            want_dx = maxpool.maxpool3x3s2_bwd_plain(g, want_idx)
            torch.cuda.synchronize()
            if not (same_bits(torch, y, want_y)
                    and torch.equal(idx, want_idx)
                    and torch.equal(dx, want_dx)):
                raise AssertionError(f"K2b/K2c {tuple(x.shape)} {dtype} "
                                     "differ from their plain versions")
            if any(bool(want_dx[0, iy, ix].any()) for iy, ix in quads):
                raise AssertionError("K2c: an order-sensitive quad's "
                                     "plain sum is not 0")
            n_quads += len(quads)
    log(f"  K2b/K2c exact at {len(K2_EDGE_SHAPES)} edge shapes in bf16 and "
        f"f32 ({n_quads} order-sensitive quads)")
    shape = (TRAIN_BATCH, 112, 112, 64)

    def rand(shp):
        return torch.randn(shp, generator=gen, device="cuda").to(
            torch.bfloat16)

    x = rand(shape)
    x[0, 0:2, 0:2, :] = float("-inf")       # all-(-inf) window at (0, 0)
    x[1, 5, 7, :8] = float("nan")
    x[1, 6, 7, :8] = float("nan")           # same window, later tap
    x[3, 40:43, 40:43, :] = 0.5             # ties
    y, idx = maxpool.maxpool3x3s2_argmax(x)
    want_y, want_idx = maxpool.maxpool3x3s2_argmax_plain(x)
    g = rand(y.shape)
    dx = maxpool.maxpool3x3s2_bwd(g, idx)
    want_dx = maxpool.maxpool3x3s2_bwd_plain(g, want_idx)
    torch.cuda.synchronize()
    if not (same_bits(torch, y, want_y) and torch.equal(idx, want_idx)
            and torch.equal(dx, want_dx)):
        raise AssertionError("K2b/K2c differ from their plain versions")
    if not bool((idx[0, 0, 0] == 4).all()):
        raise AssertionError("K2b: all-(-inf) window's tap is not 4")
    del x, y, idx, g, dx, want_y, want_idx, want_dx
    # bytes: x read, y and the int8 idx written (K2b); g and idx read,
    # dx written (K2c)
    n_in = math.prod(shape)
    n_out = n_in // 4
    nbytes = n_in * 2 + n_out * 3
    n = copies_for(nbytes)
    xs = [rand(shape) for _ in range(n)]
    outs = [maxpool.maxpool3x3s2_argmax(t) for t in xs]
    gs = [rand(outs[0][0].shape) for _ in range(n)]
    fwd = {"ms": graph_ms(torch, [
        (lambda i=i: maxpool.maxpool3x3s2_argmax(xs[i])) for i in range(n)],
        reps=max(2, 40 // n)),
        "plain_ms": graph_ms(torch, [
            (lambda i=i: maxpool.maxpool3x3s2_argmax_plain(xs[i]))
            for i in range(n)], reps=max(2, 10 // n)),
        "library_ms": graph_ms(torch, [
            (lambda i=i: F.max_pool2d(xs[i].permute(0, 3, 1, 2), 3, 2, 1,
                                      return_indices=True))
            for i in range(n)], reps=max(2, 40 // n))}
    lib_idx = [F.max_pool2d(t.permute(0, 3, 1, 2), 3, 2, 1,
                            return_indices=True)[1] for t in xs]
    bwd = {"ms": graph_ms(torch, [
        (lambda i=i: maxpool.maxpool3x3s2_bwd(gs[i], outs[i][1]))
        for i in range(n)], reps=max(2, 40 // n)),
        "plain_ms": graph_ms(torch, [
            (lambda i=i: maxpool.maxpool3x3s2_bwd_plain(gs[i], outs[i][1]))
            for i in range(n)], reps=max(2, 10 // n)),
        "library_ms": graph_ms(torch, [
            (lambda i=i: torch.ops.aten.max_pool2d_with_indices_backward(
                gs[i].permute(0, 3, 1, 2), xs[i].permute(0, 3, 1, 2),
                [3, 3], [2, 2], [1, 1], [1, 1], False, lib_idx[i]))
            for i in range(n)], reps=max(2, 40 // n))}
    for d, ops in ((fwd, 9 * n_out), (bwd, 4 * n_in)):
        d.update(bound_ms=bound_ms(nbytes, ops), bound_by=bound_by(nbytes,
                                                                   ops),
                 max_abs_err=0.0)
    log(f"  K2b argmax {shape} bf16 exact: kernel {fwd['ms'] * 1e3:.2f} us  "
        f"plain {fwd['plain_ms'] * 1e3:.2f} us  F.max_pool2d(indices) "
        f"{fwd['library_ms'] * 1e3:.2f} us  bound "
        f"{fwd['bound_ms'] * 1e3:.2f} us")
    log(f"  K2c gather bwd exact: kernel {bwd['ms'] * 1e3:.2f} us  plain "
        f"{bwd['plain_ms'] * 1e3:.2f} us  aten backward "
        f"{bwd['library_ms'] * 1e3:.2f} us  bound "
        f"{bwd['bound_ms'] * 1e3:.2f} us")
    return {"maxpool3x3s2_argmax": fwd, "maxpool3x3s2_bwd": bwd}


# -- phase 7: the LRN kernels against their plain versions -----------------

def ptxas_usage(log: str) -> dict[str, dict]:
    """Registers and spill bytes of each kernel in an ``-Xptxas -v``
    report, by mangled name."""
    usage: dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            usage[name] = {}
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            usage[name].update(spill_stores=nums[1], spill_loads=nums[2])
        elif name and "Used" in line and "registers" in line:
            words = line.split()
            usage[name]["registers"] = int(words[words.index("Used") + 1])
    return usage


def k3_instances(log: str) -> dict[str, dict]:
    """Phase 2's registers and spills of each ``lrn_kernel<T, V, FAST,
    BWD>`` instance, named by direction, dtype, vector width and window
    path."""
    out = {}
    for name, use in ptxas_usage(log).items():
        m = re.search(r"lrn_kernelI(13__nv_bfloat16|f)Li(\d+)ELb([01])"
                      r"ELb([01])E", name)
        if m:
            dtype, vec, fast, bwd = m.groups()
            out[f"{'K3b' if bwd == '1' else 'K3a'} "
                f"{'f32' if dtype == 'f' else 'bf16'} v{vec} "
                f"{'n5' if fast == '1' else 'any n'}"] = use
    return out


def check_k3(torch, ptxas: str) -> dict:
    """K3a/K3b against their plain versions on the card: AlexNet's two
    batch-128 shapes (after conv1 and conv2) in bf16 and f32, n=3 at
    C=32, n=4 (the adjoint window), a ragged row count, a C that is not
    a multiple of the vector width and a misaligned tensor (the scalar
    path), a 16-byte aligned tensor that does not start its buffer, C 1,
    7, 9 and 4096 with n 1, 2, 5, 7, 9 and windows wider than 2C + 1,
    one row, and the kernels' rows per tile (``lrn.tile_geometry``)
    less and plus one; each 0 ulp (the kernels do the plain version's
    f32 operations in its order and round once).  At the two bf16
    AlexNet shapes: kernel, plain version and ``F.local_response_norm``
    (on the NCHW view; forward, and forward + backward through autograd)
    timed with CUDA graphs, beside each kernel's byte bound and the
    registers and spills phase 2 read for each kernel instance."""
    import torch.nn.functional as F

    from theanompi_tpu_torch.ops import lrn

    gen = torch.Generator(device="cuda").manual_seed(7)
    bf16, f32 = torch.bfloat16, torch.float32
    alex = [(TRAIN_BATCH, 55, 55, 96), (TRAIN_BATCH, 27, 27, 256)]

    def tile(c, n, d):
        return (1, 1, lrn.tile_geometry(c, n)["rows"] + d, c)

    edges = [((2, 9, 7, 32), 3, 0), ((3, 11, 13, 96), 4, 0),
             ((1, 33, 33, 96), 5, 0), ((2, 5, 7, 33), 5, 0),
             ((2, 5, 7, 32), 5, 1), ((2, 5, 7, 96), 5, 8),
             ((2, 3, 1, 1), 1, 0), ((2, 3, 1, 1), 2, 0),
             ((1, 2, 3, 7), 7, 0), ((2, 3, 5, 7), 31, 0),
             ((1, 3, 2, 9), 2, 0), ((1, 3, 2, 9), 9, 0),
             ((1, 1, 3, 4096), 1, 0), ((1, 1, 3, 4096), 5, 0),
             ((1, 1, 2, 4096), 2, 0), ((1, 1, 1, 96), 5, 0),
             (tile(96, 5, -1), 5, 0), (tile(96, 5, 1), 5, 0),
             (tile(256, 5, -1), 5, 0), (tile(256, 5, 1), 5, 0),
             (tile(33, 4, 1), 4, 0)]
    cases = ([(shp, 5, dt, 0) for dt in (bf16, f32) for shp in alex]
             + [(shp, n, dt, off) for dt in (bf16, f32)
                for shp, n, off in edges])
    instances = k3_instances(ptxas)
    rows_out = []
    worst = {"lrn": 0.0, "lrn_bwd": 0.0}
    # per batch-128 step (both shapes, bf16): kernel, plain, library
    # ms, bytes and operations of each kernel
    step = {"lrn": dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0,
                        ops=0),
            "lrn_bwd": dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0,
                            ops=0)}
    lib_fwd_bwd_ms = 0.0

    def rand(shape, dtype, scale, offset):
        t = torch.randn(math.prod(shape) + offset, generator=gen,
                        device="cuda") * scale
        return t.to(dtype)[offset:].view(shape)

    for shape, n, dtype, off in cases:
        x, g = rand(shape, dtype, LRN_SCALE, off), rand(shape, dtype, 1, off)
        y, dx = lrn.lrn_fwd(x, n), lrn.lrn_bwd(x, g, n)
        want_y, want_dx = lrn.lrn_plain(x, n), lrn.lrn_bwd_plain(x, g, n)
        torch.cuda.synchronize()
        ulp = (ulp_distance(torch, y, want_y),
               ulp_distance(torch, dx, want_dx))
        err = (float((y.float() - want_y.float()).abs().max()),
               float((dx.float() - want_dx.float()).abs().max()))
        worst["lrn"] = max(worst["lrn"], err[0])
        worst["lrn_bwd"] = max(worst["lrn_bwd"], err[1])
        row = {"shape": list(shape), "n": n, "offset": off,
               "dtype": str(dtype).replace("torch.", ""), "ulp_y": ulp[0],
               "ulp_dx": ulp[1], "max_abs_err_y": err[0],
               "max_abs_err_dx": err[1]}
        if any(ulp):
            raise AssertionError(f"K3 {row}: kernel differs from its plain "
                                 "version (limit 0 ulp)")
        del y, dx, want_y, want_dx
        if dtype == bf16 and shape in alex:
            row.update(time_k3(torch, F, lrn, x, g, n))
            for name in ("lrn", "lrn_bwd"):
                for key in step[name]:
                    step[name][key] += row[name][key]
            lib_fwd_bwd_ms += row["library_fwd_bwd_ms"]
        rows_out.append(row)
        log(f"  K3 {str(list(shape)):20s} n={n} {row['dtype']:8s} "
            f"offset={off}: y {ulp[0]} ulp, dx {ulp[1]} ulp"
            + ("" if "lrn" not in row else
               f"; K3a {row['lrn']['ms'] * 1e3:.1f} us (plain "
               f"{row['lrn']['plain_ms'] * 1e3:.1f}, F.local_response_norm "
               f"{row['lrn']['library_ms'] * 1e3:.1f}, bound "
               f"{row['lrn']['bound_ms'] * 1e3:.1f}); K3b "
               f"{row['lrn_bwd']['ms'] * 1e3:.1f} us (plain "
               f"{row['lrn_bwd']['plain_ms'] * 1e3:.1f}, bound "
               f"{row['lrn_bwd']['bound_ms'] * 1e3:.1f}); library fwd+bwd "
               f"{row['library_fwd_bwd_ms'] * 1e3:.1f} us"))
        del x, g
    per_step = {name: {"ms": d["ms"], "plain_ms": d["plain_ms"],
                       "library_ms": d["library_ms"],
                       "bound_ms": bound_ms(d["nbytes"], d["ops"]),
                       "bound_by": bound_by(d["nbytes"], d["ops"])}
                for name, d in step.items()}
    log(f"  per step (both LRNs, bf16): K3a "
        f"{per_step['lrn']['ms']:.4f} ms (bound "
        f"{per_step['lrn']['bound_ms']:.4f}), K3b "
        f"{per_step['lrn_bwd']['ms']:.4f} ms (bound "
        f"{per_step['lrn_bwd']['bound_ms']:.4f}); kernels fwd+bwd "
        f"{per_step['lrn']['ms'] + per_step['lrn_bwd']['ms']:.4f} ms "
        f"against F.local_response_norm fwd+bwd {lib_fwd_bwd_ms:.4f} ms")
    for inst, use in sorted(instances.items()):
        log(f"  {inst}: {use.get('registers')} registers, spill "
            f"{use.get('spill_stores')}/{use.get('spill_loads')} bytes "
            "(stores/loads)")
    if not instances:
        log("  registers not read: the library was built before this run")
    return {"cases": rows_out, "max_abs_err": worst, "per_step": per_step,
            "library_fwd_bwd_ms_per_step": lib_fwd_bwd_ms,
            "instances": instances}


def time_k3(torch, F, lrn, x, g, n, k: float = 2.0,
            alpha: float = 1e-4) -> dict:
    """Device times of K3a and K3b at one shape (window ``n``, ``k``,
    ``alpha``, beta 0.75), of their plain versions, and of
    ``F.local_response_norm`` on the NCHW view: its forward (K3a's
    library time), and its forward + backward through autograd less
    that forward (K3b's: no single PyTorch call computes the backward
    alone)."""
    elt = x.element_size()
    numel = x.numel()
    nb = {"lrn": 2 * numel * elt, "lrn_bwd": 3 * numel * elt}
    # per element: n squares, n-1 adds, a*W, k+, pow, x*p (K3a); the same
    # plus t (2 mul), the first term (2 mul), n-1 adjoint adds, 2 mul
    # and the subtraction (K3b)
    ops = {"lrn": numel * (2 * n + 3), "lrn_bwd": numel * (3 * n + 9)}
    copies = copies_for(nb["lrn_bwd"])
    xs = [x] + [x.clone() for _ in range(copies - 1)]
    gs = [g] + [g.clone() for _ in range(copies - 1)]
    reps = max(2, 20 // copies)

    def lib_fwd(i):
        return F.local_response_norm(xs[i].permute(0, 3, 1, 2), n,
                                     alpha=alpha, beta=0.75, k=k)

    xr = [t.detach().clone().requires_grad_() for t in xs]

    def lib_fwd_bwd(i):
        y = F.local_response_norm(xr[i].permute(0, 3, 1, 2), n,
                                  alpha=alpha, beta=0.75, k=k)
        return torch.autograd.grad(y, xr[i], gs[i].permute(0, 3, 1, 2))

    out = {}
    times = {
        "lrn": (graph_ms(torch, [(lambda i=i: lrn.lrn_fwd(xs[i], n, k,
                                                          alpha))
                                 for i in range(copies)], reps),
                graph_ms(torch, [(lambda i=i: lrn.lrn_plain(xs[i], n, k,
                                                            alpha))
                                 for i in range(copies)], max(2, reps // 2)),
                graph_ms(torch, [(lambda i=i: lib_fwd(i))
                                 for i in range(copies)], reps)),
        "lrn_bwd": (graph_ms(torch, [(lambda i=i: lrn.lrn_bwd(
                        xs[i], gs[i], n, k, alpha))
                        for i in range(copies)], reps),
                    graph_ms(torch, [(lambda i=i: lrn.lrn_bwd_plain(
                        xs[i], gs[i], n, k, alpha))
                        for i in range(copies)], max(2, reps // 2)),
                    None)}
    fwd_bwd = graph_ms(torch, [(lambda i=i: lib_fwd_bwd(i))
                               for i in range(copies)], reps)
    times["lrn_bwd"] = times["lrn_bwd"][:2] + (fwd_bwd - times["lrn"][2],)
    for name, (k_ms, p_ms, l_ms) in times.items():
        out[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                     "nbytes": nb[name], "ops": ops[name],
                     "bound_ms": bound_ms(nb[name], ops[name])}
    out["library_fwd_bwd_ms"] = fwd_bwd
    return out


# -- phase 12: the attention kernels against their plain versions ----------

def causal_pairs(q_pos, k_pos, causal: bool) -> int:
    """Query-key pairs the mask lets through (all of them unless
    causal), for one (b, h)."""
    if not causal:
        return len(q_pos) * len(k_pos)
    return int((q_pos[:, None] >= k_pos[None, :]).sum())


def check_k4(torch) -> dict:
    """K4a and the two K4b passes against their plain versions on the
    card: the slice's shape (8, 1024, 12, 64) causal in bf16 and f32, a
    non-causal case, Tq != Tk with global positions (q_pos = 512 +
    arange(256) against 1024 keys), rows that see no key at all, ragged
    T (1000 and 77), the default model's d_head 32, both position
    vectors shuffled (the skip rule assumes no order), a query tile
    holding rows that see no key beside rows that do (q_pos = arange(160)
    - 40 against 256 keys), Tk = 130 against Tq = 65, d_head 40
    (padded to 64), d_head 20 (loaded without cp.async) and 66 000 keys
    (planned in two chunks of key tiles); each within the limits of
    ``attention.tolerance_excess`` (stated there).  At the slice's bf16
    shape: each kernel, the same kernel without the causal mask, the plain
    versions and ``F.scaled_dot_product_attention`` (forward, and forward +
    backward through autograd, on the (B, H, T, D) view) timed with CUDA
    graphs, beside each kernel's bound (operations at the bf16
    tensor-core rate: 4*D per unmasked pair forward, 6*D for the row pass,
    8*D for the column pass, 10*D for the backward as a whole; bytes: each
    input read once, each output written once)."""
    import torch.nn.functional as F

    from theanompi_tpu_torch.ops import attention

    bf16, f32 = torch.bfloat16, torch.float32
    b, t, h, d = (LM_BATCH, LM_DIMS["seq_len"], LM_DIMS["n_heads"],
                  LM_DIMS["d_model"] // LM_DIMS["n_heads"])
    # (label, B, Tq, Tk, H, D, causal, q_pos offset (None: both position
    # vectors shuffled), dtype)
    cases = [("slice", b, t, t, h, d, True, 0, bf16),
             ("slice", b, t, t, h, d, True, 0, f32),
             ("non-causal", 2, t, t, h, d, False, 0, bf16),
             ("global positions", b, 256, t, h, d, True, 512, bf16),
             ("global positions", b, 256, t, h, d, True, 512, f32),
             ("rows see no key", 2, 256, t, h, d, True, -100, bf16),
             ("ragged T", 2, 1000, 1000, h, d, True, 0, bf16),
             ("ragged T", 2, 77, 77, h, d, True, 0, f32),
             ("d_head 32", 16, 128, 128, 4, 32, True, 0, bf16),
             ("shuffled positions", 2, t, t, h, d, True, None, bf16),
             ("no-key border", 2, 160, 256, h, d, True, -40, bf16),
             ("ragged Tk", 2, 65, 130, h, d, True, 0, bf16),
             ("d_head 40", 4, 256, 256, 4, 40, True, 0, bf16),
             ("d_head 20", 2, 70, 90, 4, 20, True, 5, bf16),
             ("over 1024 key tiles", 1, 64, 66000, 2, 16, True, 65950,
              bf16)]
    gen = torch.Generator(device="cuda").manual_seed(12)
    perm = torch.Generator().manual_seed(13)
    rows_out = []
    worst = {"attention": 0.0, "attention_bwd_dq": 0.0,
             "attention_bwd_dkdv": 0.0}
    timed = None
    for label, b_, tq, tk, h_, d_, causal, off, dtype in cases:
        q, k, v = (torch.randn(b_, n, h_, d_, generator=gen,
                               device="cuda").to(dtype)
                   for n in (tq, tk, tk))
        g = torch.randn(b_, tq, h_, d_, generator=gen, device="cuda").to(dtype)
        if off is None:
            q_pos, k_pos = (torch.randperm(n, generator=perm).to(
                "cuda", torch.int32) for n in (tq, tk))
        else:
            q_pos = torch.arange(tq, device="cuda", dtype=torch.int32) + off
            k_pos = torch.arange(tk, device="cuda", dtype=torch.int32)
        scale = d_ ** -0.5
        o, lse = attention.attention_fwd(q, k, v, q_pos, k_pos, scale, causal)
        grads = attention.attention_bwd(q, k, v, q_pos, k_pos, lse, g, scale,
                                        causal)
        want_o, want_lse = attention.attention_fwd_plain(q, k, v, q_pos,
                                                         k_pos, scale, causal)
        want = attention.attention_bwd_plain(q, k, v, q_pos, k_pos, lse, g,
                                             scale, causal)
        torch.cuda.synchronize()
        got = {"o": o, "lse": lse, "dq": grads[0], "dk": grads[1],
               "dv": grads[2]}
        wanted = {"o": want_o, "lse": want_lse, "dq": want[0],
                  "dk": want[1], "dv": want[2]}
        fwd_inputs = (q, k, v, q_pos, k_pos, scale, causal)
        excess = {n: attention.tolerance_excess(n, got[n], wanted[n],
                                                fwd_inputs)
                  for n in got}
        err = {n: float((got[n].float() - wanted[n].float()).abs().max())
               for n in got}
        finite = all(bool(torch.isfinite(x).all()) for x in got.values())
        worst["attention"] = max(worst["attention"], err["o"])
        worst["attention_bwd_dq"] = max(worst["attention_bwd_dq"], err["dq"])
        worst["attention_bwd_dkdv"] = max(worst["attention_bwd_dkdv"],
                                          err["dk"], err["dv"])
        row = {"case": label, "shape_q": [b_, tq, h_, d_], "tk": tk,
               "causal": causal, "q_pos_offset": off,
               "dtype": str(dtype).replace("torch.", ""),
               "excess": excess, "max_abs_err": err}
        log(f"  K4 {label:18s} q {str([b_, tq, h_, d_]):18s} tk {tk:4d} "
            f"{'causal' if causal else 'full':6s} {row['dtype']:8s}: "
            "error / limit " + ", ".join(f"{n} {x:.3f}"
                                         for n, x in excess.items()))
        if max(excess.values()) > 1.0 or not finite:
            raise AssertionError(f"K4 {row}: kernel off its plain version "
                                 f"(finite {finite})")
        del o, lse, grads, want_o, want_lse, want, got, wanted, fwd_inputs
        if label == "slice" and dtype == bf16:
            row["timing"] = timed = time_k4(torch, F, attention, q, k, v, g,
                                            q_pos, k_pos, scale)
        rows_out.append(row)
        del q, k, v, g
        torch.cuda.empty_cache()
    return {"cases": rows_out, "max_abs_err": worst, **timed}


def time_k4(torch, F, attention, q, k, v, g, q_pos, k_pos, scale) -> dict:
    """Device ms per launch of K4a, the K4b row pass and the K4b column
    pass at the slice's shape (bf16, causal), of the plain versions
    (forward; backward from the kernel's lse) and of SDPA (forward; and
    forward + backward less forward, the backward both passes compute
    together), with each kernel's bound; and each kernel on the same
    inputs without the causal mask (``noncausal_ms``: causal tile skipping
    should bring the causal time near 136/256 of it)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    rd = torch.empty((b * h, tq, 2), dtype=torch.float32, device="cuda")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))

    def passes(causal):
        """K4a, the row pass and the column pass, causal or not."""
        _, lse = attention.attention_fwd(q, k, v, q_pos, k_pos, scale,
                                         causal)
        dims = (b, tq, tk, h, d, scale, int(causal), 1)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                k_pos.data_ptr(), g.data_ptr(), lse.data_ptr())
        return {"attention": lambda: attention.attention_fwd(
                    q, k, v, q_pos, k_pos, scale, causal),
                "attention_bwd_dq": lambda: attention.K_BWD_DQ(
                    q.device, *ptrs, dq.data_ptr(), rd.data_ptr(), *dims),
                "attention_bwd_dkdv": lambda: attention.K_BWD_DKDV(
                    q.device, *ptrs, rd.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), *dims)}, lse

    # each lse stays referenced while its closures hold its pointer
    causal_fns, lse = passes(True)
    full_fns, lse_full = passes(False)

    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    qr, kr, vr = (x.detach().clone().requires_grad_() for x in (qs, ks, vs))
    gs = g.transpose(1, 2)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
        return torch.autograd.grad(out, (qr, kr, vr), gs)

    reps = 4
    ms = {name: graph_ms(torch, [fn], reps)
          for name, fn in causal_fns.items()}
    full_ms = {name: graph_ms(torch, [fn], reps)
               for name, fn in full_fns.items()}
    plain = {"attention": graph_ms(torch, [
                 lambda: attention.attention_fwd_plain(
                     q, k, v, q_pos, k_pos, scale, True)], 2),
             "backward": graph_ms(torch, [
                 lambda: attention.attention_bwd_plain(
                     q, k, v, q_pos, k_pos, lse, g, scale, True)], 2)}
    sdpa_fwd = graph_ms(torch, [lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True)], reps)
    sdpa_fwd_bwd_ms = graph_ms(torch, [sdpa_fwd_bwd], reps)
    pairs = b * h * causal_pairs(q_pos.cpu().numpy(), k_pos.cpu().numpy(),
                                 True)
    # the skip rule's count per (b, h), from its plain mirror (the log's
    # reference for noncausal_ms; nothing on the card counts tiles)
    skipped = attention.skipped_tiles(q_pos, k_pos, True)
    kept, n_tiles = int((~skipped).sum()), skipped.numel()
    elt = q.element_size()
    n_q, n_k = q.numel() * elt, k.numel() * elt
    lse_b = lse.numel() * 4
    work = {"attention": (2 * n_q + 2 * n_k + lse_b, 4 * d * pairs),
            "attention_bwd_dq": (2 * n_q + 2 * n_k + lse_b + n_q
                                 + 2 * lse_b, 6 * d * pairs),
            "attention_bwd_dkdv": (2 * n_q + 2 * n_k + 3 * lse_b + 2 * n_k,
                                   8 * d * pairs),
            "backward": (2 * n_q + 2 * n_k + lse_b + n_q + 2 * n_k,
                         10 * d * pairs)}
    out = {"pairs": pairs, "rule_tile_pairs": [kept, n_tiles],
           "sdpa_fwd_ms": sdpa_fwd,
           "sdpa_fwd_bwd_ms": sdpa_fwd_bwd_ms,
           "sdpa_bwd_ms": sdpa_fwd_bwd_ms - sdpa_fwd,
           "plain_bwd_ms": plain["backward"],
           "bwd_ms": ms["attention_bwd_dq"] + ms["attention_bwd_dkdv"],
           "bwd_bound_ms": bound_ms(*work["backward"], BF16_OPS_PER_S)}
    for name, k_ms in ms.items():
        nbytes, ops = work[name]
        out[name] = {"ms": k_ms, "bound_ms": bound_ms(nbytes, ops,
                                                      BF16_OPS_PER_S),
                     "bound_by": bound_by(nbytes, ops, BF16_OPS_PER_S),
                     "nbytes": nbytes, "ops": ops,
                     "tflops": ops / k_ms / 1e9,
                     "noncausal_ms": full_ms[name]}
    out["attention"].update(plain_ms=plain["attention"],
                            library_ms=sdpa_fwd)
    for name in ("attention_bwd_dq", "attention_bwd_dkdv"):
        # no one call computes one pass: each K4b entry carries the whole
        # backward's times (both passes: backward_ms), its plain version's
        # and SDPA's backward
        out[name].update(plain_ms=plain["backward"],
                         library_ms=out["sdpa_bwd_ms"],
                         backward_ms=out["bwd_ms"],
                         backward_bound_ms=out["bwd_bound_ms"])
    log(f"  at {[b, tq, h, d]} bf16 causal ({pairs} unmasked pairs; the "
        f"skip rule keeps {kept} of {n_tiles} 64x64 tile pairs per (b, h), "
        "by its CPU mirror): K4a "
        f"{ms['attention']:.4f} ms ({out['attention']['tflops']:.1f} "
        f"TFLOP/s; bound {out['attention']['bound_ms']:.4f}, plain "
        f"{plain['attention']:.4f}, SDPA {sdpa_fwd:.4f}); K4b row pass "
        f"{ms['attention_bwd_dq']:.4f} ms (bound "
        f"{out['attention_bwd_dq']['bound_ms']:.4f}), column pass "
        f"{ms['attention_bwd_dkdv']:.4f} ms (bound "
        f"{out['attention_bwd_dkdv']['bound_ms']:.4f}); backward "
        f"{out['bwd_ms']:.4f} ms (bound {out['bwd_bound_ms']:.4f}, plain "
        f"{plain['backward']:.4f}, SDPA backward {out['sdpa_bwd_ms']:.4f})")
    log("  the same kernels without the causal mask: " + ", ".join(
        f"{name} {full_ms[name]:.4f} ms (causal / full "
        f"{ms[name] / full_ms[name]:.3f})" for name in ms)
        + f"; the rule's share {kept / n_tiles:.3f}")
    return out


# -- phase 4: the served slice ----------------------------------------------

def seeded_weights(torch, ref_model, seed: int,
                   exit_scales: tuple[float, float] = SERVE_EXIT_SCALES
                   ) -> None:
    """Random weights a bf16 comparison can read: every BN scale nonzero
    (exit BNs uniform in ``exit_scales``, the rest in [0.5, 1.5], so
    K1b's x*scale term is live), biases N(0, 0.1), and running mean/var
    set to the batch statistics of seeded calibration images, so
    activations stay O(1) through the depth.  Runs on the f32 CPU
    reference model."""
    from theanompi_tpu_torch.models.layers import BatchNormAct

    rng = np.random.default_rng(seed)
    module = ref_model.module
    exits = {id(blk.bn2) for blk in module.blocks}
    bns = [m for m in module.modules() if isinstance(m, BatchNormAct)]

    def calibrate(mod, args):
        x = args[0].float()
        mod.mean.copy_(x.mean((0, 1, 2)))
        mod.var.copy_(x.var((0, 1, 2), unbiased=False))

    with torch.no_grad():
        for m in bns:
            c = m.scale.numel()
            lo, hi = exit_scales if id(m) in exits else (0.5, 1.5)
            m.scale.copy_(torch.from_numpy(
                rng.uniform(lo, hi, c).astype(np.float32)))
            m.bias.copy_(torch.from_numpy(
                (0.1 * rng.standard_normal(c)).astype(np.float32)))
        hooks = [m.register_forward_pre_hook(calibrate) for m in bns]
        cal = rng.integers(0, 256, (8, 224, 224, 3), dtype=np.uint8)
        module(ref_model.data.device_transform(torch.from_numpy(cal)))
        for h in hooks:
            h.remove()


def serve(torch, model, ref_model, export_dir: str) -> dict:
    from theanompi_tpu_torch.ops import _kernels
    from theanompi_tpu_torch.serving import (
        BatchPolicy,
        InferenceServer,
        export_model,
    )

    export_model(model, export_dir, version=0)
    t0 = time.monotonic()
    server = InferenceServer(
        export_dir, replicas=1, device="cuda", reload_poll_s=0,
        policy=BatchPolicy(max_batch=BATCH, max_delay_ms=5.0,
                           max_queue=256))

    rng = np.random.default_rng(3)
    n_threads, per_thread = 12, 8
    reqs = [[rng.integers(0, 256, (int(rng.integers(1, 5)), 224, 224, 3),
                          dtype=np.uint8) for _ in range(per_thread)]
            for _ in range(n_threads)]
    answers = [[None] * per_thread for _ in range(n_threads)]
    lat_ms = []
    errors = []
    lock = threading.Lock()

    def client(i):
        try:
            for j, x in enumerate(reqs[i]):
                t = time.monotonic()
                answers[i][j] = server.submit(x)
                with lock:
                    lat_ms.append((time.monotonic() - t) * 1e3)
        except Exception as e:  # reported and failed below
            errors.append(e)

    server.start()
    log(f"  server up (export load + warmup of buckets "
        f"{server.policy.resolved_buckets()}) in "
        f"{time.monotonic() - t0:.1f} s")
    try:
        threads = [threading.Thread(target=client, args=(i,),
                                    name=f"smoke-client-{i}")
                   for i in range(n_threads)]
        _kernels.reset_launch_counts()
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.monotonic() - t0
        launches = _kernels.launch_counts()
        stats = server.stats()
    finally:
        server.stop()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"requests failed: {errors[:3]}")
    n_req = n_threads * per_thread
    rows = sum(x.shape[0] for r in reqs for x in r)
    batches = stats["batches"]
    log(f"  {n_req} requests ({rows} rows) from {n_threads} threads in "
        f"{batches} batches, max_occupancy {stats['max_occupancy']}; "
        f"launches {launches}")
    if stats["max_occupancy"] <= 1:
        raise AssertionError("no coalescing: max_occupancy <= 1")
    want = {k: 0 for k in launches}
    want.update(scale_bias_act=37 * batches, scale_bias_act_res=16 * batches,
                maxpool3x3s2=batches)
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want} for "
                             f"{batches} batches")

    # answers of a subset of rows against the f32 CPU reference
    got, xs = [], []
    for i in range(n_threads):
        for j in range(per_thread):
            if sum(x.shape[0] for x in xs) >= CHECK_ROWS:
                break
            xs.append(reqs[i][j])
            got.append(answers[i][j])
    x = np.concatenate(xs)
    got = np.concatenate(got)
    with torch.inference_mode():
        xt = ref_model.data.device_transform(torch.from_numpy(x))
        want_logits = ref_model.module(xt).numpy()
    if got.shape != want_logits.shape or not np.isfinite(got).all():
        raise AssertionError(f"served logits {got.shape} not finite or "
                             f"not {want_logits.shape}")
    rel = (np.linalg.norm(got - want_logits, axis=1)
           / np.linalg.norm(want_logits, axis=1))
    top1 = float((got.argmax(1) == want_logits.argmax(1)).mean())
    log(f"  {len(x)} rows vs f32 CPU reference: max rel L2 "
        f"{rel.max():.4g}, top-1 agreement {top1:.3f}")
    if rel.max() > 0.05 or top1 < 0.9:
        raise AssertionError(f"served answers off the f32 reference: rel "
                             f"L2 {rel.max():.4g} (<= 0.05), top-1 {top1} "
                             "(>= 0.9)")
    lat = np.sort(np.asarray(lat_ms))
    return {"requests": n_req, "rows": rows, "batches": batches,
            "max_occupancy": stats["max_occupancy"], "launches": launches,
            "wall_s": wall, "requests_per_s": n_req / wall,
            "rows_per_s": rows / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "max_rel_l2": float(rel.max()), "top1_agreement": top1,
            "checked_rows": int(len(x))}


def trace_forward(torch, export_dir: str) -> dict:
    """Where one batch-32 ``InferenceSession.infer`` spends its time:
    host-clock ms per call (H2D of the uint8 rows, eval transform,
    forward, D2H of the logits), and from ``torch.profiler`` the device
    time by kernel family.  The idle share is 1 - device ms / host ms of
    the unprofiled calls: the profiler's own host work lengthens the
    profiled calls, so their wall is reported beside it, not used."""
    from torch.profiler import ProfilerActivity, profile

    from theanompi_tpu_torch.serving import InferenceSession

    session = InferenceSession.from_export(export_dir, device="cuda")
    x = np.random.default_rng(5).integers(0, 256, (BATCH, 224, 224, 3),
                                          dtype=np.uint8)
    for _ in range(3):
        session.infer(x)
    reps = 20
    t0 = time.monotonic()
    for _ in range(reps):
        session.infer(x)
    infer_ms = (time.monotonic() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(5):
            session.infer(x)
        wall_us = (time.monotonic() - t0) * 1e6
    families = {"fused_bn (K1)": 0.0, "maxpool (K2)": 0.0, "other": 0.0}
    by_name: dict[str, float] = {}
    for e in prof.events():
        if not device_kernel(torch, e):
            continue
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        fam = ("fused_bn (K1)" if "scale_bias_act_kernel" in e.name else
               "maxpool (K2)" if "maxpool3x3s2_kernel" in e.name else
               "other")
        families[fam] += us
    device_us = sum(families.values())
    device_ms = device_us / 5e3
    out = {"infer_ms": infer_ms, "images_per_s": BATCH * 1e3 / infer_ms,
           "profiled_infer_ms": wall_us / 5e3,
           "device_ms_per_infer": device_ms,
           "idle_share": (1 - device_ms / infer_ms) if device_us else None,
           "families_ms_per_infer": {k: v / 5e3
                                     for k, v in families.items()},
           "top_kernels_ms_per_infer": {
               k: v / 5e3 for k, v in sorted(by_name.items(),
                                             key=lambda kv: -kv[1])[:12]}}
    if not device_us:
        log("  torch.profiler recorded no device time (not measured)")
    else:
        log(f"  device {device_ms:.3f} ms per infer; by family "
            + ", ".join(f"{k} {v:.3f} ms"
                        for k, v in out["families_ms_per_infer"].items()))
    log(f"  batch-{BATCH} infer {infer_ms:.2f} ms host clock "
        f"({out['images_per_s']:.0f} images/s), "
        f"{out['profiled_infer_ms']:.2f} ms under the profiler")
    if device_us:
        log(f"  idle share {out['idle_share']:.3f} "
            f"(1 - {device_ms:.3f} / {infer_ms:.2f} ms unprofiled)")
    return out


# -- phase 6: the training slice --------------------------------------------

def rel_l2(torch, got, want) -> float:
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def one_bsp_step(torch, model, batch, crops, crop: int = 224,
                 lr: float = 0.05, weight_decay: float = 1e-4) -> dict:
    """One BSP step of ``model`` on uint8 ``batch`` with explicit crop
    offsets and flips; its loss, flattened gradient and updated running
    statistics (f32, on the CPU; empty without BatchNorm)."""
    from theanompi_tpu_torch.data.imagenet import IMAGENET_MEAN, IMAGENET_STD
    from theanompi_tpu_torch.models import layers as L
    from theanompi_tpu_torch.ops.augment import crop_flip_normalize
    from theanompi_tpu_torch.parallel.bsp import (
        TrainState,
        make_bsp_train_step,
        running_stats,
    )
    from theanompi_tpu_torch.utils.helper_funcs import build_optimizer

    dev = model.device
    ys, xs, flips = (t.to(dev) for t in crops)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)

    def loss_fn(module, batch_, rng_):
        xb, yb = batch_
        logits = module(crop_flip_normalize(xb, ys, xs, flips, crop, mean,
                                            std), train=True)
        loss = L.softmax_cross_entropy(logits, yb)
        return loss, {"error": L.error_rate(logits.detach(), yb)}

    model.module.train()
    state = TrainState(model.module, build_optimizer(
        model.module.parameters(), lr, "sgd", momentum=0.9,
        weight_decay=weight_decay))
    t0 = time.monotonic()
    metrics = make_bsp_train_step(loss_fn)(
        state, tuple(t.to(dev) for t in batch), None)
    out = {"loss": float(metrics["loss"]),
           "grads": torch.cat([p.grad.float().reshape(-1).cpu()
                               for p in model.module.parameters()]),
           "stats": torch.cat([torch.zeros(0)] + [
               b.float().reshape(-1).cpu()
               for b in running_stats(model.module)]),
           "s": time.monotonic() - t0}
    model.module.eval()
    return out


def grad_check(torch) -> dict:
    """One BSP step of the same weights as a bf16 model on the card, an
    f32 model on the CPU and a bf16 model on the CPU (both through the
    plain versions), on the same 8 uint8 images, crops and flips.

    At phase 4's weights (exit-BN scales 0.2-0.5) the gradient of a
    batch-8 train-mode step is chaotic: a rounding anywhere moves it by
    tens of percent, so bf16 on the CPU is as far from f32 as the card
    is.  Those weights are measured and printed, not held to a limit.
    The check runs at exit scales 0.05-0.1 (every BN scale still
    nonzero), where bf16 itself is about 0.05 from f32 in relative L2
    (measured here in every run: ``cpu_bf16_vs_f32``), so the gradient
    limit is 0.1, the most the check allows, and the card is also held
    to the CPU's bf16 step."""
    from theanompi_tpu_torch.models.resnet50 import ResNet50

    rng = np.random.default_rng(6)
    n = GRAD_CHECK_IMAGES
    batch = (torch.from_numpy(rng.integers(0, 256, (n, 256, 256, 3),
                                           dtype=np.uint8)),
             torch.from_numpy(rng.integers(0, 1000, n).astype(np.int64)))
    crops = (torch.from_numpy(rng.integers(0, 33, n)),
             torch.from_numpy(rng.integers(0, 33, n)),
             torch.from_numpy(rng.random(n) < 0.5))
    results = {}
    for label, exit_scales in (("serve_weights", SERVE_EXIT_SCALES),
                               ("check_weights", GRAD_CHECK_EXIT_SCALES)):
        f32 = ResNet50(device="cpu", config=dataclasses.replace(
            ResNet50.default_config(), compute_dtype="float32"))
        seeded_weights(torch, f32, seed=0, exit_scales=exit_scales)
        steps = {}
        for name, model in (("card", ResNet50(device="cuda")),
                            ("cpu_bf16", ResNet50(device="cpu")),
                            ("cpu_f32", f32)):
            if model is not f32:
                model.module.load_state_dict(f32.module.state_dict())
            steps[name] = one_bsp_step(torch, model, batch, crops)
        card, ref, bf = steps["card"], steps["cpu_f32"], steps["cpu_bf16"]
        r = {"exit_scales": list(exit_scales),
             "loss_card": card["loss"], "loss_cpu_f32": ref["loss"],
             "loss_rel": abs(card["loss"] - ref["loss"]) / abs(ref["loss"]),
             "grad_vs_f32": rel_l2(torch, card["grads"], ref["grads"]),
             "grad_vs_cpu_bf16": rel_l2(torch, card["grads"], bf["grads"]),
             "cpu_bf16_vs_f32": rel_l2(torch, bf["grads"], ref["grads"]),
             "stats": rel_l2(torch, card["stats"], ref["stats"]),
             "finite": bool(torch.isfinite(card["grads"]).all()),
             "cpu_f32_s": ref["s"], "cpu_bf16_s": bf["s"]}
        results[label] = r
        log(f"  exit-BN scales {exit_scales}: loss card {r['loss_card']:.6f} "
            f"cpu f32 {r['loss_cpu_f32']:.6f} (rel {r['loss_rel']:.3g}); "
            f"gradient rel L2 card vs f32 {r['grad_vs_f32']:.4g}, card vs "
            f"cpu bf16 {r['grad_vs_cpu_bf16']:.4g}, cpu bf16 vs f32 "
            f"{r['cpu_bf16_vs_f32']:.4g}; BN running stats rel L2 "
            f"{r['stats']:.4g} (cpu steps f32 {r['cpu_f32_s']:.1f} s, bf16 "
            f"{r['cpu_bf16_s']:.1f} s)")
    r = results["check_weights"]
    over = {k: r[k] for k, lim in GRAD_CHECK_LIMITS.items() if not r[k] <= lim}
    if over or not r["finite"]:
        raise AssertionError(
            f"card step off the CPU references at exit scales "
            f"{GRAD_CHECK_EXIT_SCALES}: {over} over {GRAD_CHECK_LIMITS}, "
            f"finite {r['finite']}")
    return {"images": n, "limits": GRAD_CHECK_LIMITS, **results}


def alexnet_grad_check(torch) -> dict:
    """One BSP step of the same seeded AlexNet as a bf16 model on the
    card, an f32 model on the CPU and a bf16 model on the CPU (plain
    versions), on the same 8 uint8 256x256 images with the same explicit
    227 crops and flips, under the recipe's SGD (LR 0.01, momentum 0.9,
    wd 5e-4).  Dropout is the identity on all three (rate 0), so the
    steps compare like with like.  The weights are He-normal
    (N(0, 2/fan_in)) with the recipe's bias constants, so activations
    stay O(1) through the depth.  Limits: loss within relative 1e-2,
    the flattened gradient within relative L2 0.1 of f32 and of the
    CPU's bf16 step."""
    from theanompi_tpu_torch.models import layers as L
    from theanompi_tpu_torch.models.alex_net import AlexNet

    rng = np.random.default_rng(8)
    n = GRAD_CHECK_IMAGES
    batch = (torch.from_numpy(rng.integers(0, 256, (n, 256, 256, 3),
                                           dtype=np.uint8)),
             torch.from_numpy(rng.integers(0, 1000, n).astype(np.int64)))
    crops = (torch.from_numpy(rng.integers(0, 30, n)),
             torch.from_numpy(rng.integers(0, 30, n)),
             torch.from_numpy(rng.random(n) < 0.5))
    f32 = AlexNet(device="cpu", config=dataclasses.replace(
        AlexNet.default_config(), compute_dtype="float32"))
    with torch.no_grad():
        for m in f32.module.modules():
            if isinstance(m, (L.Conv, L.Dense)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.from_numpy(
                    (rng.standard_normal(tuple(m.weight.shape))
                     * math.sqrt(2.0 / fan_in)).astype(np.float32)))
    steps = {}
    for name, model in (("card", AlexNet(device="cuda")),
                        ("cpu_bf16", AlexNet(device="cpu")),
                        ("cpu_f32", f32)):
        if model is not f32:
            model.module.load_state_dict(f32.module.state_dict())
        model.module.drop.rate = 0.0
        steps[name] = one_bsp_step(torch, model, batch, crops, crop=227,
                                   lr=0.01, weight_decay=5e-4)
    card, ref, bf = steps["card"], steps["cpu_f32"], steps["cpu_bf16"]
    r = {"images": n, "limits": ALEX_GRAD_LIMITS,
         "loss_card": card["loss"], "loss_cpu_f32": ref["loss"],
         "loss_rel": abs(card["loss"] - ref["loss"]) / abs(ref["loss"]),
         "grad_vs_f32": rel_l2(torch, card["grads"], ref["grads"]),
         "grad_vs_cpu_bf16": rel_l2(torch, card["grads"], bf["grads"]),
         "cpu_bf16_vs_f32": rel_l2(torch, bf["grads"], ref["grads"]),
         "finite": bool(torch.isfinite(card["grads"]).all()),
         "cpu_f32_s": ref["s"], "cpu_bf16_s": bf["s"]}
    log(f"  loss card {r['loss_card']:.6f} cpu f32 {r['loss_cpu_f32']:.6f} "
        f"(rel {r['loss_rel']:.3g}); gradient rel L2 card vs f32 "
        f"{r['grad_vs_f32']:.4g}, card vs cpu bf16 "
        f"{r['grad_vs_cpu_bf16']:.4g}, cpu bf16 vs f32 "
        f"{r['cpu_bf16_vs_f32']:.4g} (cpu steps f32 {r['cpu_f32_s']:.1f} "
        f"s, bf16 {r['cpu_bf16_s']:.1f} s)")
    over = {k: r[k] for k, lim in ALEX_GRAD_LIMITS.items() if not r[k] <= lim}
    if over or not r["finite"]:
        raise AssertionError(f"AlexNet card step off the CPU references: "
                             f"{over} over {ALEX_GRAD_LIMITS}, finite "
                             f"{r['finite']}")
    return r


def launcher_session(torch, workdir: str) -> dict:
    """The AlexNet slice's main path as a user starts it: ``python -m
    theanompi_tpu_torch.launcher BSP -D 1 -m
    theanompi_tpu_torch.models.alex_net -c AlexNet`` (one worker on this
    card, a one-rank NCCL group), the default recipe at batch 128 on the
    default synthetic pool, ``ALEX_EPOCHS`` epochs (:func:`launcher_run`)."""
    return launcher_run(torch, workdir, "theanompi_tpu_torch.models.alex_net",
                        "AlexNet", ALEX_EPOCHS, TRAIN_BATCH,
                        ALEX_TRAIN_LAUNCHES, ALEX_VAL_LAUNCHES,
                        ("print_freq=16",))


class Launched:
    """A ``python -m theanompi_tpu_torch.launcher <args>`` subprocess
    writing its result JSON under ``workdir`` and its output to files
    there (so runs side by side never block on a full pipe)."""

    def __init__(self, workdir: str, args: list[str]):
        self.out_json = os.path.join(workdir, "result.json")
        self.cmd = [sys.executable, "-m", "theanompi_tpu_torch.launcher",
                    *args, "--result-json", self.out_json]
        self.logs = [open(os.path.join(workdir, f"launcher.{k}"), "w+")
                     for k in ("stdout", "stderr")]
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            self.cmd, stdout=self.logs[0], stderr=self.logs[1], text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))

    def close(self) -> None:
        """Kill the run if it is still going (idempotent)."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def wait(self, timeout: float = 900) -> tuple[dict, float, str]:
        """The result JSON, the run's wall seconds and its stdout; raises
        on a non-zero exit (the output's tail in the message)."""
        try:
            self.proc.wait(timeout=timeout)
        finally:
            self.close()
        wall = time.monotonic() - self.t0
        stdout, stderr = (f.seek(0) or f.read() for f in self.logs)
        for f in self.logs:
            f.close()
        for line in stdout.strip().splitlines()[-6:]:
            log(f"    | {line}")
        if self.proc.returncode != 0:
            raise AssertionError(
                f"launcher exited {self.proc.returncode}:\n"
                + (stdout[-3000:] + stderr[-3000:]).strip())
        with open(self.out_json) as f:
            return json.load(f), wall, stdout


def launcher_start(workdir: str, modelfile: str, modelclass: str,
                   epochs: int, sets=()) -> Launched:
    """Start ``python -m theanompi_tpu_torch.launcher BSP -D 1 -m
    <modelfile> -c <modelclass> --epochs <epochs>`` with ``--set`` each
    of ``sets`` (:func:`launcher_run`)."""
    args = ["BSP", "-D", "1", "-m", modelfile, "-c", modelclass,
            "--epochs", str(epochs), "--snapshot-dir", workdir]
    for kv in sets:
        args += ["--set", kv]
    return Launched(workdir, args)


def launcher_run(torch, workdir: str, modelfile: str, modelclass: str,
                 epochs: int, batch: int, want_train: dict, want_val: dict,
                 sets=(), started: Launched | None = None) -> dict:
    """``python -m theanompi_tpu_torch.launcher BSP -D 1 -m <modelfile>
    -c <modelclass> --epochs <epochs>`` with ``--set`` each of ``sets``,
    in a subprocess (one worker on this card, a one-rank NCCL group),
    the model's default recipe and data.  The worker is a fresh process,
    so its launch counts start at 0; its epoch records carry the
    launches of each epoch's training steps and of its validation pass,
    held to ``want_train`` per step and ``want_val`` per validation
    batch (kernels the worker never imported count 0).  Every loss
    finite: the records hold each epoch's mean training loss, which is
    finite only if every step's loss (a cross-entropy, never negative)
    is.  Times: the last epoch's ms per step and images/s at the
    per-card ``batch``.  ``started``: the run, already started by
    :func:`launcher_start` (to run beside another)."""
    run = started or launcher_start(workdir, modelfile, modelclass, epochs,
                                    sets)
    res, wall, _ = run.wait()
    cmd = run.cmd
    recs = res["records"]
    if len(recs) != epochs or res["world_size"] != 1:
        raise AssertionError(f"launcher result: {len(recs)} epochs, world "
                             f"{res['world_size']}")
    totals: dict[str, int] = {}
    for rec in recs:
        steps, n_val = rec["train_steps"], rec["val_batches"]
        want_t = {k: v * steps for k, v in want_train.items()}
        want_v = {k: v * n_val for k, v in want_val.items()}
        got_t, got_v = ({k: rec["launches"][part].get(k, 0) for k in want}
                        for part, want in (("train", want_t),
                                           ("val", want_v)))
        unknown = (set(rec["launches"]["train"])
                   | set(rec["launches"]["val"])) - set(want_t)
        if got_t != want_t or got_v != want_v or unknown:
            raise AssertionError(
                f"epoch {rec['epoch']}: launches {rec['launches']} != train "
                f"{want_t}, val {want_v} ({steps} steps, {n_val} "
                "validation batches)")
        if not all(math.isfinite(rec[k]) for k in ("train_loss",
                                                   "val_loss")):
            raise AssertionError(f"non-finite loss in {rec}")
        for k in want_t:
            totals[k] = totals.get(k, 0) + got_t[k] + got_v[k]
    last = recs[-1]
    ms = last["train_s"] * 1e3 / last["train_steps"]
    out = {"cmd": " ".join(cmd[1:]), "wall_s": wall, "records": recs,
           "val": res["val"], "launches": totals,
           "ms_per_step": ms, "images_per_s": batch * 1e3 / ms,
           "first_epoch_ms_per_step": recs[0]["train_s"] * 1e3
           / recs[0]["train_steps"]}
    per_step = {KERNEL_IDS[k]: v for k, v in want_train.items() if v}
    per_val = {KERNEL_IDS[k]: v for k, v in want_val.items() if v}
    log(f"  {len(recs)} epoch(s) of {last['train_steps']} steps + "
        f"{last['val_batches']} validation batches in {wall:.1f} s; "
        f"launches per step {per_step or 'none'}, per validation batch "
        f"{per_val or 'none'} (totals {totals})")
    log(f"  epoch {last['epoch']}: {ms:.2f} ms/step, "
        f"{out['images_per_s']:.0f} images/s per card (epoch 0, first "
        f"steps included: {out['first_epoch_ms_per_step']:.2f} ms/step); "
        f"train loss {[r['train_loss'] for r in recs]}, val {res['val']}")
    if len(recs) > 1:
        out["overlap"] = overlap_ms(last)
        log(f"  epoch {last['epoch']} by the part of epoch "
            f"{last['epoch'] - 1}'s save running in the background: "
            f"{overlap_line(out['overlap'])}")
    return out


def overlap_ms(rec: dict) -> dict:
    """An epoch record's ``ckpt_overlap`` as steps, ms per step and loader
    wait in ms per step, per background part of a save ("none": steps no
    part overlapped)."""
    return {part: {"steps": v["steps"],
                   "ms_per_step": v["s"] * 1e3 / v["steps"],
                   "wait_ms_per_step": v["wait_s"] * 1e3 / v["steps"]}
            for part, v in rec["ckpt_overlap"].items() if v["steps"]}


def overlap_line(split: dict) -> str:
    return "; ".join(f"{part} {v['steps']} steps {v['ms_per_step']:.2f} ms"
                     f"/step (loader wait {v['wait_ms_per_step']:.2f})"
                     for part, v in split.items())


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def counted_session(torch, model) -> dict:
    """``run_bsp_session`` of ``model`` with every launch count set to 0
    just before it and read just after.  Records each step's loss, the
    validation pass's launches (taken around it), and ms per step between
    the first and the last in-epoch metrics flush (each flush waits for
    the card)."""
    from theanompi_tpu_torch.ops import _kernels
    from theanompi_tpu_torch.rules.bsp import run_bsp_session
    from theanompi_tpu_torch.utils.recorder import Recorder

    losses: list[float] = []
    flushes: list[tuple[int, float]] = []

    class LossRecorder(Recorder):
        def train_metrics(self, loss, error, n_images):
            losses.append(float(loss))
            super().train_metrics(loss, error, n_images)

    flush = model._flush_metrics

    def timed_flush(recorder):
        flush(recorder)
        flushes.append((len(losses), time.monotonic()))

    model._flush_metrics = timed_flush
    val_counts = {}
    val_epoch = model.val_epoch

    def counted_val_epoch(recorder):
        before = _kernels.launch_counts()
        out = val_epoch(recorder)
        after = _kernels.launch_counts()
        val_counts.update({k: after[k] - before[k] for k in after})
        return out

    model.val_epoch = counted_val_epoch
    recorder = LossRecorder(print_freq=model.config.print_freq,
                            flops_per_sample=model.train_flops_per_sample)
    _kernels.reset_launch_counts()
    t0 = time.monotonic()
    # no checkpoints: these sessions time the step as earlier PRs did
    # (phase 16 drives the checkpoints)
    result = run_bsp_session(model, recorder=recorder, checkpoint=False)
    wall = time.monotonic() - t0
    launches = _kernels.launch_counts()
    # the session's own flush after the epoch's last step is the final
    # entry: time from the first in-epoch flush to the last one
    (n0, t_first), (n1, t_last) = flushes[0], flushes[-2]
    return {"result": result, "losses": losses, "val_counts": val_counts,
            "launches": launches, "wall_s": wall,
            "ms_per_step": (t_last - t_first) * 1e3 / (n1 - n0),
            "timed_steps": [n0, n1]}


def train_session(torch, workdir: str) -> tuple[dict, object]:
    """``run_bsp_session`` of a batch-128 ResNet-50 on a one-rank NCCL
    group; returns the results and the trained model."""
    from theanompi_tpu_torch.data.imagenet import ImageNet_data
    from theanompi_tpu_torch.models.resnet50 import ResNet50
    from theanompi_tpu_torch.ops import fused_bn

    t0 = time.monotonic()
    data = ImageNet_data(seed=0, synthetic_n=TRAIN_STEPS * TRAIN_BATCH,
                         synthetic_pool=64, synthetic_store=256,
                         augment_on_device=True)
    config = dataclasses.replace(
        ResNet50.default_config(), batch_size=TRAIN_BATCH, n_epochs=1,
        print_freq=8, snapshot_dir=workdir)
    model = ResNet50(config=config, device="cuda", data=data)
    setup_s = time.monotonic() - t0
    fused_bn.grad_copies.reset()
    run = counted_session(torch, model)
    result, losses, wall = run["result"], run["losses"], run["wall_s"]
    launches, val_counts = run["launches"], run["val_counts"]
    copies = fused_bn.grad_copies.value
    steps = len(losses)
    train_counts = {k: launches[k] - val_counts.get(k, 0) for k in launches}
    n_val = data.n_val // TRAIN_BATCH
    want = {k: v * steps for k, v in TRAIN_LAUNCHES.items()}
    log(f"  {steps} steps + {n_val} validation batches in {wall:.1f} s "
        f"(set-up {setup_s:.1f} s); train launches {train_counts}, "
        f"validation {val_counts}")
    if steps != TRAIN_STEPS or train_counts != want:
        raise AssertionError(f"train launches {train_counts} != {want} "
                             f"for {steps} steps")
    if (val_counts.get("maxpool3x3s2") != n_val
            or val_counts.get("scale_bias_act") != 37 * n_val):
        raise AssertionError(f"validation launches {val_counts} for {n_val} "
                             "batches")
    if not all(math.isfinite(v) for v in losses) or not math.isfinite(
            result["val"]["loss"]):
        raise AssertionError(f"non-finite loss: {losses} {result['val']}")
    ms, (n0, n1) = run["ms_per_step"], run["timed_steps"]
    out = {"steps": steps, "val_batches": n_val, "launches": launches,
           "train_launches": train_counts, "val_launches": val_counts,
           "grad_copies": copies, "losses": losses, "val": result["val"],
           "ms_per_step": ms, "images_per_s": TRAIN_BATCH * 1e3 / ms,
           "timed_steps": [n0, n1], "wall_s": wall, "setup_s": setup_s}
    log(f"  session steps {n0 + 1}-{n1}: {ms:.2f} ms/step, "
        f"{out['images_per_s']:.0f} images/s per card (loader overlapped); "
        f"losses {losses[0]:.4f} -> {losses[-1]:.4f}, val {result['val']}; "
        f"K1 backward gradient copies {copies}")
    return out, model


# -- phases 13-15: the transformer slice -------------------------------------

def lm_model(torch, device: str, dtype: str = "bfloat16", data=None,
             n_epochs: int = 1, workdir: str | None = None):
    """A TransformerLM at bench_lm's recipe (``LM_DIMS``, batch 8, AdamW
    at 1e-3 with weight decay 0.01, constant schedule) in ``dtype``."""
    from theanompi_tpu_torch.models.base import ModelConfig
    from theanompi_tpu_torch.models.transformer import TransformerLM

    config = ModelConfig(
        batch_size=LM_BATCH, n_epochs=n_epochs, optimizer="adamw",
        learning_rate=1e-3, weight_decay=0.01, lr_schedule="constant",
        compute_dtype=dtype, print_freq=8,
        snapshot_dir=workdir or "./snapshots")
    return TransformerLM(config=config, device=device, data=data, **LM_DIMS)


def lm_grad_check(torch) -> dict:
    """One BSP step of the same seeded full-width TransformerLM as a bf16
    model on the card, an f32 model on the CPU and a bf16 model on the
    CPU (plain attention), on the same 2 x 1024 tokens: the loss within
    relative 1e-2 and the flattened gradient within relative L2 0.1 of
    f32 and of the CPU's bf16 step."""
    from theanompi_tpu_torch.data.lm import SeqLM_data

    n, t = LM_GRAD_CHECK
    data = SeqLM_data(vocab=LM_DIMS["vocab"], seq_len=t, n_train=n,
                      n_val=n, seed=13)
    tokens, targets = next(iter(data.train_batches(0, n)))
    ref = lm_model(torch, "cpu", "float32", data=data)
    steps = {}
    for name, model in (("card", lm_model(torch, "cuda", data=data)),
                        ("cpu_bf16", lm_model(torch, "cpu", data=data)),
                        ("cpu_f32", ref)):
        if model is not ref:
            model.module.load_state_dict(ref.module.state_dict())
        model.compile_iter_fns()
        dev = model.device
        t0 = time.monotonic()
        metrics = model.train_step(model.state, (
            torch.from_numpy(tokens).to(dev),
            torch.from_numpy(targets).to(dev)), None)
        steps[name] = {
            "loss": float(metrics["loss"]),
            "grads": torch.cat([p.grad.float().reshape(-1).cpu()
                                for p in model.module.parameters()]),
            "s": time.monotonic() - t0}
        del model
    # the models hold reference cycles (their steps close over them):
    # free the card's copy before the next phases measure peak memory
    gc.collect()
    card, f32, bf = steps["card"], steps["cpu_f32"], steps["cpu_bf16"]
    r = {"tokens": [n, t], "layers": LM_DIMS["n_layers"],
         "limits": LM_GRAD_LIMITS, "loss_card": card["loss"],
         "loss_cpu_f32": f32["loss"],
         "loss_rel": abs(card["loss"] - f32["loss"]) / abs(f32["loss"]),
         "grad_vs_f32": rel_l2(torch, card["grads"], f32["grads"]),
         "grad_vs_cpu_bf16": rel_l2(torch, card["grads"], bf["grads"]),
         "cpu_bf16_vs_f32": rel_l2(torch, bf["grads"], f32["grads"]),
         "finite": bool(torch.isfinite(card["grads"]).all()),
         "cpu_f32_s": f32["s"], "cpu_bf16_s": bf["s"]}
    log(f"  {LM_DIMS['n_layers']} layers, {n}x{t} tokens: loss card "
        f"{r['loss_card']:.6f} cpu f32 {r['loss_cpu_f32']:.6f} (rel "
        f"{r['loss_rel']:.3g}); gradient rel L2 card vs f32 "
        f"{r['grad_vs_f32']:.4g}, card vs cpu bf16 "
        f"{r['grad_vs_cpu_bf16']:.4g}, cpu bf16 vs f32 "
        f"{r['cpu_bf16_vs_f32']:.4g} (cpu steps f32 {r['cpu_f32_s']:.1f} s, "
        f"bf16 {r['cpu_bf16_s']:.1f} s)")
    over = {k: r[k] for k, lim in LM_GRAD_LIMITS.items() if not r[k] <= lim}
    if over or not r["finite"]:
        raise AssertionError(f"LM card step off the CPU references: {over} "
                             f"over {LM_GRAD_LIMITS}, finite {r['finite']}")
    return r


def lm_session(torch, workdir: str) -> tuple[dict, object]:
    """``run_bsp_session`` of the full-width LM on a one-rank NCCL group,
    ``SeqLM_data(vocab=256, seq_len=1024, n_train=256, n_val=16)`` passed
    as ``data``: one epoch of 32 steps and 2 validation batches
    (``counted_session``)."""
    from theanompi_tpu_torch.data.lm import SeqLM_data

    t0 = time.monotonic()
    data = SeqLM_data(vocab=LM_DIMS["vocab"], seq_len=LM_DIMS["seq_len"],
                      n_train=LM_TRAIN_STEPS * LM_BATCH,
                      n_val=LM_VAL_BATCHES * LM_BATCH)
    model = lm_model(torch, "cuda", data=data, workdir=workdir)
    setup_s = time.monotonic() - t0
    run = counted_session(torch, model)
    result, losses, wall = run["result"], run["losses"], run["wall_s"]
    launches, val_counts = run["launches"], run["val_counts"]
    steps = len(losses)
    n_val = model.val_batches_run
    want_t = {k: v * steps for k, v in LM_TRAIN_LAUNCHES.items()}
    want_v = {k: v * n_val for k, v in LM_VAL_LAUNCHES.items()}
    # a kernel whose module this process never imported counts 0
    val_counts = {k: val_counts.get(k, 0) for k in want_v}
    train_counts = {k: launches.get(k, 0) - val_counts[k] for k in want_t}
    launches = {k: launches.get(k, 0) for k in want_t}
    log(f"  {steps} steps + {n_val} validation batches in {wall:.1f} s "
        f"(set-up {setup_s:.1f} s); train launches {train_counts}, "
        f"validation {val_counts}")
    if (steps != LM_TRAIN_STEPS or n_val != LM_VAL_BATCHES
            or train_counts != want_t or val_counts != want_v):
        raise AssertionError(f"LM launches train {train_counts} != {want_t}"
                             f", validation {val_counts} != {want_v} "
                             f"({steps} steps, {n_val} batches)")
    if not all(math.isfinite(v) for v in losses) or not math.isfinite(
            result["val"]["loss"]) or not losses[-1] < losses[0]:
        raise AssertionError(f"LM losses not finite or not falling: "
                             f"{losses} {result['val']}")
    ms, (n0, n1) = run["ms_per_step"], run["timed_steps"]
    tokens_per_s = LM_BATCH * LM_DIMS["seq_len"] * 1e3 / ms
    tflops = model.train_flops_per_sample * LM_BATCH / ms / 1e9
    out = {"steps": steps, "val_batches": n_val, "launches": launches,
           "train_launches": train_counts, "val_launches": val_counts,
           "losses": losses, "val": result["val"], "ms_per_step": ms,
           "tokens_per_s": tokens_per_s, "tflops": tflops,
           "train_flops_per_sample": model.train_flops_per_sample,
           "timed_steps": [n0, n1], "wall_s": wall, "setup_s": setup_s}
    log(f"  session steps {n0 + 1}-{n1}: {ms:.2f} ms/step, "
        f"{tokens_per_s:.0f} tokens/s per card, {tflops:.1f} TFLOP/s "
        f"(train_flops_per_sample {model.train_flops_per_sample:.4g}); "
        f"losses {losses[0]:.4f} -> {losses[-1]:.4f}, val {result['val']}")
    return out, model


def device_kernel(torch, event) -> bool:
    """A profiler event that is work on the card: a CUDA event that is
    not a user annotation (``Optimizer.step#SGD.step`` is a range on the
    device timeline around the optimizer's kernels, not a kernel)."""
    return (event.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


def family(name: str) -> str:
    """Kernel family of a device event name in a training step."""
    n = name.lower()
    if "attn_fwd" in n:
        return "attention forward (K4a)"
    if "attn_bwd_dq" in n or "attn_bwd_dkdv" in n:
        return "attention backward (K4b)"
    if "lrn_kernel" in n:
        return "LRN (K3a/K3b)"
    if "max_pool" in n or "avg_pool" in n:
        return "pools (F.max_pool2d)"
    if "distribution" in n or "philox" in n:
        return "dropout masks (random)"
    if "scale_bias_act_bwd_cluster_kernel" in n:
        return "K1 backward (K1c/K1d)"
    if "scale_bias_act_kernel" in n:
        return "K1 forward (K1a/K1b)"
    if "maxpool3x3s2" in n:
        return "max-pool (K2b/K2c)"
    if "nccl" in n:
        return "all-reduce (NCCL)"
    if ("sgd" in n or "adam" in n or "multi_tensor" in n
            or "foreach" in n):
        return "optimizer"
    if "wgrad" in n or "dgrad" in n or "bprop" in n:
        return "convolutions, backward"
    if any(k in n for k in ("conv", "xmma", "cudnn", "implicit", "gemm",
                            "cutlass", "sm90", "nvjet")):
        return ("convolutions and GEMMs (forward, and backward kernels not "
                "named so)")
    if "reduce" in n:
        return "reductions (BN or LayerNorm statistics, loss)"
    if "copy" in n or "memcpy" in n or "memset" in n:
        return "copies"
    return "other elementwise"


def eager_op_us(torch, n: int = 2000) -> float:
    """Host microseconds per eager PyTorch call that launches one tiny
    kernel (``add_`` on one element, ``n`` calls between two
    synchronisations): the host's dispatch rate in this run, the yardstick
    for a leg's host-side cost per launch."""
    a = torch.zeros(1, device="cuda")
    for _ in range(50):
        a.add_(1)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n):
        a.add_(1)
    torch.cuda.synchronize()
    return (time.monotonic() - t0) * 1e6 / n


def trace_train_step(torch, model, batch_size: int = TRAIN_BATCH) -> dict:
    """The device-step leg: one training step on a staged batch, timed
    on the host clock (20 steps, synchronised) and traced (3 steps).  The
    host side from the same trace: device events per step and the CPU
    time of the kernel-launch calls, beside ``eager_op_us`` measured just
    before, so a host that is slow in this run is told apart from a step
    that makes many launches."""
    from torch.profiler import ProfilerActivity, profile

    x, y = next(iter(model.data.train_batches(0, batch_size)))
    batch = (torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    gen = model._epoch_rng(0)

    def step():
        return model.train_step(model.state, batch, gen)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    reps = 20
    t0 = time.monotonic()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) * 1e3 / reps
    op_us = eager_op_us(torch)
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    families: dict[str, float] = {}
    family_events: dict[str, int] = {}
    by_name: dict[str, float] = {}
    by_id = {k: 0 for k in TRACE_KERNELS}
    n_device, launch_us, memsets, memset_us = 0, 0.0, 0, 0.0
    for e in prof.events():
        if e.name.startswith(("cudaLaunch", "cuLaunch")):
            launch_us += e.time_range.elapsed_us()
        if not device_kernel(torch, e):
            continue
        n_device += 1
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        fam = family(e.name)
        families[fam] = families.get(fam, 0.0) + us
        family_events[fam] = family_events.get(fam, 0) + 1
        if "memset" in e.name.lower():
            memsets += 1
            memset_us += us
        for k, pat in TRACE_KERNELS.items():
            by_id[k] += bool(re.search(pat, e.name))
    device_ms = sum(families.values()) / 3e3
    out = {"step_ms": step_ms, "images_per_s": batch_size * 1e3 / step_ms,
           "device_ms_per_step": device_ms,
           "idle_share": (1 - device_ms / step_ms) if device_ms else None,
           "peak_memory_gb": peak_gb,
           "device_events_per_step": n_device / 3,
           "launch_call_ms_per_step": launch_us / 3e3,
           "eager_op_us": op_us,
           "families_ms_per_step": {k: v / 3e3 for k, v in sorted(
               families.items(), key=lambda kv: -kv[1])},
           "family_events_per_step": {k: v / 3 for k, v in
                                      family_events.items()},
           "kernel_events_per_step": {k: v / 3 for k, v in by_id.items()},
           "memsets_per_step": {"events": memsets / 3,
                                "ms": memset_us / 3e3},
           "top_kernels_ms_per_step": {
               k: v / 3e3 for k, v in sorted(by_name.items(),
                                             key=lambda kv: -kv[1])[:25]}}
    log(f"  device-step leg: {step_ms:.2f} ms/step on the host clock "
        f"({out['images_per_s']:.0f} samples/s per card), peak memory "
        f"{peak_gb:.1f} GB; host: {n_device / 3:.0f} device events and "
        f"{launch_us / 3e3:.2f} ms of launch calls per step (traced), "
        f"{op_us:.2f} us per eager one-kernel op")
    if not device_ms:
        log("  torch.profiler recorded no device time (not measured)")
    else:
        log(f"  device {device_ms:.2f} ms per step, idle share "
            f"{out['idle_share']:.3f}; by family " + ", ".join(
                f"{k} {v:.3f} ms"
                for k, v in out["families_ms_per_step"].items()))
    return out


def trace_alexnet_step(torch) -> dict:
    """The AlexNet device-step leg: the default recipe (batch 128, bf16,
    dropout on) on a staged synthetic batch, timed and traced as the
    ResNet step (``trace_train_step``)."""
    from theanompi_tpu_torch.data.imagenet import ImageNet_data
    from theanompi_tpu_torch.models.alex_net import AlexNet

    data = ImageNet_data(crop=227, seed=0, synthetic_n=2 * TRAIN_BATCH,
                         synthetic_pool=16, synthetic_store=256)
    model = AlexNet(device="cuda", data=data)
    model.compile_iter_fns()
    return trace_train_step(torch, model)


# -- phase 16: checkpoint and resume on the card ----------------------------

def __getattr__(name: str):
    """The model classes phases name by module path, built on first
    access, so importing this script needs no port:
    ``CrashOnceResNet50``, which phase 16 (c) names to the launcher
    (``-m chip_smoke -c CrashOnceResNet50``): ResNet-50 that raises at
    step ``CKPT_CRASH_STEP`` of epoch 1 in the first life of a launcher
    group, never after; ``P21AlexNet``, phase 21 (b)'s rule workers:
    AlexNet (the recipe's weights, drawn from the seed's CPU generator,
    so alike on every device) with no dropout; ``P22AlexNet``, phase
    22's launcher workers: the AlexNet recipe on ``P22_ITERS`` batches
    of the synthetic set and one validation batch."""
    if name == "P21AlexNet":
        return _p21_alexnet()
    if name == "P22AlexNet":
        return _p22_alexnet()
    if name != "CrashOnceResNet50":
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    from theanompi_tpu_torch.launcher import RESTART_ENV
    from theanompi_tpu_torch.models.resnet50 import ResNet50

    class CrashOnceResNet50(ResNet50):
        def train_iter(self, count, recorder):
            if (os.environ.get(RESTART_ENV, "0") == "0"
                    and self.current_epoch == 1 and count == CKPT_CRASH_STEP):
                raise RuntimeError("phase 16: crash on purpose")
            return super().train_iter(count, recorder)

    return CrashOnceResNet50


def _p21_alexnet():
    from theanompi_tpu_torch.models.alex_net import AlexNet

    class P21AlexNet(AlexNet):
        def __init__(self, config=None, device="cuda", data=None,
                     shard_rank=0, shard_size=1):
            super().__init__(config, device, data=data,
                             shard_rank=shard_rank, shard_size=shard_size)
            self.module.drop.rate = 0.0

    return P21AlexNet


def _p22_alexnet():
    from theanompi_tpu_torch.data.imagenet import ImageNet_data
    from theanompi_tpu_torch.models.alex_net import AlexNet

    class P22AlexNet(AlexNet):
        def build_data(self):
            data = ImageNet_data(crop=227, seed=self.config.seed,
                                 synthetic_n=P22_ITERS * TRAIN_BATCH)
            data.n_val = TRAIN_BATCH
            return data

    return P22AlexNet


def ckpt_shards(root: str) -> str:
    """A shard tree of ``CKPT_STEPS`` training batches and
    ``CKPT_VAL_BATCHES`` validation batches of 128 uint8 256x256 images
    drawn from the port's synthetic pool (64 images, seed 0), one shard
    each, written by the port's ``prepare_imagenet_shards``: first as
    npz, then again as npy pairs, which must remove every npz shard and
    leave a manifest whose counts are the arrays'; returns its
    directory."""
    from theanompi_tpu_torch.data.imagenet import (
        ImageNet_data,
        _load_shard,
        prepare_imagenet_shards,
    )

    pool = ImageNet_data(seed=0, synthetic_n=CKPT_STEPS * TRAIN_BATCH,
                         synthetic_pool=64)
    parts = {part: next(iter(batches)) for part, batches in (
        ("train", pool.train_batches(0, CKPT_STEPS * TRAIN_BATCH)),
        ("val", pool.train_batches(1, CKPT_VAL_BATCHES * TRAIN_BATCH)))}
    for shard_format in ("npz", "npy"):
        for part, (x, y) in parts.items():
            prepare_imagenet_shards(x, y, root, part, shard_size=len(y),
                                    shard_format=shard_format)
    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    names = sorted(os.listdir(root))
    want = ["manifest.json", "train_0000.x.npy", "train_0000.y.npy",
            "val_0000.x.npy", "val_0000.y.npy"]
    counts = {name: len(_load_shard(os.path.join(root, name))[1])
              for name in manifest}
    if names != want or manifest != counts or manifest != {
            "train_0000.x.npy": CKPT_STEPS * TRAIN_BATCH,
            "val_0000.x.npy": CKPT_VAL_BATCHES * TRAIN_BATCH}:
        raise AssertionError(f"shard tree {names}, manifest {manifest}, "
                             f"shards hold {counts}")
    log(f"  shard tree by prepare_imagenet_shards (npz, then npy): {names}, "
        f"manifest {manifest}")
    return root


def launcher_cmd(out: str, snap: str, workdir: str, data_dir: str,
                 *extra: str,
                 model=("theanompi_tpu_torch.models.resnet50", "ResNet50")
                 ) -> list[str]:
    """``python -m theanompi_tpu_torch.launcher BSP -D 1`` on the shard
    tree ``data_dir``, snapshots under ``workdir/<snap>``, the result
    JSON at ``out``."""
    return [sys.executable, "-m", "theanompi_tpu_torch.launcher", "BSP",
            "-D", "1", "-m", model[0], "-c", model[1],
            "--snapshot-dir", os.path.join(workdir, snap),
            "--set", f"data_dir={data_dir}", "--set",
            f"n_epochs={CKPT_EPOCHS}", "--set", "print_freq=4",
            "--result-json", out, *extra]


def ckpt_runs(workdir: str, data_dir: str, runs: dict,
              after: dict | None = None) -> dict:
    """``python -m theanompi_tpu_torch.launcher BSP -D 1`` runs side by
    side on the card (``runs`` maps a name to its snapshot directory
    under ``workdir``, extra arguments, model and environment); a run
    that ``after`` maps to another starts as soon as that one has ended
    (it resumes from its checkpoint), beside the runs still going.
    Returns per name its result JSON with the run's wall seconds (from
    its own start) and stderr's ``[resilience]`` lines.  Fails on a
    non-zero exit."""
    after = after or {}
    procs = {}
    t0 = time.monotonic()

    def start(name: str) -> None:
        snap, extra, model, env = runs[name]
        out = os.path.join(workdir, f"{name}.json")
        logs = [open(os.path.join(workdir, f"{name}.{k}"), "w+")
                for k in ("stdout", "stderr")]
        procs[name] = [out, logs, subprocess.Popen(
            launcher_cmd(out, snap, workdir, data_dir, *extra,
                         model=model),
            stdout=logs[0], stderr=logs[1], text=True,
            env={**os.environ, **(env or {})},
            cwd=os.path.dirname(os.path.abspath(__file__))), None,
            time.monotonic()]

    try:
        for name in runs:
            if name not in after:
                start(name)
        while True:
            for p in procs.values():
                if p[3] is None and p[2].poll() is not None:
                    p[3] = time.monotonic() - p[4]
            for name, first in after.items():
                if (name not in procs and first in procs
                        and procs[first][3] is not None
                        and procs[first][2].returncode == 0):
                    start(name)
            waiting = [n for n in after if n not in procs and (
                after[n] not in procs or procs[after[n]][3] is None)]
            if not waiting and all(p[3] is not None
                                   for p in procs.values()):
                break
            if time.monotonic() - t0 > 900:
                raise AssertionError(f"launcher runs {list(runs)} still "
                                     "running after 900 s")
            time.sleep(0.2)
        results = {}
        for name, (out, logs, proc, wall, _) in procs.items():
            stdout, stderr = (f.seek(0) or f.read() for f in logs)
            resilience = [line for line in stderr.splitlines()
                          if line.startswith("[resilience]")]
            for line in resilience:
                log(f"    | {line}")
            if proc.returncode != 0:
                raise AssertionError(f"launcher run {name} exited "
                                     f"{proc.returncode}:\n{stdout[-3000:]}"
                                     f"\n{stderr[-3000:]}")
            with open(out) as f:
                res = json.load(f)
            res.update(wall_s=wall, resilience=resilience)
            log(f"  ({name}) {' '.join(runs[name][1]) or 'unbroken'}: "
                f"{wall:.1f} s, epochs_run {res['epochs_run']}, epochs "
                f"{[r['epoch'] for r in res['records']]}")
            results[name] = res
        return results
    finally:
        for _, logs, proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            for f in logs:
                f.close()


def trace_kernel_ids(path: str) -> dict[str, int]:
    """Device kernel events per kernel id in a Chrome trace that
    ``StepProfiler`` wrote."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events
             if str(e.get("cat", "")).lower() == "kernel"]
    return {k: sum(1 for n in names if re.search(pat, n))
            for k, pat in TRACE_KERNELS.items()}


def final_state(torch, snap: str):
    """The flattened float tensors of the last epoch's checkpoint under
    ``snap`` (parameters, BN statistics, momentum), in f64."""
    from theanompi_tpu_torch.utils.checkpoint import Checkpointer

    ck = Checkpointer(os.path.join(snap, "resnet50"), read_only=True)
    payload = ck.restore(CKPT_EPOCHS - 1)
    ck.close()
    parts = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_floating_point():
                parts.append(x.double().reshape(-1))
        elif isinstance(x, dict):
            for k in sorted(x, key=str):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    for key in ("params", "model_state", "opt_state"):
        walk(payload[key])
    return torch.cat(parts)


def check_ckpt_run(res: dict, want_epochs_run: int) -> None:
    """Epochs 0..CKPT_EPOCHS-1 in the records, ``epochs_run`` as the JAX
    package counts it (epochs this invocation ran), every loss finite and
    the exact launches per step and validation batch."""
    epochs = [r["epoch"] for r in res["records"]]
    if epochs != list(range(CKPT_EPOCHS)) or (
            res["epochs_run"] != want_epochs_run):
        raise AssertionError(f"epochs {epochs}, epochs_run "
                             f"{res['epochs_run']} (want {want_epochs_run})")
    for rec in res["records"]:
        if not all(math.isfinite(rec[k]) for k in ("train_loss",
                                                   "val_loss")):
            raise AssertionError(f"non-finite loss in {rec}")
        steps, n_val = rec["train_steps"], rec["val_batches"]
        if (steps, n_val) != (CKPT_STEPS, CKPT_VAL_BATCHES):
            raise AssertionError(f"epoch {rec['epoch']}: {steps} steps, "
                                 f"{n_val} validation batches")
        for part, per, n in (("train", TRAIN_LAUNCHES, steps),
                             ("val", RESNET_VAL_LAUNCHES, n_val)):
            got = rec["launches"][part]
            want = {k: v * n for k, v in per.items()}
            if ({k: got.get(k, 0) for k in want} != want
                    or set(got) - set(want)):
                raise AssertionError(f"epoch {rec['epoch']} {part} "
                                     f"launches {got} != {want}")


def checkpoint_phase(torch, workdir: str) -> dict:
    """Phase 16 (module docstring): ResNet-50 through the launcher, (a)
    unbroken twice (the first profiled), (b) corrupted at its latest
    epoch by the fault plan and resumed through the fallback, (c) crashed
    and auto-resumed; every restore bit-exact against its save, the
    final states held to (a)'s.  The runs that need no other's checkpoint
    go side by side, and (b)'s resume starts beside them as soon as its
    first run has ended (the save pauses and times are then those of up
    to four processes sharing the card and the host)."""
    from theanompi_tpu_torch.resilience import recovery

    data = ckpt_shards(os.path.join(workdir, "data"))
    prof = os.path.join(workdir, "profile")
    r50 = ("theanompi_tpu_torch.models.resnet50", "ResNet50")
    # side by side; b2 resumes b1's checkpoint as soon as b1 has ended
    first = ckpt_runs(workdir, data, {
        "a1": ("a1", (), r50, {"THEANOMPI_TPU_PROFILE": prof,
                               "THEANOMPI_TPU_PROFILE_STEPS":
                               str(CKPT_PROFILE_STEPS)}),
        "a2": ("a2", (), r50, None),
        "b1": ("b", ("--epochs", "2", "--fault-plan", json.dumps(
            [{"site": "checkpoint", "epoch": 1, "action": "truncate"}])),
            r50, None),
        "c": ("c", ("--max-restarts", "1"),
              ("chip_smoke", "CrashOnceResNet50"), None),
        "b2": ("b", ("--resume", "--epochs", "2"), r50, None)},
        after={"b2": "b1"})
    a1, a2, c, b2 = first["a1"], first["a2"], first["c"], first["b2"]
    for res, want in ((a1, CKPT_EPOCHS), (a2, CKPT_EPOCHS), (b2, 2), (c, 2)):
        check_ckpt_run(res, want)
    if not any("is CORRUPT" in line for line in b2["resilience"]):
        raise AssertionError(f"(b) found no corrupt epoch: {b2['resilience']}")
    if not any("auto-resume 1/1" in line for line in c["resilience"]):
        raise AssertionError(f"(c) did not auto-resume: {c['resilience']}")
    restores = {}
    for name, res in (("b", b2), ("c", c)):
        r = res["checkpoint"]["restore"]
        if r is None or r["epoch"] != 0 or (
                r["digest_restored"] != r["digest_at_save"]):
            raise AssertionError(f"({name}) restore {r}: want epoch 0, its "
                                 "digest after restore equal to the one "
                                 "at save")
        restores[name] = r
    snap_b = os.path.join(workdir, "b", "resnet50")
    if (os.listdir(os.path.join(snap_b, "quarantine")) != ["1"]
            or recovery.verify_checkpoint(snap_b, 1)[0] is not True):
        raise AssertionError("(b): epoch 1 not quarantined and saved again")
    # the last-state comparison
    digests = {n: r["state_digests"][0]
               for n, r in (("a1", a1), ("a2", a2), ("b", b2), ("c", c))}
    if digests["a1"] == digests["a2"]:
        rule = "exact (the two unbroken runs agree bit for bit)"
        rel = {}
        if digests["b"] != digests["a1"] or digests["c"] != digests["a1"]:
            raise AssertionError(f"final state digests {digests}")
    else:
        ref = final_state(torch, os.path.join(workdir, "a1"))
        rel = {n: float((final_state(torch, os.path.join(workdir, n)) - ref)
                        .norm() / ref.norm()) for n in ("a2", "b", "c")}
        limit = CKPT_MARGIN * rel["a2"]
        rule = (f"relative L2 (the two unbroken runs differ by "
                f"{rel['a2']:.3g}; limit {CKPT_MARGIN} x that = "
                f"{limit:.3g})")
        if not (rel["b"] <= limit and rel["c"] <= limit):
            raise AssertionError(f"final states off (a): {rel}, {rule}")
    log(f"  last state against (a): {rule}; {rel or digests}")
    out = {"runs": {"a1": a1, "a2": a2, "b2": b2, "c": c},
           "rule": rule, "rel_l2": rel, "digests": digests,
           "restores": restores}
    traces = [os.path.join(prof, f) for f in os.listdir(prof)
              if f.endswith(".pt.trace.json")]
    if len(traces) != 1:
        raise AssertionError(f"profile dir holds {traces}")
    ids = trace_kernel_ids(traces[0])
    log(f"  trace {os.path.basename(traces[0])} "
        f"({os.path.getsize(traces[0]) / 1e6:.1f} MB, "
        f"{CKPT_PROFILE_STEPS} steps): kernel events {ids}")
    if not all(ids.values()):
        raise AssertionError(f"the profiler trace does not name every "
                             f"kernel of the path: {ids}")
    out["trace_kernels"] = ids
    runs = [r["checkpoint"]["saves"] for r in (a1, a2, b2, c)]
    saves = [s for run in runs for s in run]
    out["saves"] = saves
    # a process's first save also pins its host buffers
    first = sorted(run[0]["pause_ms"] for run in runs)
    pause = sorted(s["pause_ms"] for run in runs for s in run[1:])
    parts = {k: sorted(s[k] for s in saves if k in s)
             for k in ("write_s", "digest_s", "manifest_s")}
    restore_s = [r["s"] for r in restores.values()]
    mb = saves[0]["bytes"] / 1e6
    out.update(pause_first_ms=first, pause_ms=pause, restore_s=restore_s,
               checkpoint_mb=mb, **parts)
    log(f"  {card_line()}: save pause of the training thread "
        f"{pause[len(pause) // 2]:.2f} ms median of {len(pause)} "
        f"({pause[0]:.2f}-{pause[-1]:.2f}; a process's first save "
        f"{first[0]:.2f}-{first[-1]:.2f}); in the background, medians "
        + ", ".join(f"{k[:-2]} {v[len(v) // 2]:.3f} s ({v[0]:.3f}-"
                    f"{v[-1]:.3f})" for k, v in parts.items())
        + f"; restore (read, verify, load into the card) "
        f"{restore_s[0]:.3f} / {restore_s[1]:.3f} s; checkpoint {mb:.1f} MB")
    return out


# -- phase 17: the rest of the BSP step on the card ------------------------

def p17_batches(torch, n: int):
    """``n`` synthetic batch-128 uint8 batches staged on the card, and
    their dataset (on-device augment)."""
    from theanompi_tpu_torch.data.imagenet import ImageNet_data

    data = ImageNet_data(seed=0, synthetic_n=n * TRAIN_BATCH,
                         synthetic_pool=64, synthetic_store=256,
                         augment_on_device=True)
    it = data.train_batches(0, TRAIN_BATCH)
    return data, [tuple(torch.from_numpy(a).cuda() for a in next(it))
                  for _ in range(n)]


class P17Run:
    """One phase-17 model (full-width ResNet-50, the seeded weights every
    model of the phase starts from, bf16, batch 128 unless set) with its
    steps built, its epoch-0 generator, and ``call(run, i)``: its i-th
    dispatch (a step, a ``steps_per_call`` call or an accumulated
    update) on the staged batches."""

    def __init__(self, data, call, **cfg):
        from theanompi_tpu_torch.models.resnet50 import ResNet50

        config = dataclasses.replace(
            ResNet50.default_config(), **{"batch_size": TRAIN_BATCH,
                                          "n_epochs": 1, "print_freq": 0,
                                          **cfg})
        self.model = ResNet50(config=config, device="cuda", data=data)
        self.model.compile_iter_fns()
        self.gen = self.model._epoch_rng(0)
        self.call = call
        self.done = 0
        self.losses: list = []

    def step(self):
        metrics = self.call(self, self.done)
        self.done += 1
        self.losses.append(metrics["loss"])
        return metrics

    def state(self, torch):
        """Parameters and floating buffers, flattened (f32)."""
        return torch.cat([t.detach().float().reshape(-1)
                          for t in self.model.module.state_dict().values()
                          if t.is_floating_point()])

    def finite(self, torch) -> list[float]:
        losses = [float(x) for x in torch.cat(
            [torch.as_tensor(v).reshape(-1) for v in self.losses]).cpu()]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"non-finite loss: {losses}")
        return losses


def single_step(batches):
    return lambda run, i: run.model.train_step(
        run.model.state, batches[i % len(batches)], run.gen)


def capture_grads(model) -> tuple[list, list]:
    """Hooks that clone each parameter's gradient as the backward leaves
    it (before any exchange); returns the list they fill, in parameter
    order, and their handles (remove them after the step)."""
    params = list(model.module.parameters())
    got = [None] * len(params)

    def hook_for(i):
        def hook(p):
            got[i] = p.grad.detach().clone()
        return hook

    return got, [p.register_post_accumulate_grad_hook(hook_for(i))
                 for i, p in enumerate(params)]


def p17_exchange(torch, data, batches) -> tuple[dict, dict]:
    """Phase 17 (a), its first step: one model per exchange mode, step 1
    with the bf16 wire's and the residual's exact checks.  Returns the
    runs (timed and compared later) and the checks."""
    runs, checks = {}, {}
    # two f32 one-bucket models: their difference is the reproducibility
    # limit of the comparisons, their times the spread of a mode
    for name, cfg in (("f32-b1", {}), ("f32-b4", dict(exchange_buckets=4)),
                      ("params", dict(exchange_what="params")),
                      ("bf16-b1", dict(exchange_dtype="bf16")),
                      ("ef-b1", dict(exchange_dtype="bf16",
                                     exchange_error_feedback=True)),
                      ("ef-b4", dict(exchange_dtype="bf16",
                                     exchange_error_feedback=True,
                                     exchange_buckets=4)),
                      ("f32-b1-again", {})):
        run = runs[name] = P17Run(data, single_step(batches), **cfg)
        raw, hooks = capture_grads(run.model)
        run.step()
        torch.cuda.synchronize()
        for h in hooks:      # step 1 only: the timed steps run bare
            h.remove()
        params = list(run.model.module.parameters())
        if name == "bf16-b1":
            # the optimizer leaves .grad as the exchange wrote it
            checks[name] = all(torch.equal(p.grad, g.to(torch.bfloat16)
                                           .float())
                               for p, g in zip(params, raw))
        elif name.startswith("ef"):
            checks[name] = all(torch.equal(r, g - g.to(torch.bfloat16)
                                           .float())
                               for r, g in zip(
                                   run.model.state.exchange_residual, raw))
        del raw
    log(f"  step-1 exact checks {checks}")
    if checks != {"bf16-b1": True, "ef-b1": True, "ef-b4": True}:
        raise AssertionError(f"bf16 wire / residual checks failed: {checks}")
    return runs, checks


def p17_exchange_compare(torch, runs) -> dict:
    """Phase 17 (a), after the timed rounds: the modes' final states
    against one bucket."""
    final = {n: r.state(torch) for n, r in runs.items()}
    for n in ("ef-b1", "ef-b4"):
        final[n + "/residual"] = torch.cat(
            [x.reshape(-1) for x in runs[n].model.state.exchange_residual])
    ref = final["f32-b1"]
    repro = float((final["f32-b1-again"] - ref).abs().max())
    rule = ("bit for bit (two f32 one-bucket runs agree)" if repro == 0
            else f"within {repro:.3g} (the largest difference of two f32 "
                 "one-bucket runs)")
    diffs = {n: float((final[n] - ref).abs().max())
             for n in ("f32-b4", "params")}
    diffs["ef-b4"] = float((final["ef-b4"] - final["ef-b1"]).abs().max())
    diffs["ef-b4/residual"] = float(
        (final["ef-b4/residual"] - final["ef-b1/residual"]).abs().max())
    log(f"  (a) after {runs['f32-b1'].done} steps each, against one "
        f"bucket, {rule}: largest differences {diffs}")
    if any(v > repro for v in diffs.values()):
        raise AssertionError(f"exchange modes differ: {diffs}, {rule}")
    return {"repro_max_abs": repro, "diffs": diffs}


def p17_optimizers(torch, data, batches) -> tuple[dict, dict]:
    """Phase 17 (b): each optimizer's first ``P17_OPT_STEPS`` steps on the
    card against its class on the CPU, from the card's own gradients.
    Returns the runs (timed later) and the largest differences."""
    from theanompi_tpu_torch.utils.helper_funcs import build_optimizer

    runs, worst = {}, {}
    for name, lr in P17_OPTIMIZERS.items():
        run = runs[name] = P17Run(data, single_step(batches), optimizer=name,
                                  learning_rate=lr, momentum=0.9,
                                  weight_decay=5e-5)
        params = list(run.model.module.parameters())
        shadow = [p.detach().cpu().clone() for p in params]
        cpu_opt = build_optimizer(shadow, lr, **run.model._optimizer_kwargs())
        if type(cpu_opt) is not type(run.model.state.optimizer):
            raise AssertionError(f"{name}: CPU optimizer class differs")
        worst[name] = 0.0
        for _ in range(P17_OPT_STEPS):
            run.step()
            for s_, p in zip(shadow, params):
                s_.grad = p.grad.detach().cpu()
            cpu_opt.step()
            for s_, p in zip(shadow, params):
                rel = float((p.detach().cpu() - s_).abs().max()
                            / s_.abs().max().clamp_min(1e-30))
                worst[name] = max(worst[name], rel)
        log(f"  ({name}) card vs {type(cpu_opt).__name__} on the CPU over "
            f"{P17_OPT_STEPS} steps: largest difference {worst[name]:.3g} "
            f"of a parameter's largest value (limit {P17_OPT_REL}); losses "
            f"{run.finite(torch)}")
        if worst[name] > P17_OPT_REL:
            raise AssertionError(f"{name}: card vs CPU {worst[name]}")
        del shadow, cpu_opt
    return runs, worst


def p17_cadences(torch, data, batches) -> tuple[dict, dict]:
    """Phase 17 (c): steps_per_call against single calls, and
    accumulation's launches.  Returns the ``steps_per_call`` and
    accumulation runs (timed later) and the results."""
    from theanompi_tpu_torch.ops import _kernels

    final = {}
    for name, cfg, call, n in (
            ("single", {}, single_step(batches), P17_BATCHES),
            ("single-again", {}, single_step(batches), P17_BATCHES),
            ("steps_per_call=4", dict(steps_per_call=4),
             lambda run, i: run.model.train_step_multi(
                 run.model.state, [batches[(4 * i + j) % len(batches)]
                                   for j in range(4)], run.gen),
             P17_BATCHES // 4)):
        run = P17Run(data, call, **cfg)
        for _ in range(n):
            run.step()
        final[name] = run.state(torch)
        run.finite(torch)
        if name != "steps_per_call=4":
            del run
            torch.cuda.empty_cache()
    multi = run
    repro = float((final["single-again"] - final["single"]).abs().max())
    diff = float((final["steps_per_call=4"] - final["single"]).abs().max())
    log(f"  steps_per_call=4 against {P17_BATCHES} single calls: largest "
        f"difference {diff} (two single runs: {repro})")
    if diff > repro:
        raise AssertionError(f"steps_per_call differs: {diff} > {repro}")
    half = TRAIN_BATCH // 2
    micro = [(x[i:i + half], y[i:i + half]) for x, y in batches
             for i in (0, half)]
    accum = P17Run(data, lambda run, i: run.model.train_step_accum(
        run.model.state, [micro[(2 * i + j) % len(micro)] for j in (0, 1)],
        run.gen), batch_size=half, grad_accum_steps=2)
    updates = 4
    _kernels.reset_launch_counts()
    for _ in range(updates):
        accum.step()
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    want = {k: 2 * v * updates for k, v in TRAIN_LAUNCHES.items()}
    log(f"  grad_accum_steps=2 at 64: {updates} updates, "
        f"{accum.model.state.step} optimizer steps, losses "
        f"{accum.finite(torch)}; launches {counts}")
    if ({k: counts.get(k, 0) for k in want} != want
            or accum.model.state.step != updates):
        raise AssertionError(f"accumulation launches {counts} != {want}")
    return ({"steps_per_call=4": multi, "grad_accum_steps=2": accum},
            {"steps_per_call_diff": diff, "repro_max_abs": repro,
             "accum_launches": counts})


def p17_rounds(torch, runs: dict, rounds: int,
               steps: dict | None = None) -> dict:
    """Each run's next dispatch in turn, ``rounds`` times (so drift of the
    host hits every run alike), each one alone between synchronises:
    host enqueue (until the call returns; it also waits whenever the
    card's launch queue is full), host wall and the CUDA event span.
    Returns per run the medians in ms, per step (a ``steps_per_call``
    call counts 4, or ``steps[name]``; an accumulated update 1)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    samples = {n: [] for n in runs}
    for _ in range(rounds):
        for name, run in runs.items():
            torch.cuda.synchronize()
            t0 = time.monotonic()
            start.record()
            run.step()
            t1 = time.monotonic()
            end.record()
            end.synchronize()
            samples[name].append(((t1 - t0) * 1e3,
                                  (time.monotonic() - t0) * 1e3,
                                  start.elapsed_time(end)))
    out = {}
    for name, rows in samples.items():
        per = (steps or {}).get(name, 4 if name == "steps_per_call=4" else 1)
        cols = [sorted(c) for c in zip(*rows)]
        med = [c[len(c) // 2] / per for c in cols]
        out[name] = {"enqueue_ms": med[0], "wall_ms": med[1],
                     "event_ms": med[2],
                     "wall_ms_range": [cols[1][0] / per, cols[1][-1] / per]}
        runs[name].finite(torch)
        unit = ("update" if name == "grad_accum_steps=2" or "accum" in name
                else "step")
        log(f"  ({name}) ms per {unit}, median of {rounds}: host enqueue "
            f"{med[0]:.2f}, host wall {med[1]:.2f} "
            f"({cols[1][0] / per:.2f}-{cols[1][-1] / per:.2f}), CUDA event "
            f"span {med[2]:.2f}")
    return out


def p17_launcher(torch, workdir: str, data_dir: str) -> dict:
    """Phase 17 (d): the launcher with the rest of the BSP step, stopped
    after epoch 0 and resumed (as soon as the first run has ended, beside
    the unbroken run), against the unbroken run."""
    sets = [a for kv in P17_SETS for a in ("--set", kv)]
    wave = launcher_wave(workdir, data_dir, {
        "p17-unbroken": ("p17u", sets),
        "p17-first": ("p17r", [*sets, "--epochs", "1"]),
        "p17-resumed": ("p17r", [*sets, "--resume", "--epochs", "1"])},
        after={"p17-resumed": ("p17-first", None)})
    for name, o in wave.items():
        if o["rc"] != 0:
            raise AssertionError(f"(d) {name} exited {o['rc']}: {o['err']}")
    unbroken = wave["p17-unbroken"]["res"]
    resumed = wave["p17-resumed"]["res"]
    for res in (unbroken, resumed):
        for rec in res["records"]:
            got = rec["launches"]["train"]
            want = {k: v * CKPT_STEPS for k, v in TRAIN_LAUNCHES.items()}
            if ({k: got.get(k, 0) for k in want} != want
                    or rec["train_steps"] != CKPT_STEPS
                    or not math.isfinite(rec["train_loss"])):
                raise AssertionError(f"(d) epoch record {rec}")
    restore = resumed["checkpoint"]["restore"]
    if (restore is None or restore["epoch"] != 0
            or restore["digest_restored"] != restore["digest_at_save"]):
        raise AssertionError(f"(d) restore {restore}")
    if [r["epoch"] for r in resumed["records"]] != [0, 1]:
        raise AssertionError(f"(d) records {resumed['records']}")
    same = resumed["state_digests"] == unbroken["state_digests"]
    log(f"  resumed run's state digest {'equals' if same else 'DIFFERS from'}"
        f" the unbroken run's ({unbroken['state_digests'][0][:16]}...)")
    if not same:
        raise AssertionError(f"(d) {resumed['state_digests']} != "
                             f"{unbroken['state_digests']}")
    return {"unbroken": unbroken, "resumed": resumed}


def rest_of_bsp_phase(torch, workdir: str, data_dir: str) -> dict:
    """Phase 17 (module docstring)."""
    import torch.distributed as dist

    data, batches = p17_batches(torch, P17_BATCHES)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        log("  (a) exchange modes")
        exchange, checks = p17_exchange(torch, data, batches)
        log("  (b) optimizers")
        optimizers, opt_err = p17_optimizers(torch, data, batches)
        log("  (c) cadences")
        cadences, cadence = p17_cadences(torch, data, batches)
        log(f"  (e) {card_line()}: every run in turn (one rank: the "
            "4-bucket runs show what 161 gradient hooks cost the host, "
            "not overlap)")
        times = p17_rounds(torch, {**exchange, **optimizers, **cadences},
                           P17_ROUNDS)
        hooks = (times["f32-b4"]["enqueue_ms"]
                 - times["f32-b1"]["enqueue_ms"])
        log(f"  the hooks' host cost: f32 host enqueue ms per step, 4 "
            f"buckets minus one bucket, {hooks:.3f}")
        compared = p17_exchange_compare(torch, exchange)
    finally:
        dist.destroy_process_group()
    del exchange, optimizers, cadences, batches
    torch.cuda.empty_cache()
    log("  (d) the launcher: lars, accumulation, bf16 wire, error "
        "feedback, 4 buckets; stop and resume")
    launched = p17_launcher(torch, workdir, data_dir)
    return {"exchange": {**compared, "step1_checks": checks},
            "optimizer_max_rel_err": opt_err, "cadences": cadence,
            "times": times, "hook_enqueue_ms": hooks, "launcher": launched}


# -- phase 18: the classifier zoo --------------------------------------------

def zoo_step(torch, model, batch, crops, crop: int = 224) -> dict:
    """One BSP step of ``model`` through its own ``loss_fn`` (GoogLeNet:
    the aux-weighted loss) on uint8 ``batch``, the crops and flips given
    explicitly (a fixed device transform in place of the dataset's
    random one); its loss and flattened gradient (f32, on the CPU)."""
    from theanompi_tpu_torch.data.imagenet import IMAGENET_MEAN, IMAGENET_STD
    from theanompi_tpu_torch.models import layers as L
    from theanompi_tpu_torch.ops.augment import crop_flip_normalize

    dev = model.device
    ys, xs, flips = (t.to(dev) for t in crops)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    model.data.device_transform = (
        lambda x, rng, train: crop_flip_normalize(x, ys, xs, flips, crop,
                                                  mean, std))
    for m in model.module.modules():
        if isinstance(m, L.Dropout):
            m.rate = 0.0
    model.compile_iter_fns()
    t0 = time.monotonic()
    metrics = model.train_step(model.state,
                               tuple(t.to(dev) for t in batch), None)
    named = list(model.module.named_parameters())
    out = {"loss": float(metrics["loss"]),
           "grads": torch.cat([p.grad.float().reshape(-1).cpu()
                               for _, p in named]),
           "names": [n for n, _ in named],
           "sizes": [p.numel() for _, p in named],
           "s": time.monotonic() - t0}
    model.module.eval()
    return out


def worst_tensors(torch, got: dict, want: dict, k: int = 3) -> list:
    """The ``k`` parameters whose gradients in ``got`` are farthest from
    ``want``'s in relative L2, as (distance, name), farthest first."""
    pairs = zip(got["names"], got["grads"].split(got["sizes"]),
                want["grads"].split(want["sizes"]))
    return sorted(((rel_l2(torch, a, b), n) for n, a, b in pairs),
                  reverse=True)[:k]


def fmt_worst(worst: list) -> str:
    return ", ".join(f"{n} {d:.4g}" for d, n in worst)


def zoo_grad_check(torch) -> dict:
    """Phase 18 (a): one BSP step of seeded full-width VGG16 and
    GoogLeNet (each recipe's own inits from seed 42, its SGD; dropout
    off) in bf16 and in f32 on the card and in f32 and bf16 on the CPU
    (plain versions), on the same 8 uint8 256x256 images with the same
    explicit 224 crops and flips.  GoogLeNet's loss includes both aux
    terms.  Both card steps run K1 (and GoogLeNet's K3) the counts of a
    training step.  Limits (:data:`ZOO_GRAD_LIMITS`): the f32 card step
    against the f32 CPU step tightly, as a whole and parameter by
    parameter (only the order of sums differs, TF32 off); the bf16 card
    step, the recipe's, within bf16 rounding of both CPU steps."""
    from theanompi_tpu_torch.models.googlenet import GoogLeNet
    from theanompi_tpu_torch.models.vgg16 import VGG16
    from theanompi_tpu_torch.ops import _kernels

    rng = np.random.default_rng(18)
    n = GRAD_CHECK_IMAGES
    batch = (torch.from_numpy(rng.integers(0, 256, (n, 256, 256, 3),
                                           dtype=np.uint8)),
             torch.from_numpy(rng.integers(0, 1000, n).astype(np.int64)))
    crops = (torch.from_numpy(rng.integers(0, 33, n)),
             torch.from_numpy(rng.integers(0, 33, n)),
             torch.from_numpy(rng.random(n) < 0.5))
    out = {"images": n, "limits": ZOO_GRAD_LIMITS}
    f32_cfg = {"compute_dtype": "float32"}
    for cls, want in ((VGG16, VGG_TRAIN_LAUNCHES),
                      (GoogLeNet, GOOGLENET_TRAIN_LAUNCHES)):
        f32 = cls(device="cpu", config=dataclasses.replace(
            cls.default_config(), **f32_cfg))
        steps, launched = {}, {}
        for name, build in (
                ("card", lambda: cls(device="cuda")),
                ("card_f32", lambda: cls(device="cuda", config=dataclasses.
                                         replace(cls.default_config(),
                                                 **f32_cfg))),
                ("cpu_bf16", lambda: cls(device="cpu")),
                ("cpu_f32", lambda: f32)):
            model = build()
            if model is not f32:
                model.module.load_state_dict(f32.module.state_dict())
            _kernels.reset_launch_counts()
            steps[name] = zoo_step(torch, model, batch, crops)
            launched[name] = {k: _kernels.launch_counts().get(k, 0)
                              for k in want}
            del model
        del f32
        for name in ("card", "card_f32"):
            if launched[name] != want:
                raise AssertionError(f"{cls.name} {name} step launched "
                                     f"{launched[name]}, not {want}")
        card, ref, bf = steps["card"], steps["cpu_f32"], steps["cpu_bf16"]
        c32 = steps["card_f32"]
        worst32 = worst_tensors(torch, c32, ref)
        r = {"loss_card": card["loss"], "loss_cpu_f32": ref["loss"],
             "loss_card_f32": c32["loss"],
             "loss_rel": abs(card["loss"] - ref["loss"]) / abs(ref["loss"]),
             "f32_loss_rel": abs(c32["loss"] - ref["loss"]) / abs(
                 ref["loss"]),
             "f32_grad_vs_f32": rel_l2(torch, c32["grads"], ref["grads"]),
             "f32_worst": worst32, "f32_worst_tensor": worst32[0][0],
             "bf16_worst": worst_tensors(torch, card, bf),
             "grad_vs_f32": rel_l2(torch, card["grads"], ref["grads"]),
             "grad_vs_cpu_bf16": rel_l2(torch, card["grads"], bf["grads"]),
             "cpu_bf16_vs_f32": rel_l2(torch, bf["grads"], ref["grads"]),
             "finite": bool(torch.isfinite(card["grads"]).all()
                            and torch.isfinite(c32["grads"]).all()),
             "card_launches": {KERNEL_IDS[k]: v for k, v in
                               launched["card"].items() if v},
             "cpu_f32_s": ref["s"], "cpu_bf16_s": bf["s"]}
        out[cls.name] = r
        log(f"  {cls.name}: f32 card vs cpu: loss {r['loss_card_f32']:.6f} "
            f"vs {r['loss_cpu_f32']:.6f} (rel {r['f32_loss_rel']:.3g}), "
            f"gradient rel L2 {r['f32_grad_vs_f32']:.4g} (farthest "
            f"tensors {fmt_worst(r['f32_worst'])}); bf16 card: loss "
            f"{r['loss_card']:.6f} (rel {r['loss_rel']:.3g}); gradient "
            f"rel L2 bf16 card vs f32 {r['grad_vs_f32']:.4g}, bf16 card vs "
            f"cpu bf16 {r['grad_vs_cpu_bf16']:.4g}, cpu bf16 vs f32 "
            f"{r['cpu_bf16_vs_f32']:.4g} (farthest from cpu bf16 "
            f"{fmt_worst(r['bf16_worst'])}); launches per card step "
            f"{r['card_launches']} (cpu steps f32 {r['cpu_f32_s']:.1f} s, "
            f"bf16 {r['cpu_bf16_s']:.1f} s)")
        over = {k: r[k] for k, lim in ZOO_GRAD_LIMITS.items()
                if not r[k] <= lim}
        if over or not r["finite"]:
            raise AssertionError(f"{cls.name} card step off the CPU "
                                 f"references: {over} over "
                                 f"{ZOO_GRAD_LIMITS}, finite {r['finite']}")
        del steps
        gc.collect()
        torch.cuda.empty_cache()
    return out


def zoo_builder(cls, steps: int, batch: int, workdir: str, **cfg):
    """A function building one ImageNet zoo model of the JAX recipe at
    ``batch`` with ``cfg`` on the synthetic pool (on-device augment) for
    one epoch of ``steps`` steps."""
    from theanompi_tpu_torch.data.imagenet import ImageNet_data
    from theanompi_tpu_torch.models.alex_net import AlexNet

    def build():
        crop = 227 if cls is AlexNet else 224
        data = ImageNet_data(crop=crop, seed=0, synthetic_n=steps * batch,
                             synthetic_pool=64, synthetic_store=256,
                             augment_on_device=True)
        config = dataclasses.replace(
            cls.default_config(), batch_size=batch, n_epochs=1,
            print_freq=4, snapshot_dir=workdir, **cfg)
        return cls(config=config, device="cuda", crop=crop, data=data)
    return build


def zoo_models(torch, workdir: str):
    """Phase 18 (b)'s runs: (label, a function building the model, its
    per-card batch, launches per training step, per validation batch)."""
    from theanompi_tpu_torch.models.alex_net import AlexNet
    from theanompi_tpu_torch.models.cifar10 import Cifar10_model
    from theanompi_tpu_torch.models.googlenet import GoogLeNet
    from theanompi_tpu_torch.models.model_zoo import (
        ResNet50_LargeBatch,
        ResNet101,
    )
    from theanompi_tpu_torch.models.vgg16 import VGG16

    def imagenet(cls, steps, batch, **cfg):
        return zoo_builder(cls, steps, batch, workdir, **cfg)

    def cifar10():
        return Cifar10_model(config=dataclasses.replace(
            Cifar10_model.default_config(), n_epochs=1, print_freq=8,
            snapshot_dir=workdir), device="cuda")

    return [
        ("vgg16", imagenet(VGG16, ZOO_STEPS, ZOO_BATCH), ZOO_BATCH,
         VGG_TRAIN_LAUNCHES, VGG_VAL_LAUNCHES),
        ("googlenet", imagenet(GoogLeNet, ZOO_STEPS, ZOO_BATCH), ZOO_BATCH,
         GOOGLENET_TRAIN_LAUNCHES, GOOGLENET_VAL_LAUNCHES),
        ("cifar10", cifar10, 128, CIFAR_TRAIN_LAUNCHES, CIFAR_VAL_LAUNCHES),
        ("vgg16_bn", imagenet(VGG16, ZOO_SHORT_STEPS, ZOO_BATCH,
                              batch_norm=True), ZOO_BATCH,
         VGG_TRAIN_LAUNCHES, VGG_VAL_LAUNCHES),
        ("alexnet_bn", imagenet(AlexNet, ZOO_SHORT_STEPS, TRAIN_BATCH,
                                batch_norm=True), TRAIN_BATCH,
         ALEX_BN_TRAIN_LAUNCHES, ALEX_BN_VAL_LAUNCHES),
        ("resnet101", imagenet(ResNet101, ZOO_SHORT_STEPS, TRAIN_BATCH),
         TRAIN_BATCH, RESNET101_TRAIN_LAUNCHES, RESNET101_VAL_LAUNCHES),
        ("resnet50_large", imagenet(ResNet50_LargeBatch, ZOO_SHORT_STEPS,
                                    TRAIN_BATCH), TRAIN_BATCH,
         TRAIN_LAUNCHES, RESNET_VAL_LAUNCHES)]


def zoo_session(torch, label: str, model, batch: int, want_train: dict,
                want_val: dict) -> dict:
    """Phase 18 (b): ``run_bsp_session`` of one zoo model with the counts
    set to 0 just before and read just after (:func:`counted_session`):
    exact launches per training step and per validation batch, every
    loss finite; ms per step and images/s per card."""
    run = counted_session(torch, model)
    losses, launches, val_counts = (run["losses"], run["launches"],
                                    run["val_counts"])
    steps, n_val = len(losses), model.val_batches_run
    train_counts = {k: launches.get(k, 0) - val_counts.get(k, 0)
                    for k in want_train}
    got_val = {k: val_counts.get(k, 0) for k in want_val}
    want_t = {k: v * steps for k, v in want_train.items()}
    want_v = {k: v * n_val for k, v in want_val.items()}
    if train_counts != want_t or got_val != want_v or not steps:
        raise AssertionError(f"{label}: train launches {train_counts} != "
                             f"{want_t} ({steps} steps), validation "
                             f"{got_val} != {want_v} ({n_val} batches)")
    val = run["result"]["val"]
    if not all(math.isfinite(v) for v in losses) or not math.isfinite(
            val["loss"]):
        raise AssertionError(f"{label}: non-finite loss: {losses} {val}")
    ms = run["ms_per_step"]
    out = {"steps": steps, "val_batches": n_val, "batch": batch,
           "launches": launches, "train_launches": train_counts,
           "val_launches": got_val, "losses": losses, "val": val,
           "ms_per_step": ms, "images_per_s": batch * 1e3 / ms,
           "timed_steps": run["timed_steps"], "wall_s": run["wall_s"]}
    per_step = {KERNEL_IDS[k]: v for k, v in want_train.items() if v}
    per_val = {KERNEL_IDS[k]: v for k, v in want_val.items() if v}
    log(f"  {label}: {steps} steps of {batch} + {n_val} validation batches "
        f"in {run['wall_s']:.1f} s; launches per step {per_step}, per "
        f"validation batch {per_val}; {ms:.2f} ms/step, "
        f"{out['images_per_s']:.0f} images/s per card; losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, val loss {val['loss']:.4f}")
    return out


def zoo_k1(torch, label: str, module, batch: int) -> dict:
    """Phase 18 (d), K1: the (rows, C) of every BiasAct of one training
    forward of ``module`` at ``batch`` (bf16), each checked against the
    plain versions (y and dx exact) and timed at unit scale;
    K1a and K1c summed per step beside their bounds and plain times."""
    x = torch.zeros((batch, 224, 224, 3), device="cuda")
    cases = k1_cases(torch, module, x, train=True)
    del x
    log(f"  {label}: {sum(cases.values())} BiasAct launches per training "
        f"forward, {len(cases)} shapes")
    fwd = check_k1(torch, cases, unit_scale=True)
    bwd = check_k1_bwd(torch, cases, unit_scale=True)
    torch.cuda.empty_cache()
    return {"K1a": fwd["per_forward"]["scale_bias_act"],
            "K1c": bwd["per_step"]["scale_bias_act_bwd"],
            "cases": {"fwd": fwd["cases"], "bwd": bwd["cases"]},
            "max_abs_err": {"K1a": fwd["max_abs_err"]["scale_bias_act"],
                            "K1c": bwd["max_abs_err"]["scale_bias_act_bwd"]}}


def zoo_k3(torch, label: str, shapes, n: int, k: float, alpha: float,
           dtype) -> dict:
    """Phase 18 (d), K3: K3a/K3b at each of ``shapes`` (one training
    step's two LRNs) with the model's n, k and alpha, 0 ulp against the
    plain versions, then timed (:func:`time_k3`) and summed per step."""
    import torch.nn.functional as F

    from theanompi_tpu_torch.ops import lrn

    gen = torch.Generator(device="cuda").manual_seed(18)
    per_step = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                       "nbytes": 0, "ops": 0} for name in ("lrn", "lrn_bwd")}
    worst = {"lrn": 0.0, "lrn_bwd": 0.0}
    for shape in shapes:
        x = (torch.randn(shape, generator=gen, device="cuda")
             * LRN_SCALE).to(dtype)
        g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        got = (lrn.lrn_fwd(x, n, k, alpha), lrn.lrn_bwd(x, g, n, k, alpha))
        want = (lrn.lrn_plain(x, n, k, alpha),
                lrn.lrn_bwd_plain(x, g, n, k, alpha))
        for name, a, b in zip(("lrn", "lrn_bwd"), got, want):
            ulp = ulp_distance(torch, a, b)
            if ulp:
                raise AssertionError(f"{label} K3 {name} {shape} {dtype}: "
                                     f"{ulp} ulp from its plain version")
            worst[name] = max(worst[name],
                              float((a.float() - b.float()).abs().max()))
        t = time_k3(torch, F, lrn, x, g, n, k, alpha)
        for name in per_step:
            for key in per_step[name]:
                per_step[name][key] += t[name][key]
        log(f"  {label} K3 {shape} {str(dtype)[6:]} n={n}: 0 ulp; K3a "
            f"{t['lrn']['ms'] * 1e3:.2f} us (bound "
            f"{t['lrn']['bound_ms'] * 1e3:.2f}), K3b "
            f"{t['lrn_bwd']['ms'] * 1e3:.2f} us (bound "
            f"{t['lrn_bwd']['bound_ms'] * 1e3:.2f})")
        del x, g, got, want
    out = {}
    for name, v in per_step.items():
        out[KERNEL_IDS[name]] = {
            "ms": v["ms"], "plain_ms": v["plain_ms"],
            "library_ms": v["library_ms"],
            "bound_ms": bound_ms(v["nbytes"], v["ops"]),
            "bound_by": bound_by(v["nbytes"], v["ops"]),
            "max_abs_err": worst[name]}
    return out


def zoo_phase(torch, workdir: str, beside=None) -> dict:
    """Phase 18 (module docstring); ``beside()`` is called once (c)'s
    launchers have started, to start other work beside them."""
    import torch.distributed as dist

    from theanompi_tpu_torch.models.googlenet import GoogLeNetCNN
    from theanompi_tpu_torch.models.vgg16 import VGGCNN

    log("  (a) VGG16 and GoogLeNet: one step on the card against the CPU "
        "references")
    checked = zoo_grad_check(torch)
    log(f"  (b) run_bsp_session on a one-rank NCCL group ({card_line()})")
    sessions = {}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        for label, build, batch, want_t, want_v in zoo_models(torch,
                                                             workdir):
            model = build()
            sessions[label] = zoo_session(torch, label, model, batch,
                                          want_t, want_v)
            del model
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    log("  (c) the launcher: GoogLeNet and Cifar10, one worker on this card")
    launched, runs = {}, {}
    for label, modelfile, cls, batch, want_t, want_v in (
            ("googlenet", "theanompi_tpu_torch.models.googlenet",
             "GoogLeNet", ZOO_BATCH, GOOGLENET_TRAIN_LAUNCHES,
             GOOGLENET_VAL_LAUNCHES),
            ("cifar10", "theanompi_tpu_torch.models.cifar10",
             "Cifar10_model", 128, CIFAR_TRAIN_LAUNCHES,
             CIFAR_VAL_LAUNCHES)):
        sub = os.path.join(workdir, f"launcher_{label}")
        os.makedirs(sub)
        # both side by side on the card: their times are shared ones
        runs[label] = (sub, modelfile, cls, batch, want_t, want_v,
                       launcher_start(sub, modelfile, cls, 1))
    if beside is not None:
        beside()
    try:
        for label, (sub, modelfile, cls, batch, want_t, want_v,
                    run) in runs.items():
            launched[label] = launcher_run(torch, sub, modelfile, cls, 1,
                                           batch, want_t, want_v,
                                           started=run)
    finally:
        for *_, run in runs.values():
            run.close()
    log(f"  (d) K1 and K3 at the zoo's shapes ({card_line()})")
    times = {}
    for label, build in (("vgg16", lambda: VGGCNN(dtype=torch.bfloat16)),
                         ("googlenet", lambda: GoogLeNetCNN(
                             dtype=torch.bfloat16))):
        with torch.device("cuda"):
            module = build()     # shapes only: the weights stay unset
        times[label] = zoo_k1(torch, label, module, ZOO_BATCH)
        del module
    times["googlenet"].update(zoo_k3(
        torch, "googlenet", [(ZOO_BATCH, 56, 56, 64),
                             (ZOO_BATCH, 56, 56, 192)],
        5, 2.0, 1e-4, torch.bfloat16))
    times["cifar10"] = zoo_k3(torch, "cifar10", [(128, 15, 15, 32),
                                                 (128, 7, 7, 32)],
                              3, 1.0, 5e-5, torch.float32)
    for label, t in times.items():
        log(f"  {label} per training step: " + "; ".join(
            f"{kid} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f}, plain "
            f"{v['plain_ms']:.4f})" for kid, v in t.items()
            if kid.startswith("K")))
    return {"grad_check": checked, "sessions": sessions,
            "launcher": launched, "kernel_times": times}


# -- phase 19: the WGAN, npz snapshots, sync_bn -----------------------------

def _flat_update(torch, module, before: dict, prefix: str):
    """The f64 update of the parameters under ``prefix`` (after less
    ``before``), flattened."""
    return torch.cat([(p.detach().double().cpu() - before[n]).reshape(-1)
                      for n, p in module.named_parameters()
                      if n.startswith(prefix)])


def wgan_round_check(torch) -> dict:
    """Phase 19 (a): one seeded full-width WGAN round on the card against
    the same round on the CPU in f32 (and in f64, f32's own distance),
    from the same weights, real rows and noise (``WGAN_LIMITS``); every
    critic weight within the clip; no kernel of the port launched."""
    from theanompi_tpu_torch.models.wasserstein_gan import Wasserstein_GAN
    from theanompi_tpu_torch.ops import _kernels

    config = dataclasses.replace(Wasserstein_GAN.default_config(),
                                 batch_size=WGAN_BATCH)
    models = {dev: Wasserstein_GAN(config=config, device=dev,
                                   width=WGAN_WIDTH)
              for dev in ("cuda", "cpu")}
    models["f64"] = Wasserstein_GAN(config=config, device="cpu",
                                    width=WGAN_WIDTH)
    for m in models["f64"].module.modules():   # every layer computes in f64
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    models["f64"].module.double()
    for m in models.values():
        m.module.load_state_dict(models["cuda"].module.state_dict())
        m.compile_iter_fns()
    before = {n: p.detach().double().cpu()
              for n, p in models["cpu"].module.named_parameters()}
    x, y = next(iter(models["cpu"].data.train_batches(
        0, WGAN_BATCH * WGAN_N_CRITIC)))
    z = torch.randn((WGAN_N_CRITIC + 1, WGAN_BATCH, 100),
                    generator=torch.Generator().manual_seed(0))
    out, updates = {}, {}
    for dev, m in models.items():
        dt = torch.float64 if dev == "f64" else torch.float32
        to = "cuda" if dev == "cuda" else "cpu"
        batch = (torch.from_numpy(x).to(to, dt), torch.from_numpy(y).to(to))
        noise = (z[:WGAN_N_CRITIC].to(to, dt), z[WGAN_N_CRITIC].to(to, dt))
        _kernels.reset_launch_counts()
        metrics = m.round(m.state, batch, None, noise=noise)
        if dev == "cuda":
            torch.cuda.synchronize()
            launched = _kernels.launch_counts()
        out[dev] = {k: float(v) for k, v in metrics.items()}
        updates[dev] = {net: _flat_update(torch, m.module, before, net)
                        for net in ("generator", "critic")}
    def loss_rel_of(a, b):
        return {k: abs(out[a][k] - out[b][k]) / abs(out[b][k])
                for k in ("loss", "error")}

    loss_rel, f32_loss_rel = loss_rel_of("cuda", "cpu"), loss_rel_of("cpu",
                                                                     "f64")

    def rel(a, b):
        return {net: float((updates[a][net] - updates[b][net]).norm()
                           / updates[b][net].norm())
                for net in ("generator", "critic")}

    card_vs_cpu, f32_vs_f64 = rel("cuda", "cpu"), rel("cpu", "f64")
    clip = max(float(p.detach().abs().max())
               for p in models["cuda"].module["critic"].parameters())
    res = {"losses": out, "loss_rel": loss_rel,
           "f32_vs_f64_loss": f32_loss_rel,
           "update_rel_l2": card_vs_cpu, "f32_vs_f64_update": f32_vs_f64,
           "critic_max_abs": clip, "launches": launched,
           "limits": WGAN_LIMITS}
    log(f"  (a) losses card {out['cuda']}, CPU {out['cpu']}: relative "
        f"{loss_rel} (CPU f32 vs f64 {f32_loss_rel}); update relative L2 "
        f"card vs CPU {card_vs_cpu} (CPU f32 vs f64 {f32_vs_f64}); critic "
        f"max |w| {clip:.6f}; launches "
        f"{ {k: v for k, v in launched.items() if v} or 'none'}")
    if (max(loss_rel.values()) > WGAN_LIMITS["loss_rel"]
            or card_vs_cpu["generator"] > WGAN_LIMITS["generator_update"]
            or card_vs_cpu["critic"] > WGAN_LIMITS["critic_update"]
            or clip > 0.01 or any(launched.values())):
        raise AssertionError(f"WGAN round check failed: {res}")
    # the steady round: the same staged rows, fresh noise each round
    card, batch = models["cuda"], (torch.from_numpy(x).cuda(),
                                   torch.from_numpy(y).cuda())
    gen = card._epoch_rng(0)
    ms = []
    for i in range(WGAN_WARMUP_ROUNDS + WGAN_TIMED_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card.round(card.state, batch, gen)
        torch.cuda.synchronize()
        if i >= WGAN_WARMUP_ROUNDS:
            ms.append((time.perf_counter() - t0) * 1e3)
    med = sorted(ms)[len(ms) // 2]
    images = WGAN_BATCH * WGAN_N_CRITIC
    res.update(round_ms=ms, round_ms_median=med,
               images_per_s=images * 1e3 / med)
    log(f"  (a) {card_line()}: {med:.2f} ms per round (median of "
        f"{len(ms)}, {min(ms):.2f}-{max(ms):.2f}; host wall, synchronised), "
        f"{res['images_per_s']:.0f} images/s ({images} real images a round)")
    return res


def wgan_launcher(torch, workdir: str) -> dict:
    """Phase 19 (b): ``python -m theanompi_tpu_torch.launcher BSP -D 1 -m
    theanompi_tpu_torch.models.wasserstein_gan -c Wasserstein_GAN
    --epochs 1`` (the default recipe and synthetic pool; no kernel
    launched); every loss finite, the clip held in the epoch's
    checkpoint, ms per round and images/s; then the checkpointed model's
    ``save``, ``load`` into a fresh model and ``generate(8, seed=1)`` bit
    for bit, with the npz holding ``WGAN_NPZ``."""
    from theanompi_tpu_torch.models.wasserstein_gan import Wasserstein_GAN
    from theanompi_tpu_torch.utils.checkpoint import Checkpointer

    run = launcher_run(torch, workdir,
                       "theanompi_tpu_torch.models.wasserstein_gan",
                       "Wasserstein_GAN", 1, WGAN_BATCH * WGAN_N_CRITIC,
                       _launches(), _launches(), ("print_freq=4",))
    ck = Checkpointer(os.path.join(workdir, "wgan"), read_only=True)
    payload = ck.restore(0)
    ck.close()
    clip = max(float(v.abs().max())
               for v in payload["critic_params"].values())
    if clip > 0.01 or payload["step"] != run["records"][0]["train_steps"]:
        raise AssertionError(f"checkpoint: critic max |w| {clip}, step "
                             f"{payload['step']}")
    trained = Wasserstein_GAN(device="cuda", width=WGAN_WIDTH)
    trained.adopt_restored_state(payload)
    path = trained.save(os.path.join(workdir, "wgan_params.npz"))
    fresh = Wasserstein_GAN(device="cuda", width=WGAN_WIDTH)
    # cuDNN's transposed-conv forward (a conv's data gradient) may sum
    # with atomics: generate with its deterministic algorithms
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        untrained = fresh.generate(8, seed=1)
        fresh.load(path)
        want, got = trained.generate(8, seed=1), fresh.generate(8, seed=1)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    same_params = all(
        torch.equal(p, q) for p, q in zip(trained.module.parameters(),
                                          fresh.module.parameters()))
    with np.load(path) as z:
        keys = {k: z[k].shape for k in z.files}
        order = list(z.files)
    if (not same_params or not np.array_equal(got, want)
            or np.array_equal(untrained, want) or keys != WGAN_NPZ
            or order != list(WGAN_NPZ)):
        raise AssertionError(f"save/load: parameters equal {same_params}, "
                             f"generate equal {np.array_equal(got, want)}, "
                             f"npz {keys}")
    ms = run["ms_per_step"]
    log(f"  (b) {card_line()}: WGAN launcher epoch {ms:.2f} ms per round "
        f"(first rounds included), {run['images_per_s']:.0f} images/s "
        f"({WGAN_BATCH * WGAN_N_CRITIC} real images a round); critic max "
        f"|w| {clip:.6f}; save -> load -> generate(8, seed=1) bit for bit; "
        f"npz {len(keys)} flax paths")
    return {**run, "critic_max_abs": clip, "npz_keys": order}


def sync_bn_resnet(torch) -> dict:
    """Phase 19 (c), ResNet-50: ``SYNC_BN_STEPS`` steps with sync_bn on
    the one-rank group bit-identical to the same steps without it, with
    phase 6's launches per step; then ``SYNC_BN_ROUNDS`` timed rounds of
    one step each, each model in turn."""
    from theanompi_tpu_torch.models.layers import BatchNormAct
    from theanompi_tpu_torch.ops import _kernels

    data, batches = p17_batches(torch, SYNC_BN_STEPS)
    runs = {"off": P17Run(data, single_step(batches)),
            "on": P17Run(data, single_step(batches), sync_bn=True)}
    counts = {}
    for name, run in runs.items():
        _kernels.reset_launch_counts()
        for _ in range(SYNC_BN_STEPS):
            run.step()
        torch.cuda.synchronize()
        counts[name] = {k: _kernels.launch_counts().get(k, 0)
                        for k in TRAIN_LAUNCHES}
        run.finite(torch)
    want = {k: v * SYNC_BN_STEPS for k, v in TRAIN_LAUNCHES.items()}
    states = [r.model.module.state_dict() for r in runs.values()]
    same = all(torch.equal(states[0][k], states[1][k]) for k in states[0])
    ms: dict[str, list] = {name: [] for name in runs}
    for _ in range(SYNC_BN_ROUNDS):
        for name, run in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run.step()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    med = {name: sorted(v)[len(v) // 2] for name, v in ms.items()}
    n_bn = sum(isinstance(m, BatchNormAct)
               for m in runs["on"].model.module.modules())
    log(f"  (c) ResNet-50 at batch {TRAIN_BATCH}, {SYNC_BN_STEPS} steps: "
        f"sync_bn bit-identical to per-rank BN: {same}; launches with "
        f"sync_bn {counts['on']}; {card_line()}: median ms per step "
        f"(host wall, synchronised) off {med['off']:.2f}, on "
        f"{med['on']:.2f} (+{med['on'] - med['off']:.2f} for {2 * n_bn} "
        "statistics all-reduces a step)")
    if not same or counts["on"] != want or counts["off"] != want:
        raise AssertionError(f"sync_bn: bit-identical {same}, launches "
                             f"{counts} (want {want} each)")
    return {"bit_identical": same, "launches": counts["on"],
            "ms_per_step": med, "ms_rounds": ms}


def sync_bn_phase(torch, workdir: str) -> dict:
    """Phase 19 (module docstring)."""
    import torch.distributed as dist

    out = {"wgan_round": wgan_round_check(torch)}
    gc.collect()
    sub = os.path.join(workdir, "wgan")
    os.makedirs(sub)
    out["wgan_launcher"] = wgan_launcher(torch, sub)
    torch.cuda.empty_cache()
    from theanompi_tpu_torch.models.vgg16 import VGG16

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        out["resnet50"] = sync_bn_resnet(torch)
        gc.collect()
        torch.cuda.empty_cache()
        model = zoo_builder(VGG16, ZOO_SHORT_STEPS, ZOO_BATCH, workdir,
                            batch_norm=True, sync_bn=True)()
        out["vgg16_bn"] = zoo_session(torch, "vgg16_bn with sync_bn", model,
                                      ZOO_BATCH, VGG_TRAIN_LAUNCHES,
                                      VGG_VAL_LAUNCHES)
        del model
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 20: ZeRO-1 and FSDP on the card -----------------------------------

def p20_call(batches, micro, cfg: dict):
    """A phase-20 run's i-th dispatch: a step, a ``steps_per_call`` call
    or an accumulated update."""
    k, a = cfg.get("steps_per_call", 1), cfg.get("grad_accum_steps", 1)
    if k > 1:
        return lambda run, i: run.model.train_step_multi(
            run.model.state, [batches[(k * i + j) % len(batches)]
                              for j in range(k)], run.gen)
    if a > 1:
        return lambda run, i: run.model.train_step_accum(
            run.model.state, [micro[(a * i + j) % len(micro)]
                              for j in range(a)], run.gen)
    return single_step(batches)


def p20_state(torch, model) -> dict:
    """A model's parameters, BN running statistics, per-parameter
    optimizer state and error-feedback residual, by parameter name and
    index: ZeRO's shard state gathered and cut into parameters, FSDP's
    parameters gathered."""
    from theanompi_tpu_torch.parallel.fsdp import per_param_opt_state
    from theanompi_tpu_torch.parallel.zero import _unravel_bucketed

    st, cfg = model.state, model.config
    with model.full_params():
        tensors = {k: v.clone() for k, v in model.module.state_dict().items()}
    params = list(model.module.parameters())
    if cfg.fsdp_sharding:
        opt = per_param_opt_state(st)["state"]
    elif cfg.zero_sharding:
        shard, opt = st.sharding, {}
        for key, v in st.optimizer.state[shard.shard].items():
            if torch.is_tensor(v) and v.shape == shard.shard.shape:
                leaves = _unravel_bucketed(shard.gather_flat(v), shard.layout)
                for j, t in enumerate(leaves):
                    i = len(params) - 1 - j
                    opt.setdefault(i, {})[key] = t.view(params[i].shape)
            else:
                for i in range(len(params)):
                    opt.setdefault(i, {})[key] = v
    else:
        opt = {i: dict(st.optimizer.state[p]) for i, p in enumerate(params)}
    out = {**{f"module/{k}": v for k, v in tensors.items()},
           **{f"opt/{i}/{k}": v for i, per in opt.items()
              for k, v in per.items()}}
    res = st.exchange_residual
    if isinstance(res, torch.Tensor):
        for j, t in enumerate(_unravel_bucketed(res, st.sharding.layout)):
            i = len(params) - 1 - j
            out[f"residual/{i}"] = t.view(params[i].shape)
    elif res is not None:
        out.update({f"residual/{i}": r for i, r in enumerate(res)})
    return out


def p20_models(torch, data, batches) -> dict:
    """Phase 20 (a): the plain twins and the ZeRO/FSDP runs, each
    ``P20_STEPS`` steps with its launches counted; every run compared
    with its twin bit for bit.  Returns the runs, the checks and each
    run's launches, bytes and peak memory."""
    from theanompi_tpu_torch.ops import _kernels

    half = TRAIN_BATCH // 2
    micro = [(x[i:i + half], y[i:i + half]) for x, y in batches
             for i in (0, half)]
    runs, info = {}, {}
    for name, cfg in {**P20_TWINS, **{
            n: {**P20_TWINS[twin], **extra}
            for n, (twin, extra) in P20_RUNS.items()}}.items():
        cfg = {**P20_BASE, **cfg}
        per = max(cfg.get("steps_per_call", 1), cfg.get("grad_accum_steps", 1))
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        run = runs[name] = P17Run(data, p20_call(batches, micro, cfg), **cfg)
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        for _ in range(P20_STEPS // (per if "steps_per_call" in cfg else 1)):
            run.step()
        torch.cuda.synchronize()
        counts = {k: _kernels.launch_counts().get(k, 0)
                  for k in TRAIN_LAUNCHES}
        want = {k: v * P20_STEPS * (2 if "grad_accum_steps" in cfg else 1)
                for k, v in TRAIN_LAUNCHES.items()}
        run.finite(torch)
        info[name] = {
            "launches": counts, "launches_ok": counts == want,
            "bytes": run.model.state_bytes(),
            "resident_bytes": torch.cuda.memory_allocated() - before,
            "peak_bytes": torch.cuda.max_memory_allocated() - before,
            "steps_per_dispatch": per if "steps_per_call" in cfg else 1}
        if counts != want:
            raise AssertionError(f"(a) {name}: launches {counts} != {want}")
    states = {n: p20_state(torch, runs[n].model) for n in P20_TWINS}
    for name, (twin, _) in P20_RUNS.items():
        got, ref = p20_state(torch, runs[name].model), states[twin]
        diff = sorted(k for k in ref if k not in got
                      or not torch.equal(got[k], ref[k]))
        extra = sorted(set(got) - set(ref))
        info[name]["bit_identical"] = not diff and not extra
        b = info[name]["bytes"]
        log(f"  ({name}) against {twin} after {P20_STEPS} steps: "
            f"{'bit-identical' if not diff and not extra else 'DIFFERS'} "
            f"({len(ref)} tensors: parameters, BN statistics, optimizer "
            f"state{', residual' if any(k.startswith('residual') for k in ref) else ''}); "
            f"launches {'exact' if info[name]['launches_ok'] else 'WRONG'}; "
            f"bytes a rank: parameters {b['params']}, optimizer "
            f"{b['optimizer']} (twin {info[twin]['bytes']['optimizer']}), "
            f"residual {b['residual']}; resident {info[name]['resident_bytes']}"
            f", peak above it {info[name]['peak_bytes']}")
        if diff or extra:
            raise AssertionError(f"(a) {name} differs from {twin}: "
                                 f"{(diff + extra)[:8]}")
    return runs, info


def launcher_wave(workdir: str, data_dir: str, runs: dict,
                  after: dict | None = None) -> dict:
    """Launcher runs side by side on the card (``launcher_cmd``; ``runs``
    maps a name to (snapshot dir, extra arguments)); a run that ``after``
    maps to (another run, a callable or None) starts, after the callable,
    as soon as that other run has ended with exit code 0 (it resumes from
    its checkpoint), beside the runs still going.  Returns per name the
    exit code, the result JSON (None on failure) and stderr's tail."""
    after = after or {}
    procs, out = {}, {}
    t0 = time.monotonic()

    def start(name: str) -> None:
        snap, extra = runs[name]
        err = open(os.path.join(workdir, f"{name}.stderr"), "w+")
        procs[name] = (subprocess.Popen(
            launcher_cmd(os.path.join(workdir, f"{name}.json"), snap,
                         workdir, data_dir, *extra),
            stdout=subprocess.DEVNULL, stderr=err, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__))), err)

    try:
        for name in runs:
            if name not in after:
                start(name)
        while True:
            for name, (first, prepare) in after.items():
                if (name not in procs and first in procs
                        and procs[first][0].poll() == 0):
                    if prepare is not None:
                        prepare()
                    start(name)
            waiting = [n for n, (first, _) in after.items()
                       if n not in procs and (first not in procs
                                              or procs[first][0].poll()
                                              is None)]
            if not waiting and all(p.poll() is not None
                                   for p, _ in procs.values()):
                break
            if time.monotonic() - t0 > 600:
                raise AssertionError(f"launcher runs {list(runs)} still "
                                     "running after 600 s")
            time.sleep(0.2)
        for name in runs:
            if name not in procs:
                out[name] = {"rc": None, "res": None,
                             "err": f"not started: {after[name][0]} failed"}
                continue
            proc, err = procs[name]
            res = None
            if proc.returncode == 0:
                with open(os.path.join(workdir, f"{name}.json")) as f:
                    res = json.load(f)
            out[name] = {"rc": proc.returncode, "res": res,
                         "err": (err.seek(0) or err.read())[-3000:]}
    finally:
        for proc, err in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            err.close()
    log(f"  {', '.join(runs)} side by side"
        + (f" ({', '.join(f'{n} after {f}' for n, (f, _) in after.items())})"
           if after else "")
        + f": {time.monotonic() - t0:.1f} s; exit codes "
        f"{[o['rc'] for o in out.values()]}")
    return out


def p20_launcher(torch, workdir: str, data_dir: str) -> dict:
    """Phase 20 (b): the launcher under ZeRO (4 buckets) and FSDP,
    unbroken and stopped after epoch 0 and resumed, and the ZeRO
    checkpoint resumed under 2 buckets; every run goes side by side on
    the card, each resume as soon as the run whose checkpoint it takes has
    ended."""
    import shutil

    def sets(knob):
        return [a for kv in P20_SETS[knob] for a in ("--set", kv)]

    def copy_zero() -> None:
        shutil.copytree(os.path.join(workdir, "p20zerof"),
                        os.path.join(workdir, "p20zeroo"))

    other = [a for kv in P20_SETS["zero"] if not kv.startswith(
        "exchange_buckets") for a in ("--set", kv)]
    wave = launcher_wave(workdir, data_dir, {
        **{f"{k}-{r}": (f"p20{k}{r[0]}", [*sets(k), *extra])
           for k in P20_SETS
           for r, extra in (("unbroken", []),
                            ("first", ["--epochs", "1"]))},
        **{f"{k}-resumed": (f"p20{k}f", [*sets(k), "--resume", "--epochs",
                                          "1"]) for k in P20_SETS},
        "zero-other-buckets": ("p20zeroo", [*other, "--set",
                                            "exchange_buckets=2",
                                            "--resume"])},
        after={**{f"{k}-resumed": (f"{k}-first", None) for k in P20_SETS},
               "zero-other-buckets": ("zero-first", copy_zero)})
    for name, o in wave.items():
        if o["rc"] != 0 and name != "zero-other-buckets":
            raise AssertionError(f"(b) {name} exited {o['rc']}: {o['err']}")
    bad = wave.pop("zero-other-buckets")
    if bad["rc"] == 0 or "ZeRO layout needs" not in bad["err"]:
        raise AssertionError(f"(b) the resume under 2 buckets exited "
                             f"{bad['rc']}: {bad['err']}")
    why = next(line for line in bad["err"].splitlines()
               if "ZeRO layout needs" in line)
    log(f"  (zero-other-buckets) exited {bad['rc']}: {why.strip()[:300]}")
    out = {"other_buckets_rc": bad["rc"]}
    for k in P20_SETS:
        unbroken = wave[f"{k}-unbroken"]["res"]
        resumed = wave[f"{k}-resumed"]["res"]
        for res in (unbroken, resumed):
            for rec in res["records"]:
                got = rec["launches"]["train"]
                want = {n: v * CKPT_STEPS for n, v in TRAIN_LAUNCHES.items()}
                if ({n: got.get(n, 0) for n in want} != want
                        or rec["train_steps"] != CKPT_STEPS
                        or not math.isfinite(rec["train_loss"])):
                    raise AssertionError(f"(b) {k} epoch record {rec}")
        restore = resumed["checkpoint"]["restore"]
        same = resumed["state_digests"] == unbroken["state_digests"]
        log(f"  ({k}) resumed run's state digest "
            f"{'equals' if same else 'DIFFERS from'} the unbroken run's "
            f"({unbroken['state_digests'][0][:16]}...); restore of epoch "
            f"{restore and restore['epoch']} bit-exact: "
            f"{restore and restore['digest_restored'] == restore['digest_at_save']}"
            f"; state bytes {unbroken.get('state_bytes')}")
        if (not same or restore is None or restore["epoch"] != 0
                or restore["digest_restored"] != restore["digest_at_save"]):
            raise AssertionError(f"(b) {k}: resumed {resumed['state_digests']}"
                                 f" != {unbroken['state_digests']}, restore "
                                 f"{restore}")
        out[k] = {"unbroken": unbroken, "resumed": resumed}
    return out


def sharded_phase(torch, workdir: str, data_dir: str) -> dict:
    """Phase 20 (module docstring)."""
    import torch.distributed as dist

    t0 = time.monotonic()
    data, batches = p17_batches(torch, P20_STEPS)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        log(f"  (a) {len(P20_RUNS)} ZeRO/FSDP runs against "
            f"{len(P20_TWINS)} plain twins, {P20_STEPS} steps each")
        runs, info = p20_models(torch, data, batches)
        log(f"  (a) {card_line()}: every run in turn")
        times = p17_rounds(torch, runs, P20_ROUNDS, steps={
            n: i["steps_per_dispatch"] for n, i in info.items()})
    finally:
        dist.destroy_process_group()
    del runs, batches
    gc.collect()
    torch.cuda.empty_cache()
    t_a = time.monotonic() - t0
    log("  (b) the launcher under ZeRO and FSDP: unbroken, stopped and "
        "resumed, and a ZeRO resume under another bucket count")
    launched = p20_launcher(torch, workdir, data_dir)
    log(f"  phase 20: (a) {t_a:.1f} s, (b) "
        f"{time.monotonic() - t0 - t_a:.1f} s")
    return {"runs": info, "times": times, "launcher": launched,
            "seconds": {"a": t_a, "b": time.monotonic() - t0 - t_a}}


# -- phase 21: the async rules on one card ----------------------------------

def p21_session(torch, name: str, workdir: str) -> dict:
    """One session of rule ``name`` through the rule API: AlexNet's
    recipe (batch 128, bf16, 227 crops, synthetic ImageNet, on-device
    augment) as two workers sharing this card (``devices=["cuda:0",
    "cuda:0"]``, a CUDA stream each), one epoch of ``P21_ITERS[name]``
    iterations a worker, then a validation of ``P21_VAL_IMAGES`` images,
    under ``monitor`` (per-worker step times and exchange spans).
    The launch counts are set to 0 just before the session and read just
    after: exactly 2 K3a + 2 K3b an iteration over both workers and 2
    K3a a validation batch, no other kernel; EASGD's exchanges and
    ASGD's updates as the iteration counts give them, GOSGD's weights
    summing to 1 within 1e-6; every training loss and the validation
    finite.  Times: the session's worker-thread wall over its iterations
    a worker (first iterations included); each worker's iteration
    (``step_ms``: host wall of the worker's loop body, its exchange
    included) as a mean without the slowest (the first) and a p50, and
    images/s over both workers at the means; the exchange spans' host ms
    per call."""
    from theanompi_tpu_torch import monitor, rules
    from theanompi_tpu_torch.data.imagenet import ImageNet_data
    from theanompi_tpu_torch.models.alex_net import AlexNet
    from theanompi_tpu_torch.ops import _kernels

    iters = P21_ITERS[name]
    data = ImageNet_data(crop=227, seed=0,
                         synthetic_n=2 * iters * TRAIN_BATCH)
    data.n_val = P21_VAL_IMAGES
    cfg = dataclasses.replace(AlexNet.default_config(), n_epochs=1,
                              batch_size=TRAIN_BATCH, print_freq=0,
                              snapshot_dir=workdir)
    opts = {"EASGD": {"tau": P21_TAU}, "ASGD": {},
            "GOSGD": {"p_push": P21_P_PUSH}}[name]
    span = P21_SPANS[name]
    with monitor.session(os.path.join(workdir, f"monitor_{name}")):
        _kernels.reset_launch_counts()
        rule = getattr(rules, name)().init(
            devices=["cuda:0", "cuda:0"],
            modelfile="theanompi_tpu_torch.models.alex_net",
            modelclass="AlexNet", config=cfg, data=data, checkpoint=False,
            **opts)
        res = rule.wait()
        counts = _kernels.launch_counts()
        reg = monitor.registry()
        hists = [reg.get("span_ms", span=span, worker=str(w)) for w in (0, 1)]
        steps = [reg.get("step_ms", phase="train", worker=str(w))
                 for w in (0, 1)]
    n_it = 2 * iters
    want = {k: 0 for k in counts}
    want.update(lrn=2 * n_it + 2 * res["val_batches"], lrn_bwd=2 * n_it)
    losses = [x for r in rule.recorders for x in r.train_losses]
    out = {"iterations": res["iterations"], "val_batches": res["val_batches"],
           "launches": counts, "session_launches": res["launches"],
           "train_s": res["train_s"], "val": res["val"],
           "session_ms_per_worker_iteration": res["train_s"] * 1e3 / iters,
           "session_images_per_s": n_it * TRAIN_BATCH / res["train_s"],
           "step_ms_p50": [h.percentile(50.0) for h in steps],
           # the slowest iteration (the first: the data pool, the first
           # launches on a new stream) left out
           "step_ms_mean": [(h.sum - h.max) / (h.count - 1) for h in steps],
           "first_step_ms": [h.max for h in steps]}
    out["images_per_s"] = sum(TRAIN_BATCH * 1e3 / ms
                              for ms in out["step_ms_mean"])
    calls = sum(h.count for h in hists if h)
    out.update(span=span, span_calls=calls,
               span_ms_per_call=sum(h.sum for h in hists if h) / max(1, calls),
               losses=len(losses), first_loss=losses[0] if losses else None,
               last_loss=losses[-1] if losses else None)
    for key in ("n_exchanges", "n_updates", "weights"):
        if key in res:
            out[key] = res[key]
    log(f"  {name}: {n_it} iterations over 2 workers in "
        f"{res['train_s']:.2f} s ({out['session_ms_per_worker_iteration']:.2f}"
        f" ms per worker iteration, first iterations included); a worker's "
        f"iteration: mean {out['step_ms_mean'][0]:.2f} / "
        f"{out['step_ms_mean'][1]:.2f} ms after the first "
        f"({out['first_step_ms'][0]:.0f} / {out['first_step_ms'][1]:.0f} "
        f"ms), p50 {out['step_ms_p50'][0]:.2f} / {out['step_ms_p50'][1]:.2f};"
        f" {out['images_per_s']:.0f} images/s on the card at the means; "
        f"{calls} {span} at {out['span_ms_per_call']:.2f} ms "
        f"(host); validation {res['val']} on {res['val_batches']} batches; "
        + ", ".join(f"{k} {out[k]}" for k in ("n_exchanges", "n_updates",
                                               "weights") if k in out))
    bad = []
    if counts != want or counts != res["launches"]:
        bad.append(f"launches {counts} (session {res['launches']}) != {want}")
    if res["iterations"] != n_it or len(losses) != n_it:
        bad.append(f"{res['iterations']} iterations, {len(losses)} losses, "
                   f"want {n_it}")
    if not all(math.isfinite(x) for x in losses) or not all(
            math.isfinite(v) for v in res["val"].values()) or not res["val"]:
        bad.append(f"non-finite loss or validation {res['val']}")
    if name == "EASGD" and res["n_exchanges"] != 2 * (iters // P21_TAU + 1):
        bad.append(f"n_exchanges {res['n_exchanges']}")
    if name == "ASGD" and res["n_updates"] != n_it:
        bad.append(f"n_updates {res['n_updates']}")
    if name == "GOSGD" and abs(sum(res["weights"]) - 1.0) > 1e-6:
        bad.append(f"weights {res['weights']} sum {sum(res['weights'])}")
    if bad:
        raise AssertionError(f"phase 21 {name}: " + "; ".join(bad))
    return out


def p21_store_ops(torch) -> dict:
    """Each store operation at AlexNet's 61.0 M f32 parameters on this
    card, ``P21_OP_REPS`` calls after one warm-up, host wall ending in a
    synchronize: an EASGD exchange (the host center copied to the card
    and back: 2 x 4P bytes over the host link), an ASGD ``push_pull``
    (gradients copied onto the server's card, the optimizer step, the
    fresh center copied out: 4 x 4P bytes of copies on HBM beside the
    step's own), a GOSGD push (a copy of the parameters: 2 x 4P bytes on
    HBM) and the receiver's merge of it (3 x 4P bytes)."""
    from theanompi_tpu_torch.models.alex_net import AlexNet
    from theanompi_tpu_torch.parallel.exchanger import gosgd_merge
    from theanompi_tpu_torch.parallel.server import (
        ASGDServer,
        EASGDServer,
        GossipHub,
    )

    model = AlexNet(device="cuda")
    params = [p.detach() for p in model.module.parameters()]
    nbytes = sum(p.numel() * p.element_size() for p in params)
    grads = [torch.full_like(p, 1e-4) for p in params]
    easgd = EASGDServer(params, alpha=0.5)
    asgd = ASGDServer(params, model.optimizer_hyperparams())
    hub = GossipHub(2)

    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(P21_OP_REPS):
            fn()
        torch.cuda.synchronize()
        return (time.monotonic() - t0) * 1e3 / P21_OP_REPS

    out = {"params": sum(p.numel() for p in params), "param_bytes": nbytes,
           "easgd_exchange": {"ms": timed(lambda: easgd.exchange(params)),
                              "host_link_bytes": 2 * nbytes},
           "asgd_push_pull": {"ms": timed(lambda: asgd.push_pull(grads)),
                              "copy_bytes": 4 * nbytes},
           "gosgd_push": {"ms": timed(lambda: hub.push(1, params, 0.25)),
                          "copy_bytes": 2 * nbytes}}
    (recv, _), *_ = hub.drain(1)
    out["gosgd_merge"] = {
        "ms": timed(lambda: gosgd_merge(params, 0.5, recv, 0.25)),
        "hbm_bytes": 3 * nbytes}
    for op in ("easgd_exchange", "asgd_push_pull", "gosgd_push",
               "gosgd_merge"):
        b = next(v for k, v in out[op].items() if k.endswith("bytes"))
        out[op]["gb_per_s"] = b / out[op]["ms"] / 1e6
    log(f"  store operations at {out['params']} parameters "
        f"({nbytes / 1e6:.1f} MB): "
        + "; ".join(f"{op} {out[op]['ms']:.2f} ms ({out[op]['gb_per_s']:.1f} "
                    "GB/s of its bytes)"
                    for op in ("easgd_exchange", "asgd_push_pull",
                               "gosgd_push", "gosgd_merge")))
    return out


def p21_schedule(torch, name: str, device: str, schedule=None,
                 **remote) -> dict:
    """The CPU tests' round-robin two-worker schedule of rule ``name``
    (EASGD: tau 2, alpha 0.5, 8 iterations a worker then the final sync;
    ASGD: 3 pushes a worker in each of 2 epochs, the LR schedule forwarded
    in between) driven through ``rule.prepare`` on ``device``: f32,
    batch 8, the host augment (numpy draws, alike on both devices),
    ``P21AlexNet`` (the recipe's seeded weights, no dropout).  Returns
    the initial parameters, the center and both workers' parameters, on
    the host.  From He-normal weights these schedules are chaotic (a
    1e-7 relative change of the initial weights moves the CPU's EASGD
    center by 3.6% of its displacement); from the recipe's, by 1.4e-5.
    ``schedule`` overrides ``P21_SCHEDULES[name]``; ``remote``
    (``server_addr``) runs the store in a service (phase 22)."""
    from theanompi_tpu_torch import rules
    from theanompi_tpu_torch.data.imagenet import ImageNet_data
    from theanompi_tpu_torch.models.alex_net import AlexNet

    epochs, iters = schedule or P21_SCHEDULES[name]
    data = ImageNet_data(crop=227, seed=0,
                         synthetic_n=2 * iters * P21_CHECK_BATCH,
                         synthetic_pool=16, augment_on_device=False)
    cfg = dataclasses.replace(
        AlexNet.default_config(), compute_dtype="float32",
        batch_size=P21_CHECK_BATCH, n_epochs=epochs, lr_decay_epochs=(1,),
        print_freq=0)
    opts = {"tau": 2, "alpha": 0.5} if name == "EASGD" else {}
    rule = getattr(rules, name)().prepare(
        devices=[device, device], modelfile="chip_smoke",
        modelclass="P21AlexNet", config=cfg, data=data, checkpoint=False,
        **opts, **remote)
    try:
        # copies: on the CPU .cpu() would alias the live parameters
        init = [p.detach().cpu().clone()
                for p in rule.models[0].module.parameters()]
        ws = rule.workers
        for w in ws:
            w.open()
        for epoch in range(epochs):
            for w in ws:
                w.model.begin_epoch(epoch)
            for it in range(iters):
                for w in ws:
                    w.step(it)
            for w in ws:
                w.end_epoch(epoch)
        for w in ws:
            w.finish()
            w.close()
        return {"init": init,
                "center": [t.detach().cpu().clone() for t in
                           rule.server.get_center()],
                "workers": [[p.detach().cpu().clone() for p in w.params]
                            for w in ws]}
    finally:
        rule.close()


def p21_card_vs_cpu(torch) -> dict:
    """The EASGD and ASGD schedules on the card and on the CPU: the
    center's displacement from the initial parameters, and each worker's,
    within relative L2 ``P21_CENTER_LIMIT`` of the CPU's (the limit phase
    18 (a) holds an f32 card gradient to)."""
    def flat(ts):
        return torch.cat([t.reshape(-1).double() for t in ts])

    out = {}
    for name in P21_SCHEDULES:
        t0 = time.monotonic()
        card = p21_schedule(torch, name, "cuda:0")
        t_card = time.monotonic() - t0
        cpu = p21_schedule(torch, name, "cpu")
        t_cpu = time.monotonic() - t0 - t_card
        init = flat(cpu["init"])
        if not torch.equal(flat(card["init"]), init):
            raise AssertionError(f"phase 21 (b) {name}: the card's initial "
                                 "parameters differ from the CPU's")

        def rel(got, want):
            d = flat(want) - init
            return float((flat(got) - flat(want)).norm() / d.norm())

        r = {"center": rel(card["center"], cpu["center"]),
             "workers": [rel(g, w) for g, w in zip(card["workers"],
                                                   cpu["workers"])],
             "center_finite": bool(torch.isfinite(flat(card["center"])).all()),
             "displacement": float((flat(cpu["center"]) - init).norm()
                                   / init.norm()),
             "card_s": t_card, "cpu_s": t_cpu}
        out[name] = r
        log(f"  {name}: card vs CPU, relative L2 of the displacement from "
            f"the initial parameters: center {r['center']:.3g}, workers "
            f"{', '.join(f'{x:.3g}' for x in r['workers'])} (limit "
            f"{P21_CENTER_LIMIT}; the center moved {r['displacement']:.3g} "
            f"of the parameters' norm); card {t_card:.1f} s, cpu "
            f"{t_cpu:.1f} s")
        if not (r["center_finite"] and r["center"] <= P21_CENTER_LIMIT
                and max(r["workers"]) <= P21_CENTER_LIMIT):
            raise AssertionError(f"phase 21 (b) {name}: {r}")
    return out


def p21_launcher_start(workdir: str) -> Launched:
    """Start ``python -m theanompi_tpu_torch.launcher EASGD -D 1 --tau 4``
    on AlexNet's defaults (batch 128, one epoch of the 8192-image
    synthetic set) with ``--result-json``."""
    return Launched(workdir, [
        "EASGD", "-D", "1", "--tau", str(P21_TAU), "-m",
        "theanompi_tpu_torch.models.alex_net", "-c", "AlexNet", "--epochs",
        "1", "--set", "print_freq=0", "--snapshot-dir", workdir])


def p21_launcher(run: Launched) -> dict:
    """Phase 21 (c)'s checks of :func:`p21_launcher_start`'s run: one
    worker, its exchanges (one each 4 iterations and the final one), 2
    K3a + 2 K3b an iteration and 2 K3a a validation batch, a finite
    validation."""
    res, wall, _ = run.wait(600)
    cmd = run.cmd
    n_it = res["iterations"]
    want = {k: 0 for k in res["launches"]}
    want.update(lrn=2 * n_it + 2 * res["val_batches"], lrn_bwd=2 * n_it)
    out = {"cmd": " ".join(cmd[1:]), "wall_s": wall, "iterations": n_it,
           "n_exchanges": res["n_exchanges"], "launches": res["launches"],
           "val_batches": res["val_batches"], "val": res["val"],
           "train_s": res["train_s"], "devices": res["devices"],
           "ms_per_iteration": res["train_s"] * 1e3 / n_it}
    log(f"  {n_it} iterations, {res['n_exchanges']} exchanges, "
        f"{res['val_batches']} validation batches in {wall:.1f} s "
        f"({out['ms_per_iteration']:.2f} ms an iteration: the session's "
        f"worker wall, its start and exchanges included); val {res['val']};"
        f" launches lrn {res['launches']['lrn']}"
        f" lrn_bwd {res['launches']['lrn_bwd']}")
    if (res["devices"] != ["cuda:0"] or n_it != 8192 // TRAIN_BATCH
            or res["n_exchanges"] != n_it // P21_TAU + 1
            or res["launches"] != want or not res["val"]
            or not all(math.isfinite(v) for v in res["val"].values())):
        raise AssertionError(f"phase 21 (c): {out} (want launches {want})")
    return out


def async_phase(torch, workdir: str) -> dict:
    """Phase 21: (a) the three rules' sessions on two workers sharing the
    card, then each store operation timed alone; (b) the card against
    the CPU, with (c) the EASGD launcher's run beside it (neither is
    timed against the other)."""
    t0 = time.monotonic()
    log("  (a) EASGD, ASGD and GOSGD: two AlexNet workers on this card")
    sessions = {name: p21_session(torch, name, workdir)
                for name in P21_ITERS}
    torch.cuda.empty_cache()
    ops = p21_store_ops(torch)
    torch.cuda.empty_cache()
    log("  (b) the round-robin EASGD and ASGD schedules, card against CPU,"
        " beside (c) the launcher: EASGD -D 1")
    started = p21_launcher_start(workdir)
    try:
        checked = p21_card_vs_cpu(torch)
        torch.cuda.empty_cache()
        launched = p21_launcher(started)
    finally:
        started.close()
    seconds = time.monotonic() - t0
    log(f"  phase 21: {seconds:.1f} s")
    return {"sessions": sessions, "store_ops": ops, "card_vs_cpu": checked,
            "launcher": launched, "seconds": seconds}


class ServiceProc:
    """``python -m theanompi_tpu_torch.parallel.service`` on its default
    device (this card), its output in a file under ``workdir``."""

    def __init__(self, workdir: str, name: str):
        self.port = free_port()
        self.addr = f"127.0.0.1:{self.port}"
        self.log = open(os.path.join(workdir, f"{name}.log"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "theanompi_tpu_torch.parallel.service",
             "--host", "127.0.0.1", "--port", str(self.port)],
            stdout=self.log, stderr=subprocess.STDOUT, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))

    def wait_ready(self, timeout: float = 120.0) -> None:
        from theanompi_tpu_torch.parallel.service import ServiceClient
        from theanompi_tpu_torch.resilience.retry import RetryPolicy

        deadline = time.monotonic() + timeout
        while True:
            try:
                c = ServiceClient(self.addr,
                                  retry=RetryPolicy(max_attempts=1))
                try:
                    if c.call("ping") == "pong":
                        return
                finally:
                    c.close()
            except OSError:
                pass
            if self.proc.poll() is not None or time.monotonic() > deadline:
                self.log.seek(0)
                raise AssertionError(
                    f"service at {self.addr} did not come up (exit "
                    f"{self.proc.poll()}): {self.log.read()[-2000:]}")
            time.sleep(0.3)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


def _counter(reg, name: str, direction: str | None = None,
             **labels) -> float:
    if direction is not None:
        labels["dir"] = direction
    m = reg.get(name, **labels)
    return float(m.value) if m is not None else 0.0


def p22_wire_env(shm_lane: bool, dtype: str) -> None:
    """The service clients' wire settings, read when a client is made."""
    os.environ["THEANOMPI_TPU_WIRE_SHM"] = "1" if shm_lane else "0"
    os.environ["THEANOMPI_TPU_WIRE_DTYPE"] = dtype


def p22_exchange_costs(torch, addr: str, workdir: str) -> dict:
    """Phase 22 (c): AlexNet's parameters (on this card) moved once each
    way and exchanged, ``P22_REPS`` timed calls after one warm-up, host
    wall ending in a synchronize.  Worker to service: a gossip push (the
    worker's tensors copied to the host, framed, received and copied into
    the hub); service to worker: the hub's drain (framed back, copied
    into new host tensors, then onto the card); round trip: an EASGD
    exchange (both ways and the elastic arithmetic on the service's
    card).  Setups: ``tcp`` (in-band f32), ``shm`` (the lane, f32), and
    ``bf16`` (in-band: the lane ships a leaf at its own dtype); the
    in-process stores beside them.  Each direction's bytes before and
    after the wire (the client's ``service/wire_bytes_pre``/``_post``),
    their ratio and ``shm/oob_bytes_total`` per call say which path each
    exchange took."""
    from theanompi_tpu_torch import monitor
    from theanompi_tpu_torch.models.alex_net import AlexNet
    from theanompi_tpu_torch.parallel import shm
    from theanompi_tpu_torch.parallel.server import EASGDServer, GossipHub
    from theanompi_tpu_torch.parallel.service import (
        RemoteEASGD,
        RemoteGossipHub,
    )

    model = AlexNet(device="cuda")
    params = [p.detach() for p in model.module.parameters()]
    nbytes = sum(p.numel() * p.element_size() for p in params)
    st = os.statvfs("/dev/shm")
    dev_shm = {"size_bytes": st.f_blocks * st.f_frsize,
               "free_bytes": st.f_bavail * st.f_frsize}
    log(f"  /dev/shm: {dev_shm['size_bytes'] / 2**20:.0f} MiB, "
        f"{dev_shm['free_bytes'] / 2**20:.0f} MiB free; AlexNet's "
        f"{sum(p.numel() for p in params)} parameters: {nbytes / 1e6:.1f} MB")

    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(P22_REPS):
            fn()
        torch.cuda.synchronize()
        return (time.monotonic() - t0) * 1e3 / P22_REPS

    out = {"param_bytes": nbytes, "dev_shm": dev_shm, "setups": {}}
    setups = {"tcp": (False, "f32"), "shm": (True, "f32"),
              "bf16": (False, "bf16")}
    try:
        for name, (lane, dtype) in setups.items():
            p22_wire_env(lane, dtype)
            with monitor.session(os.path.join(workdir, f"p22c_{name}")):
                reg = monitor.registry()
                hub = RemoteGossipHub(addr, 2, session_id=f"p22c-{name}")
                east = RemoteEASGD(addr, params, alpha=0.5,
                                   session_id=f"p22c-{name}")
                try:
                    row = {}
                    before = {k: _counter(reg, *k) for k in _P22_SERIES}
                    push_ms, drain_ms = [], []
                    for _ in range(P22_REPS + 1):
                        torch.cuda.synchronize()
                        t1 = time.monotonic()
                        hub.push(1, params, 0.25)
                        t2 = time.monotonic()
                        (got, _), = hub.drain(1)
                        moved = [t.to("cuda", non_blocking=True)
                                 for t in got]
                        torch.cuda.synchronize()
                        t3 = time.monotonic()
                        push_ms.append((t2 - t1) * 1e3)
                        drain_ms.append((t3 - t2) * 1e3)
                        del got, moved
                    mid = {k: _counter(reg, *k) for k in _P22_SERIES}
                    trip_ms = timed(lambda: east.exchange(params))
                    after = {k: _counter(reg, *k) for k in _P22_SERIES}
                    calls = P22_REPS + 1
                    moved1 = {k: (mid[k] - before[k]) / calls
                              for k in _P22_SERIES}
                    moved2 = {k: (after[k] - mid[k]) / calls
                              for k in _P22_SERIES}
                    # the warm-up call left out of the times
                    row["to_service"] = _p22_bytes_row(
                        "to_service", float(np.mean(push_ms[1:])), moved1,
                        nbytes)
                    row["to_worker"] = _p22_bytes_row(
                        "to_worker", float(np.mean(drain_ms[1:])), moved1,
                        nbytes)
                    row["round_trip"] = _p22_bytes_row(
                        "round_trip", trip_ms, moved2, nbytes)
                    row["fallbacks"] = {
                        r: _counter(reg, "shm/fallback_total", reason=r)
                        for r in ("cap", "alloc", "space", "remote",
                                  "nonce")}
                finally:
                    hub.close()
                    east.close()
            out["setups"][name] = row
            log(f"  {name}: " + "; ".join(
                f"{way} {r['ms']:.1f} ms ({r['path']}, "
                f"{r['pre_bytes'] / 1e6:.1f} -> {r['post_bytes'] / 1e6:.1f}"
                f" MB on the wire, ratio {r['ratio']:.3f}, oob "
                f"{r['oob_bytes'] / 1e6:.1f} MB, "
                f"{nbytes / r['ms'] / 1e6 * (2 if way == 'round_trip' else 1):.2f}"
                " GB/s of parameters)"
                for way, r in row.items() if way != "fallbacks")
                + (f"; shm fallbacks {row['fallbacks']}"
                   if any(row["fallbacks"].values()) else ""))
            # the bf16 wire halves the parameters' bytes, TCP in f32
            # keeps them (the frame's header travels whole in both: a
            # few KiB of 244 MB); the lane's bytes are not on the wire
            want_ratio = {"tcp": 1.0, "bf16": 0.5}.get(name)
            off = {way: r["ratio"] for way, r in row.items()
                   if way != "fallbacks" and want_ratio is not None
                   and abs(r["ratio"] - want_ratio) > 1e-3}
            if off:
                raise AssertionError(f"phase 22 (c) {name}: wire ratio "
                                     f"{off}, want {want_ratio}")
    finally:
        shm.release_all()
        p22_wire_env(True, "f32")
    easgd = EASGDServer(params, alpha=0.5)
    hub = GossipHub(2)

    def push_drain():
        hub.push(1, params, 0.25)
        hub.drain(1)
    push_ms = timed(push_drain)
    out["in_process"] = {
        "easgd_exchange_ms": timed(lambda: easgd.exchange(params)),
        "gosgd_push_drain_ms": push_ms}
    ex_ms = out["in_process"]["easgd_exchange_ms"]
    log(f"  in-process: EASGD exchange {ex_ms:.1f} ms, gossip push and "
        f"drain {push_ms:.1f} ms")
    return out


#: the client-side byte series phase 22 (c) reads (name, dir)
_P22_SERIES = (("service/wire_bytes_pre", "send"),
               ("service/wire_bytes_post", "send"),
               ("service/wire_bytes_pre", "recv"),
               ("service/wire_bytes_post", "recv"),
               ("shm/oob_bytes_total", "send"),
               ("shm/oob_bytes_total", "recv"))


def _p22_bytes_row(way: str, ms: float, got: dict, nbytes: int) -> dict:
    """One direction's bytes per call: the big frame's direction (send
    for the push, recv for the drain, both for the round trip)."""
    dirs = {"to_service": ("send",), "to_worker": ("recv",),
            "round_trip": ("send", "recv")}[way]
    pre = sum(got[("service/wire_bytes_pre", d)] for d in dirs)
    post = sum(got[("service/wire_bytes_post", d)] for d in dirs)
    oob = sum(got[("shm/oob_bytes_total", d)] for d in dirs)
    return {"ms": ms, "pre_bytes": pre, "post_bytes": post,
            "ratio": post / pre if pre else 1.0, "oob_bytes": oob,
            "path": ("shm lane" if oob >= 0.9 * nbytes * len(dirs)
                     else "in-band" if oob == 0 else "mixed")}


def p22_schedules(torch, addr: str) -> dict:
    """Phase 22 (a): phase 21 (b)'s EASGD and ASGD schedules at
    ``P22_SCHEDULES``' lengths on the card,
    in-process and through the service on the f32 wire (bit-identical:
    center and both workers), and EASGD's on the bf16 wire (lane off)
    within ``P22_BF16_LIMIT`` of the f32 wire's parameters in relative
    L2; the K3 launches of each remote run exact (2 K3a + 2 K3b an
    iteration, no validation).  cuDNN runs its deterministic algorithms
    here: otherwise two runs of one schedule on this card differ in
    their summation order (phase 21 (b) saw the card's own repeat
    differ), and the comparison would test the convolutions,
    not the service.  If the f32 wire is not bit-identical, the
    in-process schedule runs again to say whether the card repeats
    itself."""
    from theanompi_tpu_torch.ops import _kernels

    def flat(ts):
        return torch.cat([t.reshape(-1).double() for t in ts])

    def tensors(run):
        return run["center"] + sum(run["workers"], [])

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for name, (epochs, iters) in P22_SCHEDULES.items():
            runs, counts = {}, {}
            legs = [("in_process", True, "f32", {}),
                    ("f32_wire", True, "f32", {"server_addr": addr})]
            if name == "EASGD":
                legs.append(("bf16_wire", False, "bf16",
                             {"server_addr": addr}))
            for label, lane, dtype, remote in legs:
                p22_wire_env(lane, dtype)
                _kernels.reset_launch_counts()
                t0 = time.monotonic()
                runs[label] = p21_schedule(torch, name, "cuda:0",
                                           (epochs, iters), **remote)
                runs[label]["s"] = time.monotonic() - t0
                counts[label] = _kernels.launch_counts()
            p22_wire_env(True, "f32")
            n_it = 2 * epochs * iters
            want = {k: 0 for k in counts["f32_wire"]}
            want.update(lrn=2 * n_it, lrn_bwd=2 * n_it)
            same = [torch.equal(a, b) for a, b in
                    zip(tensors(runs["in_process"]),
                        tensors(runs["f32_wire"]))]
            r = {"bit_identical": all(same), "tensors": len(same),
                 "launches": counts,
                 "seconds": {k: v["s"] for k, v in runs.items()}}
            if "bf16_wire" in runs:
                f32, b16 = runs["f32_wire"], runs["bf16_wire"]

                def rel(got, want_):
                    return float((flat(got) - flat(want_)).norm()
                                 / flat(want_).norm())
                r["bf16_center"] = rel(b16["center"], f32["center"])
                r["bf16_workers"] = [rel(g, w) for g, w in
                                     zip(b16["workers"], f32["workers"])]
            if not r["bit_identical"]:
                again = p21_schedule(torch, name, "cuda:0",
                                     (epochs, iters))
                r["card_repeats_itself"] = all(
                    torch.equal(a, b) for a, b in
                    zip(tensors(runs["in_process"]), tensors(again)))
            out[name] = r
            log(f"  {name} schedule: service (f32 wire) against "
                f"in-process: {sum(same)}/{len(same)} tensors "
                "bit-identical"
                + (f" (the card repeats itself: "
                   f"{r['card_repeats_itself']})"
                   if "card_repeats_itself" in r else "")
                + (f"; bf16 wire against f32 wire: center "
                   f"{r['bf16_center']:.3g}, workers "
                   f"{', '.join(f'{x:.3g}' for x in r['bf16_workers'])} "
                   f"(relative L2 of the parameters; limit "
                   f"{P22_BF16_LIMIT:.4g})" if "bf16_center" in r else "")
                + "; " + ", ".join(f"{k} {v:.1f} s"
                                   for k, v in r["seconds"].items()))
            bad = []
            if not r["bit_identical"]:
                bad.append("the service's f32 run is not the in-process "
                           "run")
            if "bf16_center" in r and max(
                    [r["bf16_center"], *r["bf16_workers"]]) \
                    > P22_BF16_LIMIT:
                bad.append("bf16 wire past its limit")
            if "bf16_center" in r and min(
                    [r["bf16_center"], *r["bf16_workers"]]) <= 0.0:
                bad.append("bf16 wire at distance 0 from the f32 wire: "
                           "nothing was rounded")
            for label in counts:
                if label != "in_process" and counts[label] != want:
                    bad.append(f"{label} launches {counts[label]} != "
                               f"{want}")
            if bad:
                raise AssertionError(f"phase 22 (a) {name}: "
                                     + "; ".join(bad))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


def p22_aggregated(torch, service: ServiceProc, workdir: str) -> dict:
    """Phase 22 (b), in this process: EASGD with two AlexNet workers on
    ``devices=["cuda:0", "cuda:0"]`` (tau 1, alpha 0.5: n * alpha = 1)
    and ``local_aggregation=True`` through the service, each worker on
    its half of the ``P22_ITERS`` batches: one aggregate wire exchange a
    period (every iteration of a worker and the final sync), each
    counted as two exchanges at the service, no fallback, exact K3
    totals."""
    from theanompi_tpu_torch import rules
    from theanompi_tpu_torch.ops import _kernels

    cls = _p22_alexnet()
    cfg = dataclasses.replace(cls.default_config(), n_epochs=1,
                              batch_size=TRAIN_BATCH, print_freq=0,
                              snapshot_dir=workdir)
    _kernels.reset_launch_counts()
    t0 = time.monotonic()
    rule = rules.EASGD().init(
        devices=["cuda:0", "cuda:0"], modelfile="chip_smoke",
        modelclass="P22AlexNet", config=cfg, checkpoint=False, tau=1,
        alpha=0.5, local_aggregation=True, server_addr=service.addr,
        session_id="p22-aggregated")
    res = rule.wait()
    wall = time.monotonic() - t0
    counts = _kernels.launch_counts()
    n_it = res["iterations"]
    periods = P22_ITERS // 2 + 1
    want = {k: 0 for k in counts}
    want.update(lrn=2 * n_it + 2 * res["val_batches"], lrn_bwd=2 * n_it)
    out = {"iterations": n_it, "aggregate": res["aggregate"],
           "n_exchanges": res["n_exchanges"], "periods": periods,
           "launches": counts, "val": res["val"], "wall_s": wall,
           "train_s": res["train_s"]}
    log(f"  aggregated EASGD: {n_it} iterations over 2 workers, "
        f"{res['aggregate']['flights']} aggregate exchanges for "
        f"{periods} periods, {res['aggregate']['fallbacks']} fallbacks, "
        f"{res['n_exchanges']} exchanges counted at the service; "
        f"{wall:.1f} s; val {res['val']}")
    if (n_it != P22_ITERS or counts != want
            or res["aggregate"] != {"flights": periods, "fallbacks": 0}
            or res["n_exchanges"] != 2 * periods or not res["val"]
            or not all(math.isfinite(v) for v in res["val"].values())):
        raise AssertionError(f"phase 22 (b) aggregated: {out} (want "
                             f"launches {want})")
    return out


def p22_launchers_start(workdir: str, service_addr: str) -> dict:
    """Phase 22 (b)'s launcher runs, started side by side."""
    common = ["-m", "chip_smoke", "-c", "P22AlexNet", "--epochs", "1",
              "--set", "print_freq=0"]
    args = {
        "easgd": ["EASGD", "-D", "1", "--tau", str(P22_TAU),
                  "--server-addr", service_addr, "--session-id",
                  "p22-easgd"],
        "asgd_shards": ["ASGD", "-D", "1", "--shards", "2"],
        **{f"gosgd_r{r}": ["GOSGD", "-D", "1", "--p-push", str(P22_P_PUSH),
                           "--server-addr", service_addr,
                           "--n-total-workers", "2", "--rank-offset",
                           str(r), "--session-id", "p22-gosgd"]
           for r in (0, 1)}}
    runs = {}
    for name, a in args.items():
        d = os.path.join(workdir, name)
        os.makedirs(d, exist_ok=True)
        runs[name] = Launched(d, [*a, *common, "--snapshot-dir", d])
    return runs


def p22_launchers(runs: dict) -> dict:
    """Phase 22 (b)'s checks: each run's iterations, exact K3 totals (2
    K3a + 2 K3b an iteration, 2 K3a a validation batch), a finite
    validation; EASGD's exchanges (one each ``P22_TAU`` iterations and
    the final one), ASGD's updates, the two GOSGD processes' weights
    summing to 1 within 1e-6."""
    out = {}
    for name, run in runs.items():
        res, wall, stdout = run.wait(600)
        n_it = res["iterations"]
        want = {k: 0 for k in res["launches"]}
        want.update(lrn=2 * n_it + 2 * res["val_batches"], lrn_bwd=2 * n_it)
        r = {"cmd": " ".join(run.cmd[1:]), "wall_s": wall,
             "iterations": n_it, "launches": res["launches"],
             "val_batches": res["val_batches"], "val": res["val"],
             "train_s": res["train_s"],
             "ms_per_iteration": res["train_s"] * 1e3 / n_it}
        for key in ("n_exchanges", "n_updates", "weights"):
            if key in res:
                r[key] = res[key]
        out[name] = r
        log(f"  launcher {name}: {n_it} iterations, {res['val_batches']} "
            f"validation batches in {wall:.1f} s ({r['ms_per_iteration']:.1f}"
            f" ms an iteration, the cards shared); launches lrn "
            f"{res['launches']['lrn']} lrn_bwd {res['launches']['lrn_bwd']}; "
            + ", ".join(f"{k} {r[k]}" for k in ("n_exchanges", "n_updates",
                                                 "weights") if k in r))
        bad = (n_it != P22_ITERS or res["launches"] != want
               or not res["val"]
               or not all(math.isfinite(v) for v in res["val"].values()))
        if name == "easgd":
            bad |= res["n_exchanges"] != P22_ITERS // P22_TAU + 1
        if name == "asgd_shards":
            bad |= res["n_updates"] != P22_ITERS
            # the fleet holds its ranges on the workers' platform
            shards = dict(re.findall(r"\[shards\] shard (\d+) listening "
                                     r"on \S+ \(device (\S+)\)", stdout))
            r["shard_devices"] = shards
            log(f"  launcher {name}: shard devices {shards}")
            bad |= sorted(shards) != ["0", "1"] or any(
                d != "cuda" for d in shards.values())
        if bad:
            raise AssertionError(f"phase 22 (b) {name}: {r} (want "
                                 f"launches {want})")
    weights = out["gosgd_r0"]["weights"] + out["gosgd_r1"]["weights"]
    if abs(sum(weights) - 1.0) > 1e-6:
        raise AssertionError(f"phase 22 (b) gosgd: weights {weights}")
    return out


def remote_phase(torch, workdir: str) -> dict:
    """Phase 22: (c) the exchange costs alone, then (b)'s launchers side
    by side on the card while this process runs (a) and (b)'s aggregated
    session (none of these timed against another)."""
    import secrets

    t0 = time.monotonic()
    os.environ.setdefault("THEANOMPI_TPU_SERVICE_KEY", secrets.token_hex(16))
    services = [ServiceProc(workdir, "service_launchers"),
                ServiceProc(workdir, "service_here")]
    runs: dict = {}
    try:
        for s in services:
            s.wait_ready()
        log(f"  two services up in {time.monotonic() - t0:.1f} s")
        log("  (c) one exchange of AlexNet's parameters each way, alone")
        costs = p22_exchange_costs(torch, services[1].addr, workdir)
        torch.cuda.empty_cache()
        log("  (b) the launchers side by side, beside (a) and the "
            "aggregated session")
        runs = p22_launchers_start(workdir, services[0].addr)
        sched = p22_schedules(torch, services[1].addr)
        torch.cuda.empty_cache()
        aggregated = p22_aggregated(torch, services[1], workdir)
        torch.cuda.empty_cache()
        launched = p22_launchers(runs)
    finally:
        for run in runs.values():
            run.close()
        for s in services:
            s.close()
    seconds = time.monotonic() - t0
    log(f"  phase 22: {seconds:.1f} s")
    return {"exchange_costs": costs, "schedules": sched,
            "aggregated": aggregated, "launchers": launched,
            "seconds": seconds}


# -- phase 23: the telemetry plane and distributed ingest -------------------

def _exact_launches(got: dict, want: dict) -> bool:
    """Every kernel of ``want`` launched exactly so often, and no kernel
    it does not name."""
    return ({k: got.get(k, 0) for k in want} == want
            and not set(got) - set(want))


def _digesting_prefetcher(digests: list, sizes: list):
    """A stand-in for ``models.base.DevicePrefetcher`` that files the
    sha256 of every host batch (images, then labels) in ``digests`` and
    its images' bytes in ``sizes`` on the loader thread, where the batch
    is staged, before it goes on."""
    import hashlib

    from theanompi_tpu_torch.data import prefetch

    def tap(host_batches):
        for x, y in host_batches:
            h = hashlib.sha256(np.ascontiguousarray(x).data)
            h.update(np.ascontiguousarray(y).data)
            digests.append(h.hexdigest())
            sizes.append(int(x.nbytes))
            yield x, y

    def make(host_batches, device, source="local"):
        return prefetch.DevicePrefetcher(tap(host_batches), device,
                                         source=source)

    return make


def p23_steps(torch, data_dir: str, ingest: str | None,
              run_dir: str) -> dict:
    """Phase 23 (a): ``P23_STEPS`` batch-128 ResNet-50 steps in this
    process on ``data_dir`` through ``begin_epoch``, from the local
    loader (``ingest`` None) or the fleet at ``ingest``
    (``THEANOMPI_TPU_INGEST``), under a monitor session in ``run_dir``:
    the per-batch digests and image bytes, the launches of the steps
    (counts set to 0 just before them), the final state's digest, the
    host wall a step over steps 2 on (a synchronize at each end) and
    the bytes received out of band over the shm lane
    (``shm/oob_bytes_total{dir=recv}``)."""
    from theanompi_tpu_torch import monitor
    from theanompi_tpu_torch.models import base as model_base
    from theanompi_tpu_torch.models.resnet50 import ResNet50
    from theanompi_tpu_torch.ops import _kernels
    from theanompi_tpu_torch.utils.checkpoint import state_digest
    from theanompi_tpu_torch.utils.recorder import Recorder

    config = dataclasses.replace(
        ResNet50.default_config(), batch_size=TRAIN_BATCH, n_epochs=1,
        print_freq=P23_STEPS, data_dir=data_dir)
    model = ResNet50(config=config, device="cuda")
    model.compile_iter_fns()
    digests: list[str] = []
    sizes: list[int] = []
    saved_env = os.environ.pop("THEANOMPI_TPU_INGEST", None)
    saved_prefetcher = model_base.DevicePrefetcher
    model_base.DevicePrefetcher = _digesting_prefetcher(digests, sizes)
    try:
        if ingest:
            os.environ["THEANOMPI_TPU_INGEST"] = ingest
        with monitor.session(run_dir, name="p23a"):
            n_iters = model.begin_epoch(0)
            source = model._train_prefetcher._source
            recorder = Recorder(print_freq=0)
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            it = model.train_iter(0, recorder)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            while it < P23_STEPS:
                it += model.train_iter(it, recorder)
            torch.cuda.synchronize()
            ms = (time.monotonic() - t0) * 1e3 / (P23_STEPS - 1)
            launches = _kernels.launch_counts()
            model._flush_metrics(recorder)
            digest = state_digest(model.checkpoint_payload(0))
            oob = monitor.registry().value("shm/oob_bytes_total",
                                           dir="recv") or 0
    finally:
        model.cleanup()
        model_base.DevicePrefetcher = saved_prefetcher
        os.environ.pop("THEANOMPI_TPU_INGEST", None)
        if saved_env is not None:
            os.environ["THEANOMPI_TPU_INGEST"] = saved_env
    want = {k: v * P23_STEPS for k, v in TRAIN_LAUNCHES.items()}
    if not _exact_launches(launches, want):
        raise AssertionError(f"phase 23 (a) {source}: launches {launches} "
                             f"!= {want}")
    losses = recorder.train_losses
    if len(losses) != P23_STEPS or not all(math.isfinite(v)
                                           for v in losses):
        raise AssertionError(f"phase 23 (a) {source}: losses {losses}")
    return {"source": source, "n_iters": n_iters,
            "digests": digests[:P23_STEPS], "image_bytes": sizes[:P23_STEPS],
            "state_digest": digest, "launches": launches, "losses": losses,
            "ms_per_step": ms, "oob_recv_bytes": oob}


def p23_spans(torch, model, workdir: str) -> dict:
    """Phase 23 (c): ``P23_SPAN_REPS`` batch-128 steps of ``model`` (a
    ResNet-50) each under a span fenced on the parameters
    (``bsp/step``) and under an unfenced one (``bsp/enqueue``), each
    step also timed by CUDA events recorded around its enqueue; every
    fenced span must last at least its step's event time."""
    from theanompi_tpu_torch import monitor

    model.compile_iter_fns()
    model.begin_epoch(0)
    params = list(model.module.parameters())
    out: dict = {"fenced_ms": [], "unfenced_ms": [], "event_ms": [],
                 "event_ms_unfenced": []}
    try:
        with monitor.session(os.path.join(workdir, "p23_spans"),
                             name="p23spans"):
            reg = monitor.registry()
            for name, fence in (("bsp/step", params),
                                ("bsp/enqueue", None)):
                for _ in range(P23_SPAN_REPS):
                    batch = next(model._train_iter)
                    torch.cuda.synchronize()
                    ev0 = torch.cuda.Event(enable_timing=True)
                    ev1 = torch.cuda.Event(enable_timing=True)
                    before = reg.get("span_ms", span=name)
                    s0 = before.sum if before is not None else 0.0
                    with monitor.span(name, fence=fence):
                        ev0.record()
                        model.train_step(model.state, batch, model._rng)
                        ev1.record()
                    span_ms = reg.get("span_ms", span=name).sum - s0
                    torch.cuda.synchronize()
                    key = "fenced" if fence is not None else "unfenced"
                    out[f"{key}_ms"].append(span_ms)
                    out["event_ms" if fence is not None
                        else "event_ms_unfenced"].append(
                        ev0.elapsed_time(ev1))
    finally:
        model.cleanup()
    short = [(f, e) for f, e in zip(out["fenced_ms"], out["event_ms"])
             if f < e]
    if short:
        raise AssertionError(f"phase 23 (c): a fenced span shorter than "
                             f"its step's CUDA-event time: {short}")
    return out


def p23_fault(model, ingest: str, workdir: str) -> dict:
    """Phase 23 (d): ``run_bsp_session`` of ``model`` fed by the fleet
    with a fault plan raising at ``ingest_pull`` index
    ``P23_FAULT_INDEX``: the session must fail with ``FaultInjected``
    and leave a postmortem."""
    from theanompi_tpu_torch.resilience import faults
    from theanompi_tpu_torch.rules.bsp import run_bsp_session

    run_dir = os.path.join(workdir, "p23_fault")
    faults.install([{"site": "ingest_pull", "index": P23_FAULT_INDEX,
                     "action": "raise"}])
    os.environ["THEANOMPI_TPU_INGEST"] = ingest
    raised = None
    try:
        run_bsp_session(model, checkpoint=False, monitor_dir=run_dir)
    except faults.FaultInjected as e:
        raised = e
    finally:
        faults.clear()
        os.environ.pop("THEANOMPI_TPU_INGEST", None)
        model.cleanup()
    path = os.path.join(run_dir, "postmortem_rank0.json")
    if raised is None or not os.path.exists(path):
        raise AssertionError(f"phase 23 (d): raised {raised!r}, "
                             f"postmortem {os.path.exists(path)}")
    with open(path) as f:
        pm = json.load(f)
    if pm["exception"]["type"] != "FaultInjected":
        raise AssertionError(f"phase 23 (d): postmortem {pm['exception']}")
    return {"exception": pm["exception"]["type"],
            "message": pm["exception"]["message"],
            "recent_step_ms": pm.get("recent_step_ms"),
            "open_spans": [sp["name"] for sp in pm["open_spans"]],
            "metrics": len(pm.get("metrics", []))}


def p23_fleet_records(run_dir: str) -> dict:
    """Phase 23 (b)'s reading of ``fleet.jsonl``: spans by role (the
    exporter's suffix without a trailing pid: ``rank0``,
    ``ingest_reader<i>``, ``ingest_coord``), the traces that link the
    trainer with each reader and with the coordinator, each reader's
    ``rpc_handle`` spans whose parent is one of the trainer's
    ``ingest_request`` spans, and the orphans (spans whose parent is
    absent from the file)."""
    from theanompi_tpu_torch.monitor.collector import read_fleet

    recs = read_fleet(os.path.join(run_dir, "fleet.jsonl"))
    spans = [r for r in recs if r.get("event") == "span"]

    def role(r: dict) -> str:
        return re.sub(r"_\d+$", "", str(r.get("role")))

    roles: dict = {}
    for r in spans:
        roles[role(r)] = roles.get(role(r), 0) + 1
    ids = {r["span"] for r in spans}
    orphans = [r for r in spans if r.get("parent") not in (None, *ids)]
    by_trace: dict = {}
    for r in spans:
        by_trace.setdefault(r["trace"], []).append(r)

    def links(peer: str) -> int:
        return sum(1 for t in by_trace.values()
                   if any(role(x) == "rank0" for x in t)
                   and any(role(x) == peer for x in t))

    readers = [f"ingest_reader{i}" for i in range(P23_READERS)]
    pulls = {r["span"] for r in spans if r["name"] == "ingest_request"
             and role(r) == "rank0"}
    served = {name: 0 for name in readers}
    for r in spans:
        if r["name"] == "rpc_handle" and r.get("parent") in pulls:
            served[role(r)] = served.get(role(r), 0) + 1
    return {"records": len(recs), "spans": len(spans), "roles": roles,
            "orphans": len(orphans), "traces": len(by_trace),
            "linked_reader_traces": {name: links(name) for name in readers},
            "linked_coordinator_traces": links("ingest_coord"),
            "ingest_requests": len(pulls), "served_pulls": served,
            "metrics_events": sum(1 for r in recs
                                  if r.get("event") == "metrics")}


def _metric_value(path: str, name: str, **labels) -> float:
    """The value of one series in a ``metrics_<suffix>.jsonl`` snapshot
    (0 when the file lacks it)."""
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec["name"] == name and rec["labels"] == labels:
                return rec["value"]
    return 0


def ingest_phase(torch, workdir: str, data_dir: str) -> dict:
    """Phase 23: (a) in-process steps fed by the local loader and by a
    two-reader fleet, in the order local, ingest, ingest, local, all
    bit-identical, the fleet's batches out of band over the shm lane;
    (b) ``launcher BSP -D 1 --ingest --collector --monitor-dir`` from
    the same fleet, one fleet.jsonl, its batches over the shm lane too;
    (c) fenced spans against CUDA events; (d) an ``ingest_pull``
    fault's postmortem.  The shm lane is at its default (on) for the
    whole phase, as a user of ``--ingest`` gets it."""
    from theanompi_tpu_torch.ingest.fleet import IngestProcessGroup
    from theanompi_tpu_torch.models.resnet50 import ResNet50
    from theanompi_tpu_torch.monitor import trace
    from theanompi_tpu_torch.monitor.collector import CollectorProcess

    t_phase = time.monotonic()
    run_dir = os.path.join(workdir, "p23_monitor")
    seed = ResNet50.default_config().seed
    # the fleet's own collector, started first so every reader and the
    # coordinator ship to it; the launcher's --collector writes the same
    # fleet.jsonl (a fleet started before a run cannot know the run's)
    saved = {k: os.environ.get(k) for k in (
        trace.ENV_VAR, trace.COLLECTOR_ENV_VAR, "THEANOMPI_TPU_MONITOR",
        "THEANOMPI_TPU_SERVICE_KEY", "THEANOMPI_TPU_WIRE_SHM")}
    os.environ.setdefault("THEANOMPI_TPU_SERVICE_KEY", "chip-smoke-p23")
    os.environ.pop("THEANOMPI_TPU_WIRE_SHM", None)
    fleet_collector = fleet = None
    try:
        fleet_collector = CollectorProcess(run_dir)
        os.environ[trace.ENV_VAR] = "1"
        os.environ["THEANOMPI_TPU_MONITOR"] = run_dir
        t0 = time.monotonic()
        fleet = IngestProcessGroup(P23_READERS, data_dir, seed=seed)
        start_s = time.monotonic() - t0
        # this process's own runs do not ship: (a)-(d) measure the steps
        for k in (trace.ENV_VAR, trace.COLLECTOR_ENV_VAR,
                  "THEANOMPI_TPU_MONITOR"):
            os.environ.pop(k, None)
        log(f"  (fleet) {P23_READERS} readers and a coordinator up in "
            f"{start_s:.1f} s: --ingest {fleet.ingest_addr}")
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            # ABBA: a drift over the four runs weighs on both feeds alike
            runs = []
            for k, label in enumerate(("local", "ingest", "ingest",
                                       "local")):
                run = p23_steps(
                    torch, data_dir,
                    fleet.ingest_addr if label == "ingest" else None,
                    os.path.join(workdir, f"p23_a{k}"))
                runs.append((label, run))
                torch.cuda.empty_cache()
        finally:
            torch.backends.cudnn.deterministic = deterministic
        local = [r for label, r in runs if label == "local"]
        remote = [r for label, r in runs if label == "ingest"]
        log(f"  (a) {P23_STEPS} steps a run, in the order "
            f"{[label for label, _ in runs]}: "
            f"{[round(r['ms_per_step'], 2) for _, r in runs]} ms a step "
            f"(host wall, steps 2-{P23_STEPS}); launches "
            f"{remote[0]['launches']}; shm lane bytes received "
            f"{[r['oob_recv_bytes'] for _, r in runs]}")
        ref = local[0]
        for label, r in runs:
            if (r["digests"] != ref["digests"]
                    or len(r["digests"]) != P23_STEPS
                    or r["state_digest"] != ref["state_digest"]
                    or r["losses"] != ref["losses"]
                    or r["source"] != ("remote" if label == "ingest"
                                       else "local")):
                raise AssertionError(f"phase 23 (a): {label} {r} != local "
                                     f"{ref}")
        # every ingest-fed batch's images came over the lane, out of band
        lane_short = [r["oob_recv_bytes"] for r in remote
                      if r["oob_recv_bytes"] < sum(r["image_bytes"])]
        if lane_short or any(r["oob_recv_bytes"] for r in local):
            raise AssertionError(
                f"phase 23 (a): shm lane bytes received "
                f"{[r['oob_recv_bytes'] for _, r in runs]} against "
                f"{sum(ref['image_bytes'])} image bytes a run")
        log(f"  (a) {P23_STEPS} batch digests, losses and the state digest "
            f"{ref['state_digest'][:16]} equal over the four runs; each "
            f"ingest run received >= {sum(ref['image_bytes'])} bytes "
            "over the shm lane")

        # (b) runs beside (c) and (d), which time nothing against it
        launched: dict = {}

        def launch() -> None:
            try:
                launched.update(ckpt_runs(workdir, data_dir, {
                    "p23-launcher": (
                        "p23snap", ["--epochs", "1", "--ingest",
                                    fleet.ingest_addr, "--collector",
                                    "--monitor-dir", run_dir],
                        ("theanompi_tpu_torch.models.resnet50",
                         "ResNet50"), None)}))
            except BaseException as e:  # raised after the join below
                launched["error"] = e

        launcher_thread = threading.Thread(target=launch, daemon=True,
                                           name="p23-launcher")
        launcher_thread.start()
        config = dataclasses.replace(
            ResNet50.default_config(), batch_size=TRAIN_BATCH, n_epochs=1,
            print_freq=1, data_dir=data_dir,
            snapshot_dir=os.path.join(workdir, "p23_snap"))
        model = ResNet50(config=config, device="cuda")
        try:
            spans = p23_spans(torch, model, workdir)
            log(f"  (c) fenced bsp/step "
                f"{[round(v, 2) for v in spans['fenced_ms']]} ms >= its "
                f"CUDA events {[round(v, 2) for v in spans['event_ms']]}; "
                f"unfenced bsp/enqueue "
                f"{[round(v, 2) for v in spans['unfenced_ms']]} against "
                f"{[round(v, 2) for v in spans['event_ms_unfenced']]} "
                "(beside (b))")
            fault = p23_fault(model, fleet.ingest_addr, workdir)
        finally:
            model.cleanup()
            del model
        log(f"  (d) ingest_pull fault at index {P23_FAULT_INDEX}: "
            f"{fault['exception']} ({fault['message']}), postmortem with "
            f"{len(fault['recent_step_ms'] or [])} recent steps, open spans "
            f"{fault['open_spans']}, {fault['metrics']} series")
        launcher_thread.join()
        if "error" in launched:
            raise launched["error"]
        res = launched["p23-launcher"]
        (rec,) = res["records"]
        want_train = {k: v * CKPT_STEPS for k, v in TRAIN_LAUNCHES.items()}
        want_val = {k: v * CKPT_VAL_BATCHES
                    for k, v in RESNET_VAL_LAUNCHES.items()}
        if (rec["train_steps"] != CKPT_STEPS
                or not _exact_launches(rec["launches"]["train"], want_train)
                or not _exact_launches(rec["launches"]["val"], want_val)):
            raise AssertionError(f"phase 23 (b): steps {rec['train_steps']}"
                                 f", launches {rec['launches']} (want "
                                 f"{want_train}, {want_val})")
        files = sorted(os.listdir(run_dir))
        missing = [f for f in ("metrics_rank0.jsonl", "metrics_rank0.prom",
                               "heartbeat_rank0.json", "fleet.jsonl")
                   if f not in files]
        fleet_view = p23_fleet_records(run_dir)
        lane_b = (0 if missing else _metric_value(
            os.path.join(run_dir, "metrics_rank0.jsonl"),
            "shm/oob_bytes_total", dir="recv"))
        log(f"  (b) launcher: {rec['train_steps']} steps + "
            f"{rec['val_batches']} validation batches, train_s "
            f"{rec['train_s']:.2f}, launches exact; shm lane bytes "
            f"received {lane_b}; fleet.jsonl {fleet_view}")
        readers = fleet_view["served_pulls"]
        if (missing or fleet_view["orphans"]
                or not {"rank0", "ingest_coord", *readers}
                <= set(fleet_view["roles"])
                or not all(fleet_view["linked_reader_traces"].values())
                or not all(readers.values())
                or sum(readers.values()) < CKPT_STEPS
                or not fleet_view["linked_coordinator_traces"]
                or lane_b < CKPT_STEPS * ref["image_bytes"][0]):
            raise AssertionError(f"phase 23 (b): files {files}, shm lane "
                                 f"bytes {lane_b}, {fleet_view}")
    finally:
        if fleet is not None:
            fleet.stop()
        if fleet_collector is not None:
            fleet_collector.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    seconds = time.monotonic() - t_phase
    log(f"  phase 23: {seconds:.1f} s")
    return {"order": [label for label, _ in runs],
            "ms_per_step": [r["ms_per_step"] for _, r in runs],
            "local": local, "ingest": remote, "launcher": {
        "train_steps": rec["train_steps"], "val_batches": rec["val_batches"],
        "train_s": rec["train_s"], "launches": rec["launches"],
        "wall_s": res["wall_s"], "oob_recv_bytes": lane_b},
        "fleet": fleet_view, "spans": spans,
        "fault": fault, "fleet_start_s": start_s, "seconds": seconds}


# -- phase 24: the LM family's parallel variants ---------------------------

#: phase 24 (a): sequence_attention's shape (B, T, H, D), bf16, causal
P24_ATTN = (8, 1024, 12, 64)
#: (b): checked f32 steps of TP and PP against DP, and their limits
#: (the loss relative to DP's; the flattened gradient's relative L2)
P24_STEPS = 3
P24_LIMITS = {"loss_rel": 1e-5, "grad_rel_l2": 1e-4}
#: PP's microbatches (one stage)
P24_MICRO = 4
#: (c): the MoE cut to P24_MOE_LAYERS layers at full width, 8 experts,
#: one step of P24_MOE_TOKENS on the card and on the CPU, both f32.  A
#: CPU step replayed on the card's routes and ReLU gates is held to
#: (b)'s P24_LIMITS, and so is the CPU's step on its own decisions where
#: none flipped; where one did (a pre-activation within rounding of 0
#: moves a whole token's gradient), that step is held to P24_MOE_LIMITS
P24_MOE_LAYERS, P24_MOE_TOKENS = 2, (2, 1024)
P24_MOE_LIMITS = {"loss_rel": 1e-4, "grad_rel_l2": 1e-3}
#: (e): timed bf16 steps of each variant (after one untimed)
P24_TIMED = 3
_K4 = ("attention", "attention_bwd_dq", "attention_bwd_dkdv")
#: K4 launches per training step of each variant at 12 layers
P24_LAUNCHES = {"dp": (12, 12, 12), "tp": (12, 12, 12),
                "pp": (12 * P24_MICRO * 2, 12 * P24_MICRO, 12 * P24_MICRO),
                "moe": (12, 12, 12), "remat": (24, 12, 12)}


def _k4_counts(counts: dict) -> tuple:
    return tuple(counts.get(k, 0) for k in _K4)


def p24_attention(torch, mesh) -> dict:
    """(a) Each strategy on the (one-rank) seq group at ``P24_ATTN``,
    forward and backward: K4 launches (all-gather and Ulysses 1 + 1 + 1,
    ring none), and the output and gradients against the plain twins of
    K4 (``ops/attention.tolerance_excess`` at most 1; ring against the
    f32 plain path)."""
    from theanompi_tpu_torch.ops import _kernels
    from theanompi_tpu_torch.ops.attention import (
        attention_bwd_plain,
        attention_fwd_plain,
        tolerance_excess,
    )
    from theanompi_tpu_torch.parallel.sequence import (
        STRATEGIES,
        attention_reference,
        sequence_attention,
    )

    b, t, h, d = P24_ATTN
    gen = torch.Generator(device="cuda").manual_seed(24)
    q, k, v, g = (torch.randn((b, t, h, d), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    pos = torch.arange(t, device="cuda", dtype=torch.int32)
    scale = d ** -0.5
    seq = mesh.axis("seq")
    out = {}
    for name in STRATEGIES:
        f32 = name == "ring"
        ins = tuple(x.float() for x in (q, k, v)) if f32 else (q, k, v)
        want_o, lse = attention_fwd_plain(*ins, pos, pos, scale, True)
        want = attention_bwd_plain(*ins, pos, pos, lse,
                                   g.float() if f32 else g, scale, True)
        for _ in range(2):   # the second call is counted and timed
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            o = sequence_attention(*leaves, seq, causal=True, strategy=name)
            o.backward(g)
            e1.record()
            torch.cuda.synchronize()
        launches = _k4_counts(_kernels.launch_counts())
        excess = {"o": tolerance_excess("o", o.detach(), want_o,
                                        (q, k, v, pos, pos, scale, True))}
        for n, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
            excess[n] = tolerance_excess(n, leaf.grad, w)
        ref = attention_reference(q, k, v, causal=True)
        out[name] = {"launches": launches, "excess": excess,
                     "ms_fwd_bwd": e0.elapsed_time(e1),
                     "rel_l2_vs_reference": rel_l2(torch, o.detach().float(),
                                                   ref.float())}
        log(f"  {name}: K4 launches {launches}, tolerance excess "
            + ", ".join(f"{n} {x:.3g}" for n, x in excess.items())
            + f"; {out[name]['ms_fwd_bwd']:.2f} ms fwd+bwd; rel L2 vs "
            f"attention_reference {out[name]['rel_l2_vs_reference']:.3g}")
        want_l = (0, 0, 0) if f32 else (1, 1, 1)
        if launches != want_l or max(excess.values()) > 1:
            raise AssertionError(f"phase 24 (a) {name}: launches "
                                 f"{launches} != {want_l} or excess "
                                 f"{excess} over 1")
        del o, leaves, ref, want, want_o, lse
        torch.cuda.empty_cache()
    return out


def p24_config(dtype: str = "bfloat16", **kw):
    """The variants' recipe: bench_lm's (``lm_model``), print-free."""
    from theanompi_tpu_torch.models.base import ModelConfig

    base = dict(batch_size=LM_BATCH, n_epochs=1, optimizer="adamw",
                learning_rate=1e-3, weight_decay=0.01,
                lr_schedule="constant", compute_dtype=dtype, print_freq=0)
    base.update(kw)
    return ModelConfig(**base)


def p24_model(torch, kind: str, mesh, dtype: str = "bfloat16",
              dims=None, data=None, **cfg):
    """One variant at ``LM_DIMS`` (``dims`` overrides): 'dp' (no mesh),
    'remat', 'tp', 'pp' (``P24_MICRO`` microbatches) or 'moe' (8
    experts)."""
    from theanompi_tpu_torch.models import transformer as T

    dims = dict(LM_DIMS, **(dims or {}))
    if kind == "remat":
        cfg["remat"] = True
    cls = {"dp": T.TransformerLM, "remat": T.TransformerLM,
           "tp": T.TransformerLM_TP, "pp": T.TransformerLM_PP,
           "moe": T.TransformerLM_MoE}[kind]
    extra = ({"n_microbatches": P24_MICRO} if kind == "pp" else
             {"n_experts": 8} if kind == "moe" else {})
    return cls(config=p24_config(dtype, **cfg), device="cuda", data=data,
               mesh=None if kind in ("dp", "remat") else mesh, **dims,
               **extra)


def p24_batches(torch, n: int, rows: int, seed: int = 24):
    from theanompi_tpu_torch.data.lm import SeqLM_data

    data = SeqLM_data(vocab=LM_DIMS["vocab"], seq_len=LM_DIMS["seq_len"],
                      n_train=n * rows, n_val=rows, seed=seed)
    return data, [tuple(torch.from_numpy(x).cuda() for x in bt)
                  for bt in data.train_batches(0, rows)]


def _grads(model) -> dict:
    return {n: p.grad.detach().float().reshape(-1).clone()
            for n, p in model.module.named_parameters()}


def p24_vs_dp(torch, mesh) -> dict:
    """(b) TP (tp 1) and PP (one stage, ``P24_MICRO`` microbatches) from
    the DP model's weights, f32, ``P24_STEPS`` SGD steps on the same
    batches: each step's loss within ``P24_LIMITS['loss_rel']`` of DP's,
    the first step's flattened gradient within ``grad_rel_l2``, and K4's
    launches per step exactly ``P24_LAUNCHES``."""
    from theanompi_tpu_torch.models.bridge import pipeline_state_dict_from_lm
    from theanompi_tpu_torch.ops import _kernels

    data, batches = p24_batches(torch, P24_STEPS, LM_BATCH)
    cfg = dict(optimizer="sgd", learning_rate=1e-2, weight_decay=0.0)
    dp = p24_model(torch, "dp", mesh, "float32", data=data, **cfg)
    whole = {k: v.detach().clone() for k, v in dp.module.state_dict().items()}
    runs = {}
    for kind in ("dp", "tp", "pp"):
        model = dp if kind == "dp" else p24_model(torch, kind, mesh,
                                                  "float32", data=data, **cfg)
        if kind == "tp":
            model.load_whole_state_dict(whole)
        elif kind == "pp":
            model.load_whole_state_dict(pipeline_state_dict_from_lm(
                whole, LM_DIMS["seq_len"]))
        model.compile_iter_fns()
        losses, first, per_step = [], None, []
        for batch in batches:
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            losses.append(float(model.train_step(model.state, batch,
                                                 None)["loss"]))
            per_step.append(_k4_counts(_kernels.launch_counts()))
            if first is None:
                first = _grads(model)
        if kind == "pp":
            back = {"embed.embedding": "Embed_0.embedding",
                    "ln_f.scale": "LayerNorm_0.scale",
                    "ln_f.bias": "LayerNorm_0.bias",
                    "head.weight": "Dense_0.weight",
                    "head.bias": "Dense_0.bias"}
            first = {back.get(n, n): g for n, g in first.items()}
            pe = first["pos_emb"]
            first["pos_emb"] = torch.cat([pe, torch.zeros(
                runs["dp"]["grads"]["pos_emb"].numel() - pe.numel(),
                device=pe.device)])
        runs[kind] = {"losses": losses, "grads": first,
                      "launches_per_step": per_step}
        del model
        gc.collect()
        torch.cuda.empty_cache()
    out = {"limits": P24_LIMITS, "steps": P24_STEPS}
    ref = runs["dp"]
    for kind in ("tp", "pp"):
        r = runs[kind]
        names = list(ref["grads"])
        g = torch.cat([r["grads"][n] for n in names])
        g0 = torch.cat([ref["grads"][n] for n in names])
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                          ref["losses"]))
        out[kind] = {"losses": r["losses"], "loss_rel": loss_rel,
                     "grad_rel_l2": rel_l2(torch, g, g0),
                     "launches_per_step": r["launches_per_step"]}
        log(f"  {kind} vs dp (f32, {P24_STEPS} steps): losses "
            f"{[round(x, 6) for x in r['losses']]} vs "
            f"{[round(x, 6) for x in ref['losses']]}, loss rel "
            f"{loss_rel:.3g}, gradient rel L2 {out[kind]['grad_rel_l2']:.3g};"
            f" K4 launches per step {r['launches_per_step']}")
        want = [P24_LAUNCHES[kind]] * P24_STEPS
        if (loss_rel > P24_LIMITS["loss_rel"]
                or not out[kind]["grad_rel_l2"] <= P24_LIMITS["grad_rel_l2"]
                or r["launches_per_step"] != want):
            raise AssertionError(f"phase 24 (b) {kind}: {out[kind]} over "
                                 f"{P24_LIMITS} or launches != {want}")
    out["dp"] = {"losses": ref["losses"],
                 "launches_per_step": ref["launches_per_step"]}
    return out


class _DecisionTap:
    """Stands in for parallel/expert.py's ``top1_dispatch`` and
    ``apply_experts`` while entered, to record the MoE's discrete
    decisions: each layer's routes (every token's first-max expert), the
    tokens that fit their expert's capacity, and the experts' ReLU gates
    (pre-activation > 0).  Recording calls the port's own functions.
    Given ``replay`` (another run's tap) it takes that run's routes and
    gates instead, with the port's arithmetic otherwise (the
    probabilities, queue positions, capacity drop and aux loss of
    ``top1_dispatch``; the experts' products)."""

    def __init__(self, torch, replay=None):
        from theanompi_tpu_torch.parallel import expert

        self.torch, self.expert, self.replay = torch, expert, replay
        self.routes, self.kept, self.gates = [], [], []

    def __enter__(self):
        self.real = (self.expert.top1_dispatch, self.expert.apply_experts)
        self.expert.top1_dispatch = self.dispatch
        self.expert.apply_experts = self.experts
        return self

    def __exit__(self, *exc):
        self.expert.top1_dispatch, self.expert.apply_experts = self.real

    def dispatch(self, router_logits, capacity):
        torch = self.torch
        F = torch.nn.functional
        probs = torch.softmax(router_logits.float(), dim=-1)
        idx = probs.max(dim=-1).indices
        if self.replay is None:
            out = self.real[0](router_logits, capacity)
        else:
            idx = self.replay.routes[len(self.routes)].to(idx.device)
            e = probs.shape[1]
            onehot = F.one_hot(idx, e).to(torch.int32)
            pos = (torch.cumsum(onehot, dim=0, dtype=torch.int32) * onehot
                   - 1).amax(dim=-1)
            keep = pos < capacity
            aux = e * torch.sum(onehot.float().mean(dim=0)
                                * probs.mean(dim=0))
            slot = torch.where(keep, pos, torch.zeros_like(pos))
            dispatch = (onehot.float()[:, :, None]
                        * F.one_hot(slot.long(), capacity).float()[:, None]
                        * keep.float()[:, None, None])
            combine = dispatch * probs.gather(1, idx[:, None])[:, :, None]
            out = dispatch.permute(1, 2, 0), combine, aux
        self.routes.append(idx.detach().cpu())
        self.kept.append(int(out[0].sum()))
        return out

    def experts(self, p, tok):
        pre = self.torch.bmm(tok, p["up_kernel"]) + p["up_bias"][:, None]
        if self.replay is None:
            self.gates.append((pre > 0).cpu())
            return self.real[1](p, tok)
        gate = self.replay.gates[len(self.gates)]
        self.gates.append(gate)
        h = pre * gate.to(pre.device, pre.dtype)
        return self.torch.bmm(h, p["down_kernel"]) + p["down_bias"][:, None]


def p24_moe_vs_cpu(torch, mesh) -> dict:
    """(c) The MoE cut to ``P24_MOE_LAYERS`` layers at full width, f32,
    one step on ``P24_MOE_TOKENS`` from the same seeded weights on the
    card, on the CPU, and on the CPU replaying the card's routes and ReLU
    gates (``_DecisionTap``): the routes and gates that flipped between
    card and CPU and the tokens each layer kept; the replayed step's loss
    and flattened gradient within ``P24_LIMITS`` of the card's, and the
    CPU's own step within them too unless a decision flipped, then within
    ``P24_MOE_LIMITS``."""
    from theanompi_tpu_torch.data.lm import SeqLM_data
    from theanompi_tpu_torch.models.transformer import TransformerLM_MoE

    n, t = P24_MOE_TOKENS
    data = SeqLM_data(vocab=LM_DIMS["vocab"], seq_len=t, n_train=n,
                      n_val=n, seed=25)
    tokens, targets = next(iter(data.train_batches(0, n)))
    steps, taps = {}, {}
    for run, dev in (("card", "cuda"), ("cpu", "cpu"),
                     ("replayed", "cpu")):
        t0 = time.monotonic()
        model = TransformerLM_MoE(
            config=p24_config("float32", batch_size=n, optimizer="sgd",
                              learning_rate=1e-2, weight_decay=0.0),
            device=dev, data=data, n_experts=8, mesh=mesh,
            **dict(LM_DIMS, n_layers=P24_MOE_LAYERS, seq_len=t))
        model.compile_iter_fns()
        with _DecisionTap(torch, taps.get("card") if run == "replayed"
                          else None) as taps[run]:
            m = model.train_step(model.state, (
                torch.from_numpy(tokens).to(dev),
                torch.from_numpy(targets).to(dev)), None)
        steps[run] = {"loss": float(m["loss"]), "aux": float(m["aux"]),
                      "grads": torch.cat([p.grad.float().reshape(-1).cpu()
                                          for p in model.module.parameters()]),
                      "s": time.monotonic() - t0}
        del model
        gc.collect()
    card = steps["card"]

    def flipped(what: str) -> list:
        return [int((a != b).sum()) for a, b in zip(
            getattr(taps["card"], what), getattr(taps["cpu"], what))]

    r = {"layers": P24_MOE_LAYERS, "tokens": [n, t],
         "loss_card": card["loss"], "aux_card": card["aux"],
         "kept_card": taps["card"].kept,
         "flipped_routes": flipped("routes"),
         "flipped_gates": flipped("gates"),
         "gates_per_layer": [g.numel() for g in taps["card"].gates]}
    for run in ("cpu", "replayed"):
        s = steps[run]
        r[run] = {"loss": s["loss"], "aux": s["aux"], "kept": taps[run].kept,
                  "loss_rel": abs(s["loss"] - card["loss"]) / abs(s["loss"]),
                  "grad_rel_l2": rel_l2(torch, card["grads"], s["grads"]),
                  "limits": P24_LIMITS, "s": s["s"]}
    if any(r["flipped_routes"]) or any(r["flipped_gates"]):
        r["cpu"]["limits"] = P24_MOE_LIMITS
    log(f"  MoE cut to {P24_MOE_LAYERS} layers (full width, 8 experts), "
        f"{n}x{t} tokens, f32: flipped card vs CPU per layer: routes "
        f"{r['flipped_routes']}, ReLU gates {r['flipped_gates']} of "
        f"{r['gates_per_layer']}; tokens kept card {r['kept_card']} CPU "
        f"{r['cpu']['kept']}")
    for run in ("cpu", "replayed"):
        x = r[run]
        log(f"    {run:8s}: loss card {card['loss']:.6f} cpu "
            f"{x['loss']:.6f} (rel {x['loss_rel']:.3g}), aux "
            f"{card['aux']:.6f}/{x['aux']:.6f}, gradient rel L2 "
            f"{x['grad_rel_l2']:.3g} (limits {x['limits']}; cpu step "
            f"{x['s']:.1f} s)")
        if not (x["loss_rel"] <= x["limits"]["loss_rel"]
                and x["grad_rel_l2"] <= x["limits"]["grad_rel_l2"]):
            raise AssertionError(f"phase 24 (c) {run}: {x}")
    if r["replayed"]["kept"] != r["kept_card"]:
        raise AssertionError(f"phase 24 (c): the replayed step kept "
                             f"{r['replayed']['kept']} tokens, the card "
                             f"{r['kept_card']}")
    return r


def p24_remat(torch) -> dict:
    """(d) The DP model with and without ``remat`` from the same weights,
    bf16, one step on the same batch: every gradient and every updated
    parameter bit for bit."""
    from theanompi_tpu_torch.ops import _kernels

    data, (batch,) = p24_batches(torch, 1, LM_BATCH, seed=26)
    out, seen = {}, {}
    for kind in ("dp", "remat"):
        model = p24_model(torch, kind, None, data=data)
        model.compile_iter_fns()
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        loss = float(model.train_step(model.state, batch, None)["loss"])
        out[kind] = {"loss": loss,
                     "launches": _k4_counts(_kernels.launch_counts())}
        seen[kind] = ({n: p.grad.clone() for n, p in
                       model.module.named_parameters()},
                      {n: p.detach().clone() for n, p in
                       model.module.named_parameters()})
        del model
        gc.collect()
    (g0, p0), (g1, p1) = seen["dp"], seen["remat"]
    differ = [n for n in g0 if not (torch.equal(g0[n], g1[n])
                                    and torch.equal(p0[n], p1[n]))]
    out["same_bits"] = not differ and out["dp"]["loss"] == out["remat"]["loss"]
    out["differ"] = differ[:8]
    log(f"  remat vs plain (bf16, one step): loss {out['dp']['loss']:.6f} / "
        f"{out['remat']['loss']:.6f}, gradients and parameters bit for bit "
        f"{out['same_bits']} ({len(differ)} of {len(g0)} tensors differ); "
        f"K4 launches {out['dp']['launches']} / {out['remat']['launches']}")
    if not out["same_bits"] or (out["remat"]["launches"], out["dp"][
            "launches"]) != (P24_LAUNCHES["remat"], P24_LAUNCHES["dp"]):
        raise AssertionError(f"phase 24 (d): {out}")
    del seen
    torch.cuda.empty_cache()
    return out


def p24_timing(torch, mesh) -> dict:
    """(e) Each variant at the recipe (bf16, batch 8, AdamW): ms a step
    over ``P24_TIMED`` steps after one untimed, the peak memory of those
    steps, and K4's launches per step (exactly ``P24_LAUNCHES``)."""
    from theanompi_tpu_torch.ops import _kernels

    data, batches = p24_batches(torch, P24_TIMED + 1, LM_BATCH, seed=27)
    out = {}
    for kind in ("dp", "remat", "tp", "pp", "moe"):
        t0 = time.monotonic()
        model = p24_model(torch, kind, mesh, data=data)
        model.compile_iter_fns()
        model.train_step(model.state, batches[0], None)
        torch.cuda.synchronize()
        setup_s = time.monotonic() - t0
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t1 = time.monotonic()
        e0.record()
        losses = [model.train_step(model.state, b, None)["loss"]
                  for b in batches[1:]]
        e1.record()
        torch.cuda.synchronize()
        host_ms = (time.monotonic() - t1) * 1e3 / P24_TIMED
        counts = _k4_counts(_kernels.launch_counts())
        per_step = tuple(c // P24_TIMED for c in counts)
        losses = [float(x) for x in losses]
        out[kind] = {"ms_per_step": e0.elapsed_time(e1) / P24_TIMED,
                     "host_ms_per_step": host_ms,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "launches_per_step": per_step, "losses": losses,
                     "setup_s": setup_s}
        log(f"  {kind}: {out[kind]['ms_per_step']:.2f} ms a step (event), "
            f"{host_ms:.2f} host, peak {out[kind]['peak_gib']:.2f} GiB, K4 "
            f"launches per step {per_step}, losses "
            f"{[round(x, 4) for x in losses]} (set-up {setup_s:.1f} s)")
        if (counts != tuple(c * P24_TIMED for c in P24_LAUNCHES[kind])
                or not all(math.isfinite(x) for x in losses)):
            raise AssertionError(f"phase 24 (e) {kind}: launches {counts} "
                                 f"over {P24_TIMED} steps != "
                                 f"{P24_LAUNCHES[kind]} each, or losses "
                                 f"{losses}")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def lm_variants_phase(torch) -> dict:
    """Phase 24 on a one-rank NCCL group: (a) the SP strategies, (b) TP
    and PP against DP, (c) the MoE against the CPU, (d) remat, (e) ms a
    step and peak memory of each variant.  Every axis of the mesh has
    degree 1: no collective of the mesh is issued."""
    import torch.distributed as dist

    from theanompi_tpu_torch.parallel.mesh import MeshSpec, make_training_mesh

    out = {}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_training_mesh(MeshSpec())
        for part, label, fn, args in (
                ("a", "attention", p24_attention, (mesh,)),
                ("b", "vs_dp", p24_vs_dp, (mesh,)),
                ("c", "moe_vs_cpu", p24_moe_vs_cpu, (mesh,)),
                ("d", "remat", p24_remat, ()),
                ("e", "timing", p24_timing, (mesh,))):
            t0 = time.monotonic()
            log(f"  phase 24 ({part}) {label}")
            out[label] = fn(torch, *args)
            out[label + "_s"] = time.monotonic() - t0
    finally:
        dist.destroy_process_group()
    return out


# -- phase 25: the TCP front, quantized exports and autoregressive decode ----

#: (b) the 8 concurrent streams: prompt lengths spanning the default
#: prefill buckets (8 .. 512; 200 and above overflow the 128-token window
#: at prefill) and staggered lengths to generate (24 .. 136: the
#: 100-token prompt decodes past the window, and the decode batch walks
#: buckets 8, 4, 2 and 1 as the streams end)
P25_PROMPT_LENS = (5, 12, 24, 50, 100, 200, 300, 500)
P25_MAX_NEW = tuple(24 + 16 * i for i in range(8))
#: a greedy token that differs from the oracle's is a tie only where
#: the oracle's top-2 margin is below this
P25_TIE = 1e-4
P25_SPEC_K = 4
P25_DRAFT_LAYERS = 2
P25_INFER_REPS = 5
#: (a) bf16 and int8 ResNet-50 exports against the f32 export, batch 32
#: of the seeded weights (max |logit difference|, least top-1
#: agreement): about 10x what an H100 read (0.0046 and 0.14, top-1 1.0;
#: PERF.md)
P25_QUANT_LIMITS = {"bf16": (0.05, 0.9), "int8": (1.5, 0.9)}


class Served:
    """An ``InferenceServer`` behind ``serve()`` on a loopback port, with
    the clients it hands out (phase 25); ``close`` shuts all of them."""

    def __init__(self, server):
        from theanompi_tpu_torch.serving import serve as serve_tcp

        self.server = server
        self.port = free_port()
        self.ready, self.stop = threading.Event(), threading.Event()
        self.thread = threading.Thread(
            target=serve_tcp, daemon=True, name=f"p25-serve-{self.port}",
            args=(server, "127.0.0.1", self.port, self.ready, self.stop))
        self.thread.start()
        if not self.ready.wait(60):
            raise AssertionError("serve() did not come up in 60 s")
        self.clients = []

    def client(self):
        from theanompi_tpu_torch.serving import InferenceClient

        c = InferenceClient(f"127.0.0.1:{self.port}")
        self.clients.append(c)
        return c

    def close(self) -> None:
        self.stop.set()
        for c in self.clients:
            c.close()
        self.thread.join(10)
        self.server.stop()


def p25_resnet(torch, workdir: str) -> dict:
    """(a) ResNet-50 exported f32, bf16 and int8, each served over TCP and
    queried with ``InferenceClient.infer`` at batch 32."""
    from theanompi_tpu_torch.models.resnet50 import ResNet50
    from theanompi_tpu_torch.ops import _kernels
    from theanompi_tpu_torch.parallel.service import ServiceError
    from theanompi_tpu_torch.resilience import faults
    from theanompi_tpu_torch.serving import (
        BatchPolicy,
        InferenceServer,
        export_model,
    )

    model = ResNet50(device="cuda")
    ref = ResNet50(device="cpu", config=dataclasses.replace(
        model.config, compute_dtype="float32"))
    seeded_weights(torch, ref, seed=0)
    model.module.load_state_dict(ref.module.state_dict())
    del ref
    x = np.random.default_rng(25).integers(0, 256, (BATCH, 224, 224, 3),
                                           dtype=np.uint8)
    out, f32 = {}, None
    for wd in ("f32", "bf16", "int8"):
        d = os.path.join(workdir, f"resnet50_{wd}")
        export_model(model, d, version=0, weight_dtype=wd)
        srv = Served(InferenceServer(
            d, device="cuda", reload_poll_s=0,
            policy=BatchPolicy(max_batch=BATCH, max_delay_ms=5.0,
                               max_queue=64)).start())
        try:
            c = srv.client()
            c.infer(x)
            b0 = srv.server.stats()["batches"]
            _kernels.reset_launch_counts()
            lat = []
            for _ in range(P25_INFER_REPS):
                t = time.monotonic()
                got = c.infer(x)
                lat.append((time.monotonic() - t) * 1e3)
            launches = _kernels.launch_counts()
            batches = srv.server.stats()["batches"] - b0
            want = {k: 0 for k in launches}
            want.update(scale_bias_act=37 * batches,
                        scale_bias_act_res=16 * batches,
                        maxpool3x3s2=batches)
            if batches != P25_INFER_REPS or launches != want:
                raise AssertionError(f"{wd}: {batches} batches, launches "
                                     f"{launches} != {want}")
            if got.shape != (BATCH, 1000) or not np.isfinite(got).all():
                raise AssertionError(f"{wd}: logits {got.shape} not finite")
            rec = {"infer_ms": lat, "infer_ms_median": float(np.median(lat)),
                   "launches_per_batch": {k: v // batches
                                          for k, v in launches.items() if v}}
            if wd == "f32":
                local = srv.server.submit(x)
                if not np.array_equal(got, local):
                    raise AssertionError("f32 over TCP is not bit-identical "
                                         "to the in-process submit")
                f32 = got
                export_model(model, d, version=1)
                if c.reload() != 1 or not np.array_equal(c.infer(x), local):
                    raise AssertionError("reload to v1 failed")
                faults.install([{"site": "serve_rpc", "op": "infer",
                                 "nth": 1}])
                try:
                    c.infer(x)
                    raise AssertionError("the serve_rpc fault did not fire")
                except ServiceError as e:
                    if "FaultInjected" not in str(e):
                        raise
                finally:
                    faults.clear()
                if not np.array_equal(c.infer(x), local):
                    raise AssertionError("the client did not survive the "
                                         "serve_rpc fault")
                rec.update(bit_identical=True, reloaded_to=1,
                           fault_survived=True)
            else:
                max_abs = float(np.abs(got - f32).max())
                top1 = float((got.argmax(1) == f32.argmax(1)).mean())
                rec.update(max_abs_vs_f32=max_abs, top1_vs_f32=top1)
                lim_abs, lim_top1 = P25_QUANT_LIMITS[wd]
                if max_abs > lim_abs or top1 < lim_top1:
                    raise AssertionError(
                        f"{wd} export off f32: max |d logit| {max_abs:.4g} "
                        f"(<= {lim_abs}), top-1 {top1} (>= {lim_top1})")
        finally:
            srv.close()
        out[wd] = rec
        log(f"  (a) ResNet-50 {wd}: infer over TCP at batch {BATCH} "
            f"{rec['infer_ms_median']:.2f} ms (median of {P25_INFER_REPS}), "
            f"launches per batch {rec['launches_per_batch']}"
            + (f", max |d logit| vs f32 {rec['max_abs_vs_f32']:.4g}, top-1 "
               f"agreement {rec['top1_vs_f32']:.3f}" if wd != "f32" else
               ", bit-identical to submit, reload v1, serve_rpc fault "
               "survived"))
    del model
    torch.cuda.empty_cache()
    return out


def p25_streams(srv: Served, prompts, max_new) -> tuple[list, float]:
    """Every prompt as its own concurrent ``generate`` over TCP; the
    token lists and the wall seconds from the first start to the last
    answer."""
    clients = [srv.client() for _ in prompts]
    outs, errors = [None] * len(prompts), []

    def go(i):
        try:
            outs[i] = clients[i].generate(prompts[i], max_new[i]).tolist()
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=go, args=(i,), daemon=True)
               for i in range(len(prompts))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.monotonic() - t0
    if errors or any(o is None for o in outs):
        raise AssertionError(f"generate failed: {errors[:3]}")
    for o, n in zip(outs, max_new):
        if len(o) != n:
            raise AssertionError(f"a stream gave {len(o)} tokens, not {n}")
    return outs, wall


def p25_oracle(torch, net, prompt, tokens, window: int) -> dict:
    """The greedy tokens against the argmax of ``full_forward(window)`` of
    the card over the prompt and the tokens before each; a difference is
    a tie only where the oracle's top-2 margin is below ``P25_TIE``."""
    from theanompi_tpu_torch.decode.model import full_forward

    seq = torch.tensor(np.concatenate([prompt, tokens[:-1]]).astype(np.int64),
                       device="cuda")[None]
    with torch.no_grad():
        logits = full_forward(net, seq, window)[0][0, len(prompt) - 1:]
    top2 = logits.topk(2, dim=-1)
    pred = top2.indices[:, 0].cpu().numpy()
    margin = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
    diff = np.nonzero(pred != np.asarray(tokens))[0]
    ties = [(int(i), float(margin[i])) for i in diff]
    return {"differ": len(diff), "ties": ties,
            "ok": all(m < P25_TIE for _, m in ties),
            "min_margin": float(margin.min()),
            "margins": [float(m) for m in margin]}


def p25_first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def p25_lm(torch, workdir: str) -> dict:
    """(b)-(e) the LM at ``LM_DIMS`` (f32 compute) served with the
    launcher's ``--decode`` defaults."""
    from theanompi_tpu_torch import launcher
    from theanompi_tpu_torch.models.transformer import TransformerLM
    from theanompi_tpu_torch.ops import _kernels
    from theanompi_tpu_torch.serving import InferenceServer, export_model
    from theanompi_tpu_torch.serving.server import decode_opts_from_args
    from theanompi_tpu_torch.utils.token_accounting import token_throughput

    model = lm_model(torch, "cuda", dtype="float32")
    dirs = {wd: os.path.join(workdir, f"lm_{wd}")
            for wd in ("f32", "bf16", "int8")}
    for wd, d in dirs.items():
        export_model(model, d, version=0, weight_dtype=wd)
    # the draft: the target's embeddings, first blocks and head
    draft = TransformerLM(config=model.config, device="cuda",
                          **dict(LM_DIMS, n_layers=P25_DRAFT_LAYERS))
    draft.module.load_state_dict({
        k: v for k, v in model.module.state_dict().items()
        if not k.startswith("blocks.")
        or int(k.split(".")[1]) < P25_DRAFT_LAYERS})
    draft_dir = os.path.join(workdir, "lm_draft")
    export_model(draft, draft_dir, version=0)
    del draft
    opts = decode_opts_from_args(launcher.parse_args(
        ["SERVE", "--export-dir", dirs["f32"], "--decode"]))
    rng = np.random.default_rng(26)

    def prompt_set():
        return [rng.integers(0, LM_DIMS["vocab"], n).astype(np.int32)
                for n in P25_PROMPT_LENS]

    def server(d, **extra):
        return Served(InferenceServer(d, device="cuda", reload_poll_s=0,
                                      decode=True,
                                      decode_opts=dict(opts, **extra))
                      .start())

    res = {"decode_opts": {k: list(v) if isinstance(v, tuple) else v
                           for k, v in opts.items()}}
    t0 = time.monotonic()
    main_srv = server(dirs["f32"])
    res["server_up_s"] = time.monotonic() - t0
    try:
        rep = main_srv.server.replicas[0]
        sess = rep.session
        window = sess.window
        c = main_srv.client()
        # serial warm: every prefill bucket alone, then a concurrent pass
        for p in prompt_set():
            c.generate(p, 2)
        warm, _ = p25_streams(main_srv, prompt_set(), P25_MAX_NEW)
        keys = {f: set(k) for f, k in sess.bucket_keys.items()}
        ptrs = [t.data_ptr() for t in sess.page_tensors]
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        rep.batcher.reset_intertoken()
        _kernels.reset_launch_counts()
        s0 = main_srv.server.stats()
        ps = prompt_set()
        f32_out, wall = p25_streams(main_srv, ps, P25_MAX_NEW)
        torch.cuda.synchronize()
        launches = _kernels.launch_counts()
        st = main_srv.server.stats()
        # (e) the restated pins
        new_keys = {f: sorted(map(str, set(k) - keys[f]))
                    for f, k in sess.bucket_keys.items() if set(k) - keys[f]}
        pins = {"new_bucket_keys": new_keys,
                "data_ptr_kept": [t.data_ptr() for t in sess.page_tensors]
                == ptrs,
                "memory_reserved_before": reserved,
                "memory_reserved_after": torch.cuda.memory_reserved(),
                "bucket_keys": {f: len(k) for f, k in keys.items()}}
        res["pins"] = pins
        if new_keys or not pins["data_ptr_kept"] \
                or pins["memory_reserved_after"] > reserved:
            raise AssertionError(f"(e) steady-state pins broken: {pins}")
        if any(launches.values()):
            raise AssertionError(f"the decode path launched kernels: "
                                 f"{launches}")
        tokens = st["tokens"] - s0["tokens"]
        thr = token_throughput(tokens, wall)
        it = st["replicas"][0]["intertoken_ms"]
        res["f32"] = {"throughput": thr, "intertoken_ms": it,
                      "steps": st["steps"] - s0["steps"],
                      "shared_steps": st["shared_steps"] - s0["shared_steps"],
                      "max_concurrent": st["max_concurrent"]}
        log(f"  (b) f32 decode, 8 streams: {thr['tokens']} tokens in "
            f"{wall:.3f} s = {thr['tokens_per_sec']:.1f} tokens/s; "
            f"inter-token p50 {it['p50']:.2f} ms p99 {it['p99']:.2f} ms "
            f"({it['count']} gaps); {res['f32']['steps']} steps")
        log(f"  (e) no new bucket key after the warm passes "
            f"({sum(pins['bucket_keys'].values())} keys), page tensors "
            f"kept their data_ptr, memory_reserved {reserved} -> "
            f"{pins['memory_reserved_after']} bytes; no kernel launched")
        # (b) the oracle
        oracle = [p25_oracle(torch, model.module, p, o, window)
                  for p, o in zip(ps, f32_out)]
        res["oracle"] = oracle
        # phase 26 serves the same export and holds its routed streams to
        # these tokens
        res.update(f32_dir=dirs["f32"], prompts=[p.tolist() for p in ps],
                   f32_tokens=f32_out)
        for p, o, orc in zip(ps, f32_out, oracle):
            if orc["differ"]:
                log(f"  (b) prompt {len(p)}: {orc['differ']} token(s) off "
                    f"the oracle at (position, top-2 margin) {orc['ties']}")
            if not orc["ok"]:
                raise AssertionError(f"greedy tokens off the full_forward "
                                     f"oracle beyond a tie: {orc['ties']}")
        if not any(len(p) < window < len(p) + n
                   for p, n in zip(ps, P25_MAX_NEW)):
            raise AssertionError("no stream decoded past the window")
        log(f"  (b) f32 tokens equal the full_forward(window={window}) "
            f"oracle over {sum(len(o) for o in f32_out)} tokens "
            f"(least top-2 margin {min(o['min_margin'] for o in oracle):.3g}"
            f", {sum(o['differ'] for o in oracle)} near-ties)")

        # (d) the prefix cache
        pp = rng.integers(0, LM_DIMS["vocab"], 40).astype(np.int32)
        cold = c.generate(pp, 16).tolist()
        h0 = main_srv.server.stats()["prefix_cache_hits"]
        hot = c.generate(pp, 16).tolist()
        hits = main_srv.server.stats()["prefix_cache_hits"] - h0
        if hits < 1 or hot != cold:
            raise AssertionError(f"prefix cache: {hits} hits, tokens "
                                 f"{hot} vs cold {cold}")
        res["prefix"] = {"hits": hits, "tokens_equal": True}
        log(f"  (d) a repeated 40-token prompt: {hits} prefix-cache hit(s), "
            "the cold run's tokens")

        # (d) migration: a stream drained from a second replica, adopted
        n_mig = 96
        pm = rng.integers(0, LM_DIMS["vocab"], 40).astype(np.int32)
        in_place = c.generate(pm, n_mig).tolist()
        donor = server(dirs["f32"])
        try:
            dc, probe = donor.client(), donor.client()
            got = {}
            t = threading.Thread(target=lambda: got.setdefault(
                "out", dc.generate(pm, n_mig)), daemon=True)
            t.start()
            for _ in range(4000):
                if probe.stats()["tokens"] >= 5:
                    break
                time.sleep(0.002)
            probe.drain_migrate()
            t.join(120)
            mig = got.get("out")
            if not hasattr(mig, "manifest"):
                raise AssertionError(f"the drained stream came back as "
                                     f"{type(mig).__name__}, not migrated")
            rest = c.adopt(mig.manifest, mig.k, mig.v,
                           n_mig - len(mig.tokens)).tolist()
        finally:
            donor.close()
        stitched = mig.tokens + rest
        if stitched != in_place:
            raise AssertionError(
                f"migrated stream off the in-place one at token "
                f"{p25_first_diff(stitched, in_place)}")
        res["migration"] = {"emitted_before_drain": len(mig.tokens),
                            "adopted_tokens": len(rest)}
        log(f"  (d) drain_migrate after {len(mig.tokens)} tokens, adopted "
            f"by the other replica over TCP: {n_mig} tokens equal to the "
            "in-place stream")
    finally:
        main_srv.close()

    # (c) speculative decode
    spec = server(dirs["f32"], draft_export_dir=draft_dir,
                  speculate_k=P25_SPEC_K)
    try:
        spec_out, wall = p25_streams(spec, ps, P25_MAX_NEW)
        st = spec.server.stats()
    finally:
        spec.close()
    for p, a, b, orc in zip(ps, spec_out, f32_out, oracle):
        i = p25_first_diff(a, b)
        if i is not None and not any(j == i and m < P25_TIE
                                     for j, m in orc["ties"]):
            raise AssertionError(f"speculative tokens off plain at token {i}"
                                 f" of the {len(p)}-token prompt")
    res["speculative"] = {"accept_rate": st["accept_rate"],
                          "draft_tokens": st["draft_tokens"],
                          "accepted_draft_tokens":
                              st["accepted_draft_tokens"],
                          "steps": st["steps"],
                          "throughput": token_throughput(st["tokens"], wall)}
    log(f"  (c) speculative (k={P25_SPEC_K}, a {P25_DRAFT_LAYERS}-layer "
        f"draft): tokens equal to plain; accept rate "
        f"{st['accept_rate']:.3f}, {st['steps']} target steps for "
        f"{st['tokens']} tokens, "
        f"{res['speculative']['throughput']['tokens_per_sec']:.1f} tokens/s")

    # (b) the bf16 and int8 exports
    for wd in ("bf16", "int8"):
        srv = server(dirs[wd])
        try:
            q_out, wall = p25_streams(srv, ps, P25_MAX_NEW)
            st = srv.server.stats()
        finally:
            srv.close()
        first = [p25_first_diff(a, b) for a, b in zip(q_out, f32_out)]
        res[wd] = {"throughput": token_throughput(st["tokens"], wall),
                   "first_diff_vs_f32": first,
                   "intertoken_ms": st["replicas"][0]["intertoken_ms"]}
        log(f"  (b) {wd} export: {res[wd]['throughput']['tokens_per_sec']:.1f}"
            f" tokens/s; first token off f32 per stream {first}")
    del model
    torch.cuda.empty_cache()
    return res


def decode_serving_phase(torch, workdir: str) -> dict:
    """Phase 25: the rest of serving (TCP front, quantized exports) and
    autoregressive decode (module docstring)."""
    os.environ.setdefault("THEANOMPI_TPU_SERVICE_KEY", "chip-smoke-serving")
    os.environ["THEANOMPI_TPU_WIRE_SHM"] = "0"
    t0 = time.monotonic()
    out = {"resnet": p25_resnet(torch, workdir)}
    out["lm"] = p25_lm(torch, workdir)
    out["seconds"] = time.monotonic() - t0
    log(f"  phase 25: {out['seconds']:.1f} s")
    return out


# -- phase 26: disaggregated serving and the fleet prefix cache ------------

#: phase 26: the fleet's prefill and decode children; the fleet-cache
#: prompts' shared prefix (two 16-token pages), their suffixes and the
#: tokens (c)'s stream generates; (d)'s streams (phase 25's four longest);
#: how long the router process may run before it is killed
P26_PREFILL, P26_DECODE = 2, 2
P26_PREFIX, P26_SUFFIX, P26_CACHE_NEW = 32, 8, 16
P26_FAILOVER_STREAMS = (4, 5, 6, 7)
P26_TIMEOUT_S = 300


def p26_prompts() -> list:
    """Phase 25 (b)'s measured prompts: its generator's third draw,
    after the serial and the concurrent warm passes."""
    rng = np.random.default_rng(26)
    draws = [[rng.integers(0, LM_DIMS["vocab"], n).astype(np.int32)
              for n in P25_PROMPT_LENS] for _ in range(3)]
    return draws[2]


def p26_streams(new_client, prompts, max_new, during=None):
    """Every prompt as its own concurrent ``generate`` through the router;
    ``during()`` runs once every stream has started.  The token lists,
    each stream's seconds and the wall seconds of the whole set."""
    clients = [new_client() for _ in prompts]
    outs, secs, errors = [None] * len(prompts), [0.0] * len(prompts), []

    def go(i):
        t = time.monotonic()
        try:
            outs[i] = clients[i].generate(prompts[i], max_new[i]).tolist()
        except Exception as e:  # reported below
            errors.append(f"{type(e).__name__}: {e}")
        secs[i] = time.monotonic() - t

    threads = [threading.Thread(target=go, args=(i,), daemon=True)
               for i in range(len(prompts))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    try:
        if during is not None:
            during()
    finally:
        for t in threads:
            t.join(P26_TIMEOUT_S)
    wall = time.monotonic() - t0
    if errors or any(o is None for o in outs):
        raise AssertionError(f"a routed stream failed: {errors[:3]}")
    for o, n in zip(outs, max_new):
        if len(o) != n:
            raise AssertionError(f"a stream gave {len(o)} tokens, not {n}")
    return outs, secs, wall


def p26_smi() -> dict:
    """nvidia-smi's compute processes (pid, used MiB) and the card's used
    memory."""
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    used = subprocess.run(
        ["nvidia-smi", "-i", os.environ.get("CUDA_VISIBLE_DEVICES", "0"),
         "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    rows = []
    for line in apps:
        pid, _, mem = (x.strip() for x in line.partition(","))
        if pid.isdigit():
            rows.append((int(pid), float(mem.split()[0]) if mem else 0.0))
    return {"apps": rows, "used_mib": float(used.stdout.split()[0])}


def p26_device(torch, fleet, before: dict) -> dict:
    """(b) The children on the card, the router (this process) not:
    ``nvidia-smi --query-compute-apps=pid,used_memory``.  Where the card's
    nvidia-smi shows the children's own pids, each must appear with
    memory above 0 and the router's pid must not; where it cannot see
    this machine's pid namespace (it names every process pid 1), the
    compute processes must have grown by exactly the children (the router
    adds none) and the card's used memory by more than 0 a child."""
    now = p26_smi()
    pids = {}
    for role, group in (("prefill", fleet.prefill_group),
                        ("decode", fleet.decode_group)):
        with group._lock:
            for port, proc in sorted(group._procs.items()):
                pids[f"{role}:{port}"] = proc.pid
    apps = dict(now["apps"])
    by_pid = {name: apps.get(pid) for name, pid in pids.items()}
    visible = all(m is not None for m in by_pid.values())
    added = len(now["apps"]) - len(before["apps"])
    per_child = (now["used_mib"] - before["used_mib"]) / len(pids)
    out = {"pids": pids, "router_pid": os.getpid(),
           "pids_visible": visible, "children_mib": by_pid,
           "compute_apps_before": before["apps"],
           "compute_apps": now["apps"], "apps_added": added,
           "used_mib_before": before["used_mib"],
           "used_mib": now["used_mib"], "mib_per_child": per_child,
           "router_on_card": os.getpid() in apps,
           "router_cuda_initialized": torch.cuda.is_initialized()}
    if visible:
        ok = all(m > 0 for m in by_pid.values())
        log(f"  (b) nvidia-smi used memory per child (MiB): {by_pid}")
    else:
        ok = added == len(pids) and per_child > 0
        log(f"  (b) nvidia-smi lists {len(now['apps'])} compute processes "
            f"(pids {sorted(set(apps))}: not this machine's namespace), "
            f"{added} more than before the fleet: one per child, none for "
            f"the router; the card's used memory {before['used_mib']:.0f} "
            f"-> {now['used_mib']:.0f} MiB, {per_child:.0f} MiB a child")
    log(f"  (b) the router (pid {os.getpid()}) on the card: "
        f"{out['router_on_card']}, its CUDA initialized: "
        f"{out['router_cuda_initialized']}")
    if (not ok or out["router_on_card"]
            or out["router_cuda_initialized"]):
        raise AssertionError(f"(b) the device: {out}")
    return out


def p26_wait(cond, what: str, timeout: float = 120.0) -> float:
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(0.005)
    return time.monotonic() - t0


def p26_fleet(spec: dict) -> dict:
    """Phase 26 (a)-(e) in the router's process (see ``p26_router``)."""
    import torch

    from theanompi_tpu_torch import monitor
    from theanompi_tpu_torch.frontdoor import (
        Autoscaler,
        DisaggregatedFleet,
        HysteresisController,
        PrefillClient,
        RouterClient,
    )
    from theanompi_tpu_torch.serving import InferenceClient

    ps = [np.asarray(p, np.int32) for p in spec["prompts"]]
    max_new = list(spec["max_new"])
    res: dict = {}
    before = p26_smi()
    t0 = time.monotonic()
    fleet = DisaggregatedFleet(spec["export_dir"], prefill=P26_PREFILL,
                               decode=P26_DECODE, router_host="127.0.0.1",
                               device="cuda")
    clients = []

    def client(cls=RouterClient, addr=None):
        c = cls(addr or fleet.router_addr)
        clients.append(c)
        return c

    try:
        res["startup_s"] = time.monotonic() - t0
        log(f"  {P26_PREFILL} prefill + {P26_DECODE} decode children on "
            "the card (the cache authority first, then the other three at "
            f"once) up in {res['startup_s']:.1f} s")
        res["device"] = p26_device(torch, fleet, before)

        # (a) 8 streams through the router
        tokens, _, wall = p26_streams(client, ps, max_new)
        hist = monitor.registry().get("frontdoor/migrate_ms")
        migrate = {"p50": hist.percentile(50), "p99": hist.percentile(99),
                   "count": hist.count}
        man, k, v = client(PrefillClient,
                           fleet.prefill_group.addresses()[0]).prefill(ps[0])
        page_bytes = {"manifest": len(json.dumps(man)),
                      "k": int(k.nbytes), "v": int(v.nbytes)}
        _, ttft, _ = p26_streams(client, ps, [1] * len(ps))
        st = fleet.router.stats()
        n_tok = sum(len(t) for t in tokens)
        res["a"] = {"tokens": tokens, "wall_s": wall,
                    "tokens_per_s": n_tok / wall, "migrate_ms": migrate,
                    "page_bytes": page_bytes, "ttft_s": ttft,
                    "router": {k2: st[k2] for k2 in (
                        "streams", "shed", "failovers", "migrations")}}
        log(f"  (a) {len(ps)} streams through the router: {n_tok} tokens in "
            f"{wall:.3f} s = {n_tok / wall:.1f} tokens/s; "
            f"frontdoor/migrate_ms p50 {migrate['p50']:.2f} p99 "
            f"{migrate['p99']:.2f} ({migrate['count']} prefill legs); "
            f"pages a stream: manifest {page_bytes['manifest']} + k "
            f"{page_bytes['k']} + v {page_bytes['v']} bytes; time to first "
            f"token (a 1-token stream, 8 at once) {min(ttft):.3f}-"
            f"{max(ttft):.3f} s; router {res['a']['router']}")
        if st["shed"]:
            raise AssertionError(f"(a) the router shed: {st}")

        # (c) the fleet prefix cache
        auth = fleet._authority_addr
        peer = next(a for a in fleet.prefill_group.addresses() if a != auth)
        cache = spec["cache"]
        pa = np.asarray(cache["prefix"] + cache["a"], np.int32)
        pb = np.asarray(cache["prefix"] + cache["b"], np.int32)
        ac, pc = client(PrefillClient, auth), client(PrefillClient, peer)
        s0 = ac.stats()
        man_a, _, _ = pc.prefill(pa)   # cold on the peer: registers
        s1 = ac.stats()
        man_b, _, _ = pc.prefill(pb)   # the peer's own prefix cache
        dc = client(InferenceClient, fleet.decode_group.addresses()[0])
        d0 = dc.stats()["prefix_cache_hits"]
        hit = dc.generate(pb, P26_CACHE_NEW).tolist()
        s2, d1 = ac.stats(), dc.stats()["prefix_cache_hits"]
        res["c"] = {"authority": auth, "peer": peer,
                    "authority_prefix_cache": [s0["prefix_cache"],
                                               s1["prefix_cache"],
                                               s2["prefix_cache"]],
                    "leases_after": s2["fleet_cache_leases"],
                    "peer_prefix_cache": pc.stats()["prefix_cache"],
                    "decode_prefix_hits": d1 - d0,
                    "first_tokens": [man_a["first_token"],
                                     man_b["first_token"]],
                    "tokens": hit}
        log(f"  (c) authority {auth}: prefix cache {s0['prefix_cache']} -> "
            f"after the peer's cold prefill {s1['prefix_cache']} -> after "
            f"a decode replica's fetch {s2['prefix_cache']}, leases "
            f"{s2['fleet_cache_leases']}; the peer's second prompt "
            f"{res['c']['peer_prefix_cache']}; the decode replica's "
            f"prefix hits +{d1 - d0}")
        if (s1["prefix_cache"]["entries"] <= s0["prefix_cache"]["entries"]
                or s2["prefix_cache"]["hits"] <= s1["prefix_cache"]["hits"]
                or s2["fleet_cache_leases"] != 0 or d1 - d0 < 1):
            raise AssertionError(f"(c) no fleet hit: {res['c']}")

        # (d) failover: a decode replica killed with streams in flight
        victim = fleet.decode_group.addresses()[0]
        vc = client(InferenceClient, victim)
        base = vc.stats()["tokens"]
        idx = P26_FAILOVER_STREAMS

        killed = []

        def kill_when_running():
            p26_wait(lambda: fleet.router.backend_streams("decode", victim)
                     and vc.stats()["tokens"] - base >= 5,
                     "(d) a stream running on the victim")
            fleet.decode_group.kill(victim)
            killed.append(time.monotonic())
            log(f"  (d) killed decode replica {victim} with "
                f"{fleet.router.backend_streams('decode', victim)} "
                "stream(s) on it")

        f0 = fleet.router.stats()["failovers"]
        d_tok, _, _ = p26_streams(client, [ps[i] for i in idx],
                                  [max_new[i] for i in idx],
                                  during=kill_when_running)
        st = fleet.router.stats()
        res["d"] = {"victim": victim, "tokens": d_tok,
                    "failovers": st["failovers"] - f0, "shed": st["shed"]}
        log(f"  (d) {len(idx)} streams finished: {res['d']['failovers']} "
            f"failover(s), shed {st['shed']}")
        if res["d"]["failovers"] < 1 or st["shed"]:
            raise AssertionError(f"(d) failover: {st}")

        # (e) scale events: grow the decode role (while the watcher
        # relaunches (d)'s victim), then drain-first shrink
        t = time.monotonic()
        new = fleet.decode_group.grow()
        grow_s = time.monotonic() - t
        p26_wait(lambda: fleet.decode_group._rpc_probe(victim),
                 "(d) the victim's relaunch")
        res["d"].update(relaunch_s=time.monotonic() - killed[0],
                        restarts=fleet.decode_group.restart_counts())
        log(f"  (d) the watcher relaunched the victim: serving again "
            f"{res['d']['relaunch_s']:.1f} s after the kill")
        fleet.router.add_backend("decode", new)
        nc = client(InferenceClient, new)
        e_up, _, _ = p26_streams(client, ps, max_new)
        adopted_new = sum(r["adopted"] for r in nc.stats()["replicas"])
        target = fleet.decode_group.addresses()[-1]
        with fleet.decode_group._lock:
            target_proc = fleet.decode_group._procs[
                int(target.rpartition(":")[2])]
        tc = client(InferenceClient, target)
        base = tc.stats()["tokens"]
        scaler = Autoscaler(fleet.router, {"decode": fleet.decode_group},
                            {"decode": HysteresisController(
                                up=2.0, down=1.5, hold=1, cooldown_s=0.0,
                                min_size=P26_DECODE,
                                max_size=P26_DECODE + 1)})

        def shrink_when_running():
            p26_wait(lambda: fleet.router.backend_streams("decode", target)
                     and tc.stats()["tokens"] - base >= 5,
                     "(e) a stream running on the replica to drain")
            scaler.tick()

        m0 = fleet.router.stats()["migrations"]
        try:
            e_down, _, _ = p26_streams(client, ps, max_new,
                                       during=shrink_when_running)
        finally:
            scaler.stop()
        st = fleet.router.stats()
        exited = p26_wait(lambda: target_proc.poll() is not None,
                          "(e) the drained child's exit", 30.0)
        res["e"] = {"grown": new, "grow_s": grow_s,
                    "adopted_on_new": adopted_new, "drained": target,
                    "events": list(scaler.events), "tokens_up": e_up,
                    "tokens_down": e_down,
                    "migrations": st["migrations"] - m0,
                    "shed": st["shed"], "exit_code": target_proc.returncode,
                    "exited_after_s": exited,
                    "decode_replicas": fleet.decode_group.addresses()}
        log(f"  (e) grew {new} in {grow_s:.1f} s (it adopted "
            f"{adopted_new} streams of 8); the autoscaler drained {target} "
            f"with streams in flight: {res['e']['migrations']} stream(s) "
            f"migrated, shed {st['shed']}, the child exited "
            f"(rc {target_proc.returncode}); decode role now "
            f"{res['e']['decode_replicas']}")
        if (adopted_new < 1 or scaler.events != [("decode", "down", target)]
                or res["e"]["migrations"] < 1 or st["shed"]
                or len(fleet.decode_group) != P26_DECODE):
            raise AssertionError(f"(e) scale events: {res['e']}")
        res["router_cuda_initialized"] = torch.cuda.is_initialized()
        if res["router_cuda_initialized"]:
            raise AssertionError("the router process initialized CUDA")
    finally:
        for c in clients:
            c.close()
        fleet.stop()
    return res


def p26_router(spec_path: str) -> int:
    """Phase 26's router process: ``python -c 'import chip_smoke;
    chip_smoke.p26_router(spec)'`` from the repository root.  It builds
    the ``DisaggregatedFleet`` (its children on the card), runs (a)-(e)
    and writes its results beside the spec; it holds no model and never
    touches the card."""
    with open(spec_path) as f:
        spec = json.load(f)
    os.environ["THEANOMPI_TPU_MONITOR"] = spec["monitor_dir"]
    from theanompi_tpu_torch import monitor

    out = {"ok": False}
    try:
        with monitor.session(spec["monitor_dir"], name="p26router"):
            out.update(p26_fleet(spec))
        out["ok"] = True
    except Exception as e:
        import traceback

        out["error"] = f"{type(e).__name__}: {e}"
        traceback.print_exc()
    with open(spec["out"], "w") as f:
        json.dump(out, f)
    return 0 if out["ok"] else 1


def p26_same(got, want, oracle) -> bool:
    """Two greedy token lists of one prompt agree: equal, or first apart
    where the oracle's top-2 margin (over ``want``'s sequence, which both
    share up to there) is below ``P25_TIE``."""
    i = p25_first_diff(got, want)
    if i is None:
        return len(got) == len(want)
    return oracle["margins"][i] < P25_TIE


def frontdoor_phase(torch, workdir: str, phase25: dict | None = None) -> dict:
    """Phase 26 (module docstring): the disaggregated fleet at phase 25's
    LM, driven from a router process of its own."""
    import signal

    from theanompi_tpu_torch.decode.session import DecodeSession
    from theanompi_tpu_torch.parallel import shm
    from theanompi_tpu_torch.serving import export_model
    from theanompi_tpu_torch.serving.export import (
        build_model_from_meta,
        load_export,
    )

    t0 = time.monotonic()
    os.environ.setdefault("THEANOMPI_TPU_SERVICE_KEY", "chip-smoke-serving")
    os.environ["THEANOMPI_TPU_WIRE_SHM"] = "0"
    ps = p26_prompts()
    lm = (phase25 or {}).get("lm") or {}
    if lm and [p.tolist() for p in ps] != lm["prompts"]:
        raise AssertionError("phase 26's prompts are not phase 25's")
    export_dir = lm.get("f32_dir")
    if export_dir is None:
        model = lm_model(torch, "cuda", dtype="float32")
        export_dir = os.path.join(workdir, "lm_f32")
        export_model(model, export_dir, version=0)
        del model
    loaded = load_export(export_dir)
    model = build_model_from_meta(loaded.meta, "cuda")
    model.module.load_state_dict(loaded.state)
    net = model.module.eval()
    rng = np.random.default_rng(2626)
    cache = {"prefix": rng.integers(0, LM_DIMS["vocab"], P26_PREFIX).tolist(),
             "a": rng.integers(0, LM_DIMS["vocab"], P26_SUFFIX).tolist(),
             "b": rng.integers(0, LM_DIMS["vocab"], P26_SUFFIX).tolist()}
    spec = {"export_dir": export_dir, "prompts": [p.tolist() for p in ps],
            "max_new": list(P25_MAX_NEW), "cache": cache,
            "monitor_dir": os.path.join(workdir, "p26_monitor"),
            "out": os.path.join(workdir, "p26_out.json")}
    spec_path = os.path.join(workdir, "p26_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    segs = set(shm.segment_names())
    t1 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.p26_router(sys.argv[1]))", spec_path],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        start_new_session=True)
    try:
        rc = proc.wait(timeout=P26_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        # the router's group holds every child it spawned: nothing of
        # the fleet outlives the phase, pass or fail
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    router_s = time.monotonic() - t1
    left = sorted(set(shm.segment_names()) - segs)
    if rc != 0 or not os.path.exists(spec["out"]):
        raise AssertionError(f"phase 26's router process exited {rc}")
    with open(spec["out"]) as f:
        res = json.load(f)
    if not res.get("ok"):
        raise AssertionError(f"phase 26: {res.get('error')}")
    if left:
        raise AssertionError(f"phase 26 left shm segments {left}")

    # the tokens: the oracle, phase 25's single-role run, a cold run
    window = 16 * 8
    oracle = [p25_oracle(torch, net, p, o, window)
              for p, o in zip(ps, res["a"]["tokens"])]
    for p, orc in zip(ps, oracle):
        if not orc["ok"]:
            raise AssertionError(f"(a) routed tokens of the {len(p)}-token "
                                 f"prompt off the oracle: {orc['ties']}")
    single = lm.get("f32_tokens")
    if single is not None:
        bad = [i for i, (a, b) in enumerate(zip(res["a"]["tokens"], single))
               if not p26_same(a, b, oracle[i])]
        if bad:
            raise AssertionError(f"(a) routed streams {bad} off phase 25's")

    def held(tokens, which):
        return [i for i, t in zip(which, tokens)
                if not p26_same(t, res["a"]["tokens"][i], oracle[i])]

    bad = (held(res["d"]["tokens"], P26_FAILOVER_STREAMS)
           + held(res["e"]["tokens_up"], range(len(ps)))
           + held(res["e"]["tokens_down"], range(len(ps))))
    if bad:
        raise AssertionError(f"(d)/(e) streams {bad} off (a)'s tokens")
    pb = np.asarray(cache["prefix"] + cache["b"], np.int32)
    sess = DecodeSession(model, params=loaded.state, page_size=16,
                         pages_per_seq=8, max_seqs=8, prefix_cache=False)
    seq, logits = sess.admit(pb)
    cold = [int(np.argmax(logits))]
    while len(cold) < P26_CACHE_NEW:
        cold.append(int(np.argmax(sess.decode(
            [seq], np.asarray([cold[-1]], np.int32))[0])))
    sess.release(seq)
    corc = p25_oracle(torch, net, pb, cold, window)
    if not (corc["ok"] and p26_same(res["c"]["tokens"], cold, corc)
            and p26_same(res["c"]["first_tokens"][1:], cold[:1], corc)):
        raise AssertionError(f"(c) fleet-hit tokens {res['c']['tokens']} "
                             f"vs the cold run's {cold}")
    del model, net, sess
    torch.cuda.empty_cache()
    res["oracle"] = oracle
    res["cold_tokens"] = cold
    res["router_process_s"] = router_s
    res["seconds"] = time.monotonic() - t0
    n_tok = sum(len(t) for t in res["a"]["tokens"])
    log(f"  tokens: routed (a) {n_tok} equal to the "
        f"full_forward(window={window}) oracle (least top-2 margin "
        f"{min(o['min_margin'] for o in oracle):.3g}"
        + (", and to phase 25's single-role run" if single is not None
           else "") + "); (d) and (e)'s streams equal to (a)'s; (c)'s "
        f"fleet-hit stream equal to a cold run ({P26_CACHE_NEW} tokens)")
    log(f"  phase 26: {res['seconds']:.1f} s (router process "
        f"{router_s:.1f} s)")
    return res


# -- phase 27: the checker suite, the entry points, the native host
# -- augment and the kernel cache directory ---------------------------------

#: (b): the entry forward's per-row relative L2 against the CPU's f32
P27_ENTRY_LIMIT = 0.05
#: (d): the host batches timed, and the timing repeats of each path
P27_IMAGENET = (128, 256, 224)   # batch, stored side, crop
P27_CIFAR = (128, 32, 4)         # batch, side, reflect pad
P27_REPS = 3
#: (d): the Cifar10 step's batch; (e): the launcher epoch's (the
#: synthetic pool of 4096 images: 8 steps)
P27_CIFAR_BATCH, P27_LAUNCHER_BATCH = 128, 512


def p27_tmlint() -> dict:
    """(a) ``theanompi_tpu_torch/tools/tmlint.py --gate --format json``
    as a subprocess: its exit code and the finding counts by check."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    p = subprocess.run(
        [sys.executable, os.path.join(root, "theanompi_tpu_torch", "tools",
                                      "tmlint.py"),
         "--gate", "--format", "json", "--root", root],
        capture_output=True, text=True, timeout=300)
    out = json.loads(p.stdout)
    counts: dict[str, int] = {}
    for f in out["findings"]:
        counts[f["check_id"]] = counts.get(f["check_id"], 0) + 1
    res = {"rc": p.returncode, "findings_by_check": counts,
           "new": len(out["new"]), "stale": len(out["stale_baseline_keys"]),
           "seconds": time.monotonic() - t0}
    log(f"  (a) tmlint --gate rc {p.returncode} in {res['seconds']:.1f} s: "
        f"{len(out['findings'])} findings {counts}, {res['new']} new, "
        f"{res['stale']} stale baseline keys")
    if p.returncode != 0 or res["new"]:
        raise AssertionError(f"phase 27 (a): tmlint gate failed: {p.stdout}"
                             f"{p.stderr}")
    return res


def p27_entry(torch) -> dict:
    """(b) ``entry(device="cuda")``: its bf16 forward of a seeded batch
    against the same weights in f32 on the CPU (per-row relative L2 <=
    ``P27_ENTRY_LIMIT``), exactly the launches one forward of the full
    ResNet-50 derives (K1a 37, K1b 16, K2a 1) and nothing else, and the
    call's time (CUDA events, after a warm call)."""
    from theanompi_tpu_torch.entry import entry, resnet_launches
    from theanompi_tpu_torch.models.resnet50 import ResNet
    from theanompi_tpu_torch.ops import _kernels

    fn, (net, x) = entry("cuda")
    want = resnet_launches(net, train=False)
    xs = torch.from_numpy(np.random.default_rng(27).standard_normal(
        tuple(x.shape)).astype(np.float32))
    fn(net, xs.cuda())  # warm
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0, t1 = torch.cuda.Event(True), torch.cuda.Event(True)
    t0.record()
    got = fn(net, xs.cuda())
    t1.record()
    torch.cuda.synchronize()
    launches = {k: v for k, v in _kernels.launch_counts().items() if v}
    ref = ResNet(dtype=torch.float32)
    ref.load_state_dict({k: v.float().cpu()
                         for k, v in net.state_dict().items()})
    with torch.no_grad():
        want_out = ref.eval()(xs, train=False)
    got = got.float().cpu()
    rel = ((got - want_out).norm(dim=1) / want_out.norm(dim=1)).tolist()
    res = {"launches": launches, "want_launches": want,
           "rel_l2": rel, "ms": t0.elapsed_time(t1),
           "shape": list(x.shape), "finite": bool(torch.isfinite(got).all())}
    log(f"  (b) entry(): {tuple(x.shape)} bf16 forward {res['ms']:.2f} ms "
        f"(CUDA events), launches {launches}; per-row relative L2 against "
        f"the CPU's f32 max {max(rel):.4f} (limit {P27_ENTRY_LIMIT})")
    if (launches != want or not res["finite"]
            or max(rel) > P27_ENTRY_LIMIT):
        raise AssertionError(f"phase 27 (b): {res}")
    return res


def p27_dryrun_check(torch, result: dict) -> dict:
    """(c) ``dryrun_multichip(1, device="cuda")``'s legs: every loss
    finite and each leg's launches exactly the tiny ResNet-50's per
    training step (``entry.resnet_launches``) times the batches it
    consumed."""
    from theanompi_tpu_torch.entry import TINY_RESNET, resnet_launches
    from theanompi_tpu_torch.models.resnet50 import ResNet

    per_step = resnet_launches(ResNet(
        stage_sizes=TINY_RESNET["stage_sizes"], width=TINY_RESNET["width"]),
        train=True)
    bad = []
    for leg, r in result.items():
        want = {k: v * r["consumed"] for k, v in per_step.items()}
        log(f"  (c) {leg}: loss {r['loss']:.6f}, {r['consumed']} batch(es), "
            f"launches {r['launches']}")
        if r["launches"] != want or not math.isfinite(r["loss"]):
            bad.append(f"{leg}: launches {r['launches']} != {want} or loss "
                       f"{r['loss']}")
    if bad:
        raise AssertionError("phase 27 (c): " + "; ".join(bad))
    return {"legs": result, "per_step": per_step}


def p27_native(torch) -> dict:
    """(d) The native host augment on the host: bitwise equal
    to the numpy path on a batch-128 ImageNet crop (256 -> 224) and a
    CIFAR batch (32, pad 4); host ms a batch of each path (native at its
    default thread count and at 1 thread, numpy), best of ``P27_REPS``;
    then one Cifar10 BSP step (batch 128, f32, deterministic cuDNN) fed
    by the native path and one fed by the numpy path from the same seed
    (``augment_on_device=False``: the host augments):
    the same batch, loss and parameters bit for bit, exactly K3a 2 and
    K3b 2 launches each, and native calls only in the first."""
    import torch.distributed as dist

    from theanompi_tpu_torch import native
    from theanompi_tpu_torch.data import utils
    from theanompi_tpu_torch.data.cifar10 import CIFAR_MEAN, CIFAR_STD
    from theanompi_tpu_torch.data.imagenet import IMAGENET_MEAN, IMAGENET_STD
    from theanompi_tpu_torch.launcher import param_digest
    from theanompi_tpu_torch.models.cifar10 import Cifar10_model
    from theanompi_tpu_torch.ops import _kernels
    from theanompi_tpu_torch.utils.recorder import Recorder

    if not native.native_available():
        raise AssertionError("phase 27 (d): no g++ on the host")
    rng = np.random.default_rng(27)
    n, side, crop = P27_IMAGENET
    cn, cside, pad = P27_CIFAR
    cases = {"imagenet": (rng.integers(0, 256, (n, side, side, 3),
                                       dtype=np.uint8), crop, 0,
                          IMAGENET_MEAN, IMAGENET_STD),
             "cifar": (rng.integers(0, 256, (cn, cside, cside, 3),
                                    dtype=np.uint8), cside, pad,
                       CIFAR_MEAN, CIFAR_STD)}
    threads = min(os.cpu_count() or 1, 8)
    out = {"threads": threads, "cpu_count": os.cpu_count()}

    def best(fn) -> float:
        times = []
        for _ in range(P27_REPS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    for name, (images, c, p, mean, std) in cases.items():
        def run(use_native, n_threads=None):
            r = np.random.default_rng(5)
            ys = r.integers(0, images.shape[1] + 2 * p - c + 1,
                            size=len(images))
            xs = r.integers(0, images.shape[2] + 2 * p - c + 1,
                            size=len(images))
            flips = r.random(len(images)) < 0.5
            if use_native:
                return native.crop_flip_normalize(
                    images, ys, xs, flips, c, c,
                    np.asarray(mean, np.float32),
                    np.asarray(std, np.float32), pad=p,
                    n_threads=n_threads)
            crops = utils._gather_crops(images, ys, xs, flips, c, c, p)
            return np.ascontiguousarray(utils._normalize(crops, mean, std))

        got, want = run(True), run(False)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"phase 27 (d) {name}: native != numpy")
        out[name] = {"shape": list(images.shape), "crop": c, "pad": p,
                     "native_ms": best(lambda: run(True)),
                     "native_1thread_ms": best(lambda: run(True, 1)),
                     "numpy_ms": best(lambda: run(False))}
        r = out[name]
        log(f"  (d) {name} {tuple(images.shape)} -> {c}: bitwise equal; "
            f"host ms a batch: native {r['native_ms']:.2f} ({threads} "
            f"threads), native 1 thread {r['native_1thread_ms']:.2f}, numpy "
            f"{r['numpy_ms']:.2f} (os.cpu_count() {os.cpu_count()})")

    def step(enabled: bool) -> dict:
        native.ENABLED = enabled
        native.CALLS.reset()
        cfg = dataclasses.replace(Cifar10_model.default_config(),
                                  batch_size=P27_CIFAR_BATCH, n_epochs=1,
                                  print_freq=0, augment_on_device=False)
        model = Cifar10_model(config=cfg, device="cuda")
        model.compile_iter_fns()
        model.begin_epoch(0)
        batch = next(iter(model.data.train_batches(0, P27_CIFAR_BATCH)))
        rec = Recorder(print_freq=0)
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        model.train_iter(0, rec)
        model._flush_metrics(rec)
        launches = {k: v for k, v in _kernels.launch_counts().items() if v}
        digest = param_digest(model.module)
        model.cleanup()
        return {"launches": launches, "loss": rec.train_losses[-1],
                "digest": digest, "native_calls": native.CALLS.value,
                "batch": batch[0]}

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        fed = step(True)
        plain = step(False)
    finally:
        native.ENABLED = True
        torch.backends.cudnn.deterministic = deterministic
        dist.destroy_process_group()
    want = {"lrn": 2, "lrn_bwd": 2}
    same_batch = bool(np.array_equal(fed.pop("batch"), plain.pop("batch")))
    out["step"] = {"native": fed, "numpy": plain, "same_batch": same_batch}
    log(f"  (d) Cifar10 step fed by the native path: loss {fed['loss']!r}, "
        f"launches {fed['launches']}, {fed['native_calls']} native calls; "
        f"by the numpy path: loss {plain['loss']!r}, launches "
        f"{plain['launches']}, {plain['native_calls']} native calls; same "
        f"batch {same_batch}, same parameters "
        f"{fed['digest'] == plain['digest']}")
    if (not same_batch or fed["digest"] != plain["digest"]
            or fed["loss"] != plain["loss"] or fed["launches"] != want
            or plain["launches"] != want or fed["native_calls"] < 1
            or plain["native_calls"] != 0):
        raise AssertionError(f"phase 27 (d): {out['step']}")
    return out


def p27_cache_start(workdir: str) -> tuple[Launched, str, dict]:
    """(e) A fresh cache directory holding phase 2's libraries but lrn's,
    and one launcher epoch of Cifar10 (K3) started with
    ``--compilation-cache-dir`` on it (:func:`p27_cache_check` reads
    it)."""
    import shutil

    from theanompi_tpu_torch.ops import _kernels

    cache = os.path.join(workdir, "kernel_cache")
    os.makedirs(cache)
    copied = {}
    for name in _kernels.SOURCES:
        if name == "lrn":
            continue
        src = _kernels.library_path(name)
        dst = os.path.join(cache, src.name)
        shutil.copy2(src, dst)
        copied[name] = (dst, os.stat(dst).st_mtime_ns)
    run_dir = os.path.join(workdir, "cifar_launcher")
    os.makedirs(run_dir)
    run = Launched(run_dir, [
        "BSP", "-D", "1", "-m", "theanompi_tpu_torch.models.cifar10", "-c",
        "Cifar10_model", "--epochs", "1", "--snapshot-dir", run_dir,
        "--set", f"batch_size={P27_LAUNCHER_BATCH}",
        "--compilation-cache-dir", cache])
    return run, cache, copied


def p27_cache_check(torch, run: Launched, cache: str, copied: dict) -> dict:
    """(e) The launcher epoch ended with K3's exact launches; its worker
    built only lrn, into the cache directory under ``library_path``'s
    digest name; the copied libraries were not touched; and every
    library then loads from the directory as cached."""
    import ctypes

    from theanompi_tpu_torch.ops import _kernels

    res, wall, _ = run.wait(timeout=600)
    libs = res["kernel_libraries"]
    rec = res["records"][0]
    want_lrn = os.path.join(cache, _kernels.library_path("lrn").name)
    out = {"wall_s": wall, "kernel_build_dir": res["kernel_build_dir"],
           "kernel_libraries": libs, "train_steps": rec["train_steps"],
           "launches": rec["launches"]}
    bad = []
    if res["kernel_build_dir"] != os.path.realpath(cache):
        bad.append(f"build dir {res['kernel_build_dir']}")
    lrn = libs.get("lrn") or {}
    if (set(libs) != {"lrn"} or lrn.get("cached") is not False
            or os.path.realpath(lrn.get("path", "")) != os.path.realpath(
                want_lrn) or not os.path.exists(want_lrn)):
        bad.append(f"libraries {libs}, want lrn built at {want_lrn}")
    steps = rec["train_steps"]
    train = {k: v for k, v in rec["launches"]["train"].items() if v}
    if train != {"lrn": 2 * steps, "lrn_bwd": 2 * steps}:
        bad.append(f"train launches {train} over {steps} steps")
    for name, (path, mtime) in copied.items():
        if os.stat(path).st_mtime_ns != mtime:
            bad.append(f"{name} rewritten")
    saved = (_kernels.BUILD_DIR, _kernels.CACHE_DIR)
    try:
        _kernels.set_build_dir(cache)
        again = _kernels.build()
        for name, info in again.items():
            ctypes.CDLL(info["path"])
    finally:
        _kernels.BUILD_DIR, _kernels.CACHE_DIR = saved
    out["reloaded"] = {k: v["cached"] for k, v in again.items()}
    if not all(out["reloaded"].values()):
        bad.append(f"not cached on reload: {out['reloaded']}")
    log(f"  (e) launcher epoch ({steps} steps, {wall:.1f} s wall) with "
        f"--compilation-cache-dir: lrn built in {lrn.get('seconds', 0):.1f} s "
        f"(nvcc) at {os.path.basename(lrn.get('path', ''))}; train launches "
        f"{train}; reloaded from the directory: {out['reloaded']}")
    if bad:
        raise AssertionError("phase 27 (e): " + "; ".join(bad))
    return out


def p27_start(workdir: str) -> dict:
    """Start phase 27's two processes: (c)'s dryrun rank (in a thread
    that waits for it) and (e)'s launcher epoch; :func:`entry_phase`
    checks both and :func:`p27_stop` ends them."""
    import concurrent.futures

    from theanompi_tpu_torch.entry import dryrun_multichip

    run, cache, copied = p27_cache_start(workdir)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    return {"run": run, "cache": cache, "copied": copied, "pool": pool,
            "t0": time.monotonic(),
            "dryrun": pool.submit(dryrun_multichip, 1, "cuda", 600)}


def p27_stop(started: dict) -> None:
    """Kill (e)'s launcher if it still runs and wait for (c)'s thread
    (idempotent)."""
    started["run"].close()
    started["pool"].shutdown(wait=True)


def entry_phase(torch, workdir: str, started: dict | None = None) -> dict:
    """Phase 27 (module docstring).  (c)'s dryrun process and (e)'s
    launcher were ``started`` by :func:`p27_start` beside phase 18 (c)'s
    launchers (``main``), or start here, beside (a) and (b); (d) runs
    last, alone, for its host times."""
    t0 = time.monotonic()
    if started is None:
        started = p27_start(workdir)
    try:
        lint = p27_tmlint()
        ent = p27_entry(torch)
        torch.cuda.empty_cache()
        dryrun = p27_dryrun_check(torch, started["dryrun"].result())
        cached = p27_cache_check(torch, started["run"], started["cache"],
                                 started["copied"])
    finally:
        p27_stop(started)
    nat = p27_native(torch)
    seconds = time.monotonic() - t0
    log(f"  phase 27: {seconds:.1f} s (its two processes started "
        f"{t0 - started['t0']:.1f} s before it)")
    return {"tmlint": lint, "entry": ent, "dryrun": dryrun, "native": nat,
            "cache_dir": cached, "seconds": seconds}


def main() -> int:
    # one card: the first in nvidia-smi's (PCI bus) order unless the
    # caller picks one
    os.environ.setdefault("CUDA_DEVICE_ORDER", "PCI_BUS_ID")
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: runs on one card; CUDA_VISIBLE_DEVICES="
              f"{os.environ['CUDA_VISIBLE_DEVICES']} shows "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        from theanompi_tpu_torch.models.resnet50 import ResNet50
        from theanompi_tpu_torch.ops import _kernels
    except ModuleNotFoundError as e:
        if e.name != "theanompi_tpu_torch":
            raise
        print("chip_smoke: the port's package theanompi_tpu_torch is not "
              "beside this script; run it from the repository root",
              file=sys.stderr)
        return 2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    log("phase 1: device")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"  {card}  (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{kind}, {torch.cuda.device_count()} visible)")

    log("phase 2: build")
    t0 = time.monotonic()
    built = _kernels.build()
    for name, info in built.items():
        log(f"  {name}: {info['path']} in {info['seconds']:.1f} s")
        for line in info["ptxas"].splitlines():
            if "spill" in line or ("ptxas" in line and (
                    "Used" in line or "Compiling" in line)):
                log(f"    {line.strip()}")
    log(f"  build wall {time.monotonic() - t0:.1f} s")
    k2_regs = k2_instances(built["maxpool"]["ptxas"])
    for inst, use in sorted(k2_regs.items()):
        log(f"  {inst}: {use.get('registers')} registers, spill "
            f"{use.get('spill_stores')}/{use.get('spill_loads')} bytes "
            "(stores/loads)")
    if not k2_regs:
        log("  K2 registers not read: the library was built before this run")
    elif any(use.get("spill_stores") or use.get("spill_loads")
             for inst, use in k2_regs.items() if inst[:3] in ("K2b", "K2c")):
        raise AssertionError(f"K2b/K2c spill: {k2_regs}")
    k1_bwd_regs = k1_bwd_instances(built["fused_bn"]["ptxas"])
    for inst, use in sorted(k1_bwd_regs.items()):
        log(f"  {inst}: {use.get('registers')} registers, spill "
            f"{use.get('spill_stores')}/{use.get('spill_loads')} bytes "
            "(stores/loads)")
    if not k1_bwd_regs:
        log("  K1c/K1d registers not read: the library was built before "
            "this run")
    elif len(k1_bwd_regs) != 8 or any(
            use.get("spill_stores") or use.get("spill_loads")
            for use in k1_bwd_regs.values()):
        raise AssertionError(f"K1c/K1d instances or spill: {k1_bwd_regs}")

    log("phase 3: kernels against their plain versions")
    model = ResNet50(device="cuda")
    ref_model = ResNet50(device="cpu", config=dataclasses.replace(
        model.config, compute_dtype="float32"))
    seeded_weights(torch, ref_model, seed=0)
    model.module.load_state_dict(ref_model.module.state_dict())
    x0 = torch.zeros((BATCH, 224, 224, 3), dtype=torch.uint8, device="cuda")
    cases = k1_cases(torch, model.module, model.data.device_transform(x0))
    if sum(cases.values()) != 53:
        raise AssertionError(f"expected 53 BN epilogues per forward, got "
                             f"{sum(cases.values())}")
    k1 = check_k1(torch, cases)
    k2 = check_k2(torch)

    log("phase 4: the served slice")
    with tempfile.TemporaryDirectory() as tmp:
        export_dir = os.path.join(tmp, "export")
        served = serve(torch, model, ref_model, export_dir)
        log(f"  {card}: {served['requests_per_s']:.1f} requests/s "
            f"({served['rows_per_s']:.1f} rows/s), latency p50 "
            f"{served['p50_ms']:.1f} ms p99 {served['p99_ms']:.1f} ms")
        log("phase 4b: where one batch-32 infer spends its time")
        traced = trace_forward(torch, export_dir)
        if (traced["device_ms_per_infer"]
                and not traced["families_ms_per_infer"]["maxpool (K2)"]):
            raise AssertionError("phase 4b filed no device time under "
                                 "maxpool (K2)")

    log("phase 5: the training kernels against their plain versions")
    x0 = torch.zeros((TRAIN_BATCH, 224, 224, 3), dtype=torch.uint8,
                     device="cuda")
    cases128 = k1_cases(torch, model.module, model.data.device_transform(x0))
    del x0
    k1_128 = check_k1(torch, cases128)
    k1_bwd = check_k1_bwd(torch, cases128)
    k1_bwd["instances"] = k1_bwd_regs
    k2_train = check_k2_train(torch)
    k2_train["instances"] = k2_regs
    del model
    torch.cuda.empty_cache()

    log("phase 6a: one step on the card against the CPU references")
    checked = grad_check(torch)
    torch.cuda.empty_cache()

    log("phase 7: the LRN kernels against their plain versions")
    k3 = check_k3(torch, built["lrn"]["ptxas"])
    torch.cuda.empty_cache()
    log("phase 8: one AlexNet step on the card against the CPU references")
    alex_checked = alexnet_grad_check(torch)
    torch.cuda.empty_cache()
    log("phase 12: the attention kernels against their plain versions")
    k4 = check_k4(torch)
    torch.cuda.empty_cache()
    log("phase 13: one TransformerLM step on the card against the CPU "
        "references")
    lm_checked = lm_grad_check(torch)
    torch.cuda.empty_cache()

    import torch.distributed as dist

    log("phase 6b: run_bsp_session on a one-rank NCCL group")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            session, trained = train_session(torch, tmp)
        log("phase 6c: where one training step spends its time")
        step_trace = trace_train_step(torch, trained)
        if (step_trace["device_ms_per_step"] and not step_trace[
                "families_ms_per_step"].get("max-pool (K2b/K2c)")):
            raise AssertionError("phase 6c filed no device time under "
                                 "max-pool (K2b/K2c): a kernel name the "
                                 "family matcher does not know")
        if step_trace["device_ms_per_step"]:
            # one K1c/K1d kernel a call: nothing else in their family
            ids = step_trace["kernel_events_per_step"]
            k1_bwd_events = step_trace["family_events_per_step"].get(
                "K1 backward (K1c/K1d)")
            # each K1c/K1d call with more than one cluster a chunk (all
            # 53 at this batch) zeroes its tickets with a memset first,
            # which the family (kernels by name) does not hold
            mem = step_trace["memsets_per_step"]
            k1_bwd_ms = step_trace["families_ms_per_step"].get(
                "K1 backward (K1c/K1d)", 0.0)
            log(f"  traced kernel events per step {ids}; K1 backward "
                f"family {k1_bwd_events} events, {k1_bwd_ms:.3f} ms; "
                f"memsets (the K1c/K1d tickets' among them) "
                f"{mem['events']:.0f} events, {mem['ms']:.3f} ms; the two "
                f"{k1_bwd_ms + mem['ms']:.3f} ms a step")
            if (ids["K1c"], ids["K1d"], k1_bwd_events) != (37, 16, 53):
                raise AssertionError(
                    f"phase 6c: K1c/K1d events per step {ids}, K1 "
                    f"backward family {k1_bwd_events} (want 37, 16, 53)")
        del trained
        torch.cuda.empty_cache()
        log("phase 9: the launcher: AlexNet BSP, one worker on this card")
        with tempfile.TemporaryDirectory() as tmp:
            alex_session = launcher_session(torch, tmp)
        log("phase 10: where one AlexNet training step spends its time")
        alex_trace = trace_alexnet_step(torch)
        torch.cuda.empty_cache()
        log("phase 14: run_bsp_session of the TransformerLM (bench_lm's "
            "recipe) on a one-rank NCCL group")
        with tempfile.TemporaryDirectory() as tmp:
            lm_run, lm_trained = lm_session(torch, tmp)
        log("phase 15: where one TransformerLM training step spends its "
            "time")
        lm_trace = trace_train_step(torch, lm_trained, LM_BATCH)
        lm_trace["tokens_per_s"] = (LM_BATCH * LM_DIMS["seq_len"] * 1e3
                                    / lm_trace["step_ms"])
        log(f"  {lm_trace['tokens_per_s']:.0f} tokens/s per card on the "
            "device-step leg")
        del lm_trained
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    log("phase 16: checkpoint and resume on the card (the launcher)")
    with tempfile.TemporaryDirectory() as shards_tmp:
        ckpt = checkpoint_phase(torch, shards_tmp)
        torch.cuda.empty_cache()
        log("phase 17: the rest of the BSP step on the card")
        rest = rest_of_bsp_phase(torch, shards_tmp,
                                 os.path.join(shards_tmp, "data"))
        torch.cuda.empty_cache()

        log("phase 18: the classifier zoo")
        # phase 27's dryrun rank and launcher epoch start beside 18 (c)'s
        # launchers (times shared, as theirs are); phase 27 checks them
        p27_dir = tempfile.TemporaryDirectory()
        p27_early: dict = {}
        atexit.register(lambda: p27_early and p27_stop(p27_early))

        def p27_beside() -> None:
            p27_early.update(p27_start(p27_dir.name))
            log("  phase 27 (c) and (e) started beside (c)")

        with tempfile.TemporaryDirectory() as tmp:
            zoo = zoo_phase(torch, tmp, beside=p27_beside)
        torch.cuda.empty_cache()

        log("phase 19: the WGAN, npz snapshots and sync_bn")
        with tempfile.TemporaryDirectory() as tmp:
            phase19 = sync_bn_phase(torch, tmp)
        torch.cuda.empty_cache()

        log("phase 20: ZeRO-1 and FSDP on the card")
        with tempfile.TemporaryDirectory() as tmp:
            phase20 = sharded_phase(torch, tmp,
                                    os.path.join(shards_tmp, "data"))
        torch.cuda.empty_cache()

        log("phase 23: the telemetry plane and distributed ingest "
            "(reader fleet, coordinator, collector)")
        with tempfile.TemporaryDirectory() as tmp:
            phase23 = ingest_phase(torch, tmp,
                                   os.path.join(shards_tmp, "data"))
    torch.cuda.empty_cache()

    log("phase 21: the async rules (EASGD, ASGD, GOSGD) on one card")
    with tempfile.TemporaryDirectory() as tmp:
        phase21 = async_phase(torch, tmp)
    torch.cuda.empty_cache()

    log("phase 22: the async rules' remote paths (services, shards, "
        "local aggregation) on one card")
    with tempfile.TemporaryDirectory() as tmp:
        phase22 = remote_phase(torch, tmp)
    torch.cuda.empty_cache()

    log("phase 24: the LM family's parallel variants (SP strategies, TP, "
        "PP, MoE, remat) on a one-rank NCCL group")
    phase24 = lm_variants_phase(torch)
    torch.cuda.empty_cache()

    log("phase 25: the TCP front, bf16/int8 exports and autoregressive "
        "decode (paged KV cache, continuous batching, prefix cache, "
        "speculative decode, migration)")
    with tempfile.TemporaryDirectory() as tmp:
        phase25 = decode_serving_phase(torch, tmp)
        torch.cuda.empty_cache()

        log("phase 26: disaggregated serving (prefill fleet, front-door "
            "router, autoscaler) and the fleet prefix cache")
        phase26 = frontdoor_phase(torch, tmp, phase25)
    torch.cuda.empty_cache()

    log("phase 27: the checker suite, the entry points, the native "
        "host augment and the kernel cache directory")
    with tempfile.TemporaryDirectory() as tmp:
        phase27 = entry_phase(torch, tmp, p27_early)
    p27_dir.cleanup()

    kernels = []
    for name in ("scale_bias_act", "scale_bias_act_res"):
        kernels.append({**k1["per_forward"][name], "library_ms": None,
                        "max_abs_err": k1["max_abs_err"][name],
                        "name": name, "launches_path": "serving",
                        "per_train_step": k1_128["per_forward"][name]})
    kernels.append({"ms": k2["ms"], "plain_ms": k2["plain_ms"],
                    "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
                    "library_ms": k2["library_ms"],
                    "max_abs_err": k2["max_abs_err"],
                    "name": "maxpool3x3s2", "launches_path": "serving"})
    for name in ("scale_bias_act_bwd", "scale_bias_act_res_bwd"):
        kid = KERNEL_IDS[name]
        kernels.append({**k1_bwd["per_step"][name], "library_ms": None,
                        "max_abs_err": k1_bwd["max_abs_err"][name],
                        "name": name, "launches_path": "training",
                        "kernel": "scale_bias_act_bwd_cluster_kernel",
                        "instances": {
                            inst: use for inst, use in
                            k1_bwd["instances"].items()
                            if inst.startswith(kid)},
                        "repeat_and_two_stream_bits_equal": True})
    for name in ("maxpool3x3s2_argmax", "maxpool3x3s2_bwd"):
        kernels.append({**k2_train[name], "name": name,
                        "launches_path": "training"})
    for name in ("lrn", "lrn_bwd"):
        kernels.append({**k3["per_step"][name],
                        "max_abs_err": k3["max_abs_err"][name],
                        "name": name, "launches_path": "alexnet"})
    for name in ("attention", "attention_bwd_dq", "attention_bwd_dkdv"):
        kernels.append({**{key: k4[name][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "backward_ms", "backward_bound_ms", "noncausal_ms")
            if key in k4[name]},
            "max_abs_err": k4["max_abs_err"][name], "name": name,
            "launches_path": "transformer"})
    paths = {"serving": (served, TRAIN_LAUNCHES),
             "training": (session, TRAIN_LAUNCHES),
             "alexnet": (alex_session, ALEX_TRAIN_LAUNCHES),
             "transformer": (lm_run, LM_TRAIN_LAUNCHES)}
    tcp = phase25["resnet"]
    for k in kernels:
        src, replaces = KERNEL_SOURCES[k["name"]]
        if k["name"] in tcp["f32"]["launches_per_batch"]:
            k["tcp_launches_per_batch"] = {
                wd: r["launches_per_batch"][k["name"]]
                for wd, r in tcp.items()}
        runs, per_step = paths[k["launches_path"]]
        kid = KERNEL_IDS[k["name"]]
        k.update(id=kid, route="cuda", source=src,
                 replaces=replaces,
                 launches=runs["launches"][k["name"]],
                 train_launches_per_step=per_step[k["name"]],
                 train_session_launches=session["launches"][k["name"]],
                 zoo_launches={label: run["launches"][k["name"]]
                               for label, run in zoo["sessions"].items()
                               if run["launches"].get(k["name"])},
                 async_launches={rule: run["launches"][k["name"]]
                                 for rule, run in
                                 phase21["sessions"].items()
                                 if run["launches"].get(k["name"])})
        if k["name"] in TRAIN_LAUNCHES and (
                TRAIN_LAUNCHES[k["name"]] or RESNET_VAL_LAUNCHES[k["name"]]):
            p23 = phase23["launcher"]["launches"]
            k["ingest_launches"] = {
                "in_process": phase23["ingest"][0]["launches"][k["name"]],
                "launcher_train": p23["train"][k["name"]],
                "launcher_val": p23["val"][k["name"]]}
        if k["name"] in _K4:
            i = _K4.index(k["name"])
            k["lm_variant_launches_per_step"] = {
                kind: r["launches_per_step"][i]
                for kind, r in phase24["timing"].items()}
            k["sp_strategy_launches"] = {
                name: r["launches"][i]
                for name, r in phase24["attention"].items()}
        if k["name"] in phase27["entry"]["launches"]:
            k["entry_launches_per_call"] = phase27["entry"]["launches"][
                k["name"]]
        if k["name"] in phase27["dryrun"]["per_step"]:
            k["dryrun_launches"] = {
                leg: r["launches"][k["name"]]
                for leg, r in phase27["dryrun"]["legs"].items()}
        if k["name"] in ("lrn", "lrn_bwd"):
            k["native_fed_step_launches"] = phase27["native"]["step"][
                "native"]["launches"][k["name"]]
            k["remote_launches"] = {
                **{f"launcher_{label}": run["launches"][k["name"]]
                   for label, run in phase22["launchers"].items()},
                "aggregated_easgd":
                    phase22["aggregated"]["launches"][k["name"]],
                **{f"schedule_{rule.lower()}_{wire}":
                   r["launches"][wire][k["name"]]
                   for rule, r in phase22["schedules"].items()
                   for wire in r["launches"] if wire != "in_process"}}
        per_zoo_step = {label: {key: t[kid][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
            if key in t[kid]}
            for label, t in zoo["kernel_times"].items() if kid in t}
        if per_zoo_step:
            k["zoo_per_step"] = per_zoo_step
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "k1_cases": k1["cases"],
                   "k2": k2, "served": served, "trace": traced,
                   "k1_cases_batch128": k1_128["cases"],
                   "k1_bwd_cases": k1_bwd["cases"], "k2_train": k2_train,
                   "grad_check": checked, "session": session,
                   "train_step_trace": step_trace, "k3": k3,
                   "alexnet_grad_check": alex_checked,
                   "alexnet_session": alex_session,
                   "alexnet_step_trace": alex_trace, "k4": k4,
                   "lm_grad_check": lm_checked, "lm_session": lm_run,
                   "lm_step_trace": lm_trace, "checkpoint": ckpt,
                   "rest_of_bsp": rest, "zoo": zoo, "phase19": phase19,
                   "phase20": phase20, "phase21": phase21,
                   "phase22": phase22, "phase23": phase23,
                   "phase24": phase24, "phase25": phase25,
                   "phase26": phase26, "phase27": phase27,
                   "seconds": time.monotonic() - _STARTED,
                   "kernels": kernels,
                   "note": "kernel ms/plain_ms/bound_ms of the fused BN "
                           "epilogue are per batch-32 forward (K1a/K1b; "
                           "per_train_step: per batch-128 step) or per "
                           "batch-128 step (K1c/K1d), summed over the "
                           "launches; max-pool per launch; LRN per "
                           "batch-128 AlexNet step (both shapes, bf16; "
                           "K3b's library_ms is F.local_response_norm's "
                           "forward+backward less its forward).  "
                           "launches: the served run (launches_path "
                           "serving), the ResNet training session or "
                           "the AlexNet launcher session (alexnet); K4 "
                           "per launch at (8, 1024, 12, 64) bf16 causal "
                           "(bound: operations at the bf16 tensor-core "
                           "rate), launches in the TransformerLM session "
                           "(transformer: 32 steps + 2 validation "
                           "batches); each K4b entry's plain_ms and "
                           "library_ms (SDPA's backward: forward+backward "
                           "less forward) are the whole backward's, to "
                           "read beside its backward_ms (both passes) and "
                           "backward_bound_ms.  zoo_launches: each phase-18 "
                           "session's launches (steps + validation); "
                           "zoo_per_step: phase 18 (d)'s times summed per "
                           "training step of each zoo model (K1a/K1c at "
                           "unit scale, batch 64; K3 at GoogLeNet's batch-64 "
                           "and Cifar10's batch-128 shapes); "
                           "async_launches: each phase-21 session's "
                           "launches (two AlexNet workers sharing the "
                           "card, iterations + validation); "
                           "remote_launches (K3): each phase-22 run's "
                           "launches: the launchers (one worker, 4 "
                           "iterations + 1 validation batch), the "
                           "aggregated two-worker EASGD session, and the "
                           "remote round-robin schedules (no "
                           "validation); ingest_launches (K1, K2): "
                           "phase 23's in-process ingest-fed steps and "
                           "its launcher run's train and validation "
                           "launches; lm_variant_launches_per_step (K4): "
                           "phase 24 (e)'s launches per bf16 step of each "
                           "LM variant (dp, remat, tp, pp, moe) at 12 "
                           "layers; sp_strategy_launches (K4): phase 24 "
                           "(a)'s launches of one forward and backward "
                           "of each sequence-parallel strategy; "
                           "tcp_launches_per_batch (K1a, K1b, K2a): phase 25 "
                           "(a)'s launches per batch-32 ResNet-50 infer over "
                           "TCP, by export dtype; entry_launches_per_call "
                           "(K1a, K1b, K2a): phase 27 (b)'s entry() forward; "
                           "dryrun_launches (K1, K2b, K2c): phase 27 (c)'s "
                           "dryrun legs (one train_iter each); "
                           "native_fed_step_launches (K3): phase 27 (d)'s "
                           "native-fed Cifar10 step"},
                  f, indent=1)
    log(f"whole script: {time.monotonic() - _STARTED:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
