#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises, and the script then exits non-zero
without printing a result line:

1. Environment: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions.  Exits non-zero when CUDA is not available.
2. Build: compiles the hand-written kernels from ``tensor_ops_tpu_torch/
   csrc/`` with ``nvcc`` (``sm_90a``), one compiler per source, all at
   once, and prints ptxas' resource report.
3. Kernels: each kernel against its plain PyTorch version on the same
   inputs, TF32 off, ``torch.cuda.synchronize()`` after every launch.
   ``fused_linear``: every instance of ``linear_plan`` (gemv, tile with K
   split over blocks, large) at the flagship's layers for B = 1 to 512,
   K = 13 and 783 (scalar loads) and 4096^3, every activation with and
   without z, each shape rerun bit for bit, and with bf16 operands (y to
   one bf16 ulp of the plain y, z to 1e-4 + 1e-5|z|, each launch counted,
   the backward's dtypes those of the JAX VJP).  The whole-chain forward
   (one cluster of 16 blocks per row tile) at the flagship for B = 1, 8, 32
   and 63 and at 33-20-7 for B = 37, with and without softmax, each rerun
   bit for bit.  The train step at B = 1 to 1000 and both loss kinds, and
   twice on one input, bit for bit.
4. Serving slice: the flagship MNIST MLP 784-300-100-10 (random weights,
   seed 0) is saved with ``save_network`` and served through the serve app
   (``tensor_ops_tpu_torch.apps.serve.main``) and through a per-layer
   ``Predictor``; the served probabilities are held against the port's IR
   forward on the card and a CPU float64 run of the same checkpoint.  Both
   serving kernels must have been launched by this phase.
5. Training slice: the mnist app (``tensor_ops_tpu_torch.apps.mnist.main``)
   trains the flagship for one epoch of the synthetic set (6,000 rows,
   batches of 1,000) through ``--minibatch 100 --fused`` (the train-step
   kernel must have been launched) and through ``--minibatch 100``; the
   training error must fall in both.  Then 5 steps of ``train_fullfused``
   on the card are held against ``FusedMLP.train`` on the card and the
   plain step in CPU float64.
6. int8 kernels: ``fused_linear_w8`` at the flagship's three layers (B = 1,
   8, 16, 17, 37, 64 and 512) and ragged shapes, both precisions, logistic
   and identity, covering every instance of ``w8_plan`` (gemv, the bf16
   tensor-core tile, the "highest" SIMT tile) with and without a split of
   K, each rerun bit for bit; ``fused_linear_w8a8`` at the flagship's
   layers (B = 1, 8, 37, 64 and 512), B = 20, a misaligned 257-wide case
   and the 4096-wide layer, each on ``w8a8_plan``'s instance and on the
   other one (the quantizer and product under programmatic dependent
   launch, and the one launch), covering both with and without a split of
   K over a cluster and every row tile, each rerun bit for bit, and its
   int32-exact cases (B = 37 at K = 4096, and K = 200); and
   ``fused_mlp_w8a8_forward`` (one cooperative launch a forward) at the
   uniform serving stack (4 x 4096, seed 0, B = 16, 5, 64 and 100, the last
   in two row groups) and 3 x 512 logistic at B = 37, each bit for bit
   against the per-layer CUDA chain, on a rerun and (relu) against its
   plain version; its int32-exact cases (one layer of 256 at B = 16 and 37,
   of 8192 at B = 16); and the refusal of a grid larger than the card
   holds.
7. int8 serving slice: the serve app serves the phase-4 checkpoint with
   ``--int8`` (3 ``fused_linear_w8a8`` launches per request), a ``mode="w8"``
   ``quantized_mlp`` checkpoint of it (``fused_linear_w8``), and the 4 x 4096
   stack saved with ``save_quantized`` (``fused_mlp_w8a8_forward``); each
   is held against the plain ``QuantizedMLP`` on the CPU, and the int8
   classes against the f32 ones; a request's graph holds 3, 3 and 1
   launches (the app's one request captures it: its warm-up forward
   launches them once more).
8. Recurrent kernel: ``fused_rnn_step`` against its plain version at the
   recurrent slice's shapes (B = 1 and 256, 32 -> 512) and ragged ones (B =
   37 and 5, 3 -> 45), every activation, bit for bit on a rerun, and the
   gradients of its ``autograd.Function`` against autograd through the
   plain version.  The sequence kernel (one cluster launch per sequence)
   against ``fused_rnn_seq_ref`` and bit for bit against n step launches
   at 32 -> 512 (n = 64, B = 1 and n = 8, B = 4) and 3 -> 45 (n = 5), every
   activation, bit for bit on a rerun; the "steps" plan at 32 -> 1024.
9. Recurrent slice: the Elman 32 -> [512] -> 32 model of
   ``scratch/fit_seq_realized.py`` (random weights, seed 7) is saved with
   ``save_recurrent`` and 8 sequences of 64 steps are served through the
   serve app (``--probs`` trajectories, then ``--bench --seq-len 64``),
   held against the port's ``SequencePredictor`` on the CPU in float64;
   ``FusedRNN(impl="pallas")`` built from the served model's cell runs the
   8 sequences, one launch of the sequence kernel each (8
   ``fused_rnn_step.seq`` launches, no ``fused_rnn_step``), and the served
   trajectories are rebuilt from its outputs; five ``FusedRNN.train``
   steps on the two impls and in CPU float64 agree; the sequence gradient
   is bit-identical with and without ``offload_tape``.
10. Collectives (kernels 8-9): the one-shot, through ``ring_all_reduce``
   (one-way) and ``ring_all_reduce_bidir`` / ``ring_reduce_scatter`` /
   ``ring_all_gather``, against ``oneshot_ref`` and the ring protocol's
   plain version at R = 2, 3, 4 and 8 ranks on one card, int32 and f32
   N(0, 1), on the JAX tests' shapes and the flagship's six parameter
   shapes, f32 ar and rs also with the 1/R scale, bit for bit; the ring
   protocol (``_ring_cuda``, the route of ranks on several cards) called
   directly against its plain version at R = 2, 4 and 8; two protocol calls
   back to back on one scratch; rs then ag against ar on both routes; and,
   in a second interpreter with a time limit, the refusal of more ranks
   than one launch takes (both routes) and of a cooperative grid larger
   than the card holds.  With two or more cards, the wrappers at one rank
   per card against the plain versions; otherwise one line says it was not
   run.
11. Data-parallel slice: the flagship (random weights, seed 0, as
   ``gen_net`` draws them) for 5 steps of ``dp_megakernel_train_step`` at 4
   ranks x 100 rows of the synthetic set, on the bidirectional and the
   one-way ring: ranks bit-identical after every step, step 1 against one
   ``fused_mlp_train_step`` on the 400-row batch, 5 steps against the plain
   dp step in CPU float64, the loss falls, and 4 train-step and 6 one-shot
   launches per step (the 1/n inside them; no ring-protocol launch).  Then
   the JAX call's form, a ``Mesh`` and ``axis="data"``, for 5 steps on
   ``make_mesh(4, shape=(4, 1))`` and on ``(2, 2)`` of the card's ranks:
   every step bit-equal to ``RankGroup(4)``'s and ``RankGroup(2)``'s run on
   the same 400 rows, every rank's parameters bit-identical, and 4
   train-step launches and 6 one-shot launches per data group a step (6 on
   (4, 1), 12 on (2, 2)).
12. Fit slice: the flagship (random weights, seed 0, as ``gen_net`` draws
   them on the card) through ``fit`` (adam, lr 0.02, B = 100, 2 epochs =
   120 steps of the synthetic set's 6,000 rows, its 1,000 test rows as
   ``val`` every 10 steps, ``metrics_path``, a checkpoint every 60 steps):
   the loss falls, the metrics record equals the history, the loader is
   the native one; a crash/resume chain (1 epoch, then ``resume=True`` to
   2) and runs with ``prefetch=2`` and ``prefetch=0`` are bit-equal to it;
   5 sgd steps over the first 500 rows against the same ``fit`` on the CPU
   in float64 (``TOL_5_STEPS``); samples/s over steps 11-120 and the first
   step's wall time from ``fit``'s start, of the first fit on this network
   in the process (the ``prefetch=2`` run) and warm (the ``prefetch=0``
   run, the last), from the history's host-clock stamps, each after a
   synchronise; one step's wall time, kernels, device busy time and idle
   share; the peak device memory of the run.
13. Autoencoder: ``Encoder`` 784 -> 128 -> 32 -> 128 -> 784 (logistic,
   seed 0) and ``FusedAutoencoder.from_encoder``: 5 ``train`` steps at
   B = 100 of synthetic rows/255, exactly 5 train-step launches (the
   squared-error mode at 4 layers), held against ``FusedMLP.train`` on the
   card and the plain step in CPU float64 (``TOL_5_STEPS``); kernel 3's
   device time at this shape beside its bound; ``Encoder.fit`` for 2
   epochs with the reconstruction loss falling; a ``save_autoencoder`` ->
   ``load_autoencoder`` round trip, bit for bit.
14. Dots app: ``tensor_ops_tpu_torch.apps.dots torch --minibatch 50`` on
   the card, its render and time.
15. Timing: p50 serving latency per bucket, each kernel's time beside its
   plain version's (median of 50 CUDA-event-timed runs after warm-up), the
   profiler's device time of the kernels, where one training step's, one
   int8 request's and one recurrent request's time goes on each route
   (wall, kernels, device busy, the kernels by name), the device memory
   each served model holds (f32 vs int8), kernel 5 per layer at the
   flagship's B = 8, 64 and 512 and at 4096^2, B = 16 and 64, in turns with
   its other instance, kernel 4, kernel 1 (f32) and ``torch._int_mm`` (the
   bare product) on the same weights and codes (device time per call in a
   CUDA graph, profiler time, events, bound), kernel 4 per layer at B = 8,
   64 and 512 in turns with kernel 1 on the same weights in f32, kernel 6's
   device time (back to back and with L2 flushed), weight-stream rate and
   event median beside the per-layer chain (and both in CUDA graphs), the
   app's training samples/s per route, a FusedRNN
   sequence's wall and device time, launches, idle share and bound, kernel
   2's device time and event median at B = 1, 8 and 63 beside its bound, its
   plain version and kernel 1's three per-layer launches, kernel 1's
   device time and event
   median against ``torch.addmm``'s in turns over 3 repetitions beside its
   bound at the identity layer, 784->300 at B = 8, the three flagship
   layers at B = 100 and 4096^3, kernel 3 at B = 100, 400 and 1000 with
   its grid and barrier count, each collective phase at the flagship's
   300x784 weight on 4 ranks (the one-shot in turns with one PyTorch call
   over 3 repetitions, its plain version, its device time against the
   bound; the ring protocol beside it), and a dp step's wall time, profile
   (14 kernels, 6 one-shot launches) and samples/s on each route beside a
   single-rank ``train_fullfused`` step on the same 400 rows.
16. Recurrent fit slice (this phase and the next two run after every
   profiled phase above: run before them, they left the profiler losing
   device events): ``fit_sequences`` on the recurrent model of phase 9
   (seed 7) at the full size of ``scratch/fit_seq_realized.py``: 4,096
   sequences of 64 steps (inputs and targets standard normal, seed 0),
   batch 256, dual-rate SGD for 2 epochs (32 steps): the loss falls and
   the caller's network is unchanged; a crash/resume chain (1 epoch, then
   ``resume=True`` to 2) is bit-equal to the straight run; ``accum_steps=2``
   against the whole-batch step (``TOL_5_STEPS``); adam with ``ema_decay``
   and ``accum_steps=2``, interrupted by a Ctrl-C at step 2 and resumed,
   bit-equal to the straight run, EMA included; ``offload_activations``
   bit-equal; 3 steps of 128 sequences against the same loop on the CPU
   in f64, run in a second interpreter (within 1e-5 plus twice the CPU
   f32 run's drift);
   sequences/s over steps 2-32 and the first step's time from the
   history's host-clock stamps, and the peak device memory.
17. Production fit: ``tensor_ops_tpu_torch.examples.production_fit`` on
   the card (fit with adamw, a cosine schedule, clipping and EMA; a crash
   and a resume to the full budget; the EMA net served in int8 by
   ``Predictor``): the served accuracy above 0.9 and exactly 2 launches of
   ``fused_linear_w8a8`` per request (its graph's replay) and per bucket's
   capture at warm-up (its warm-up forward); kernel 5 at the served
   2 -> 32 -> 2 shapes (B = 8, 64 and 512) bit-equal to its plain version,
   and its device time per call at B = 64 beside its plain version's and
   its bound.
18. adam8bit fit: the flagship through ``fit`` with ``adam8bit`` (nearest
   rounding) for 2 steps of B = 100, each step also taken from the card's
   state on the CPU in f64 and f32 (the card within 1e-5 plus twice the CPU
   f32 step's distance from f64; the share of int8 moment codes that
   differ; the largest parameter), the replay bit-equal to the fit; a
   Ctrl-C at step 1 whose checkpoint, resumed to the budget, is bit-equal
   to the straight run.
19. Recurrent fit timing: one ``fit_sequences`` step's wall time, kernels,
   device busy time and idle share (its profile holds some 10,000 kernel
   events).  Phases 12, 16, 18 and 19 run one step at a time
   (``chain_steps=1``); phases 20-22 run in a second interpreter.
20. Fit chained: the fit slice's configuration (with ``ema_decay``) with
   ``chain_steps=1`` and ``"auto"`` in turns: parameters, EMA and history
   bit-equal, samples/s over steps 11-120 of each, one capture a chained
   run (its host time) and one graph replay a step, the peak device
   memory; one unchained step and one chained window of 10 steps profiled
   (per step: host-issued graph launches, kernel launches and copies, the
   card's kernels, busy time and idle share); ``chain_shuffle="device"``
   and ``"device_fixed"``: each epoch visits every row once (the row tables
   the graph read on the card), window caps 4 and 10 and a crash/resume
   chain bit-equal; ``adam8bit`` with stochastic rounding chained against
   unchained, bit-equal.
21. fit_sequences chained: phase 16's run with ``chain_steps=1`` and
   ``"auto"`` in turns, bit-equal, sequences/s; one chained window of 4
   steps profiled.
22. Mixed precision: the router's f32 and bf16 step times and decision at
   the flagship (B = 100) and at 784 -> 2048 -> 2048 -> 10 (B = 128); a
   bf16 flagship run learns on f32 masters; one bf16 sgd step's gradients
   against the full-precision step in CPU f64 (``TOL_BF16_GRAD``); the bf16
   step's product kernels by name (bf16 tensor-core GEMMs).
23. The mesh's data axis, in a second interpreter: the flagship through
   ``fit`` on ``make_mesh(4, shape=(4, 1), devices=["cuda"] * 4)`` (4
   ranks on the card, 25 rows each of B = 100; adam, lr 0.02, one epoch of
   the synthetic set = 60 steps), replicated, ``shard_opt_state``,
   ``zero_stage`` 2 and 3, ZeRO-3 with ``offload_opt_state``, and
   ``adam8bit`` (stochastic rounding) replicated and with
   ``exact_reduction`` at ZeRO-3: the loss falls in each; kernel 9's
   launches by phase (ar, rs, ag) equal ``MESH_RUNS``' prediction; ZeRO-1
   bit-equal to the replicated run, ZeRO-2 within ``TOL_MESH``, ZeRO-3
   bit-equal to ZeRO-2, offload to ZeRO-3, exact adam8bit to replicated
   adam8bit; a Ctrl-C at step 30 of ZeRO-3, resumed, bit-equal; 5 sgd steps
   against ``fit`` on one device (``TOL_5_STEPS``); each rank's resident
   bytes equal ``training_memory_report``'s rows; samples/s over steps
   11-60 of each; one ZeRO-3 step's wall time, profile and idle share.
   Then ``fit_sequences`` (phase 9's model, adam, ZeRO-2, 4 steps of 256
   sequences) against one device within ``TOL_SEQ_FIT`` plus twice the
   distance ``accum_steps=4`` makes.  With 4 or more cards the replicated
   and ZeRO-3 runs also run on 4 cards (the ring protocol), bit-equal to
   the one-card runs (a one-card machine skips them).
24. The mesh's model axis, in the same interpreter after phase 23: the
   flagship served through ``shard_fused`` + ``Predictor`` on meshes
   (1, 4) and (2, 2) of the card at buckets 1, 8, 32, 128 and 512, each
   result within 1e-5 of ``run_xla`` on one device and of the CPU f64
   run, ``fused_linear`` and ``fused_mlp_forward`` never launched, kernel
   9's launches per request equal to ``TP_SERVE``; 784 -> 2048 -> 2048 ->
   10 served on (1, 4): p50 per request, kernels, busy time and idle
   share.  ``fit`` through the tensor-parallel executor on (2, 2)
   (replicated, ZeRO-1/2/3, ZeRO-3 with offload) and (1, 4): kernel 9's
   launches equal ``TP_RUNS``; ZeRO-1 bit-equal to the replicated run,
   ZeRO-3 to ZeRO-2, offload to ZeRO-3, a Ctrl-C at step 30 of ZeRO-3
   resumed bit-equal; samples/s over steps 11-60; 5 sgd steps on each mesh
   within ``TOL_5_STEPS`` of one device; one ZeRO-3 step's wall, profile
   and idle share.  Then ``fit_sequences`` on (2, 2), its Elman cell split
   over the model axis (``parallel/tp_seq.py``: each model rank its rows
   of the state weight, the state all-gathered at each timestep, no weight
   gathered, no warning), with adam and with dual-rate sgd, against one
   device within ``TOL_5_STEPS`` (the loss curves; the leaves after sgd)
   and against the one-device run in f64 on the card within a floor plus
   twice the one-device f32 run's drift (losses and leaves), and the sgd
   run with ``remat_every`` and ``offload_activations`` against the sgd
   run; kernel 9's launches equal to ``tp_seq_predicted``.
25. The pipelines, in the same interpreter after phase 24: a
   ``PipelineMLP`` 784 -> 2048 x 8 -> 10 (random weights, seed 25), B =
   512, through ``parallel.pipeline`` on the card with its ranks named
   several times: GPipe on (4,) (4 stages of 2 layers, M = 4), dp x pp on
   (2, 2), dp x pp x tp on (2, 2, 2) (2 stages of 4 layers) and the
   circular schedule on (2,) (4 stages of 2 layers, V = 2) at M = 2 and at
   M = 4 (a FIFO of depth 2): each forward and 5 SGD steps (lr 0.01) held to
   the one-device sequential net on the card (TF32 off) and to the
   sequential net in CPU f64 (``TOL_P`` forward, ``TOL_5_STEPS`` losses and
   parameters), kernel 9's launches per forward and per step equal to
   ``pipe_predicted``; one GPipe step's wall time, samples/s, profile and
   idle share; and the Predictor of a (2, 1) ``shard_fused`` model (nothing
   sharded) serving bucket 8 from a request graph of one
   ``fused_mlp_forward`` launch.
26. The staged-IR pipelines, in the same interpreter after phase 25
   (``parallel.ir_pipeline``, random weights from seed 26, each weight over
   the square root of its fan-in): the uniform 784 -> 2048 x 9 -> 10 chain
   (a pre of 784 -> 2048, a body of eight 2048 -> 2048 segments, a post of
   2048 -> 10) at B = 512 through GPipe on (4,) and (2, 2) and the circular
   schedule on (2,) at M = 2 and 4; the flagship's heterogeneous cut on
   (3,) and (2, 2) (B = 100); the autoencoder 784 -> 128 -> 32 -> 128 ->
   784's heterogeneous circular cut on (2,): each forward, gradient and 5
   SGD steps (lr 0.01) held to the one-device plain chain on the card (TF32
   off) and to CPU f64 (``TOL_P`` / ``TOL_5_STEPS``), kernel 9's launches
   equal to ``irp_predicted``.  Then ``fit`` on those meshes: 5 sgd steps
   on (2, 2) (flagship) and (4,) (uniform) held to ``fit`` on one device,
   the flagship on (2, 2) through the ZeRO rungs (``IRP_FIT_RUNS``'
   launches; ZeRO-1 bit-equal to replicated, ZeRO-3 to ZeRO-2, offload to
   ZeRO-3), in bf16 (its loss falls), and with ``accum_steps=2`` stopped by
   Ctrl-C and resumed bit-equal; a circular resume of a GPipe checkpoint
   refused; the autoencoder on a stage mesh with a model axis of 2, (1, 2,
   2), trains; the uniform chain's ``fit`` on (4,) at B = 512: samples/s
   over steps 11-20, one step's wall, kernels, busy time and idle share.
27. The tensor-parallel pipelines, in the same interpreter after phase 26
   (phase 26's chains, weights and batches): the uniform chain's body
   row-split over the model axis through GPipe on (2, 2, 2) and the
   circular schedule on (1, 2, 2) (M = 4, V = 2, B = 512); the flagship's
   hetero-tp cut on (1, 3, 2) and the autoencoder's hetero-tp circular
   cut on (1, 2, 2) (B = 100): each forward, gradient and 5 SGD steps held
   to the one-device plain chain on the card and to CPU f64, kernel 9's
   launches equal to ``irp_tp_predicted`` (its all-gathers over each model
   group between segments and their reduce-scatter transposes among
   them).  Then ``fit`` of the uniform chain on (2, 2, 2): 5 sgd steps
   held to ``fit`` on one device, the ZeRO rungs (``IRP_TP_FIT_RUNS``'
   launches; ZeRO-1 bit-equal to replicated, ZeRO-3 to ZeRO-2, offload to
   ZeRO-3), ``accum_steps=2`` stopped by Ctrl-C and resumed bit-equal, and
   20 adam steps at B = 512: samples/s, one step's wall, kernels, busy
   time and idle share.  The CPU f64 comparisons of phases 26 and 27 run
   after both.
28. Several processes, in an interpreter of its own with a time limit
   (``procs_main``: it is process 0 and starts process 1, both
   ``init_distributed`` through the ``TOPS_*`` variables, 2 ranks each on
   the card): kernels 8-9 over the 4 ranks of both processes (ar with and
   without the 1/n scale, rs, ag, the one-way ring; f32 and int32) bit-equal
   to the plain version in every process; the flagship's ``fit`` on (2, 2)
   (data across the processes; ZeRO-3, adam, B = 512, 2 steps with a
   checkpoint from process 0, then a resume to 5), ``fit_sequences`` of the
   Elman 32 -> [512] -> 32 on (2, 2) and the uniform chain's staged-IR
   ``fit`` on (data=2, stage=2) and on a stage-only (4,) mesh across the
   processes (B = 512, M = 4, 3 sgd steps): each bit-equal to the same
   mesh's ranks in one process (the same batches: each process's loader
   shard, concatenated), within TOL_5_STEPS of CPU f64 (an adam run's
   parameters within TOL_MESH, as phase 23's), and kernel 9's calls across
   processes equal to ``proc_predicted``, every one a launch of the
   one-shot over IPC (none through the host); and 3 steps of the
   flagship's ``dp_megakernel_train_step`` on a ``(4,)`` data mesh of both
   processes' ranks (B = 512), bit-equal to one process and within
   TOL_5_STEPS of CPU f64, 2 train-step launches a process a step, 6
   cross-process one-shots a step (``proc_predicted``) and the loss's
   other ranks in one gather over gloo a step; a step's samples/s, wall,
   kernels, busy time and idle share of the flagship, the (4,) chain and
   the dp step, beside the same step in one process.
   ``chip_smoke.cards_main()`` runs only the phases that need several
   cards (the cross-card ring, these 4-card runs, the (2, 2) and (1, 4)
   fit runs with one rank a card, the (4,) GPipe run, the uniform chain's
   staged-IR ``fit`` on (4,) with one stage a card and on (1, 2, 2) with
   one rank a card, each bit-equal to one card, and phase 28's
   collectives, the flagship's ``fit`` on (4, 1) and the chain's on (4,)
   in 4 processes of one card each, on the ring protocol over CUDA IPC,
   bit-equal to one process on the 4 cards) on a four-card machine.
29. Tooling, in an interpreter of its own with a time limit
   (``tooling_main``; its plan cache a temporary file named by
   ``TENSOR_OPS_TPU_TORCH_PLAN_CACHE``): each of the seven
   ``ops.autotune`` sweeps at a main-path shape (kernel 1 at the flagship's
   three layers for B = 8 and 100, kernel 2 at B = 8, kernel 3 at B = 100,
   kernels 4 and 5 at 784 -> 300 for B = 8, kernel 6 at 3 x 512 for B = 16,
   kernel 7's sequence at 32 -> 512 for B = 1): every candidate held to the
   plain version (kernels 5 and 6 bit for bit) and rerun bit for bit, the
   rule's plan among them, the winner on disk with its provenance and seen
   by a fresh ``TileCache``, the wrappers' next call at the shape on the
   tuned plan and bit-equal to an explicit ``plan=`` call, each winner's
   µs beside the rule's; ``profile_step`` of a ``train_fullfused`` step at
   B = 100 counting the flops of the plain step on the CPU, its rates below
   the f32 peak and the memory rate; the NaN checks (a NaN through
   ``fused_linear`` raises naming it, one first made in a backward on
   autograd's device thread raises, neither with the checks off);
   ``device_trace`` over a bucket-8 request and a ``train_fullfused`` step
   holding kernels 2's and 3's device events; ``fit(profile_dir=...)`` of
   the flagship (6 steps) writing a trace with device events, bit-equal to
   ``chain_steps=1``; ``examples/plan_and_budget.py`` on the card, its
   ``memory_analysis`` of the forward at B = 4096 exactly X and the
   parameters in and B x 10 f32 out; and nothing written under
   ``~/.cache/tensor_ops_tpu_torch`` (its listing the same before and
   after).  The sweeps time each plan's device time in a CUDA graph
   (kernel 7's routes as the host launches them), and a plan replaces the
   rule only where it is faster by more than the rounds' spread.
   Phases 1-28 run with ``TENSOR_OPS_TPU_TORCH_PLAN_CACHE`` on an empty
   temporary file, so every plan there is the fixed rule's.
30. The dry run, in an interpreter of its own with a time limit
   (``dryrun_main``): ``tensor_ops_tpu_torch.dryrun``'s runs of
   ``dryrun_multichip(8, devices=["cuda:0"] * 8)``, each run's loss, wall
   time and launches: every key of ``DRYRUN_KEYS`` (the JAX dry run's runs),
   every loss finite, the dry run's own checks (the ZeRO rungs against the
   replicated adam run at 1e-5, the flagship's hetero and hetero-tp cuts
   against the sequential step at 1e-6, the cuts' types, the sharded
   ``Predictor`` and its ``reload``), and its dp-megakernel step's 8
   train-step and 4 one-shot launches; then ``entry()`` on the card:
   (32, 10), rows summing to 1 within 1e-5, within 1e-5 of
   ``entry(device="cpu")`` run in f64.
31. Request graphs, in an interpreter of its own with a time limit
   (``graphs_main``): the flagship (random weights, seed 0) served by
   ``Predictor`` at buckets 1, 8, 32, 128 and 512 on each single-device
   route (f32 through kernel 2 below ``xla_threshold`` and ``run_xla``
   above, f32 per layer through kernel 1, bf16, w8 through kernel 4, w8a8
   through kernel 5) and as a staged-IR ``Network``, the 4 x 4096 int8
   stack at B = 16 (kernel 6) and the recurrent model of phase 9 by
   ``SequencePredictor`` at buckets 8 and 256, n = 64: each bucket's
   request, served from its CUDA graph, bit-equal to the private direct
   forward, its kernel launches (the graph's, counted at the replay) equal
   to the direct forward's; 600 rows captured at first use (bucket 1024);
   every bucket replayed again in reverse order after the last capture,
   still bit-equal; by ``torch.profiler`` one graph launch a request and
   the hand-written kernels in it (``GRAPH_KERNELS``); host-clock p50s
   graph against direct in interleaved rounds, with the idle share of the
   request at buckets 8 and 512; kernel 5's two instances at bucket 8, each
   by a request graph captured with it; the JAX package's serving soak (4
   threads, 6 reloads alternating the flagship in f32 and w8a8), at bucket
   8 and at bucket 128 (``run_xla``, cuBLAS, against kernel 5): no error,
   every response bit-equal to one model's direct forward, captures only
   in warm-up and reload; a shuffled stream of 12 sequence lengths on an
   unwarmed ``SequencePredictor``: one capture a length, each response
   bit-equal, first-use and replay p50s; and the device bytes the graphs
   of a flagship, a stack and a sequence predictor hold.
32. Compiled entry points, in an interpreter of its own with a time limit
   (``compiled_main``): every entry point the JAX package jits, on the card
   from one CUDA graph per shape (``engine``): the engine's compiled
   forward, gradient and VJP behind ``Network``, ``RecurrentNetwork`` and
   ``Encoder``; ``Network.train``; the per-sample fold (1,000 samples) and
   the induction loop (5,000 steps), one captured step replayed once a
   step; ``batched_run`` (``accuracy``, ``confusion``), ``train_minibatch``,
   ``batch_loss``, ``seq_losses``, ``seq_batch_loss`` and
   ``RecurrentNetwork.train_batch``; ``FusedMLP.train`` (kernel 1),
   ``FusedRNN`` at 32 -> 512 (kernel 7's sequence launch) and 32 -> 1024
   (its step launches), ``impl="pallas"`` and ``"xla"``, and ``run_xla``
   at buckets 8 and 64: each bit-equal to its direct call
   (``engine.direct``) at its first call and at a replay, its hand-written
   launches equal, captures at the first call only (one per shape for
   ``run_xla``); the calls that run direct, ``FusedMLP.run`` (kernel 1
   three times) and ``QuantizedMLP.run`` (kernel 4 or 5 three times) at
   buckets 8 and 64 and the one-launch calls, ``train_fullfused`` and
   ``FusedAutoencoder.train`` (kernel 3), ``run_fused_inference`` (kernel
   2) and ``QuantizedMLP.run_fused`` (kernel 6, on a uniform 3 x 1024
   stack): no capture, their launches counted; new rates without a
   capture; each route graph against direct in interleaved turns, a
   direct call direct only (wall per call, kernels and graph launches per
   call, busy time, idle share); ``run_xla``'s graph at the 4 x 4096
   stack, whose static bytes are its input and output rows alone (the
   weights read in place); the
   mnist app's default fold, ``--minibatch 100``, ``--fused`` and
   ``--induce 3`` on the synthetic set with samples/s; the bytes the
   engine's graphs hold.

The second-to-last line is ``{"kernels": [...]}``: per kernel its launches
on its main path (a request served from its graph counts the launches the
graph holds, each time it replays it), its largest difference from its plain version, its time
and its plain version's, its bound (the larger of the bytes it must move
over 3.35 TB/s and its operations over the peak rate of their type) and
the time of one PyTorch call computing the same function (``torch.addmm``
for ``fused_linear``, timed at an identity layer; ``torch.stack(xs).sum(0)``
for the collectives' all-reduce; null where no one call does).  Kernels 8
and 9 appear twice: under their names the one-shot, the one-card route the
dp slice runs; as ``NAME.ring`` the ring protocol, the route of ranks on
several cards, whose launches on the one-card path are 0 and whose times
come from calling it directly; ``bidir_ring``'s launches add the dp step's
mesh form, the mesh, model-axis and the three pipeline phases', process
0's of phase 28 and the dry run's.  ``fused_mlp_train_step``'s are the
``--fused`` mnist run's and the dp step's of the mesh form (phase 11),
process 0's in phase 28 and the dry run (phase 30).  Kernel 7 appears
twice too: as ``fused_rnn_step.seq`` the sequence entry that ``FusedRNN``
runs (8 launches for the 8 served sequences, timed at n = 64, B = 1), and as
``fused_rnn_step`` the per-step entry (the public per-step function and the
"steps" plan of a cell too wide for the cluster: 0 launches on that path,
timed at B = 1).  The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import contextlib
import gc
import glob
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

FLAGSHIP = (784, 300, 100, 10)
FLAGSHIP_ACTS = ("logistic", "logistic", "softmax")
BUCKETS = (8, 64, 512)
TIMED_RUNS = 50
DEVICE = "cuda"
# f32 sums of up to 784 products, added in another order than cuBLAS adds
# them: pre-activations reach |z| ~ 30 and differ by up to ~3e-5, so they
# (and the activations of one layer, whose slope is at most 1) are held to
# absolute 1e-4 plus relative 1e-5; the probabilities a softmax makes of
# the flagship's small logits are held to 1e-5.
TOL_Z = (1e-4, 1e-5)
TOL_P = (1e-5, 0.0)

KERNELS = {
    "fused_linear": dict(
        route="cuda", source="tensor_ops_tpu_torch/csrc/fused_linear.cu",
        replaces="tensor_ops_tpu/ops/pallas_kernels.py:101"),
    "fused_mlp_forward": dict(
        route="cuda",
        source="tensor_ops_tpu_torch/csrc/fused_mlp_forward.cu",
        replaces="tensor_ops_tpu/ops/pallas_kernels.py:288"),
    "fused_mlp_train_step": dict(
        route="cuda",
        source="tensor_ops_tpu_torch/csrc/fused_mlp_train_step.cu",
        replaces="tensor_ops_tpu/ops/pallas_kernels.py:385"),
    "fused_linear_w8": dict(
        route="cuda", source="tensor_ops_tpu_torch/csrc/fused_linear_w8.cu",
        replaces="tensor_ops_tpu/ops/pallas_kernels.py:622"),
    "fused_linear_w8a8": dict(
        route="cuda",
        source="tensor_ops_tpu_torch/csrc/fused_linear_w8a8.cu",
        replaces="tensor_ops_tpu/ops/pallas_kernels.py:725"),
    "fused_mlp_w8a8_forward": dict(
        route="cuda",
        source="tensor_ops_tpu_torch/csrc/fused_mlp_w8a8_forward.cu",
        replaces="tensor_ops_tpu/ops/pallas_kernels.py:823"),
    "fused_rnn_step": dict(
        route="cuda", source="tensor_ops_tpu_torch/csrc/fused_rnn_step.cu",
        replaces="tensor_ops_tpu/ops/pallas_kernels.py:959"),
    # kernel 7's whole-sequence entry (FusedRNN's route), the same library
    "fused_rnn_step.seq": dict(
        route="cuda", source="tensor_ops_tpu_torch/csrc/fused_rnn_step.cu",
        replaces="tensor_ops_tpu/ops/pallas_kernels.py:959"),
    # kernels 8-9 on one card: the one-shot (csrc/oneshot.cuh) under the
    # libraries' names; across cards, the ring protocol (csrc/ring.cuh), its
    # launches counted apart as NAME.ring
    "ring_all_reduce": dict(
        route="cuda", source="tensor_ops_tpu_torch/csrc/oneshot.cuh",
        replaces="tensor_ops_tpu/parallel/collective_kernels.py:46"),
    "bidir_ring": dict(
        route="cuda", source="tensor_ops_tpu_torch/csrc/oneshot.cuh",
        replaces="tensor_ops_tpu/parallel/collective_kernels.py:143"),
    "ring_all_reduce.ring": dict(
        route="cuda", source="tensor_ops_tpu_torch/csrc/ring.cuh",
        replaces="tensor_ops_tpu/parallel/collective_kernels.py:46"),
    "bidir_ring.ring": dict(
        route="cuda", source="tensor_ops_tpu_torch/csrc/ring.cuh",
        replaces="tensor_ops_tpu/parallel/collective_kernels.py:143"),
}
# the kernel libraries: csrc/<lib>.cu, one nvcc each
LIBS = tuple(dict.fromkeys(name.split(".")[0] for name in KERNELS))
RING_NAMES = ("ring_all_reduce", "bidir_ring", "ring_all_reduce.ring",
              "bidir_ring.ring")
SERVE_KERNELS = ("fused_linear", "fused_mlp_forward")
# The uniform int8 serving stack of examples/bench_int8_serving.py:32-46 and
# bench.py:297-321: 4 layers of 4096 x 4096, ReLU, batch 16.
STACK_N, STACK_L, STACK_B = 4096, 4, 16
STACK_ACTS = ("relu", "relu", "relu", "identity")
FLAGSHIP_INT8_ACTS = ("logistic", "logistic", "identity")
W8_TIMED_BATCHES = (8, 64, 512)  # the w8 Predictor's buckets
# kernel 4 against its plain version: the flagship's layers at every w8_plan
# instance (gemv B <= 16, the bf16 mma tile and the "highest" SIMT tile
# above), with and without a split of K, and ragged shapes (K = 257)
W8_SHAPES = tuple((B, FLAGSHIP[i], FLAGSHIP[i + 1])
                  for B in (1, 8, 16, 17, 37, 64, 512)
                  for i in range(3)) + ((5, 257, 130), (40, 257, 130),
                                        (8, 4096, 64), (600, 64, 600))
# kernel 5 against its plain version, each shape on w8a8_plan's instance:
# the flagship's layers at the --int8 buckets and B = 1 and 37 (the one
# launch at B <= 8, the pair above), a row tile of 32 (B = 20), a ragged K
# (257) on each instance, the 4096-wide layer at B = 16 and 64 (whose codes
# need a split of K to fit a block), and a long K over few columns (a split
# over a cluster) at 8 and 37 rows
W8A8_SHAPES = tuple((B, FLAGSHIP[i], FLAGSHIP[i + 1])
                    for B in (1, 8, 37, 64, 512) for i in range(3)) + (
                        (20, 300, 100), (5, 257, 130), (40, 257, 130),
                        (16, 4096, 4096), (64, 4096, 4096), (8, 4096, 64),
                        (37, 4096, 64))
W8A8_TIMED = ((8, 64, 512), (16, 64))  # flagship buckets; 4096^2 batches
# kernel 5's two instances launched as a request launches them, in turns,
# at the one launch's bucket: the flagship's layers, and one 4096^2 layer
W8A8_DIRECT_B = 8
W8A8_TURNS = ("fused", "pdl", "pdl", "fused", "fused", "pdl")
# The H100 SXM's published peaks (NVIDIA's data sheet, dense): the bound of
# a kernel is the larger of its bytes over HBM_BPS and its operations over
# the peak of their type.
HBM_BPS = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
# A logistic or tanh epilogue against its plain version: expf/tanhf in the
# kernel and torch's on the card may differ by a few ulps of values <= 1.
TOL_ACT = (1e-6, 0.0)
# The train step against its plain version: the forward's 784-long sums,
# the gradient's sums over up to 1,000 rows and the update w - lr*g are
# taken in another order than cuBLAS takes them, so each value differs by a
# few f32 ulps of the terms it sums.  The mean loss is held to 1e-6 plus
# 1e-5 of itself (the squared-error losses reach ~80); new weights and
# biases to 1e-5 plus 1e-5 of themselves (weights reach ~3, where one ulp
# is 2.4e-7, and the squared-error gradients are 100x the softmax ones).
TOL_LOSS = (1e-6, 1e-5)
TOL_PARAM = (1e-5, 1e-5)
# Five SGD steps from one start: each step adds its own rounding, and the
# next step's forward and gradient carry the earlier steps' differences on,
# so the bound is five times one step's (5 x TOL_PARAM); against the f64
# plain step the f32 run's own rounding of the parameters adds to that.
TOL_5_STEPS = (5e-5, 5e-5)
TRAIN_RATE = 0.3
# The recurrent model the repo measures (scratch/fit_seq_realized.py:14-18,
# 38-47; BENCH.md:665): Elman 32 -> [512, logistic output and state] -> 32
# logistic, seed 7, sequences of 64 steps, batch 256.  8 sequences are
# served through the app; the SequencePredictor is timed at buckets 8 and
# 256.
RNN_IN, RNN_HIDDEN, RNN_OUT, RNN_N, RNN_SEED = 32, 512, 32, 64, 7
RNN_SEQS, RNN_BUCKETS = 8, (8, 256)
RNN_STEP_SHAPES = ((1, RNN_IN, RNN_HIDDEN), (256, RNN_IN, RNN_HIDDEN),
                   (37, 3, 45), (5, 3, 45))
ACTS = ("identity", "logistic", "relu", "tanh")
# The sequence kernel against n step launches (bit for bit) and its plain
# version: FusedRNN's shape (n = 64, B = 1), its row bound (B = 4) and a
# ragged cell (3 -> 45).  Against the plain loop each step's z is held as
# above (TOL_Z): the weights at 1/sqrt(I + O) scale make the step a
# contraction (|Ws| near 1), so one step's rounding does not grow over the
# sequence, and the final state as z.
RNN_SEQ_SHAPES = ((RNN_N, 1, RNN_IN, RNN_HIDDEN), (8, 4, RNN_IN, RNN_HIDDEN),
                  (5, 1, 3, 45))
TOL_SEQ = TOL_Z
# The step kernel against its plain version: y = z, a 544-long f32 sum in
# another order, is held as the pre-activations above (TOL_Z); s' = act(z)
# to 1e-5 (weights at 1/sqrt(K) scale keep |z| of order 1, where the sums
# differ by ~1e-6 and act has slope <= 1).  Gradients sum over up to 512
# products or 256 rows in another order: 1e-4 + 1e-5 of themselves.
TOL_RNN_S = (1e-5, 0.0)
TOL_RNN_GRAD = (1e-4, 1e-5)
# FusedRNN.train is held over the first 8 steps of a sequence: over all 64
# this random N(0, 0.5) cell of width 512 is chaotic (a parameter step that
# small still raises the sequence loss, and f32 gradients drift from f64's),
# so no f32 run can match f64 there; over 8 steps SGD at this rate lowers
# the loss and the gradients are well-conditioned.
RNN_TRAIN_N, RNN_TRAIN_RATE = 8, 1e-6
# The data-parallel slice: the flagship over DP_RANKS ranks of DP_ROWS rows
# each (global batch 400), DP_STEPS steps of dp_megakernel_train_step.  The
# one-shot is held against its plain version at RING_RANKS ranks, and the
# ring protocol, called directly, against its own at PROTOCOL_RANKS, on the
# JAX tests' shapes (per rank; the leading axis a multiple of R, so that the
# reduce-scatter splits it) and the flagship's six parameter shapes.
DP_RANKS, DP_ROWS, DP_STEPS = 4, 100, 5
# the dp step's mesh form on the card's DP_RANKS ranks, each held to the
# rank group of its data axis's size
DP_MESHES = ((4, 1), (2, 2))
RING_RANKS = (2, 3, 4, 8)
PROTOCOL_RANKS = (2, 4, 8)
# kernels per dp step: 4 train-step launches, 6 collectives, and the
# loss's 3 adds and 1/n
DP_KERNELS_PER_STEP = 4 + 6 + 4
# bf16 fused_linear against its plain version: the f32 pre-activation is
# held to TOL_Z; y = act(z) rounded to bf16 to one bf16 ulp of the plain
# y beyond what z's tolerance carries through act (slope <= 1), since the
# two z's, a few f32 ulps apart, may round to neighbouring bf16 values.
BF16_ULP = 2.0 ** -7
# kernel 1 against its plain version: the flagship's layers at the serving
# buckets, the gemv's edge (16) and the tile's first batch (17), the
# training minibatch (100), and ragged shapes: K = 13 and K = 783 take the
# scalar loads of the gemv and of the tile
LINEAR_SHAPES = tuple((B, FLAGSHIP[i], FLAGSHIP[i + 1])
                      for B in (1, 8, 16, 17, 63, 100, 512)
                      for i in range(3)) + ((7, 13, 5), (33, 40, 10),
                                            (100, 783, 300))
# The fit slice: the flagship (gen_net seed 0) through fit on the
# synthetic set's 6,000 training rows (its 1,000 test rows as val), the
# configuration the mnist app trains; adam, as a production run would.
FIT_EPOCHS, FIT_BATCH, FIT_LR = 2, 100, 0.02
FIT_LOG_EVERY, FIT_CHECKPOINT_EVERY = 10, 60
# samples/s over steps 11 to 120: the log boundaries at steps 10 and 120
FIT_TIMED_FROM = 10
# 5 sgd steps against CPU f64: the first 500 rows, one epoch of 5 batches
FIT_SGD_ROWS = 500
# The autoencoder of examples/autoencoder_digits.py: 784 -> 128 -> 32 ->
# 128 -> 784, logistic, seed 0, trained on reconstruction (squared error);
# the train-step kernel runs it in its squared-error mode.
# The recurrent fit slice: fit_sequences on the recurrent model above at
# the source's full size (scratch/fit_seq_realized.py:36-62): 4,096
# sequences of n = 64 steps, inputs and targets standard normal (seed 0),
# batch 256 (16 steps an epoch), dual-rate SGD at the source's rates for 2
# epochs; adam with EMA and accum_steps=2 for SEQ_FIT_ADAM_STEPS steps; and
# SEQ_FIT_CPU_STEPS steps of SEQ_FIT_CPU_BATCH sequences held against the
# same loop on the CPU in f64 (the batch halved for the host's time: at 1
# step the drift bound below has no steps' drift to hold the card's first
# forward against).
SEQ_FIT_SEQS, SEQ_FIT_BATCH, SEQ_FIT_EPOCHS = 4096, 256, 2
SEQ_FIT_RATES = dict(rate_state=0.01, rate_param=0.05)
SEQ_FIT_LOG_EVERY = 4
SEQ_FIT_ADAM_STEPS, SEQ_FIT_EMA = 4, 0.9
SEQ_FIT_CPU_STEPS, SEQ_FIT_CPU_BATCH = 3, 128
# The card's f32 run against CPU f64 over SEQ_FIT_CPU_STEPS steps: each
# step's sums over 128 sequences of 64 steps of 544-long products are taken
# in another order, and BPTT through the recurrence carries those
# differences on (the recurrent slice's 64-step trajectories drift by what
# the host's BLAS gives); as there, the bound is 1e-5 plus twice the drift
# of the same steps in f32 on the CPU from f64, measured in the same run.
TOL_SEQ_FIT = 1e-5
# production_fit's int8 Predictor: 2 -> 32 relu -> 2 (softmax) served at
# buckets 8, 64 and 512: a warm-up of each bucket, one request of 512 rows
# and 20 of 37 rows (bucket 64), two fused_linear_w8a8 launches each
PROD_BUCKETS = (8, 64, 512)
PROD_REQUESTS = len(PROD_BUCKETS) + 1 + 20
# adam8bit (nearest rounding) through fit on the flagship: A8_STEPS steps
# of B = 100 over the synthetic set's first A8_STEPS * 100 rows on the
# card, each step also taken from the card's state on the CPU in f64 and
# f32; a Ctrl-C at step A8_CRASH, resumed to the budget, against the
# straight run.  From the same state the step's parameters come from the
# unquantized moments: they differ from f64 by f32 rounding, and by up to
# 2 lr where a gradient is a cancellation residue whose sign f32 and f64
# round apart (adam's first steps take lr * sign(g)); the bound is TOL_A8
# plus twice the CPU f32 step's distance from f64, measured per step.
# Nearest rounding lets v round to code 0 under a nonzero m, a step of
# lr * m / eps: from step 2 on the flagship's parameters reach thousands
# (the update is the JAX package's), and the loss soon turns NaN.
# A8_STEPS stops before a loss is computed from such parameters.
A8_STEPS, A8_CRASH = 2, 1
TOL_A8 = 1e-5
AE_DIMS = (784, 128, 32, 128, 784)
AE_RATE, AE_ROWS, AE_STEPS = 0.05, 100, 5
AE_FIT_LR = 0.005
# Chained steps (phases 20-22, in a second interpreter): the fit slice's
# configuration with the EMA on (CHAIN_EMA) and a checkpoint every
# FIT_CHECKPOINT_EVERY steps, run unchained (chain_steps=1) and chained
# ("auto") in the turns CHAIN_TURNS; the device shuffles at window caps of
# 4 and 10; a chained window of CHAIN_WINDOW steps profiled.  The recurrent
# fit slice's configuration likewise, a window of SEQ_CHAIN_WINDOW steps
# profiled.
CHAIN_EMA = 0.99
CHAIN_TURNS = (1, "auto", "auto", 1)
CHAIN_WINDOW, SEQ_CHAIN_WINDOW = 10, 4
# Mixed precision: the router at the flagship (B = 100) and at a wider MLP
# whose per-sample f32 weight gradients fit on the card (784 -> 2048 ->
# 2048 -> 10 at B = 128: 2.1 GB for the 2048 x 2048 layer); a bf16 flagship
# run for FIT_EPOCHS epochs; one bf16 sgd step's gradients against the
# gradients of the full-precision step in CPU f64.  Each bf16 operand and product is
# rounded to 8 significant bits (2**-8 relative), and the step's values
# pass through some 20 roundings between input and gradient; the bound is
# 2**-4 of the leaf's largest gradient.
MP_WIDE, MP_WIDE_BATCH = (784, 2048, 2048, 10), 128
TOL_BF16_GRAD = 2.0 ** -4
FLAGSHIP_PARAM_SHAPES = tuple(
    s for k in range(3) for s in ((FLAGSHIP[k + 1], FLAGSHIP[k]),
                                  (FLAGSHIP[k + 1],)))
RING_PHASES = ("one-way ar", "ar", "rs", "ag")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def _whole(x):
    """A tensor, or a mesh leaf (``parallel.Sharded``) whole on rank 0's
    device (its blocks copied there: no collective)."""
    return x.full() if hasattr(x, "shards") else x


def max_err(got: torch.Tensor, want: torch.Tensor, tol) -> float:
    """Max |got - want|, after checking every element against
    ``atol + rtol * |want|`` (mesh leaves taken whole)."""
    got, want = _whole(got).double().cpu(), _whole(want).double().cpu()
    check(got.shape == want.shape, f"shape {tuple(got.shape)} != "
          f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite output")
    diff = (got - want).abs()
    atol, rtol = tol
    check(bool((diff <= atol + rtol * want.abs()).all()),
          f"max |err| {diff.max().item():.3e} beyond atol {atol} rtol {rtol}")
    return float(diff.max()) if diff.numel() else 0.0


def phase_environment():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, card


def phase_build() -> None:
    from tensor_ops_tpu_torch.ops import cuda_build

    with concurrent.futures.ThreadPoolExecutor(len(LIBS)) as pool:
        builds = dict(zip(LIBS, pool.map(cuda_build.build, LIBS)))
    for name in LIBS:
        built = builds[name]
        log(f"[build] tensor_ops_tpu_torch/csrc/{name}.cu -> "
            f"{built.path.name} in {built.seconds:.1f} s")
        for line in built.log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                log(f"[build]   {line.strip()}")


def _rand(seed: int, *shape, scale: float = 1.0, uniform: bool = False):
    r = np.random.default_rng(seed)
    a = r.uniform(0, 1, size=shape) if uniform else r.normal(size=shape)
    return torch.as_tensor((a * scale).astype(np.float32), device=DEVICE)


def phase_kernels() -> dict:
    from tensor_ops_tpu_torch.ops import kernels as K

    worst = {name: 0.0 for name in KERNELS}
    held = {}  # instance -> shapes held
    for n, (B, Kd, O) in enumerate(LINEAR_SHAPES):
        x = _rand(10 + n, B, Kd, uniform=True)
        w = _rand(20 + n, O, Kd, scale=0.5)
        b = _rand(30 + n, O, scale=0.5)
        errs = []
        for act in ACTS:
            for save_z in (False, True):
                y, z = K._fused_linear_cuda(x, w, b, act, save_z)
                torch.cuda.synchronize()
                y_ref, z_ref = K.fused_linear_ref(x, w, b, act, save_z=True)
                e = max_err(y, y_ref, TOL_Z)
                if save_z:
                    e = max(e, max_err(z, z_ref, TOL_Z))
                errs.append(f"{act}{'+z' if save_z else ''} {e:.1e}")
                worst["fused_linear"] = max(worst["fused_linear"], e)
        # the instance repeats bit for bit (a split's partials are added in
        # split order whichever block adds them)
        y2, z2 = K._fused_linear_cuda(x, w, b, "tanh", True)
        torch.cuda.synchronize()
        check(torch.equal(y2, y) and torch.equal(z2, z),
              f"fused_linear B={B} {Kd}->{O}: a rerun differs")
        p = K.linear_plan(B, Kd, O)
        held.setdefault(p.instance, []).append(f"{B}x{Kd}->{O}")
        log(f"[kernel] fused_linear B={B} {Kd}->{O} instance {p.instance} "
            f"({'16-byte' if p.vec else 'scalar'} loads, grid {p.grid}, "
            f"split {p.split}) max|err| {', '.join(errs)}; tol "
            f"{TOL_Z[0]:g}+{TOL_Z[1]:g}|ref|; rerun bit-equal")
    big = big_linear_inputs()
    y = K._fused_linear_cuda(*big, "identity", False)[0]
    y2 = K._fused_linear_cuda(*big, "identity", False)[0]
    torch.cuda.synchronize()
    e = max_err(y, K.fused_linear_ref(*big), TOL_Z)
    check(torch.equal(y, y2), "fused_linear 4096^3: a rerun differs")
    worst["fused_linear"] = max(worst["fused_linear"], e)
    held.setdefault(K.linear_plan(4096, 4096, 4096).instance, []).append(
        "4096^3")
    log(f"[kernel] fused_linear 4096^3 identity instance "
        f"{K.linear_plan(4096, 4096, 4096).instance} max|err| {e:.1e} vs "
        f"the plain version; rerun bit-equal")
    check(set(held) == set(K.LINEAR_INSTANCES),
          f"fused_linear instances held: {sorted(held)}")
    log("[kernel] fused_linear instances held: " + "; ".join(
        f"{i}: {', '.join(v)}" for i, v in sorted(held.items())))
    worst["fused_linear"] = max(worst["fused_linear"], phase_linear_bf16())

    nets = [(FLAGSHIP, ("logistic", "logistic", "identity"), B, sm)
            for B in (1, 8, 32, 63) for sm in (True, False)]
    nets += [((33, 20, 7), ("tanh", "relu"), 37, False),
             ((33, 20, 7), ("relu", "identity"), 37, True)]
    for n, (dims, acts, B, sm) in enumerate(nets):
        x = _rand(40 + n, B, dims[0], uniform=True)
        ws = [_rand(50 + 10 * n + i, dims[i + 1], dims[i], scale=0.5)
              for i in range(len(dims) - 1)]
        bs = [_rand(60 + 10 * n + i, dims[i + 1], scale=0.5)
              for i in range(len(dims) - 1)]
        y = K._fused_mlp_forward_cuda(x, ws, bs, acts, sm)
        y2 = K._fused_mlp_forward_cuda(x, ws, bs, acts, sm)
        torch.cuda.synchronize()
        check(torch.equal(y, y2), f"fused_mlp_forward B={B} {dims}: a rerun "
              f"differs")
        y_ref = K.fused_mlp_forward_ref(x, ws, bs, acts, sm)
        tol = TOL_P if sm else TOL_Z
        e = max_err(y, y_ref, tol)
        if sm:
            max_err(y.sum(dim=1), torch.ones(B), TOL_P)
        worst["fused_mlp_forward"] = max(worst["fused_mlp_forward"], e)
        plan = K.mlp_forward_plan(B, dims)
        log(f"[kernel] fused_mlp_forward B={B} {'-'.join(map(str, dims))} "
            f"softmax={int(sm)} rows/tile {plan.rows}, {plan.tiles} clusters "
            f"of {K.MLP_CLUSTER} blocks ({plan.smem_bytes} bytes of shared "
            f"memory each) max|err| {e:.2e} tol {tol[0]:g}+{tol[1]:g}|ref|; "
            f"rerun bit-equal")

    steps = [((12, 8, 6, 4), ("logistic", "logistic", "identity"), 16,
              "softmax_xent")]
    steps += [(FLAGSHIP, ("logistic", "logistic", "identity"), B,
               "softmax_xent") for B in (1, 37, 100, 400, 1000)]
    steps += [((8, 3, 8), ("logistic", "logistic"), 37, "squared_error"),
              ((784, 300, 784), ("tanh", "logistic"), 37, "squared_error")]
    for n, (dims, acts, B, kind) in enumerate(steps):
        args = train_step_inputs(90 + n, dims, B, kind) + (0.1, acts)
        loss_r, ws_r, bs_r = K.fused_mlp_train_step_ref(*args,
                                                        loss_kind=kind)
        loss, ws, bs = K._fused_mlp_train_step_cuda(*args, kind)
        torch.cuda.synchronize()
        e_loss = max_err(loss, loss_r, TOL_LOSS)
        e_par = max(max_err(a, b, TOL_PARAM)
                    for a, b in zip(ws + bs, ws_r + bs_r))
        worst["fused_mlp_train_step"] = max(
            worst["fused_mlp_train_step"], e_loss, e_par)
        log(f"[kernel] fused_mlp_train_step {kind} B={B} "
            f"{'-'.join(map(str, dims))} loss {float(loss):.6f} max|err| "
            f"loss {e_loss:.2e} (tol {TOL_LOSS[0]:g}+{TOL_LOSS[1]:g}|ref|), "
            f"params {e_par:.2e} (tol {TOL_PARAM[0]:g}+{TOL_PARAM[1]:g}|ref|)")
    # the flagship at B = 1000 once more: the step repeats bit for bit
    args = train_step_inputs(93, FLAGSHIP, 1000, "softmax_xent") + (
        0.1, ("logistic", "logistic", "identity"))
    a = K._fused_mlp_train_step_cuda(*args, "softmax_xent")
    b = K._fused_mlp_train_step_cuda(*args, "softmax_xent")
    torch.cuda.synchronize()
    same = all(torch.equal(u, v) for u, v in
               zip([a[0], *a[1], *a[2]], [b[0], *b[1], *b[2]]))
    check(same, "fused_mlp_train_step: two runs on one input differ")
    log("[kernel] fused_mlp_train_step flagship B=1000 twice: bit-equal")
    return worst


def big_linear_inputs():
    """x (4096, 4096) uniform, w (4096, 4096) N(0, 1/64²), b N(0, 1), made
    on the card from one seed: kernel 1's large instance."""
    g = torch.Generator(DEVICE).manual_seed(91)
    return (torch.rand(4096, 4096, device=DEVICE, generator=g),
            torch.randn(4096, 4096, device=DEVICE, generator=g) / 64,
            torch.randn(4096, device=DEVICE, generator=g))


def bf16_y_ulps(y, y_ref, z_ref):
    """The largest |y - y_ref| in bf16 ulps of y_ref, the count of values
    beyond one ulp and the largest |y_ref| among them, and the count of
    values, after checking every element against one ulp plus z's
    tolerance (see BF16_ULP)."""
    y, y_ref, z_ref = (t.double().cpu() for t in (y, y_ref, z_ref))
    check(bool(torch.isfinite(y).all()), "non-finite bf16 output")
    ulp = torch.exp2(torch.floor(torch.log2(
        y_ref.abs().clamp_min(2.0 ** -126)))) * BF16_ULP
    diff = (y - y_ref).abs()
    check(bool((diff <= ulp + TOL_Z[0] + TOL_Z[1] * z_ref.abs()).all()),
          f"bf16 y beyond one ulp: max {float((diff / ulp).max()):.2f} ulps")
    beyond = diff > ulp
    return ((float((diff / ulp).max()) if diff.numel() else 0.0),
            int(beyond.sum()), float(y_ref.abs()[beyond].max())
            if beyond.any() else 0.0, diff.numel())


def phase_linear_bf16() -> float:
    """Kernel 1's bf16 instance against its plain version at the flagship's
    layers and a ragged shape, every activation, with and without z; each
    call's launch counted; the wrapper's backward keeps the JAX VJP's
    dtypes.  Returns the largest |z - z_ref|."""
    from tensor_ops_tpu_torch.ops import kernels as K

    worst, ulps, calls, beyond, beyond_y, elems = 0.0, 0.0, 0, 0, 0.0, 0
    before = K.launch_counts()["fused_linear"]
    shapes = [(B, FLAGSHIP[i], FLAGSHIP[i + 1])
              for B in (1, 8, 17, 100, 512) for i in range(3)] + [
                  (33, 40, 10)]
    for n, (B, Kd, O) in enumerate(shapes):
        x = _rand(150 + n, B, Kd, uniform=True).to(torch.bfloat16)
        w = _rand(160 + n, O, Kd, scale=0.5)
        b = _rand(170 + n, O, scale=0.5)
        for act in ACTS:
            for save_z in (False, True):
                y, z = K._fused_linear_cuda(x, w, b, act, save_z)
                calls += 1
                torch.cuda.synchronize()
                y_ref, z_ref = K.fused_linear_ref(x, w, b, act, save_z=True)
                check(y.dtype == torch.bfloat16 and (z is None or
                                                      z.dtype == torch.float32),
                      f"bf16 fused_linear gave y {y.dtype}")
                u, nb, yb, ne = bf16_y_ulps(y, y_ref, z_ref)
                ulps, beyond, beyond_y = max(ulps, u), beyond + nb, max(
                    beyond_y, yb)
                elems += ne
                if save_z:
                    worst = max(worst, max_err(z, z_ref, TOL_Z))
    check(K.launch_counts()["fused_linear"] - before == calls,
          f"bf16 fused_linear: {calls} calls, launches "
          f"{K.launch_counts()['fused_linear'] - before}")
    # through the public wrapper: a differentiable call keeps z, and the
    # backward gives dx and dw in bf16, db in f32 (the JAX VJP's dtypes)
    x = _rand(180, 8, 300, uniform=True).to(torch.bfloat16).requires_grad_()
    w = _rand(181, 100, 300, scale=0.1).to(torch.bfloat16).requires_grad_()
    b = _rand(182, 100, scale=0.5).requires_grad_()
    K.fused_linear(x, w, b, "logistic").float().sum().backward()
    torch.cuda.synchronize()
    check((x.grad.dtype, w.grad.dtype, b.grad.dtype) == (
        torch.bfloat16, torch.bfloat16, torch.float32),
        f"bf16 grads {x.grad.dtype} {w.grad.dtype} {b.grad.dtype}")
    log(f"[kernel] fused_linear bf16 operands: {calls} launches counted "
        f"(B=1, 8, 17, 100, 512 at the flagship's layers and 33x40->10: "
        f"the gemv and the tile with its split, every act, with and without "
        f"z); y max {ulps:.2f} bf16 ulps of the plain y "
        f"(tol 1 ulp + {TOL_Z[0]:g}+{TOL_Z[1]:g}|z|), beyond one ulp in "
        f"{beyond} of {elems} values, all with |y| <= {beyond_y:.2e}; z "
        f"max|err| "
        f"{worst:.2e} (tol {TOL_Z[0]:g}+{TOL_Z[1]:g}|ref|); grads dx, dw "
        f"bf16, db f32")
    return worst


def train_step_inputs(seed: int, dims, B: int, kind: str):
    """x (pixel-like), y (one-hot, or x itself for the squared error) and
    weights at a trained net's 1/sqrt(fan-in) scale, on the card."""
    r = np.random.default_rng(seed)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=DEVICE)

    x = r.uniform(0, 1, size=(B, dims[0]))
    y = (np.eye(dims[-1])[r.integers(0, dims[-1], size=B)]
         if kind == "softmax_xent" else x)
    ws = [dev(r.normal(size=(dims[k + 1], dims[k])) / np.sqrt(dims[k]))
          for k in range(len(dims) - 1)]
    bs = [dev(r.normal(size=dims[k + 1]) * 0.3)
          for k in range(len(dims) - 1)]
    return dev(x), dev(y), ws, bs


def int8_stack_cpu():
    """The 4 x 4096 serving stack as a plain ``QuantizedMLP`` on the CPU:
    weights normal * sqrt(2/N) from ``default_rng(0)``, zero biases, acts
    relu, relu, relu, identity, raw logits out; and its batch of 16 rows
    drawn next from the same generator."""
    from tensor_ops_tpu_torch.models import FusedMLP, QuantizedMLP

    r = np.random.default_rng(0)
    n = STACK_N
    ws = [(r.normal(size=(n, n)) * math.sqrt(2.0 / n)).astype(np.float32)
          for _ in range(STACK_L)]
    x = r.normal(size=(STACK_B, n)).astype(np.float32)
    fm = FusedMLP.from_numpy(ws, [np.zeros(n, np.float32)] * STACK_L,
                             STACK_ACTS, softmax_out=False, device="cpu")
    return QuantizedMLP.from_fused(fm), ws, x


def phase_int8_kernels(stack) -> dict:
    """Kernels 4-6 against their plain versions on the card."""
    from tensor_ops_tpu_torch.ops import kernels as K

    worst = {"fused_linear_w8": 0.0, "fused_linear_w8a8": 0.0,
             "fused_mlp_w8a8_forward": 0.0}

    def layer(seed, B, Kd, O):
        x = _rand(seed, B, Kd, uniform=True)
        w = _rand(seed + 1, O, Kd, scale=1 / math.sqrt(Kd))
        b = _rand(seed + 2, O, scale=0.3)
        q, s = K.quantize_weights_int8(w)
        return x, q, s, b

    held = {}  # (instance, split or not) -> shapes held
    for n, (B, Kd, O) in enumerate(W8_SHAPES):
        x, q, s, b = layer(300 + 3 * n, B, Kd, O)
        errs = []
        for prec in ("default", "highest"):
            for act in ("logistic", "identity"):
                y = K._fused_linear_w8_cuda(x, q, s, b, act, prec)
                torch.cuda.synchronize()
                e = max_err(y, K.fused_linear_w8_ref(x, q, s, b, act, prec),
                            TOL_Z)
                worst["fused_linear_w8"] = max(worst["fused_linear_w8"], e)
                errs.append(f"{prec}/{act} {e:.1e}")
            # the instance repeats bit for bit (a split's partials are added
            # in split order whichever block adds them)
            y2 = K._fused_linear_w8_cuda(x, q, s, b, "identity", prec)
            torch.cuda.synchronize()
            check(torch.equal(y2, y), f"fused_linear_w8 {prec} B={B} "
                  f"{Kd}->{O}: a rerun differs")
            p = K.w8_plan(B, Kd, O, prec)
            held.setdefault((p.instance, p.split > 1), []).append(
                f"{B}x{Kd}->{O}")
            errs.append(f"{prec}: {p.instance} grid {p.grid}")
        log(f"[kernel] fused_linear_w8 B={B} {Kd}->{O} max|err| "
            f"{', '.join(errs)}; tol {TOL_Z[0]:g}+{TOL_Z[1]:g}|ref|; reruns "
            f"bit-equal")
    want = {("gemv", False), ("gemv", True), ("mma", False), ("mma", True),
            ("simt", False), ("simt", True)}
    check(set(held) == want, f"fused_linear_w8 plans held: {sorted(held)}")
    log("[kernel] fused_linear_w8 instances held (instance, K split): "
        + "; ".join(f"{i}{' split' * sp}: {', '.join(v)}"
                    for (i, sp), v in sorted(held.items())))

    held, rows_seen = {}, set()  # (instance, K split) -> shapes; rows a block
    dev = torch.cuda.current_device()
    for n, (B, Kd, O) in enumerate(W8A8_SHAPES):
        x, q, s, b = layer(400 + 3 * n, B, Kd, O)
        x = x * 4 - 2  # signed activations
        p = K.w8a8_plan(B, Kd, O, K._sm_count(dev))
        errs = []
        for act in ("identity", "relu", "logistic", "tanh"):
            y = K._fused_linear_w8a8_cuda(x, q, s, b, act)
            torch.cuda.synchronize()
            ref = K.fused_linear_w8a8_ref(x, q, s, b, act)
            if act in ("identity", "relu"):
                check(torch.equal(y, ref), f"fused_linear_w8a8 {act} B={B} "
                      f"{Kd}->{O} ({p.instance}, grid {p.grid}): not "
                      f"bit-equal to its plain version")
                e = 0.0
            else:
                e = max_err(y, ref, TOL_ACT)
            worst["fused_linear_w8a8"] = max(worst["fused_linear_w8a8"], e)
            errs.append(f"{act} {e:.1e}")
        y2 = K._fused_linear_w8a8_cuda(x, q, s, b, "tanh")
        torch.cuda.synchronize()
        check(torch.equal(y2, y), f"fused_linear_w8a8 B={B} {Kd}->{O} "
              f"({p.instance}): a rerun differs")
        held.setdefault((p.instance, p.split > 1), []).append(
            f"{B}x{Kd}->{O}")
        rows_seen.add(p.rows)
        log(f"[kernel] fused_linear_w8a8 B={B} {Kd}->{O} (K padded to "
            f"{K.padded_width(Kd)}): plan {p.instance} rows {p.rows} tiles "
            f"{p.tiles} grid {p.grid}; identity, relu bit-equal, a rerun "
            f"bit-equal; max|err| {', '.join(errs)}; tol {TOL_ACT[0]:g}")
    want = {("pdl", False), ("pdl", True), ("fused", False)}
    check(set(held) == want, f"fused_linear_w8a8 plans held: {sorted(held)}")
    check(rows_seen == set(K.W8A8_ROWS), f"fused_linear_w8a8 rows a block "
          f"held: {sorted(rows_seen)}")
    log("[kernel] fused_linear_w8a8 instances held (instance, K split): "
        + "; ".join(f"{i}{' split' * sp}: {', '.join(v)}"
                    for (i, sp), v in sorted(held.items()))
        + f"; rows a block {sorted(rows_seen)}")
    # int32-exact: integer x with 127 in every row (scale 1, codes = x),
    # codes scale 1, zero bias: the outputs are the exact integer products,
    # so a wrong fragment map shows as a wrong integer; at a tensor-core
    # shape with a split (B = 37, K = 4096) and at K = 200 (not a multiple of
    # the 64-k chunk), on each instance
    r = np.random.default_rng(7)
    for B, Kd, O in ((5, 12, 9), (8, 200, 40), (37, 4096, 64), (16, 200, 40)):
        xi = r.integers(-127, 128, size=(B, Kd)).astype(np.float32)
        xi[:, 0] = 127.0  # scale 1: the codes are x itself
        wi = r.integers(-127, 128, size=(O, Kd)).astype(np.int8)
        exact = (xi.astype(np.int64) @ wi.astype(np.int64).T).astype(np.float32)
        xt, wt = (torch.as_tensor(a, device=DEVICE) for a in (xi, wi))
        ones, zeros = torch.ones(O, device=DEVICE), torch.zeros(O, device=DEVICE)
        p = K.w8a8_plan(B, Kd, O, K._sm_count(dev))
        y = K._fused_linear_w8a8_cuda(xt, wt, ones, zeros, "identity")
        torch.cuda.synchronize()
        check(np.array_equal(y.cpu().numpy(), exact), f"fused_linear_w8a8: "
              f"the int32-exact case B={B} K={Kd} ({p.instance}) is not exact")
        log(f"[kernel] fused_linear_w8a8 int32-exact case (B={B}, {Kd}->{O}; "
            f"{p.instance} grid {p.grid}): exact")
    worst["fused_mlp_w8a8_forward"] = mlp_w8a8_cases(stack)
    return worst


def mlp_w8a8_cases(stack) -> float:
    """Kernel 6, one cooperative launch per forward: the serving stack at
    B = 16, 5, 64 (one group of 4 m16 tiles) and 100 (two groups), 3 x 512
    logistic at B = 37, each bit-equal to the per-layer fused_linear_w8a8
    chain, to itself on a rerun and (relu) to its plain version; the
    int32-exact cases; and a grid larger than the card holds, refused."""
    from tensor_ops_tpu_torch.ops import kernels as K

    worst = 0.0
    wq3, sw2, b2 = (t.to(DEVICE) for t in stack["model"]._cache["stacked"])
    cases = [(B, wq3, sw2, b2, "relu") for B in (STACK_B, 5, 64, 100)]
    rs = np.random.default_rng(8)
    small = torch.as_tensor(rs.normal(size=(3, 512, 512)) / math.sqrt(512),
                            dtype=torch.float32)
    q3, s3 = zip(*(K.quantize_weights_int8(w) for w in small))
    cases.append((37, torch.stack(q3).to(DEVICE),
                  torch.stack([s.reshape(-1) for s in s3]).to(DEVICE),
                  torch.zeros(3, 512, device=DEVICE), "logistic"))
    groups = set()
    for B, wq, sw, bb, act in cases:
        L, N = wq.shape[0], wq.shape[1]
        x = torch.as_tensor(stack["x"][:B] if N == STACK_N and B <= STACK_B
                            else rs.normal(size=(B, N)).astype(np.float32),
                            device=DEVICE)
        y = K._fused_mlp_w8a8_forward_cuda(x, wq, sw, bb, act)
        y2 = K._fused_mlp_w8a8_forward_cuda(x, wq, sw, bb, act)
        h = x
        for l in range(L):
            h = K._fused_linear_w8a8_cuda(h, wq[l], sw[l], bb[l],
                                          act if l < L - 1 else "identity")
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all()), "fused_mlp_w8a8_forward: "
              "non-finite output")
        check(torch.equal(y, h), f"fused_mlp_w8a8_forward {L}x{N} B={B} "
              f"{act}: not bit-equal to the per-layer CUDA chain")
        check(torch.equal(y, y2), f"fused_mlp_w8a8_forward {L}x{N} B={B} "
              f"{act}: a rerun differs")
        ref = K.fused_mlp_w8a8_forward_ref(x, wq, sw, bb, act)
        if act == "relu":
            check(torch.equal(y, ref), f"fused_mlp_w8a8_forward {L}x{N} "
                  f"B={B}: not bit-equal to its plain version")
            e = 0.0
            what = "bit-equal to its plain version"
        else:
            # a logistic layer's values lie in [0, 1]: its row scale is at
            # most 1/127, so one code flipped by an ulp of expf moves a
            # logit by at most the last layer's largest weight scale
            step = float(sw[-1].max())
            e = max_err(y, ref, (step, 0.0))
            what = (f"max|err| {e:.2e} against its plain version (tol one "
                    f"code step {step:.2e})")
        worst = max(worst, e)
        plan = K.mlp_w8a8_plan(B, N, L)
        groups.add(plan.groups > 1)
        log(f"[kernel] fused_mlp_w8a8_forward {L}x{N} B={B} {act}: one "
            f"cooperative launch ({plan.grid} blocks, {plan.groups} group(s) "
            f"of {plan.rows} rows, ring of {plan.depth} stages of {plan.kc} k,"
            f" {plan.smem_bytes} bytes of shared memory a block); bit-equal "
            f"to the per-layer CUDA chain and on a rerun, {what}")
    check(groups == {False, True}, "fused_mlp_w8a8_forward: no case held "
          "both one and several row groups")
    # int32-exact: x integers with 127 in every row (scale 1, codes = x),
    # one layer of random codes, scale 1, zero bias, identity: the logits are
    # the exact integer products, so a wrong fragment map shows as a wrong
    # integer.  N = 8192 gives each block two column tiles.
    r = np.random.default_rng(9)
    for B, N in ((16, 256), (37, 256), (16, 8192)):
        xi = r.integers(-127, 128, size=(B, N)).astype(np.float32)
        xi[:, 0] = 127.0
        wi = r.integers(-127, 128, size=(1, N, N)).astype(np.int8)
        y = K._fused_mlp_w8a8_forward_cuda(
            torch.as_tensor(xi, device=DEVICE),
            torch.as_tensor(wi, device=DEVICE), torch.ones(1, N, device=DEVICE),
            torch.zeros(1, N, device=DEVICE), "identity")
        torch.cuda.synchronize()
        exact = xi.astype(np.int64) @ wi[0].astype(np.int64).T
        check(np.array_equal(y.cpu().numpy(), exact.astype(np.float32)),
              f"fused_mlp_w8a8_forward: the int32-exact case B={B} N={N} is "
              f"not exact")
        log(f"[kernel] fused_mlp_w8a8_forward int32-exact case (B={B}, 1 "
            f"layer of {N}, {K.mlp_w8a8_plan(B, N, 1).tiles} column tile(s) "
            f"a block): exact")
    # the most blocks the kernel takes (one per column tile at N = 8192, each
    # with ~213 KB of shared memory) are more than the card holds at once:
    # the cooperative launch is refused
    B, N = 16, 8192
    xr = torch.zeros(B, N, device=DEVICE)
    q = torch.zeros(1, N, N, dtype=torch.int8, device=DEVICE)
    ones, zeros = torch.ones(1, N, device=DEVICE), torch.zeros(1, N, device=DEVICE)
    plan, fn = K._mlp_w8a8_call(B, N, 1, 0)
    big = plan._replace(grid=K.MLP8_MAX_GRID,
                        tiles=-(-N // K.MLP8_COLS // K.MLP8_MAX_GRID))
    check(big.grid > K._sm_count(0), "the card holds the kernel's largest "
          "grid: no refusal to show")
    try:
        K._mlp_w8a8_launch(big, fn, xr, q, ones, zeros, torch.empty_like(xr),
                           "identity", 0)
    except RuntimeError as err:
        check("720" in str(err), f"fused_mlp_w8a8_forward: the large grid "
              f"failed otherwise than by a refused cooperative launch: {err}")
        log(f"[kernel] fused_mlp_w8a8_forward: a grid of {big.grid} blocks "
            f"(the card holds {plan.grid}) is refused: {err}")
    else:
        raise SmokeFailure("fused_mlp_w8a8_forward: a grid larger than the "
                           "card holds was launched")
    torch.cuda.synchronize()
    return worst


def _served_probs(stdout: str, n: int) -> np.ndarray:
    rows = [l for l in stdout.splitlines()
            if l and (l[0].isdigit() or l[0] == "-")]
    check(len(rows) == n, f"serve app printed {len(rows)} rows, want {n}")
    return np.array([[float(v) for v in r.split(",")] for r in rows])


def phase_slice(tmp: str) -> dict:
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.apps import serve as serve_app
    from tensor_ops_tpu_torch.backend.rng import Rng
    from tensor_ops_tpu_torch.models import (FusedMLP, Predictor,
                                             activation_by_name, gen_net)
    from tensor_ops_tpu_torch.ops import kernels as K
    from tensor_ops_tpu_torch.utils.checkpoint import (load_network,
                                                       save_network)

    def flagship(be, seed):
        hidden = [(h, activation_by_name(a))
                  for h, a in zip(FLAGSHIP[1:-1], FLAGSHIP_ACTS[:-1])]
        return gen_net(be, FLAGSHIP[0], FLAGSHIP[-1], hidden,
                       activation_by_name(FLAGSHIP_ACTS[-1]), Rng(be, seed))

    be = TorchBackend(torch.float32, DEVICE)
    net = flagship(be, 0)
    ckpt = os.path.join(tmp, "flagship.npz")
    save_network(ckpt, net)
    x = np.random.default_rng(1).uniform(0, 1, size=(5, FLAGSHIP[0]))
    x = x.astype(np.float32)
    xfile = os.path.join(tmp, "batch.npy")
    np.save(xfile, x)

    K.reset_launch_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_app.main([ckpt, "-i", xfile, "--probs", "--device", DEVICE,
                        "--buckets", ",".join(map(str, BUCKETS))])
    served = _served_probs(buf.getvalue(), len(x))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_app.main([ckpt, "--bench", "--device", DEVICE,
                        "--buckets", ",".join(map(str, BUCKETS))])
    bench = json.loads(buf.getvalue().strip().splitlines()[-1])["latency"]
    model = FusedMLP.from_network(load_network(ckpt, net, be))
    per_layer = Predictor(model, buckets=BUCKETS, use_fused_kernel=False)
    layered = per_layer.predict(x)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    log(f"[slice] served {len(x)} rows through the app, --bench over "
        f"buckets {BUCKETS} (n={bench['n']}), {len(x)} rows through the "
        f"per-layer route, in {time.perf_counter() - t0:.1f} s; launches "
        f"{launches}")

    ir = torch.stack([net.run(be, be.asarray(r)) for r in x]).cpu().numpy()
    cpu64 = TorchBackend(torch.float64, "cpu")
    net64 = load_network(ckpt, flagship(cpu64, 0), cpu64)
    f64 = torch.stack([net64.run(cpu64, cpu64.asarray(r)) for r in x]).numpy()
    # the app prints 6 decimals: half a unit of the last digit on top of
    # each value, and of each of a row's 10 values in its sum
    rounding = 5e-7
    out = {"served": (served, rounding), "per_layer": (layered, 0.0)}
    for what, (got, r) in out.items():
        for ref_name, ref in (("IR on the card", ir), ("CPU f64", f64)):
            e = max_err(torch.as_tensor(got), torch.as_tensor(ref),
                        (TOL_P[0] + r, 0.0))
            log(f"[slice] {what} vs {ref_name}: max|err| {e:.2e}")
        e = max_err(torch.as_tensor(got.sum(axis=1)), torch.ones(len(x)),
                    (TOL_P[0] + FLAGSHIP[-1] * r, 0.0))
        log(f"[slice] {what} rows sum to 1: max|err| {e:.2e}")
        check(np.array_equal(got.argmax(1), f64.argmax(1)),
              f"{what}: classes differ from the CPU f64 run")
    for name in SERVE_KERNELS:
        check(launches[name] > 0, f"{name} was not launched by the slice")
    return {"launches": launches, "model": model, "ckpt": ckpt}


def _run_app(argv) -> str:
    from tensor_ops_tpu_torch.apps import serve as serve_app

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_app.main(argv)
    return buf.getvalue()


def _resident(load):
    """A model loaded by ``load()`` (with its input width) and the device
    bytes it holds: ``torch.cuda.memory_allocated`` before loading and after
    one forward, so the kernels' cached forms of the weights count."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    model, width = load()
    with torch.inference_mode():
        model.run(torch.zeros(1, width, device=DEVICE))
    torch.cuda.synchronize()
    return model, torch.cuda.memory_allocated() - before


def phase_int8_serving(tmp: str, ckpt: str, stack) -> dict:
    """The serve app on the three int8 routes, each driven with the launch
    counts set to 0 just before and read just after."""
    from tensor_ops_tpu_torch.apps import serve as serve_app
    from tensor_ops_tpu_torch.models import FusedMLP, QuantizedMLP
    from tensor_ops_tpu_torch.ops import kernels as K
    from tensor_ops_tpu_torch.utils.checkpoint import (load_arrays,
                                                       load_quantized,
                                                       save_quantized)

    buckets = ",".join(map(str, BUCKETS))
    # the app answers -i with one request and no warm-up: its bucket's
    # request graph is captured then, whose warm-up forward launches each
    # kernel directly once before the graph's replay launches it again
    per = 2
    x = np.random.default_rng(3).uniform(0, 1, size=(64, FLAGSHIP[0]))
    x = x.astype(np.float32)
    xfile = os.path.join(tmp, "int8_batch.npy")
    np.save(xfile, x)
    payload = load_arrays(ckpt)
    layers, cpu = list(FLAGSHIP[1:-1]), torch.device("cpu")
    f32_cpu = serve_app.load_model(payload, layers, FLAGSHIP[0], FLAGSHIP[-1],
                                   "logistic", cpu)
    plain = serve_app.load_model(payload, layers, FLAGSHIP[0], FLAGSHIP[-1],
                                 "logistic", cpu, int8=True)
    f32_classes = f32_cpu.run(torch.as_tensor(x)).numpy().argmax(1)
    out, launches = {}, {}
    # one code flipped by an ulp of expf moves a logit (and a probability)
    # by at most the last layer's largest weight scale (its input, a
    # logistic layer, has row scales <= 1/127); 5e-7 is the app's printing
    rounding = 5e-7
    step = float(plain.scales[-1].max())

    K.reset_launch_counts()
    served = _served_probs(_run_app(
        [ckpt, "--int8", "-i", xfile, "--probs", "--device", DEVICE,
         "--buckets", buckets]), len(x))
    torch.cuda.synchronize()
    launches["fused_linear_w8a8"] = K.launch_counts()["fused_linear_w8a8"]
    check(launches["fused_linear_w8a8"] == 3 * per, f"--int8 flagship: "
          f"{launches['fused_linear_w8a8']} fused_linear_w8a8 launches for "
          f"one request, want 3 in its graph, {3 * per} with its capture's "
          f"warm-up")
    want = plain.run(torch.as_tensor(x)).numpy()
    e = max_err(torch.as_tensor(served), torch.as_tensor(want),
                (step + rounding, 0.0))
    agree = float((served.argmax(1) == f32_classes).mean())
    check(agree > 0.8, f"--int8 classes agree with f32 on {agree:.3f} < 0.8")
    log(f"[int8] serve app --int8 (w8a8) on the flagship checkpoint, "
        f"{len(x)} rows: 3 fused_linear_w8a8 launches in the request's "
        f"graph (and 3 by its capture's warm-up); vs the plain "
        f"QuantizedMLP on the CPU max|err| {e:.2e} (tol one code step "
        f"{step:.2e} + {rounding:g}); classes agree with f32 on "
        f"{agree:.3f} (JAX test: > 0.8)")
    out["w8a8_err"] = e

    w8 = QuantizedMLP.from_fused(f32_cpu, mode="w8")
    w8path = os.path.join(tmp, "flagship_w8.npz")
    save_quantized(w8path, w8)
    K.reset_launch_counts()
    served = _served_probs(_run_app(
        [w8path, "-i", xfile, "--probs", "--device", DEVICE, "--buckets",
         buckets]), len(x))
    torch.cuda.synchronize()
    launches["fused_linear_w8"] = K.launch_counts()["fused_linear_w8"]
    check(launches["fused_linear_w8"] == 3 * per, f"w8 checkpoint: "
          f"{launches['fused_linear_w8']} fused_linear_w8 launches, want "
          f"{3 * per} (3 in the graph, 3 by its capture's warm-up)")
    want = w8.run(torch.as_tensor(x)).numpy()
    e = max_err(torch.as_tensor(served), torch.as_tensor(want),
                (TOL_P[0] + rounding, 0.0))
    agree = float((served.argmax(1) == f32_classes).mean())
    check(agree > 0.8, f"w8 classes agree with f32 on {agree:.3f} < 0.8")
    log(f"[int8] serve app on a mode=w8 quantized_mlp checkpoint: 3 "
        f"fused_linear_w8 launches in the request's graph (and 3 by its "
        f"capture's warm-up); vs the plain QuantizedMLP on the CPU "
        f"max|err| {e:.2e} (tol {TOL_P[0]:g} + {rounding:g}); classes "
        f"agree with f32 on {agree:.3f}")

    qm, xs = stack["model"], stack["x"]
    spath = os.path.join(tmp, "stack_4x4096.npz")
    save_quantized(spath, qm)
    xsfile = os.path.join(tmp, "stack_batch.npy")
    np.save(xsfile, xs)
    K.reset_launch_counts()
    served = _served_probs(_run_app(
        [spath, "-i", xsfile, "--probs", "--device", DEVICE, "--in-dim",
         str(STACK_N), "--out-dim", str(STACK_N), "--buckets",
         str(STACK_B)]), len(xs))
    torch.cuda.synchronize()
    counts = K.launch_counts()
    launches["fused_mlp_w8a8_forward"] = counts["fused_mlp_w8a8_forward"]
    check(counts["fused_mlp_w8a8_forward"] == per
          and counts["fused_linear_w8a8"] == 0,
          f"4x4096 stack: launches {counts}, want one fused_mlp_w8a8_forward "
          f"in the request's graph and one by its capture's warm-up")
    want = qm.run_fused(torch.as_tensor(xs))
    e = max_err(torch.as_tensor(served), want, (rounding, 0.0))
    gpu_qm = load_quantized(spath, device=DEVICE)
    with torch.inference_mode():
        got = gpu_qm.run_fused(torch.as_tensor(xs, device=DEVICE))
    check(torch.equal(got.cpu(), want), "4x4096 stack on the card is not "
          "bit-equal to the plain QuantizedMLP on the CPU")
    log(f"[int8] serve app on the 4x4096 quantized_mlp checkpoint, B=16: one "
        f"fused_mlp_w8a8_forward launch in the request's graph (and one by "
        f"its capture's warm-up); printed logits vs the plain "
        f"QuantizedMLP on the CPU max|err| {e:.2e} (tol {rounding:g}, the "
        f"printing); run_fused on the card bit-equal to it")

    sizes = {}
    for name, load in (
            ("flagship f32", lambda: (serve_app.load_model(
                payload, layers, FLAGSHIP[0], FLAGSHIP[-1], "logistic",
                torch.device(DEVICE)), FLAGSHIP[0])),
            ("flagship int8 (w8a8)", lambda: (serve_app.load_model(
                payload, layers, FLAGSHIP[0], FLAGSHIP[-1], "logistic",
                torch.device(DEVICE), int8=True), FLAGSHIP[0])),
            ("4x4096 f32", lambda: (FusedMLP.from_numpy(
                stack["weights"], [np.zeros(STACK_N, np.float32)] * STACK_L,
                STACK_ACTS, softmax_out=False, device=DEVICE), STACK_N)),
            ("4x4096 int8", lambda: (load_quantized(spath, device=DEVICE),
                                     STACK_N))):
        model, nbytes = _resident(load)
        sizes[name] = nbytes
        del model
        log(f"[int8] device memory held by the {name} model: {nbytes} bytes "
            f"(torch.cuda.memory_allocated before and after loading and one "
            f"forward)")
    out.update(launches=launches, int8_flagship=plain, gpu_stack=gpu_qm,
               w8=w8)
    return out


@contextlib.contextmanager
def no_download():
    """The loader's download attempt fails at once, without a socket: this
    smoke run never reaches for the network, and the app falls back to its
    synthetic set as it does offline."""
    from tensor_ops_tpu_torch.utils import mnist_data

    def refuse(url, timeout=20.0):
        raise OSError(f"no network in this smoke run ({url})")

    saved, mnist_data._fetch = mnist_data._fetch, refuse
    try:
        yield
    finally:
        mnist_data._fetch = saved


def run_mnist_app(tmp: str, extra) -> dict:
    """``apps.mnist.main`` for one epoch of the synthetic set at the
    flagship's widths, in a fresh data directory; the training errors, the
    samples/s after the first (warm-up) batch from the app's own per-batch
    ``--metrics`` record, and the launch counts."""
    from tensor_ops_tpu_torch.apps import mnist
    from tensor_ops_tpu_torch.ops import kernels as K

    data = tempfile.mkdtemp(dir=tmp)
    record = os.path.join(data, "metrics.jsonl")
    argv = ["--epochs", "1", "-b", "1000", "-d", data, "--device", DEVICE,
            "--seed", "0", "--metrics", record, *extra]
    buf = io.StringIO()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with no_download(), contextlib.redirect_stdout(buf):
        mnist.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    lines = buf.getvalue().splitlines()
    i_loaded = lines.index("Loaded data.")
    check(any("SYNTHETIC" in l for l in lines[:i_loaded]),
          "the app did not fall back to the synthetic set")
    train = [float(l.split()[1].rstrip("%")) for l in lines
             if l.startswith("Training:")]
    val = [float(l.split()[1].rstrip("%")) for l in lines
           if l.startswith("Validation:")]
    with open(record) as f:
        seconds = [json.loads(l)["batch_seconds"] for l in f]
    check(len(train) == len(val) == len(seconds) == 6,
          f"{' '.join(extra)}: {len(train)} training and {len(val)} "
          f"validation errors for 6 batches")
    check(train[-1] < train[0], f"{' '.join(extra)}: training error did not "
          f"fall ({train})")
    rate = 5 * 1000 / sum(seconds[1:])
    log(f"[train] mnist {' '.join(extra)}: {wall:.1f} s in all; training "
        f"error {train} %, validation error {val} %; {rate:.0f} samples/s "
        f"over batches 2-6 (batch 1: {seconds[0] * 1e3:.2f} ms); launches "
        f"{launches}")
    return {"launches": launches, "samples_per_s": rate}


def phase_train(tmp: str) -> dict:
    from tensor_ops_tpu_torch.models import FusedMLP
    from tensor_ops_tpu_torch.ops import kernels as K
    from tensor_ops_tpu_torch.utils.mnist_data import load_mnist

    t0 = time.perf_counter()
    with no_download(), contextlib.redirect_stdout(io.StringIO()):
        train_raw, _ = load_mnist(tempfile.mkdtemp(dir=tmp))
    log(f"[train] offline fallback to the synthetic set in a fresh data "
        f"directory: {time.perf_counter() - t0:.2f} s "
        f"({len(train_raw)} training rows)")

    fused = run_mnist_app(tmp, ["--minibatch", "100", "--fused"])
    check(fused["launches"]["fused_mlp_train_step"] > 0,
          "the --fused run did not launch fused_mlp_train_step")
    minibatch = run_mnist_app(tmp, ["--minibatch", "100"])

    # 5 steps on one fixed minibatch of the synthetic set, from one start
    xb = np.stack([d / 255.0 for _, d in train_raw[:100]])
    yb = np.eye(10)[[l for l, _ in train_raw[:100]]]
    r = np.random.default_rng(5)
    ws = [r.normal(size=(FLAGSHIP[k + 1], FLAGSHIP[k])) * 0.5
          for k in range(3)]
    bs = [r.normal(size=FLAGSHIP[k + 1]) * 0.5 for k in range(3)]
    acts = ("logistic", "logistic", "identity")
    kernel = plain = FusedMLP.from_numpy(
        [w.astype(np.float32) for w in ws],
        [b.astype(np.float32) for b in bs], acts, device=DEVICE)
    x32 = torch.as_tensor(xb, dtype=torch.float32, device=DEVICE)
    y32 = torch.as_tensor(yb, dtype=torch.float32, device=DEVICE)
    ws64, bs64 = ([torch.as_tensor(w) for w in ws],
                  [torch.as_tensor(b) for b in bs])
    x64, y64 = torch.as_tensor(xb), torch.as_tensor(yb)
    for _ in range(5):
        _, kernel = kernel.train_fullfused(TRAIN_RATE, x32, y32)
        _, plain = plain.train(TRAIN_RATE, x32, y32)
        _, ws64, bs64 = K.fused_mlp_train_step_ref(
            x64, y64, ws64, bs64, TRAIN_RATE, acts)
    torch.cuda.synchronize()
    for what, ref in (("FusedMLP.train on the card", plain.to_params()),
                      ("the plain step in CPU f64",
                       [p for wb in zip(ws64, bs64) for p in wb])):
        e = max(max_err(a, b, TOL_5_STEPS)
                for a, b in zip(kernel.to_params(), ref))
        log(f"[train] 5 train_fullfused steps (rate {TRAIN_RATE}, B=100) vs "
            f"{what}: max|err| {e:.2e} tol {TOL_5_STEPS[0]:g}+"
            f"{TOL_5_STEPS[1]:g}|ref|")
    return {"fused": fused, "minibatch": minibatch}


def _median_ms(fn) -> float:
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(TIMED_RUNS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def phase_timing(model) -> dict:
    from tensor_ops_tpu_torch.models import Predictor
    from tensor_ops_tpu_torch.ops import kernels as K

    pred = Predictor(model, buckets=BUCKETS)
    pred.warmup()
    r = np.random.default_rng(2)
    for b in BUCKETS:
        x = r.uniform(0, 1, size=(b, FLAGSHIP[0])).astype(np.float32)
        pred.timer.samples.clear()
        for _ in range(TIMED_RUNS):
            pred.predict(x)
        route = "fused_mlp_forward" if b < pred.xla_threshold else "matmul"
        log(f"[timing] Predictor bucket {b} ({route}): p50 "
            f"{pred.latency()['p50_s'] * 1e3:.4f} ms host clock "
            f"(n={TIMED_RUNS})")

    ws = [w.float() for w in model.weights]
    bs = [b.float() for b in model.biases]
    acts = model.acts
    times = {}
    with torch.inference_mode():
        for B in (8, 512):
            x = _rand(70 + B, B, FLAGSHIP[0], uniform=True)
            hs = [x]
            for w, b, a in zip(ws, bs, acts):
                hs.append(K.fused_linear_ref(hs[-1], w, b, a))
            tk = tp = 0.0
            for i in range(3):
                h, w, b, a = hs[i], ws[i], bs[i], acts[i]
                k_ms = _median_ms(lambda: K._fused_linear_cuda(
                    h, w, b, a, False))
                p_ms = _median_ms(lambda: K.fused_linear_ref(h, w, b, a))
                tk, tp = tk + k_ms, tp + p_ms
                log(f"[timing] fused_linear B={B} {FLAGSHIP[i]}->"
                    f"{FLAGSHIP[i + 1]} {a}: kernel {k_ms:.4f} ms, "
                    f"plain {p_ms:.4f} ms")
            log(f"[timing] fused_linear B={B} three flagship layers: "
                f"kernel {tk:.4f} ms, plain {tp:.4f} ms")
            if B == 8:
                small = hs[:3]
        # the flagship's last layer runs as an identity layer under
        # softmax_out, where one torch.addmm computes what kernel 1 does:
        # that call is kernel 1's library time (the kernels line's entry)
        h100 = [_rand(75, 100, FLAGSHIP[0], uniform=True)]
        for w, b, a in zip(ws, bs, acts):
            h100.append(K.fused_linear_ref(h100[-1], w, b, a))
        cases = (("identity layer 100->10, B=8", [(small[2], ws[2], bs[2])]),
                 ("784->300, B=8", [(small[0], ws[0], bs[0])]),
                 ("the three flagship layers, B=100",
                  list(zip(h100[:3], ws, bs))),
                 ("4096^3", [big_linear_inputs()]))
        for what, layers in cases:
            times_l = linear_timing(what, layers)
            if what.startswith("identity"):
                times["fused_linear"] = times_l
        for B in (1, 8, 63):
            times_b = mlp_forward_timing(B, ws, bs, acts)
            if B == 8:
                times["fused_mlp_forward"] = times_b

    times["fused_mlp_train_step"] = train_step_timing()
    return times


def mlp_forward_timing(B: int, ws, bs, acts) -> tuple:
    """Kernel 2 on the flagship at batch B: its profiler device time and
    CUDA-event median beside its bound, its plain version and kernel 1's
    three per-layer launches at the same B (the per-layer route's kernel
    time, which the whole-chain kernel exists to beat).  Returns (kernel
    ms, plain ms, device us)."""
    from tensor_ops_tpu_torch.ops import kernels as K

    x = _rand(80 + B, B, FLAGSHIP[0], uniform=True)

    def kernel():
        return K._fused_mlp_forward_cuda(x, ws, bs, acts, True)

    def per_layer():
        h = x
        for w, b, a in zip(ws, bs, acts):
            h = K._fused_linear_cuda(h, w, b, a, False)[0]
        return torch.softmax(h, dim=-1)

    prof = _profile_steps(kernel)
    check(list(prof["by_kernel"]) == ["mlp_forward_kernel"], f"profiler saw "
          f"{sorted(prof['by_kernel'])} for fused_mlp_forward B={B}")
    layers = _profile_steps(per_layer)
    linear_us = sum(us for n, us in layers["by_kernel"].items()
                    if n.startswith("linear_"))
    k_ms = _median_ms(kernel)
    p_ms = _median_ms(lambda: K.fused_mlp_forward_ref(x, ws, bs, acts, True))
    l_ms = _median_ms(per_layer)
    plan = K.mlp_forward_plan(B, FLAGSHIP)
    least = mlp_forward_bound(B)
    log(f"[timing] fused_mlp_forward B={B} flagship: {plan.tiles} clusters "
        f"of {K.MLP_CLUSTER} blocks, {plan.rows} rows a tile; device "
        f"{prof['busy_us']:.2f} us ({prof['busy_us'] / (least[0] * 1e3):.1f}x"
        f" the bound {least[0] * 1e3:.3f} us by {least[1]}); kernel 1's three "
        f"per-layer launches ({', '.join(K.linear_plan(B, k, o).instance for k, o in zip(FLAGSHIP[:-1], FLAGSHIP[1:]))}) "
        f"{linear_us:.2f} us of device time; events kernel {k_ms:.4f} ms, "
        f"plain {p_ms:.4f} ms, per-layer route {l_ms:.4f} ms")
    return k_ms, p_ms, None, prof["busy_us"]


def mlp_forward_bound(B: int):
    """Kernel 2 on the flagship at batch B: x, every weight and bias read
    once, the probabilities written once; 2 B sum(k o) f32 operations."""
    layers = list(zip(FLAGSHIP[:-1], FLAGSHIP[1:]))
    params = sum(k * o + o for k, o in layers)
    return _bound(4 * (B * FLAGSHIP[0] + params + B * FLAGSHIP[-1]),
                  2 * B * sum(k * o for k, o in layers), "f32")


def linear_timing(what: str, layers) -> tuple:
    """Kernel 1 (identity epilogue) on ``layers`` (x, w, b) one after
    another against one ``torch.addmm`` per layer: CUDA-event medians and
    profiler device time of both, in turns over 3 repetitions, beside the
    bound.  Returns (kernel ms, plain ms, addmm ms, kernel device us) as
    the kernels line takes them."""
    from tensor_ops_tpu_torch.ops import kernels as K

    def kernel():
        for h, w, b in layers:
            K._fused_linear_cuda(h, w, b, "identity", False)

    def library():
        for h, w, b in layers:
            torch.addmm(b, h, w.T)

    plans = [K.linear_plan(h.shape[0], h.shape[1], w.shape[0])
             for h, w, _ in layers]
    names = {"linear_gemv_kernel" if p.instance == "gemv"
             else "linear_tile_kernel" for p in plans}
    e = max(max_err(K._fused_linear_cuda(h, w, b, "identity", False)[0],
                    torch.addmm(b, h, w.T), TOL_Z) for h, w, b in layers)
    reps = []
    for _ in range(3):
        prof = _profile_steps(kernel)
        check(set(prof["by_kernel"]) == names, f"fused_linear {what}: the "
              f"profiler saw {sorted(prof['by_kernel'])}, want {names}")
        lib = _profile_steps(library)
        reps.append((_median_ms(kernel), _median_ms(library),
                     prof["busy_us"], lib["busy_us"]))
    k_ms, l_ms, k_us, l_us = (statistics.median(r[i] for r in reps)
                              for i in range(4))
    p_ms = _median_ms(lambda: [K.fused_linear_ref(h, w, b)
                               for h, w, b in layers])
    parts = [_bound(4 * (h.shape[0] * h.shape[1] + w.numel() + w.shape[0]
                         + h.shape[0] * w.shape[0]),
                    2 * h.shape[0] * h.shape[1] * w.shape[0], "f32")
             for h, w, _ in layers]
    least = (sum(p[0] for p in parts), max(parts)[1])
    log(f"[timing] fused_linear {what}: instances "
        f"{', '.join(f'{p.instance} grid {p.grid}' for p in plans)}; device "
        f"(profiler), in turns over 3 repetitions, kernel "
        f"{', '.join(f'{r[2]:.2f}' for r in reps)} us vs torch.addmm "
        f"{', '.join(f'{r[3]:.2f}' for r in reps)} us (medians {k_us:.2f} vs "
        f"{l_us:.2f} us: {k_us / l_us:.2f}x); events kernel "
        f"{', '.join(f'{r[0]:.4f}' for r in reps)} ms vs torch.addmm "
        f"{', '.join(f'{r[1]:.4f}' for r in reps)} ms (medians {k_ms:.4f} vs "
        f"{l_ms:.4f} ms); plain {p_ms:.4f} ms; bound {least[0] * 1e3:.4f} us "
        f"by {least[1]}; kernel vs addmm max|err| {e:.1e}")
    return k_ms, p_ms, l_ms, k_us


def train_step_timing() -> tuple:
    """Kernel 3 on the flagship at B = 100, 400, 1000 by CUDA events and
    by profiler device time, with the grid and the barrier count.  Returns
    (kernel ms, plain ms) at B = 100."""
    from tensor_ops_tpu_torch.ops import kernels as K

    acts = ("logistic", "logistic", "identity")
    grid = K.train_grid(K._train_step_capacity(0), K._sm_count(0), 100,
                        FLAGSHIP)
    stages = K.train_stages(len(FLAGSHIP) - 1)
    log(f"[timing] fused_mlp_train_step: grid {grid} blocks of "
        f"{K.TRAIN_THREADS} threads (one per SM; the card holds "
        f"{K._train_step_capacity(0)}), {len(stages)} stages "
        f"{'/'.join(stages)}, {len(stages) - 1} grid barriers")
    out = None
    for B in (100, 400, 1000):
        x, y, tw, tb = train_step_inputs(110 + B, FLAGSHIP, B, "softmax_xent")

        def step():
            return K._fused_mlp_train_step_cuda(x, y, tw, tb, 0.1, acts,
                                                "softmax_xent")
        prof = _profile_steps(step)
        # names only: the profiler may drop an event (its count is no
        # launch count)
        check(list(prof["by_kernel"]) == ["mlp_train_step_kernel"],
              f"fused_mlp_train_step: the profiler saw "
              f"{sorted(prof['by_kernel'])}")
        k_ms = _median_ms(step)
        p_ms = _median_ms(lambda: K.fused_mlp_train_step_ref(
            x, y, tw, tb, 0.1, acts))
        log(f"[timing] fused_mlp_train_step B={B} flagship: events "
            f"{k_ms:.4f} ms, device {prof['busy_us']:.2f} us; plain "
            f"{p_ms:.4f} ms")
        if B == 100:
            out = (k_ms, p_ms)
    return out


def _per_launch_us(prof: dict, kernel: str) -> float:
    """A kernel's device time per launch the profiler saw (0 if none)."""
    calls = prof["calls"].get(kernel, 0)
    return prof["by_kernel"][kernel] / calls if calls else 0.0


def _host_us(fn, calls: int = 1000) -> float:
    """Host time per call of ``fn``: the host clock over ``calls`` calls
    after warm-up, the card's queue drained before and not waited on
    inside (the card keeps up when each call's kernels are shorter than its
    host time)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _graph_us(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph and replayed ``reps`` times, timed with CUDA events, the median per
    call.  No host time and no profiler between the kernels: a call of two
    kernels under programmatic dependent launch overlaps as it does on its
    own.  ``fn`` first runs twice on the capture stream, so that scratch
    kept per stream is made outside the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e) * 1e3 / calls)
    del g
    return statistics.median(out)


@contextlib.contextmanager
def w8a8_instance(instance: str):
    """Every ``fused_linear_w8a8`` call inside runs ``instance`` (``"pdl"``
    or ``"fused"``) through the same wrapper: the wrapper's cached plans are
    set aside and ``w8a8_plan`` runs with the instance forced, so the two
    designs are timed with the same host work."""
    from tensor_ops_tpu_torch.ops import kernels as K

    saved, plan = dict(K._w8a8_calls), K.w8a8_plan
    K._w8a8_calls.clear()
    K.w8a8_plan = lambda *a, **kw: plan(*a, instance=instance, **kw)
    try:
        yield
    finally:
        K.w8a8_plan = plan
        K._w8a8_calls.clear()
        K._w8a8_calls.update(saved)


def w8a8_direct(B: int, layers, h, what: str) -> dict:
    """Kernel 5's two instances as a served request launches them: through
    the wrapper, one layer after another from the host, the card idle before
    the first (as between requests), no graph and no profiler.  CUDA events
    recorded between the layers give each layer's span (its host time until
    its kernels are queued, and their device time where it outlasts that);
    TIMED_RUNS chains a turn, the instances in the turns of W8A8_TURNS.
    Both instances' outputs are held bit-equal first.  Returns {instance:
    median chain us}."""
    from tensor_ops_tpu_torch.ops import kernels as K

    def chain():
        x = h
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(layers) + 1)]
        ev[0].record()
        for i, (q, s_, b, a) in enumerate(layers):
            x = K._fused_linear_w8a8_cuda(x, q, s_, b, a)
            ev[i + 1].record()
        torch.cuda.synchronize()
        return x, [ev[i].elapsed_time(ev[i + 1]) * 1e3
                   for i in range(len(layers))]

    widths = [h.shape[1]] + [q.shape[0] for q, _, _, _ in layers]
    outs, plans = {}, {}
    for inst in ("fused", "pdl"):
        with w8a8_instance(inst):
            outs[inst] = chain()[0]
            plans[inst] = [K.w8a8_plan(B, k, o).grid
                           for k, o in zip(widths, widths[1:])]
    check(torch.equal(outs["fused"], outs["pdl"]), f"fused_linear_w8a8 "
          f"{what} B={B}: the two instances' chains differ")
    spans = {"fused": [], "pdl": []}  # instance -> [layer spans] per chain
    turns = {"fused": [], "pdl": []}  # instance -> median chain per turn
    for inst in W8A8_TURNS:
        with w8a8_instance(inst):
            for _ in range(5):
                chain()
            runs = [chain()[1] for _ in range(TIMED_RUNS)]
        spans[inst] += runs
        turns[inst].append(statistics.median(sum(r) for r in runs))
    med = {i: [statistics.median(r[j] for r in spans[i])
               for j in range(len(layers))] for i in spans}
    total = {i: statistics.median(sum(r) for r in spans[i]) for i in spans}
    log(f"[timing] fused_linear_w8a8 {what} B={B}, direct launches through "
        f"the wrapper (event spans, median of {len(spans['pdl'])} chains in "
        f"turns {'/'.join(W8A8_TURNS)}): "
        + "; ".join(f"{i} " + " + ".join(f"{u:.2f}" for u in med[i])
                    + f" = {total[i]:.2f} us (turns "
                    + ", ".join(f"{u:.2f}" for u in turns[i])
                    + f"; grids {plans[i]})" for i in med))
    return total


def _replay_us(graph, replays: int = 20, reps: int = 5) -> float:
    """Device time per replay of a captured CUDA graph: ``replays``
    back-to-back replays between CUDA events, the median of ``reps``."""
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(replays):
            graph.replay()
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e) * 1e3 / replays)
    return statistics.median(out)


def w8a8_request_turns(model, x) -> dict:
    """The --int8 flagship request at bucket ``len(x)`` on each instance of
    kernel 5, each served from a request graph captured with that instance
    forced (both outputs bit-equal first), in the turns of W8A8_TURNS: each
    turn's median host-clock wall time of TIMED_RUNS ``Predictor.predict``
    calls, unprofiled, and the graph's device time per replay (CUDA events
    over back-to-back replays); then the profiler's kernels and device busy
    time per request over 10 more.  Returns {instance: median wall us}."""
    from tensor_ops_tpu_torch.models import Predictor

    b = len(x)
    preds, outs = {}, {}
    for inst in ("fused", "pdl"):
        with w8a8_instance(inst):
            preds[inst] = Predictor(model, buckets=(b,))
            preds[inst].warmup()
        outs[inst] = preds[inst].predict(x)
    check(np.array_equal(outs["fused"], outs["pdl"]), f"--int8 request "
          f"bucket {b}: the two instances' request graphs differ")
    wall = {"fused": [], "pdl": []}
    dev = {"fused": [], "pdl": []}
    for inst in W8A8_TURNS:
        pred = preds[inst]
        for _ in range(3):
            pred.predict(x)
        torch.cuda.synchronize()
        ts = []
        for _ in range(TIMED_RUNS):
            t0 = time.perf_counter()
            pred.predict(x)
            ts.append((time.perf_counter() - t0) * 1e6)
        wall[inst].append(statistics.median(ts))
        dev[inst].append(_replay_us(pred._serving[4].get(b, True).graph))
    for inst, pred in preds.items():
        prof = _profile_steps(lambda: pred.predict(x), whole=True)
        kernels = ", ".join(f"{n} x{c:g}" for n, c in prof["calls"].items())
        log(f"[graphs] --int8 flagship request bucket {b} on the {inst} "
            f"instance, from its request graph (turns "
            f"{'/'.join(W8A8_TURNS)}): wall "
            f"{statistics.median(wall[inst]):.1f} us/request (turn medians "
            + ", ".join(f"{u:.1f}" for u in wall[inst])
            + f"), device time per replay {statistics.median(dev[inst]):.2f}"
            f" us (" + ", ".join(f"{u:.2f}" for u in dev[inst])
            + f"), device busy {prof['busy_us']:.2f} us, graph launches "
            f"{prof['graph_launches']:g}; kernels {kernels}")
    return {i: statistics.median(w) for i, w in wall.items()}


# the runtime calls by which the host launches work on the card
HOST_LAUNCH_API = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                   "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                   "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
                   "cudaGraphLaunch")


def _kernel_name(raw: str) -> str:
    """A device event's kernel name without its namespace, template
    arguments and parameters (``mlp_forward_kernel``)."""
    name = raw.replace("(anonymous namespace)::", "")
    name = name.replace("void ", "").split("(")[0].split("<")[0]
    return name.split("::")[-1]


def _profile_steps(step, steps: int = 10, whole: bool = False) -> dict:
    """The device work of one call of ``step`` (a training step, a request
    or a kernel): CUDA kernels launched, copies and memsets, and device busy
    time per call (``torch.profiler`` over ``steps`` calls, kernel and copy
    rows only), and time and launches per call by kernel name; and the
    launches the host issued per call (the runtime calls the profiler
    records: graph launches apart from kernel launches and copies).
    ``whole``: every call launches the same kernels, so a count of some
    kernel that is not a multiple of ``steps`` means the profiler lost
    events (it has, from graph launches): profile again, as when it hands
    back none.  (Copies are left out of that test: it loses one
    host-to-device copy of a request's ten in every profile of some
    request graphs.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    # the profiler now and then hands back no device events at all (seen
    # once in a dozen runs on the card), or loses some: profile again, at
    # most three times more
    for attempt in range(4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
        events = prof.events()
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        seen = {}
        for e in device:
            if not e.name.startswith(("Memcpy", "Memset")):
                seen[e.name] = seen.get(e.name, 0) + 1
        if device and not (whole and any(c % steps for c in seen.values())):
            break
    api = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in HOST_LAUNCH_API:
            api[e.name] = api.get(e.name, 0) + 1
    graphs = api.get("cudaGraphLaunch", 0)
    by_kernel, calls, launches, copies, busy = {}, {}, 0, 0, 0.0
    for e in device:
        us = e.time_range.elapsed_us()
        busy += us
        if e.name.startswith(("Memcpy", "Memset")):
            copies += 1
        else:
            launches += 1
        name = _kernel_name(e.name)
        by_kernel[name] = by_kernel.get(name, 0.0) + us / steps
        calls[name] = calls.get(name, 0) + 1
    return {"launches": launches / steps, "copies": copies / steps,
            "busy_us": busy / steps,
            "graph_launches": graphs / steps,
            "other_launches": (sum(api.values()) - graphs) / steps,
            "names": sorted({e.name for e in device}),
            "calls": {n: c / steps for n, c in calls.items()},
            "by_kernel": dict(sorted(by_kernel.items(),
                                     key=lambda kv: -kv[1]))}


def phase_int8_timing(sv, stack) -> dict:
    """int8 serving on the card: p50 request latency per bucket, each int8
    kernel's CUDA-event median beside its plain version's and its profiler
    device time, and where one request's time goes on each int8 route."""
    from tensor_ops_tpu_torch.models import Predictor
    from tensor_ops_tpu_torch.ops import kernels as K

    qm_flag = sv["int8_flagship"]
    flag = type(qm_flag)(*(tuple(t.to(DEVICE) for t in ts) for ts in (
        qm_flag.wqs, qm_flag.scales, qm_flag.biases)), qm_flag.acts,
        qm_flag.softmax_out, qm_flag.mode)
    w8 = type(flag)(flag.wqs, flag.scales, flag.biases, flag.acts,
                    flag.softmax_out, "w8")
    stack_gpu = sv["gpu_stack"]
    r = np.random.default_rng(4)
    preds = [("int8 flagship (w8a8, fused_linear_w8a8 x3)",
              Predictor(flag, buckets=BUCKETS), BUCKETS, FLAGSHIP[0]),
             ("w8 flagship (fused_linear_w8 x3)",
              Predictor(w8, buckets=BUCKETS), BUCKETS, FLAGSHIP[0]),
             ("4x4096 stack (fused_mlp_w8a8_forward)",
              Predictor(stack_gpu, buckets=(STACK_B,)), (STACK_B,), STACK_N)]
    for name, pred, buckets, width in preds:
        pred.warmup()
        for b in buckets:
            x = r.uniform(0, 1, size=(b, width)).astype(np.float32)
            pred.timer.samples.clear()
            for _ in range(TIMED_RUNS):
                pred.predict(x)
            log(f"[timing] {name} Predictor bucket {b}: p50 "
                f"{pred.latency()['p50_s'] * 1e3:.4f} ms host clock "
                f"(n={TIMED_RUNS})")
        b = buckets[0]
        x = r.uniform(0, 1, size=(b, width)).astype(np.float32)
        for _ in range(3):
            pred.predict(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            pred.predict(x)
        wall_us = (time.perf_counter() - t0) / 20 * 1e6
        prof = _profile_steps(lambda: pred.predict(x))
        top = ", ".join(f"{n} {us:.1f}" for n, us in
                        list(prof["by_kernel"].items())[:3])
        log(f"[timing] request bucket {b} {name}: kernels per request "
            + ", ".join(f"{n} x{c:g}" for n, c in prof["calls"].items()))
        log(f"[timing] request bucket {b} {name}: {wall_us:.1f} us/request "
            f"wall, {prof['launches']:.0f} kernels + {prof['copies']:.0f} "
            f"copies/request, device busy {prof['busy_us']:.1f} us/request, "
            f"idle share {1 - prof['busy_us'] / wall_us:.3f}; largest "
            f"(us/request): {top}")
        if pred is preds[0][1]:
            # the w8a8 request at bucket 8: one launch a layer, no
            # quantizer kernel before a product
            check("quantize_rows_kernel" not in prof["calls"]
                  and prof["calls"].get("w8a8_kernel") == 3,
                  f"--int8 request bucket {b}: kernels {prof['calls']}, "
                  f"want 3 w8a8_kernel and no quantize_rows_kernel")

    times = {}
    with torch.inference_mode():
        flag_layers = list(zip(flag._padded(), flag.scales, flag.biases,
                               FLAGSHIP_INT8_ACTS))
        wq3, sw2, b2 = stack_gpu._cache["stacked"]
        B = W8A8_DIRECT_B
        w8a8_direct(B, flag_layers, _rand(528, B, FLAGSHIP[0], uniform=True),
                    "flagship")
        w8a8_direct(B, [(wq3[0], sw2[0], b2[0], "relu")],
                    _rand(548, B, STACK_N), "4096^2")
        for B in W8A8_TIMED[0]:
            t = w8a8_timing(B, flag_layers, _rand(500 + B, B, FLAGSHIP[0],
                                                  uniform=True), "flagship")
            if B == 8:
                times["fused_linear_w8a8"] = t
        for B in W8A8_TIMED[1]:
            x = torch.as_tensor(stack["x"] if B == STACK_B else np.random.
                                default_rng(6).normal(size=(B, STACK_N)).
                                astype(np.float32), device=DEVICE)
            w8a8_timing(B, [(wq3[0], sw2[0], b2[0], "relu")], x, "4096^2")
        for B in W8_TIMED_BATCHES:
            t = w8_timing(B, w8)
            if B == 8:
                times["fused_linear_w8"] = t
        times["fused_mlp_w8a8_forward"] = mlp_w8a8_timing(stack_gpu, stack)
    return times


def w8a8_timing(B: int, layers, h, what: str) -> tuple:
    """Kernel 5 on ``layers`` ((codes, scale, bias, act) each) from the input
    ``h`` (B rows), each layer in turns, twice, with kernel 5 forced to its
    other instance (where it takes B rows), kernel 4 ("default") on the same
    codes, kernel 1 on the same weights dequantized to f32 and
    ``torch._int_mm`` on the same int8
    codes (the bare product, where it takes the shape): device time per call
    in a CUDA graph and the profiler's kernel time (busy, overlap counted
    twice), and kernel 5's CUDA-event median beside its plain version's and
    its bound.  Returns (kernel ms, plain ms, None, graph us), summed over
    the layers."""
    from tensor_ops_tpu_torch.ops import kernels as K

    dev = torch.cuda.current_device()
    names = ("k5", "k5 other", "kernel 4", "kernel 1", "_int_mm")
    sums = dict.fromkeys(names + ("busy", "events", "plain", "bound"), 0.0)
    for q, s_, b, a in layers:
        k, o = h.shape[1], q.shape[0]
        plan = K.w8a8_plan(B, k, o, K._sm_count(dev))
        other = None  # the other instance, where it takes B rows
        if B <= K.W8A8_ROWS[0]:
            other = K.w8a8_plan(B, k, o, K._sm_count(dev), instance=(
                "fused" if plan.instance == "pdl" else "pdl"))
        w = q[:, :k].float() * s_.float().reshape(-1, 1)
        xq = K.quantize_acts_int8(h)[0]
        calls = {
            "k5": lambda: K._fused_linear_w8a8_cuda(h, q, s_, b, a),
            "kernel 4": lambda: K._fused_linear_w8_cuda(h, q, s_, b, a,
                                                        "default"),
            "kernel 1": lambda: K._fused_linear_cuda(h, w, b, a, False),
            "_int_mm": lambda: torch._int_mm(xq, q[:, :k].t()),
        }
        if other is not None:  # run under w8a8_instance below
            calls["k5 other"] = calls["k5"]
        try:
            calls["_int_mm"]()
            torch.cuda.synchronize()
        except RuntimeError as err:
            refused = str(err).splitlines()[0][:120]
            del calls["_int_mm"]
        graph, busy = {}, {}
        for n in list(calls) + list(calls)[::-1]:
            with (w8a8_instance(other.instance) if n == "k5 other"
                  else contextlib.nullcontext()):
                graph.setdefault(n, []).append(_graph_us(calls[n]))
                busy.setdefault(n, []).append(
                    _profile_steps(calls[n])["busy_us"])
        g = {n: statistics.median(v) for n, v in graph.items()}
        bz = {n: statistics.median(v) for n, v in busy.items()}
        k_ms = _median_ms(calls["k5"])
        p_ms = _median_ms(lambda: K.fused_linear_w8a8_ref(h, q, s_, b, a))
        least = _bound(B * k * 4 + o * k + 2 * o * 4 + B * o * 4,
                       2 * B * k * o, "int8")
        for n in g:
            sums[n] += g[n]
        sums["busy"] += bz["k5"]
        sums["events"] += k_ms
        sums["plain"] += p_ms
        sums["bound"] += least[0] * 1e3
        log(f"[timing] fused_linear_w8a8 {what} B={B} {k}->{o} {a}: plan "
            f"{plan.instance} rows {plan.rows} tiles {plan.tiles} grid "
            f"{plan.grid}; device per call (CUDA graph, median of 2 in turns) "
            + ", ".join(f"{n} {g[n]:.2f}" for n in g)
            + ("" if "_int_mm" in g else f", _int_mm refused ({refused})")
            + (f" us ({other.instance} grid {other.grid})" if other else
               " us (the one launch takes at most 8 rows)")
            + "; profiler busy "
            + ", ".join(f"{n} {bz[n]:.2f}" for n in bz)
            + f" us; events k5 {k_ms:.4f} ms, plain {p_ms:.4f} ms; bound "
            f"{least[0] * 1e3:.4f} us by {least[1]}")
        h = K.fused_linear_w8a8_ref(h, q, s_, b, a)
    log(f"[timing] fused_linear_w8a8 {what} B={B}, {len(layers)} layer(s): "
        f"device per call (CUDA graph) "
        + ", ".join(f"{n} {sums[n]:.2f}" for n in names if sums[n])
        + f" us; k5 profiler busy {sums['busy']:.2f} us; events "
        f"{sums['events']:.4f} ms, plain {sums['plain']:.4f} ms; bound "
        f"{sums['bound']:.4f} us")
    return sums["events"], sums["plain"], None, sums["k5"]


def w8_timing(B: int, model) -> tuple:
    """Kernel 4 on the w8 flagship's three layers at batch B ("default"),
    each layer in turns with kernel 1 on the same weights dequantized to f32
    (the instance linear_plan picks) over 3 repetitions: profiler device
    time and CUDA-event medians per layer and in sum, beside kernel 4's
    bound and its plain version.  Returns (kernel ms, plain ms, None, device
    us), summed over the layers."""
    from tensor_ops_tpu_torch.ops import kernels as K

    h = _rand(520 + B, B, FLAGSHIP[0], uniform=True)
    sums = [0.0] * 5
    for i, (q, s_, b, a) in enumerate(zip(model._padded(), model.scales,
                                          model.biases, FLAGSHIP_INT8_ACTS)):
        k, o = FLAGSHIP[i], FLAGSHIP[i + 1]
        w = q[:, :k].float() * s_.float().reshape(-1, 1)

        def w8():
            return K._fused_linear_w8_cuda(h, q, s_, b, a, "default")

        def f32():
            return K._fused_linear_cuda(h, w, b, a, False)

        reps = []
        for _ in range(3):
            kp, lp = _profile_steps(w8), _profile_steps(f32)
            reps.append((kp["busy_us"], lp["busy_us"], _median_ms(w8),
                         _median_ms(f32)))
        k_us, l_us, k_ms, l_ms = (statistics.median(r[j] for r in reps)
                                  for j in range(4))
        p_ms = _median_ms(lambda: K.fused_linear_w8_ref(h, q, s_, b, a))
        plan, lplan = K.w8_plan(B, k, o), K.linear_plan(B, k, o)
        for j, v in enumerate((k_us, l_us, k_ms, l_ms, p_ms)):
            sums[j] += v
        log(f"[timing] fused_linear_w8 B={B} {k}->{o} {a}: {plan.instance} "
            f"grid {plan.grid}; device (profiler) in turns over 3 "
            f"repetitions {', '.join(f'{r[0]:.2f}' for r in reps)} us vs "
            f"kernel 1 ({lplan.instance} grid {lplan.grid}, f32 weights) "
            f"{', '.join(f'{r[1]:.2f}' for r in reps)} us (medians "
            f"{k_us:.2f} vs {l_us:.2f}); events {k_ms:.4f} vs {l_ms:.4f} ms; "
            f"plain {p_ms:.4f} ms")
        h = K.fused_linear_w8_ref(h, q, s_, b, a, "default")
    least = w8_bound(B)
    log(f"[timing] fused_linear_w8 B={B} three flagship layers: device "
        f"{sums[0]:.2f} us vs kernel 1's {sums[1]:.2f} us; events "
        f"{sums[2]:.4f} vs {sums[3]:.4f} ms; plain {sums[4]:.4f} ms; bound "
        f"{least[0] * 1e3:.4f} us by {least[1]}")
    return sums[2], sums[4], None, sums[0]


def mlp_w8a8_timing(stack_gpu, stack) -> tuple:
    """Kernel 6 on the 4 x 4096 stack at B = 16: profiler device time over
    3 repetitions of 10 back-to-back calls and with L2 flushed before each
    call, the CUDA-event median, its plain version, the per-layer
    fused_linear_w8a8 chain (events and kernels), the weight stream's rate;
    and device time at B = 64.  Returns (kernel ms, plain ms)."""
    from tensor_ops_tpu_torch.ops import kernels as K

    wq3, sw2, b2 = stack_gpu._cache["stacked"]
    x = torch.as_tensor(stack["x"], device=DEVICE)

    def kernel(xx=x):
        return K._fused_mlp_w8a8_forward_cuda(xx, wq3, sw2, b2, "relu")

    def chain():
        h = x
        for l in range(STACK_L):
            h = K._fused_linear_w8a8_cuda(h, wq3[l], sw2[l], b2[l],
                                          STACK_ACTS[l])
        return h

    flush = torch.empty(2 * 64 * 2**20 // 4, device=DEVICE)  # 128 MB > L2

    def cold():
        flush.fill_(1.0)
        return kernel()

    warm_us = []
    for _ in range(3):
        prof = _profile_steps(kernel)
        check(list(prof["by_kernel"]) == ["mlp_w8a8_kernel"], f"the profiler "
              f"saw the stack's forward as {sorted(prof['by_kernel'])}")
        warm_us.append(prof["busy_us"])
    cold_us = _profile_steps(cold)["by_kernel"]["mlp_w8a8_kernel"]
    k_ms = _median_ms(kernel)
    p_ms = _median_ms(lambda: K.fused_mlp_w8a8_forward_ref(
        x, wq3, sw2, b2, "relu"))
    c_ms = _median_ms(chain)
    cprof = _profile_steps(chain)
    # device time per forward without host time: the whole-MLP kernel and
    # the per-layer chain, in turns (a stream capture may refuse the
    # cooperative launch: then its times read nan)
    graphs = []
    for f in (kernel, chain, chain, kernel):
        try:
            graphs.append(_graph_us(f))
        except RuntimeError as err:
            log(f"[timing] a CUDA graph of {f.__name__} failed: {err}")
            graphs.append(float("nan"))
            torch.cuda.synchronize()
    xb = torch.as_tensor(np.random.default_rng(5).normal(
        size=(64, STACK_N)).astype(np.float32), device=DEVICE)
    b64_us = _profile_steps(lambda: kernel(xb))["busy_us"]
    us = statistics.median(warm_us)
    least = bounds()["fused_mlp_w8a8_forward"]
    nbytes = STACK_L * STACK_N * STACK_N
    plan = K.mlp_w8a8_plan(STACK_B, STACK_N, STACK_L)
    log(f"[timing] fused_mlp_w8a8_forward 4x4096 B={STACK_B}: 1 kernel a "
        f"forward ({plan.grid} blocks, ring of {plan.depth} x {plan.kc} k, "
        f"{2 * STACK_L} grid barriers); device (profiler, 10 back-to-back "
        f"calls) {', '.join(f'{u:.2f}' for u in warm_us)} us, median {us:.2f} "
        f"us ({us / (least[0] * 1e3):.2f}x the bound {least[0] * 1e3:.3f} us "
        f"by {least[1]}), with L2 flushed before each call {cold_us:.2f} us; "
        f"the weights stream at {nbytes / (us * 1e-6) / 1e9:.0f} GB/s "
        f"({nbytes / (cold_us * 1e-6) / 1e9:.0f} GB/s cold) against "
        f"{HBM_BPS / 1e9:.0f}; events kernel {k_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms, per-layer fused_linear_w8a8 chain {c_ms:.4f} ms "
        f"({cprof['launches']:.0f} kernels, {cprof['busy_us']:.1f} us); "
        f"device per forward in a CUDA graph, in turns: kernel 6 "
        f"{graphs[0]:.2f}, {graphs[3]:.2f} us, chain {graphs[1]:.2f}, "
        f"{graphs[2]:.2f} us; B=64 device {b64_us:.2f} us "
        f"({K.mlp_w8a8_plan(64, STACK_N, STACK_L).groups} group)")
    return k_ms, p_ms


def phase_train_routes() -> None:
    """Where a flagship training step's time goes on the card at the
    app's minibatch of 100, for each route: wall time per step (host clock
    over 20 steps ending in a synchronise), kernels launched and device
    busy time per step (profiler), and the device's idle share."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.backend.rng import Rng
    from tensor_ops_tpu_torch.models import (FusedMLP, act_logistic,
                                             act_softmax, cross_entropy,
                                             gen_net)
    from tensor_ops_tpu_torch.models.training import train_minibatch

    be = TorchBackend(torch.float32, DEVICE)
    net = gen_net(be, FLAGSHIP[0], FLAGSHIP[-1],
                  [(h, act_logistic()) for h in FLAGSHIP[1:-1]],
                  act_softmax(), Rng(be, 0))
    fm = FusedMLP.from_network(net)
    loss = cross_entropy(FLAGSHIP[-1])
    x, y, _, _ = train_step_inputs(120, FLAGSHIP, 100, "softmax_xent")
    routes = {
        "--fused (train_fullfused)":
            lambda: fm.train_fullfused(TRAIN_RATE, x, y),
        "FusedMLP.train (fused_linear + autograd)":
            lambda: fm.train(TRAIN_RATE, x, y),
        "--minibatch (IR, vmapped)":
            lambda: train_minibatch(net, loss, be, TRAIN_RATE, x, y),
    }
    for name, step in routes.items():
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) / 20 * 1e6
        prof = _profile_steps(step)
        top = ", ".join(f"{n} {us:.1f}" for n, us in
                        list(prof["by_kernel"].items())[:3])
        log(f"[timing] step B=100 {name}: {wall_us:.1f} us/step wall, "
            f"{prof['launches']:.0f} kernels + {prof['copies']:.0f} "
            f"copies/step, device busy "
            f"{prof['busy_us']:.1f} us/step, idle share "
            f"{1 - prof['busy_us'] / wall_us:.3f}; largest (us/step): {top}")

def synthetic_set(tmp: str):
    """The synthetic pseudo-MNIST set (the offline fallback of the loader,
    in a fresh data directory): training rows/255 and one-hot labels, test
    rows/255 and labels, float64."""
    from tensor_ops_tpu_torch.utils.mnist_data import load_mnist

    with no_download(), contextlib.redirect_stdout(io.StringIO()):
        train_raw, test_raw = load_mnist(tempfile.mkdtemp(dir=tmp))
    tX = np.stack([d / 255.0 for _, d in train_raw])
    tY = np.eye(FLAGSHIP[-1])[[l for l, _ in train_raw]]
    vX = np.stack([d / 255.0 for _, d in test_raw])
    vL = np.array([l for l, _ in test_raw])
    return tX, tY, vX, vL


def _fit_rate(res, batch: int) -> tuple:
    """(samples/s over the steps after FIT_TIMED_FROM, the first record's
    ms) from a fit run's history: each record's ``t`` is the host clock
    from fit's start to its log boundary, after the synchronise that reads
    the loss (and the validation, where there is one), so the first
    record of a run without ``val`` is its first step's wall time, the
    loader's build and first copies included."""
    t = {h["step"]: h["t"] for h in res.history}
    last = res.history[-1]["step"]
    rate = (last - FIT_TIMED_FROM) * batch / (t[last] - t[FIT_TIMED_FROM])
    return rate, t[1] * 1e3


def phase_fit(tmp: str) -> dict:
    """The fit slice: the flagship through ``fit`` on the card (adam), its
    crash/resume chain and ``prefetch=0`` run bit for bit against it, 5 sgd
    steps against the same ``fit`` on the CPU in f64, and one step's
    profile."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.backend.rng import Rng
    from tensor_ops_tpu_torch.models import (Network, act_logistic,
                                             act_softmax, adam,
                                             cross_entropy, fit, gen_net,
                                             sgd)
    from tensor_ops_tpu_torch.models.trainer import make_opt_step
    from tensor_ops_tpu_torch.ops import kernels as K
    from tensor_ops_tpu_torch.utils.checkpoint import load_meta
    from tensor_ops_tpu_torch.utils.native import NativeLoader

    tX, tY, vX, vL = synthetic_set(tmp)
    be = TorchBackend(torch.float32, DEVICE)
    net = gen_net(be, FLAGSHIP[0], FLAGSHIP[-1],
                  [(h, act_logistic()) for h in FLAGSHIP[1:-1]],
                  act_softmax(), Rng(be, 0))
    loss = cross_entropy(FLAGSHIP[-1])
    probe = NativeLoader(tX[:2], tY[:2], batch=1)
    native = probe.is_native
    probe.close()
    check(native, "NativeLoader fell back to NumPy: the C++ loader did not "
          "build (g++ is on the card machine, since nvcc needs it)")
    # one step at a time, as before chaining: phase 20 times the chained
    # loop beside it
    kw = dict(epochs=FIT_EPOCHS, batch_size=FIT_BATCH, lr=FIT_LR,
              log_every=FIT_LOG_EVERY, verbose=False, chain_steps=1)
    steps = FIT_EPOCHS * (-(-len(tX) // FIT_BATCH))

    # prefetch=2 (the default) without val, the first fit on this network
    # in the process: its first record is the first step's wall time
    runs = {2: fit(net, loss, be, tX, tY, optimizer=adam(), prefetch=2,
                   **kw)}

    ck = os.path.join(tmp, "fit.npz")
    metrics = os.path.join(tmp, "fit.jsonl")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    main = fit(net, loss, be, tX, tY, optimizer=adam(), val=(vX, vL),
               metrics_path=metrics, checkpoint_path=ck,
               checkpoint_every=FIT_CHECKPOINT_EVERY, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    h = main.history
    with open(metrics) as f:
        recorded = [json.loads(line) for line in f]
    check(main.steps == steps, f"fit ran {main.steps} steps, want {steps}")
    check(recorded == h, "the metrics record differs from the history")
    check(h[-1]["loss"] < h[0]["loss"],
          f"fit: the loss did not fall ({h[0]['loss']} -> {h[-1]['loss']})")
    check(all(math.isfinite(x["loss"]) for x in h), "fit: non-finite loss")
    check(load_meta(ck + ".state")["step"] == steps,
          "fit: the last .state checkpoint is not at the last step")
    log(f"[fit] flagship {'-'.join(map(str, FLAGSHIP))} fit(adam, lr "
        f"{FIT_LR}, B={FIT_BATCH}, {FIT_EPOCHS} epochs = {steps} steps, val "
        f"{len(vX)} rows every {FIT_LOG_EVERY} steps, checkpoint every "
        f"{FIT_CHECKPOINT_EVERY}): loss {h[0]['loss']:.4f} -> "
        f"{h[-1]['loss']:.4f}, val_acc {h[0]['val_acc']:.3f} -> "
        f"{h[-1]['val_acc']:.3f}; {wall:.2f} s in all; peak device memory "
        f"{peak} bytes (torch.cuda.max_memory_allocated); NativeLoader "
        f"native: {native}; hand-written kernel launches {launches}")

    # crash at the end of epoch 1, resume to the 2-epoch budget
    ck2 = os.path.join(tmp, "crash.npz")
    fit(net, loss, be, tX, tY, optimizer=adam(), checkpoint_path=ck2,
        checkpoint_every=FIT_CHECKPOINT_EVERY, **dict(kw, epochs=1))
    other = gen_net(be, FLAGSHIP[0], FLAGSHIP[-1],
                    [(h_, act_logistic()) for h_ in FLAGSHIP[1:-1]],
                    act_softmax(), Rng(be, 99))
    resumed = fit(other, loss, be, tX, tY, optimizer=adam(),
                  checkpoint_path=ck2, resume=True, **kw)
    check(resumed.steps == steps and resumed.history[0]["step"] ==
          steps // FIT_EPOCHS + 1, "the resumed run did not continue at the "
          "saved step")
    check(all(torch.equal(a, b) for a, b in
              zip(resumed.net.params, main.net.params)),
          "crash/resume: the resumed run differs from the straight run")
    log(f"[fit] crash/resume (1 epoch with a checkpoint at step "
        f"{FIT_CHECKPOINT_EVERY}, then resume=True to {FIT_EPOCHS} epochs): "
        f"bit-equal to the straight run")

    # prefetch=0 without val, after the runs above: its first step is
    # warm. Both prefetch runs are bit-equal to the main run, and their log
    # boundaries time the steps
    runs[0] = fit(net, loss, be, tX, tY, optimizer=adam(), prefetch=0, **kw)
    for depth, r in runs.items():
        check([x["loss"] for x in r.history] ==
              [x["loss"] for x in h], f"prefetch={depth}: losses differ")
        check(all(torch.equal(a, b) for a, b in
                  zip(r.net.params, main.net.params)),
              f"prefetch={depth}: parameters differ from the main run")
    rates = {d: _fit_rate(r, FIT_BATCH) for d, r in runs.items()}
    log("[fit] prefetch=2 and prefetch=0: bit-equal to each other and to "
        "the main run")
    for depth, what in ((2, "the first fit on this network in the "
                            "process"),
                        (0, "after four fits on it: warm")):
        rate, first_ms = rates[depth]
        log(f"[fit] samples/s over steps {FIT_TIMED_FROM + 1}-{steps} "
            f"(host clock at the log boundaries, each after a synchronise), "
            f"prefetch={depth}: {rate:.1f}; first step {first_ms:.1f} ms "
            f"from fit's start ({what})")

    # 5 sgd steps, on the card in f32 and on the CPU in f64, from the same
    # parameters
    cpu = TorchBackend(torch.float64, "cpu")
    net64 = Network(net.op, tuple(cpu.asarray(p.cpu()) for p in net.params),
                    net.act_names)
    few = dict(kw, epochs=1, log_every=1)
    on_card = fit(net, loss, be, tX[:FIT_SGD_ROWS], tY[:FIT_SGD_ROWS],
                  optimizer=sgd(), **few)
    on_cpu = fit(net64, loss, cpu, tX[:FIT_SGD_ROWS], tY[:FIT_SGD_ROWS],
                 optimizer=sgd(), **few)
    check(on_card.steps == on_cpu.steps == FIT_SGD_ROWS // FIT_BATCH,
          "the sgd runs did not take 5 steps")
    e_loss = max_err(torch.tensor([x["loss"] for x in on_card.history]),
                     torch.tensor([x["loss"] for x in on_cpu.history]),
                     TOL_5_STEPS)
    e_par = max(max_err(a, b, TOL_5_STEPS)
                for a, b in zip(on_card.net.params, on_cpu.net.params))
    log(f"[fit] 5 sgd steps (lr {FIT_LR}, B={FIT_BATCH}, the first "
        f"{FIT_SGD_ROWS} rows) vs the same fit on the CPU in f64: losses "
        f"max|err| {e_loss:.2e}, parameters {e_par:.2e}, tol "
        f"{TOL_5_STEPS[0]:g}+{TOL_5_STEPS[1]:g}|ref|")

    # one step's device work: the vmapped per-sample gradient, its mean and
    # the adam update
    step_fn = make_opt_step(net, loss, be, adam())
    xb = be.asarray(tX[:FIT_BATCH].astype(np.float32))
    yb = be.asarray(tY[:FIT_BATCH].astype(np.float32))
    opt = adam()
    state = [opt.init(net.params), net.params]

    def one_step():
        v, state[0], state[1] = step_fn(FIT_LR, xb, yb, state[0], state[1])
        return v

    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        one_step()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) / 20 * 1e6
    prof = _profile_steps(one_step)
    top = ", ".join(f"{n} {us:.1f}" for n, us in
                    list(prof["by_kernel"].items())[:4])
    log(f"[timing] fit step B={FIT_BATCH} (vmapped IR gradient + mean + "
        f"adam): {wall_us:.1f} us/step wall, {prof['launches']:.0f} kernels "
        f"+ {prof['copies']:.0f} copies/step, device busy "
        f"{prof['busy_us']:.1f} us/step, idle share "
        f"{1 - prof['busy_us'] / wall_us:.3f}; largest (us/step): {top}")
    return {"launches": launches, "rates": rates, "peak": peak}


def _leaves(net) -> list:
    return list(net.states) + list(net.params)


def _seq_fit_on_cpu(src: str, dst: str) -> None:
    """The recurrent fit slice's CPU runs, in a second interpreter (a run
    at this size on the CPU left the profiler of the process that made it
    losing device events): ``fit_sequences`` from the start leaves in the
    npz ``src`` over its sequences, in f64 and in f32, one record a step;
    writes each run's losses, final leaves and seconds to the npz
    ``dst``."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.models import fit_sequences, squared_error
    from tensor_ops_tpu_torch.models.recurrent import RecurrentNetwork

    z = np.load(src)
    out = {}
    for tag, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        cpu = TorchBackend(dtype, "cpu")
        tmpl = rnn_model(cpu)
        k = len(tmpl.states)
        leaves = [cpu.asarray(z[f"leaf_{i}"])
                  for i in range(k + len(tmpl.params))]
        net = RecurrentNetwork(tmpl.op, leaves[:k], leaves[k:], tmpl.arch)
        t0 = time.perf_counter()
        res = fit_sequences(net, squared_error(RNN_OUT), cpu, z["XS"],
                            z["TS"], epochs=1, batch_size=SEQ_FIT_CPU_BATCH,
                            log_every=1, verbose=False, chain_steps=1,
                            **SEQ_FIT_RATES)
        out[f"{tag}_s"] = time.perf_counter() - t0
        out[f"{tag}_loss"] = np.array([x["loss"] for x in res.history])
        out[f"{tag}_leaves"] = np.concatenate(
            [t.numpy().reshape(-1) for t in _leaves(res.net)])
    np.savez(dst, **out)


def _held_to_f64(card, cpu: dict, floor: float,
                 f32: str = "the CPU f32 run") -> str:
    """The card run's losses and leaves against the f64 run's (``cpu``'s
    ``f64_loss`` and ``f64_leaves``), each within ``floor`` plus twice the
    f32 run's largest distance from the f64 one (its drift: ``f32_loss``,
    ``f32_leaves``; ``f32`` names that run), measured apart for the losses
    and the leaves; returns the log line."""
    got = {"loss": torch.tensor([x["loss"] for x in card.history]),
           "leaves": torch.cat([_whole(t).double().cpu().reshape(-1)
                                for t in _leaves(card.net)])}
    out = []
    for name, c in got.items():
        ref = torch.as_tensor(cpu[f"f64_{name}"])
        drift = float((torch.as_tensor(cpu[f"f32_{name}"]).double()
                       - ref).abs().max())
        tol = floor + 2 * drift
        e = max_err(c, ref, (tol, 0.0))
        out.append(f"{name} max|err| {e:.2e} (tol {tol:.2e} = {floor:g} + 2 "
                   f"x {f32}'s drift {drift:.2e})")
    return "; ".join(out)


def phase_seq_fit(tmp: str) -> dict:
    """The recurrent fit slice: ``fit_sequences`` at full width on the card
    (dual-rate SGD, 2 epochs), its crash/resume chain bit for bit,
    accumulation, adam with EMA and accumulation through a Ctrl-C, the
    offloaded tape, 3 steps against CPU f64, the caller's network
    unchanged; returns what :func:`phase_seq_fit_timing` times."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.models import adam, fit_sequences, squared_error
    from tensor_ops_tpu_torch.ops import kernels as K
    from tensor_ops_tpu_torch.utils.checkpoint import load_meta

    be = TorchBackend(torch.float32, DEVICE)
    net = rnn_model(be)
    before = [t.clone() for t in _leaves(net)]
    r = np.random.default_rng(0)
    XS = r.standard_normal((SEQ_FIT_SEQS, RNN_N, RNN_IN)).astype(np.float32)
    TS = r.standard_normal((SEQ_FIT_SEQS, RNN_N, RNN_OUT)).astype(np.float32)
    loss = squared_error(RNN_OUT)
    B = SEQ_FIT_BATCH
    spe = SEQ_FIT_SEQS // B
    steps = SEQ_FIT_EPOCHS * spe
    # one step at a time, as before chaining: phase 21 times the chained
    # loop beside it
    kw = dict(batch_size=B, log_every=SEQ_FIT_LOG_EVERY, verbose=False,
              chain_steps=1, **SEQ_FIT_RATES)
    shape = (f"Elman {RNN_IN}->[{RNN_HIDDEN}]->{RNN_OUT}, n={RNN_N}, B={B}, "
             f"{SEQ_FIT_SEQS} sequences")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    main = fit_sequences(net, loss, be, XS, TS, epochs=SEQ_FIT_EPOCHS, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = K.launch_counts()
    h = main.history
    check(main.steps == steps, f"fit_sequences ran {main.steps} steps, "
          f"want {steps}")
    check(all(math.isfinite(x["loss"]) for x in h),
          "fit_sequences: non-finite loss")
    first = [x["loss"] for x in h if x["step"] <= spe]
    last = [x["loss"] for x in h if x["step"] > spe]
    check(h[-1]["loss"] < h[0]["loss"] and
          statistics.mean(last) < statistics.mean(first),
          f"fit_sequences: the loss did not fall ({[x['loss'] for x in h]})")
    check(all(torch.equal(a, b) for a, b in zip(before, _leaves(net))),
          "fit_sequences changed the caller's network")
    t = {x["step"]: x["t"] for x in h}
    rate = (steps - 1) * B / (t[steps] - t[1])
    log(f"[seqfit] fit_sequences ({shape}, dual-rate SGD rate_state "
        f"{SEQ_FIT_RATES['rate_state']} rate_param "
        f"{SEQ_FIT_RATES['rate_param']}, {SEQ_FIT_EPOCHS} epochs = {steps} "
        f"steps): loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f} (epoch "
        f"means {statistics.mean(first):.4f} -> {statistics.mean(last):.4f});"
        f" {wall:.2f} s in all; the caller's network unchanged; "
        f"hand-written kernel launches {launches}")
    log(f"[seqfit] sequences/s over steps 2-{steps} (host clock at the log "
        f"boundaries, each after a synchronise): {rate:.1f}; the first step "
        f"{t[1] * 1e3:.1f} ms from fit_sequences' start (the first run on "
        f"this network in the process); peak device memory {peak} bytes "
        f"(torch.cuda.max_memory_allocated)")

    # the CPU runs of the comparison with f64 below, in a second
    # interpreter from the caller's leaves, started now: they overlap the
    # checks that follow, none of which is timed
    n_c = SEQ_FIT_CPU_STEPS * SEQ_FIT_CPU_BATCH
    src, dst = os.path.join(tmp, "seq_cpu_in.npz"), os.path.join(
        tmp, "seq_cpu_out.npz")
    np.savez(src, XS=XS[:n_c], TS=TS[:n_c],
             **{f"leaf_{i}": t.cpu().numpy()
                for i, t in enumerate(_leaves(net))})
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke._seq_fit_on_cpu(*sys.argv[1:])", src, dst],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=here,
        env=dict(os.environ, PYTHONPATH=here))
    atexit.register(proc.kill)   # a failed check below leaves it no orphan

    # crash at the end of epoch 1, resume to the budget
    ck = os.path.join(tmp, "seq.npz")
    fit_sequences(net, loss, be, XS, TS, epochs=1, checkpoint_path=ck,
                  checkpoint_every=spe, **kw)
    check(load_meta(ck + ".state")["step"] == spe,
          "fit_sequences: the checkpoint is not at the end of epoch 1")
    resumed = fit_sequences(rnn_model(be, RNN_SEED + 1), loss, be, XS, TS,
                            epochs=SEQ_FIT_EPOCHS, checkpoint_path=ck,
                            resume=True, **kw)
    check(resumed.steps == steps and resumed.history[0]["step"] == spe + 1,
          "the resumed fit_sequences did not continue at the saved step")
    check(all(torch.equal(a, b) for a, b in
              zip(_leaves(resumed.net), _leaves(main.net))),
          "fit_sequences crash/resume: the resumed run differs from the "
          "straight run")
    log(f"[seqfit] crash/resume (1 epoch with a checkpoint at step {spe}, "
        f"then resume=True to {SEQ_FIT_EPOCHS} epochs): states and params "
        f"bit-equal to the straight run")

    # accumulation: two half-batch means over 2 against the whole batch,
    # dual-rate SGD (the same mean up to f32 grouping)
    n_a = SEQ_FIT_ADAM_STEPS * B
    sub = (XS[:n_a], TS[:n_a])
    akw = dict(kw, log_every=1)
    acc = fit_sequences(net, loss, be, *sub, epochs=1, accum_steps=2, **akw)
    whole = fit_sequences(net, loss, be, *sub, epochs=1, **akw)
    e_acc = max(max_err(a, b, TOL_5_STEPS) for a, b in
                zip(_leaves(acc.net), _leaves(whole.net)))
    log(f"[seqfit] accum_steps=2, {SEQ_FIT_ADAM_STEPS} dual-rate steps: "
        f"states and params max|err| {e_acc:.2e} from the whole-batch run "
        f"(tol {TOL_5_STEPS[0]:g}+{TOL_5_STEPS[1]:g}|ref|)")

    # adam with the EMA and accumulation, Ctrl-C at step 2 and resumed to
    # the budget: bit-equal to the straight run, EMA included
    ck2 = os.path.join(tmp, "seq_adam.npz")

    def boom(s):
        if s == 2:
            raise KeyboardInterrupt
        return SEQ_FIT_RATES["rate_param"]

    ekw = dict(akw, optimizer=adam(), ema_decay=SEQ_FIT_EMA, accum_steps=2)
    try:
        fit_sequences(net, loss, be, *sub, epochs=1, lr_schedule=boom,
                      checkpoint_path=ck2, **ekw)
        check(False, "the interrupted fit_sequences did not stop")
    except KeyboardInterrupt:
        pass
    check(load_meta(ck2 + ".state")["step"] == 2,
          "fit_sequences: the Ctrl-C checkpoint is not at the interrupted "
          "step")
    flat = lambda s: SEQ_FIT_RATES["rate_param"]  # noqa: E731
    res_a = fit_sequences(rnn_model(be, RNN_SEED + 1), loss, be, *sub,
                          epochs=1, lr_schedule=flat, checkpoint_path=ck2,
                          resume=True, **ekw)
    straight = fit_sequences(net, loss, be, *sub, epochs=1, lr_schedule=flat,
                             **ekw)
    check(all(math.isfinite(x["loss"]) for x in straight.history),
          "adam + EMA + accum_steps: non-finite loss")
    check(all(torch.equal(a, b) for a, b in
              zip(_leaves(res_a.net) + _leaves(res_a.ema_net),
                  _leaves(straight.net) + _leaves(straight.ema_net))),
          "adam + EMA + accum_steps: the Ctrl-C/resume chain differs from "
          "the straight run")
    check(not all(torch.equal(a, b) for a, b in
                  zip(_leaves(straight.ema_net), _leaves(straight.net))),
          "the EMA does not trail the leaves")
    log(f"[seqfit] adam + ema_decay {SEQ_FIT_EMA} + accum_steps=2, "
        f"{SEQ_FIT_ADAM_STEPS} steps: loss {straight.history[0]['loss']:.4f} "
        f"-> {straight.history[-1]['loss']:.4f}; Ctrl-C at step 2 (its "
        f"checkpoint), resumed to the budget: leaves and EMA bit-equal to "
        f"the straight run")

    # the carry tape through pinned host memory under the vmapped step
    off = fit_sequences(net, loss, be, XS[:B], TS[:B], epochs=1,
                        offload_activations=True, **akw)
    on = fit_sequences(net, loss, be, XS[:B], TS[:B], epochs=1, **akw)
    check(all(torch.equal(a, b) for a, b in
              zip(_leaves(off.net), _leaves(on.net))),
          "offload_activations changed the step")
    log("[seqfit] offload_activations=True (the scan's carry tape through "
        "pinned host memory, under the vmapped step): one step bit-equal to "
        "the run without it")

    # the first steps on the card in f32 against the CPU in f64 (and f32,
    # for the drift), the CPU runs' interpreter started above
    card = fit_sequences(net, loss, be, XS[:n_c], TS[:n_c], epochs=1,
                         **dict(kw, log_every=1,
                                batch_size=SEQ_FIT_CPU_BATCH))
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    check(proc.returncode == 0, f"the CPU runs of fit_sequences failed:\n"
          f"{out}{err[-3000:]}")
    cpu = dict(np.load(dst))
    log(f"[seqfit] {SEQ_FIT_CPU_STEPS} dual-rate steps of "
        f"{SEQ_FIT_CPU_BATCH} sequences vs the same "
        f"fit_sequences on the CPU in f64: "
        f"{_held_to_f64(card, cpu, TOL_SEQ_FIT)} (CPU runs in a second "
        f"interpreter, {float(cpu['f64_s']):.1f} s in f64, "
        f"{float(cpu['f32_s']):.1f} s in f32)")

    return {"net": net, "loss": loss, "batch": (XS[:B], TS[:B]),
            "shape": shape}


def phase_seq_fit_timing(sf) -> None:
    """One ``fit_sequences`` step's device work (the vmapped scan-BPTT
    gradient, its mean and the dual-rate update): wall time, kernels,
    device busy time and idle share.  Its profile holds some 10,000 kernel
    events, so it runs after every other profile of the smoke: in one run
    the profiler handed back no device events to a profile taken after
    it."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.models.trainer import _seq_train_step

    be = TorchBackend(torch.float32, DEVICE)
    net, B = sf["net"], SEQ_FIT_BATCH
    step_fn = _seq_train_step(net, sf["loss"], be, RNN_N)
    xb, tb = (be.asarray(a) for a in sf["batch"])
    state = [net.states, net.params]

    def one_step():
        v, state[0], state[1] = step_fn(SEQ_FIT_RATES["rate_state"],
                                        SEQ_FIT_RATES["rate_param"], xb, tb,
                                        state[0], state[1])
        return v

    one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        one_step()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) / 5 * 1e6
    prof = _profile_steps(one_step, steps=2)
    top = ", ".join(f"{n} {us:.1f}" for n, us in
                    list(prof["by_kernel"].items())[:4])
    log(f"[timing] fit_sequences step ({sf['shape']}; vmapped scan-BPTT "
        f"gradient + mean + dual-rate SGD): {wall_us:.1f} us/step wall "
        f"({B / wall_us * 1e6:.1f} sequences/s), {prof['launches']:.0f} "
        f"kernels + {prof['copies']:.0f} copies/step, device busy "
        f"{prof['busy_us']:.1f} us/step, idle share "
        f"{1 - prof['busy_us'] / wall_us:.3f}; largest (us/step): {top}")


def phase_production_fit(tmp: str) -> None:
    """``examples/production_fit.py`` on the card: fit with adamw, a cosine
    schedule, clipping and EMA, a crash and a resume, and the EMA net served
    in int8 by ``Predictor`` through kernel 5 at 2 -> 32 -> 2; kernel 5 at
    those shapes against its plain version."""
    from tensor_ops_tpu_torch.examples import production_fit
    from tensor_ops_tpu_torch.ops import kernels as K

    K.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = production_fit.main(["--device", DEVICE, "--workdir",
                                   os.path.join(tmp, "production_fit")])
    launches = K.launch_counts()
    lines = out.getvalue().splitlines()
    check(res["acc"] > 0.9, f"production_fit served {res['acc']} (> 0.9)")
    check(any(x.startswith("resumed from") for x in lines),
          "production_fit did not resume")
    qm = res["pred"].model
    n_layers = len(qm.wqs)
    want = PROD_REQUESTS * n_layers
    check(launches.get("fused_linear_w8a8", 0) == want,
          f"production_fit: {launches} hand-written kernel launches, want "
          f"{want} of fused_linear_w8a8")
    log(f"[prodfit] examples/production_fit.py on the card: "
        f"{lines[-2].strip()}; hand-written kernel launches {launches} "
        f"({PROD_REQUESTS} requests x {n_layers} layers)")

    # kernel 5 at the served shapes, each layer fed the plain chain's
    # activations, against its plain version: bit for bit (relu, identity)
    shapes = []
    x0 = torch.as_tensor(
        np.random.default_rng(3).uniform(-1, 1, size=(max(PROD_BUCKETS), 2)),
        dtype=torch.float32, device=DEVICE)
    for B in PROD_BUCKETS:
        x = x0[:B]
        for q, s, b, act in zip(qm.wqs, qm.scales, qm.biases, qm.acts):
            y = K._fused_linear_w8a8_cuda(x, q, s, b, act)
            torch.cuda.synchronize()
            ref = K.fused_linear_w8a8_ref(x, q, s, b, act)
            check(torch.equal(y, ref), f"fused_linear_w8a8 {act} B={B} "
                  f"{q.shape[1]}->{q.shape[0]}: not bit-equal to its plain "
                  f"version")
            p = K.w8a8_plan(B, q.shape[1], q.shape[0],
                            K._sm_count(torch.cuda.current_device()))
            shapes.append(f"B={B} {q.shape[1]}->{q.shape[0]} {act} "
                          f"({p.instance})")
            x = ref
    log(f"[prodfit] fused_linear_w8a8 at the served shapes, bit-equal to "
        f"its plain version: {'; '.join(shapes)}")

    # the request's two layers at bucket 64 on the card, per call in a CUDA
    # graph, beside the plain chain
    x = x0[:64]

    def chain(layer):
        h = x
        for q, s, b, act in zip(qm.wqs, qm.scales, qm.biases, qm.acts):
            h = layer(h, q, s, b, act)
        return h

    us = _graph_us(lambda: chain(K._fused_linear_w8a8_cuda))
    plain_us = _graph_us(lambda: chain(K.fused_linear_w8a8_ref))
    nbytes = sum(64 * q.shape[1] * 4 + q.numel() + 2 * q.shape[0] * 4
                 + 64 * q.shape[0] * 4 for q in qm.wqs)
    ops = sum(2 * 64 * q.numel() for q in qm.wqs)
    bound = _bound(nbytes, ops, "int8")
    log(f"[timing] fused_linear_w8a8 at production_fit's 2->32->2, B=64 (two "
        f"layers, device time per call in a CUDA graph): {us:.2f} us, plain "
        f"version {plain_us:.2f} us; bound {bound[0] * 1e3:.4f} us by "
        f"{bound[1]}")


def _a8_state_on(cpu, state):
    """adam8bit's state ``(t, ((mq, ms, vq, vs), ...))`` on the CPU backend
    ``cpu``: the int8 codes as they are, the scales in its dtype."""
    t, qs = state
    return t.cpu(), tuple(tuple(x.cpu() if x.dtype == torch.int8
                          else cpu.asarray(x.cpu()) for x in leaf)
                    for leaf in qs)


def phase_adam8bit_fit(tmp: str) -> None:
    """``fit`` with adam8bit (nearest rounding) on the flagship: each of
    its A8_STEPS steps on the card against the same step from the same
    state on the CPU in f64, the share of int8 codes that differ, and a
    Ctrl-C at step A8_CRASH resumed bit for bit."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.backend.rng import Rng
    from tensor_ops_tpu_torch.models import (act_logistic, act_softmax,
                                             adam8bit, cross_entropy, fit,
                                             gen_net)
    from tensor_ops_tpu_torch.models.trainer import make_opt_step
    from tensor_ops_tpu_torch.utils.checkpoint import load_meta
    from tensor_ops_tpu_torch.utils.native import NativeLoader

    tX, tY, _, _ = synthetic_set(tmp)
    n = A8_STEPS * FIT_BATCH
    X, Y = tX[:n], tY[:n]
    be = TorchBackend(torch.float32, DEVICE)
    cpus = {d: TorchBackend(d, "cpu") for d in (torch.float64, torch.float32)}

    def flagship(seed):
        return gen_net(be, FLAGSHIP[0], FLAGSHIP[-1],
                       [(h, act_logistic()) for h in FLAGSHIP[1:-1]],
                       act_softmax(), Rng(be, seed))

    net = flagship(0)
    loss = cross_entropy(FLAGSHIP[-1])
    kw = dict(epochs=1, batch_size=FIT_BATCH, lr=FIT_LR, log_every=1,
              verbose=False, chain_steps=1)
    res = fit(net, loss, be, X, Y, optimizer=adam8bit(), **kw)
    check(res.steps == A8_STEPS and all(math.isfinite(x["loss"])
                                        for x in res.history),
          "adam8bit fit: wrong steps or a non-finite loss")

    # fit's steps again (its loader stream, its step), each also taken from
    # the card's state on the CPU in f64 and in f32
    opt = adam8bit()
    step_fn = make_opt_step(net, loss, be, opt)
    cpu_steps = {d: make_opt_step(net, loss, cpu, opt)
                 for d, cpu in cpus.items()}
    loader = NativeLoader(X, Y, batch=FIT_BATCH, seed=0)
    params, state = tuple(net.params), opt.init(tuple(net.params))
    try:
        for k in range(1, A8_STEPS + 1):
            xb, yb = loader.next()
            _, new_state, new_params = step_fn(
                FIT_LR, be.asarray(xb), be.asarray(yb), state, params)
            cpu_out = {}
            for d, cpu in cpus.items():
                cpu_out[d] = cpu_steps[d](
                    FIT_LR, cpu.asarray(xb), cpu.asarray(yb),
                    _a8_state_on(cpu, state),
                    tuple(cpu.asarray(p.cpu()) for p in params))
            _, st64, p64 = cpu_out[torch.float64]
            drift = max(float((a.double() - b).abs().max()) for a, b in
                        zip(cpu_out[torch.float32][2], p64))
            tol = (TOL_A8 + 2 * drift, 0.0)
            e_par = max(max_err(a, b, tol) for a, b in zip(new_params, p64))
            differ = total = 0
            for leaf, leaf64 in zip(new_state[1], st64[1]):
                for j in (0, 2):
                    differ += int((leaf[j].cpu() != leaf64[j]).sum())
                    total += leaf[j].numel()
            big = max(float(p.abs().max()) for p in new_params)
            log(f"[adam8bit] step {k}: parameters max|err| {e_par:.2e} from "
                f"the same step in f64 (tol {tol[0]:.2e} = {TOL_A8:g} + 2 x "
                f"the CPU f32 step's drift {drift:.2e}); int8 moment codes "
                f"that differ: {differ} of {total} ({differ / total:.2e}); "
                f"max|parameter| {big:.4g}")
            params, state = new_params, new_state
    finally:
        loader.close()
    check(all(torch.equal(a, b) for a, b in zip(params, res.net.params)),
          "adam8bit: the replayed steps differ from fit's")
    log(f"[adam8bit] flagship fit(adam8bit, nearest rounding, lr {FIT_LR}, "
        f"B={FIT_BATCH}), {A8_STEPS} steps: loss "
        f"{res.history[0]['loss']:.4f} -> {res.history[-1]['loss']:.4f}; "
        f"the replay of its steps above is bit-equal to it")

    # Ctrl-C at step A8_CRASH: its checkpoint, resumed to the budget,
    # equals the straight run bit for bit
    ck = os.path.join(tmp, "a8_intr.npz")

    def boom(step):
        if step == A8_CRASH:
            raise KeyboardInterrupt
        return FIT_LR

    try:
        fit(net, loss, be, X, Y, optimizer=adam8bit(), lr_schedule=boom,
            checkpoint_path=ck, **kw)
        check(False, "the interrupted adam8bit run did not stop")
    except KeyboardInterrupt:
        pass
    check(load_meta(ck + ".state")["step"] == A8_CRASH,
          "adam8bit: the Ctrl-C checkpoint is not at the interrupted step")
    resumed = fit(flagship(99), loss, be, X, Y, optimizer=adam8bit(),
                  checkpoint_path=ck, resume=True, **kw)
    check(resumed.steps == A8_STEPS and all(
        torch.equal(a, b) for a, b in zip(resumed.net.params,
                                          res.net.params)),
          "adam8bit: the Ctrl-C/resume chain differs from the straight run")
    log(f"[adam8bit] Ctrl-C at step {A8_CRASH} of {A8_STEPS} (the "
        f"checkpoint it leaves), resumed to the budget: bit-equal to the "
        f"straight run")


def phase_autoencoder(tmp: str) -> dict:
    """The autoencoder of examples/autoencoder_digits.py: 5 whole-step
    ``FusedAutoencoder.train`` steps (kernel 3, squared error, 4 layers)
    against ``FusedMLP.train`` on the card and the plain step in CPU f64,
    kernel 3's time at this shape, ``Encoder.fit``, and the autoencoder
    checkpoint round trip."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.backend.rng import Rng
    from tensor_ops_tpu_torch.models import (Encoder, FusedAutoencoder,
                                             act_logistic, adam, gen_net,
                                             squared_error)
    from tensor_ops_tpu_torch.ops import kernels as K
    from tensor_ops_tpu_torch.utils.checkpoint import (load_autoencoder,
                                                       save_autoencoder)

    be = TorchBackend(torch.float32, DEVICE)
    rng = Rng(be, 0)
    i, h, z = AE_DIMS[0], AE_DIMS[1], AE_DIMS[2]
    enc = Encoder(gen_net(be, i, z, [(h, act_logistic())], act_logistic(), rng),
                  gen_net(be, z, i, [(h, act_logistic())], act_logistic(), rng))
    fae = FusedAutoencoder.from_encoder(enc)
    tX = synthetic_set(tmp)[0]
    x32 = torch.as_tensor(tX[:AE_ROWS], dtype=torch.float32, device=DEVICE)
    x64 = torch.as_tensor(tX[:AE_ROWS])
    acts = fae.mlp.acts
    ws64 = [w.double().cpu() for w in fae.mlp.weights]
    bs64 = [b.double().cpu() for b in fae.mlp.biases]

    kernel, plain = fae, fae.mlp
    K.reset_launch_counts()
    losses = []
    for _ in range(AE_STEPS):
        v, kernel = kernel.train(AE_RATE, x32)
        losses.append(v)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    check(launches["fused_mlp_train_step"] == AE_STEPS,
          f"FusedAutoencoder.train: {launches['fused_mlp_train_step']} "
          f"train-step launches for {AE_STEPS} steps")
    ref_losses = []
    for _ in range(AE_STEPS):
        _, plain = plain.train(AE_RATE, x32, x32)
        v64, ws64, bs64 = K.fused_mlp_train_step_ref(
            x64, x64, ws64, bs64, AE_RATE, acts, loss_kind="squared_error")
        ref_losses.append(float(v64))
    torch.cuda.synchronize()
    e_loss = max_err(torch.tensor(losses), torch.tensor(ref_losses),
                     TOL_5_STEPS)
    log(f"[autoencoder] {'-'.join(map(str, AE_DIMS))} logistic (seed 0): "
        f"{AE_STEPS} FusedAutoencoder.train steps (rate {AE_RATE}, "
        f"B={AE_ROWS}): {launches['fused_mlp_train_step']} "
        f"fused_mlp_train_step launches; losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, vs the plain step in CPU f64 max|err| "
        f"{e_loss:.2e}")
    for what, ref in (("FusedMLP.train on the card", plain.to_params()),
                      ("the plain step in CPU f64",
                       [p for wb in zip(ws64, bs64) for p in wb])):
        e = max(max_err(a, b, TOL_5_STEPS)
                for a, b in zip(kernel.mlp.to_params(), ref))
        log(f"[autoencoder] {AE_STEPS} steps' parameters vs {what}: "
            f"max|err| {e:.2e} tol {TOL_5_STEPS[0]:g}+{TOL_5_STEPS[1]:g}|ref|")

    # kernel 3 at this shape
    ws, bs = list(fae.mlp.weights), list(fae.mlp.biases)

    def step():
        return K._fused_mlp_train_step_cuda(x32, x32, ws, bs, AE_RATE, acts,
                                            "squared_error")
    prof = _profile_steps(step)
    k_ms = _median_ms(step)
    p_ms = _median_ms(lambda: K.fused_mlp_train_step_ref(
        x32, x32, ws, bs, AE_RATE, acts, loss_kind="squared_error"))
    bound_ms, bound_by = train_step_bound(AE_DIMS, AE_ROWS)
    stages = K.train_stages(len(AE_DIMS) - 1)
    grid = K.train_grid(K._train_step_capacity(0), K._sm_count(0), AE_ROWS,
                        AE_DIMS)
    log(f"[timing] fused_mlp_train_step {'-'.join(map(str, AE_DIMS))} "
        f"squared error B={AE_ROWS}: device {prof['busy_us']:.2f} us "
        f"(profiler; kernels {sorted(prof['by_kernel'])}), events "
        f"{k_ms:.4f} ms, plain {p_ms:.4f} ms; bound {bound_ms * 1e3:.3f} us "
        f"by {bound_by}; grid {grid}, {len(stages)} stages, "
        f"{len(stages) - 1} grid barriers")

    # Encoder.fit: the joint network through fit, on the synthetic rows
    enc2, res = enc.fit(squared_error(i), be, tX, epochs=2, batch_size=AE_ROWS,
                        lr=AE_FIT_LR, optimizer=adam(), log_every=10,
                        verbose=False)
    hist = res.history
    check(hist[-1]["loss"] < hist[0]["loss"],
          f"Encoder.fit: the reconstruction loss did not fall "
          f"({hist[0]['loss']} -> {hist[-1]['loss']})")
    rate, first_ms = _fit_rate(res, AE_ROWS)
    log(f"[autoencoder] Encoder.fit (adam, lr {AE_FIT_LR}, B={AE_ROWS}, 2 "
        f"epochs = {res.steps} steps): reconstruction loss "
        f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; {rate:.1f} "
        f"samples/s over steps {FIT_TIMED_FROM + 1}-{res.steps}, first step "
        f"{first_ms:.1f} ms")

    path = os.path.join(tmp, "autoencoder.npz")
    save_autoencoder(path, kernel)
    back = load_autoencoder(path, device=DEVICE)
    check(back.n_enc == kernel.n_enc and back.mlp.acts == kernel.mlp.acts
          and back.mlp.loss_kind == "mse"
          and all(torch.equal(a, b) for a, b in
                  zip(back.mlp.to_params(), kernel.mlp.to_params())),
          "save_autoencoder -> load_autoencoder is not bit for bit")
    log("[autoencoder] save_autoencoder -> load_autoencoder: bit for bit")
    return {"launches": launches["fused_mlp_train_step"],
            "device_us": prof["busy_us"], "bound_ms": bound_ms}


def phase_dots() -> None:
    """The dots app on the card: the torch backend, minibatches of 50."""
    from tensor_ops_tpu_torch.apps import dots

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        dots.main(["torch", "--minibatch", "50", "--device", DEVICE])
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    raster = [l for l in lines if len(l) == 51]
    check(len(raster) == 21, f"dots: {len(raster)} raster lines, want 21")
    for line in lines:
        log(f"[dots] {line}")
    log(f"[dots] {wall:.2f} s in all")


def rnn_step_inputs(seed: int, B: int, I: int, O: int):
    """x normal, s a logistic state in (0, 1), weights at 1/sqrt(I + O)
    scale and a bias, all f32 on the card."""
    r = np.random.default_rng(seed)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=DEVICE)

    k = math.sqrt(I + O)
    return (dev(r.normal(size=(B, I))),
            dev(1 / (1 + np.exp(-r.normal(size=(B, O))))),
            dev(r.normal(size=(O, I)) / k), dev(r.normal(size=(O, O)) / k),
            dev(r.normal(size=O) * 0.3))


def phase_rnn_kernels() -> float:
    """Kernel 7 against its plain version on the card: every activation at
    each shape, bit for bit on a rerun, and the gradients of the
    ``autograd.Function`` against autograd through the plain version."""
    from tensor_ops_tpu_torch.ops import kernels as K

    worst = 0.0
    for n, (B, I, O) in enumerate(RNN_STEP_SHAPES):
        args = rnn_step_inputs(600 + n, B, I, O)
        errs = []
        for act in ACTS:
            y, s = K._fused_rnn_step_cuda(*args, act)
            y2, s2 = K._fused_rnn_step_cuda(*args, act)
            torch.cuda.synchronize()
            check(torch.equal(y, y2) and torch.equal(s, s2),
                  f"fused_rnn_step B={B} {I}->{O} {act}: a rerun differs")
            y_ref, s_ref = K.fused_rnn_step_ref(*args, act)
            e = max(max_err(y, y_ref, TOL_Z), max_err(s, s_ref, TOL_RNN_S))
            worst = max(worst, e)
            errs.append(f"{act} {e:.1e}")
        grads = []
        # relu's kink: a z within the sums' rounding of 0 takes the other
        # side in one version, so relu's gradients are compared where z
        # has few entries (B <= 37)
        for act in ACTS if B <= 37 else ("identity", "logistic", "tanh"):
            r = np.random.default_rng(700 + n)
            cy, cs = (torch.as_tensor(r.normal(size=(B, O)), dtype=torch.float32,
                                      device=DEVICE) for _ in range(2))
            sides = []
            for fn in (K.fused_rnn_step, K.fused_rnn_step_ref):
                ts = [a.clone().requires_grad_() for a in args]
                y, s = fn(*ts, act)
                ((y * cy).sum() + (s * cs).sum()).backward()
                sides.append([t.grad for t in ts])
            torch.cuda.synchronize()
            e = max(max_err(a, b, TOL_RNN_GRAD) for a, b in zip(*sides))
            grads.append(f"{act} {e:.1e}")
        log(f"[rnn-kernel] fused_rnn_step B={B} {I}->{O}: bit-equal on a "
            f"rerun; max|err| {', '.join(errs)} (y tol {TOL_Z[0]:g}+"
            f"{TOL_Z[1]:g}|ref|, s' tol {TOL_RNN_S[0]:g}); gradients of the "
            f"autograd.Function vs autograd through the plain version max|err| "
            f"{', '.join(grads)} (tol {TOL_RNN_GRAD[0]:g}+{TOL_RNN_GRAD[1]:g}"
            f"|ref|)")
    return worst


def rnn_seq_inputs(seed: int, n: int, B: int, I: int, O: int):
    """xs (n, B, I) normal and the step's s0, Wx, Ws, b (rnn_step_inputs),
    all f32 on the card."""
    _, s0, wx, ws, b = rnn_step_inputs(seed, B, I, O)
    xs = np.random.default_rng(seed + 1).normal(size=(n, B, I))
    return (torch.as_tensor(xs.astype(np.float32), device=DEVICE), s0, wx, ws,
            b)


def phase_rnn_seq_kernel() -> float:
    """Kernel 7's sequence entry against its plain version and, bit for bit,
    against n step launches, every activation, rerun bit for bit; then the
    "steps" plan of a cell too wide for the cluster, through the public
    wrapper, with its launches counted."""
    from tensor_ops_tpu_torch.ops import kernels as K

    worst = 0.0
    for n_case, (n, B, I, O) in enumerate(RNN_SEQ_SHAPES):
        args = rnn_seq_inputs(900 + n_case, n, B, I, O)
        check(K.rnn_seq_plan(B, I, O) == "resident",
              f"rnn_seq_plan({B}, {I}, {O}) is not resident")
        errs = []
        for act in ACTS:
            ys, sf = K._fused_rnn_seq_cuda(*args, act)
            ys2, sf2 = K._fused_rnn_seq_cuda(*args, act)
            st, out = args[1], []
            for t in range(n):
                y, st = K._fused_rnn_step_cuda(args[0][t], st, *args[2:], act)
                out.append(y)
            torch.cuda.synchronize()
            check(torch.equal(ys, ys2) and torch.equal(sf, sf2),
                  f"fused_rnn_seq n={n} B={B} {I}->{O} {act}: a rerun differs")
            check(torch.equal(ys, torch.stack(out)) and torch.equal(sf, st),
                  f"fused_rnn_seq n={n} B={B} {I}->{O} {act}: not bit-equal "
                  f"to {n} fused_rnn_step launches")
            y_ref, s_ref = K.fused_rnn_seq_ref(*args, act)
            e = max(max_err(ys, y_ref, TOL_SEQ), max_err(sf, s_ref, TOL_SEQ))
            worst = max(worst, e)
            errs.append(f"{act} {e:.1e}")
        log(f"[rnn-kernel] fused_rnn_seq n={n} B={B} {I}->{O}: one launch "
            f"of {K.RNN_SEQ_CLUSTER} blocks ({K.rnn_seq_smem_bytes(B, I, O)} "
            f"bytes of shared memory each; the card holds "
            f"{K._seq_cluster_capacity(0, B, I, O)} such clusters at once); "
            f"bit-equal to {n} fused_rnn_step launches and on a rerun; vs "
            f"fused_rnn_seq_ref max|err| {', '.join(errs)} (tol "
            f"{TOL_SEQ[0]:g}+{TOL_SEQ[1]:g}|ref|)")
    n, B, I, O = 3, 1, RNN_IN, 2 * RNN_HIDDEN
    check(K.rnn_seq_plan(B, I, O) == "steps", f"rnn_seq_plan({B}, {I}, {O})")
    args = rnn_seq_inputs(990, n, B, I, O)
    K.reset_launch_counts()
    ys, sf = K.fused_rnn_seq(*args, "tanh")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    check(counts["fused_rnn_step"] == n and counts["fused_rnn_step.seq"] == 0,
          f"the steps plan launched {counts}")
    y_ref, s_ref = K.fused_rnn_seq_ref(*args, "tanh")
    e = max(max_err(ys, y_ref, TOL_SEQ), max_err(sf, s_ref, TOL_SEQ))
    log(f"[rnn-kernel] fused_rnn_seq n={n} B={B} {I}->{O}: plan steps "
        f"({K.rnn_seq_smem_bytes(B, I, O)} bytes a block would need), {n} "
        f"fused_rnn_step launches, 0 sequence launches; max|err| {e:.1e}")
    return max(worst, e)


def rnn_model(be, seed: int = RNN_SEED):
    from tensor_ops_tpu_torch.backend.rng import Rng
    from tensor_ops_tpu_torch.models import act_logistic
    from tensor_ops_tpu_torch.models import recurrent as R

    lg = act_logistic
    return R.gen_net(be, RNN_IN, RNN_OUT, [(RNN_HIDDEN, lg(), lg())], lg(),
                     None, Rng(be, seed))


def phase_rnn_slice(tmp: str) -> dict:
    """The recurrent slice at full width: the serve app on a recurrent
    checkpoint, FusedRNN on the kernel route rebuilding the served
    trajectories, five training steps on both impls, and the offloaded
    tape."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.models import (FusedRNN, SequencePredictor,
                                             squared_error)
    from tensor_ops_tpu_torch.models.recurrent import seq_scan_op
    from tensor_ops_tpu_torch.ops import ir
    from tensor_ops_tpu_torch.ops import kernels as K
    from tensor_ops_tpu_torch.utils.checkpoint import (load_arrays,
                                                       load_recurrent,
                                                       recurrent_from_arrays,
                                                       save_recurrent)

    be = TorchBackend(torch.float32, DEVICE)
    ckpt = os.path.join(tmp, "rnn.npz")
    save_recurrent(ckpt, rnn_model(be))
    xs = np.random.default_rng(0).standard_normal(
        (RNN_SEQS, RNN_N, RNN_IN)).astype(np.float32)
    xfile = os.path.join(tmp, "seqs.npy")
    np.save(xfile, xs)
    buckets = ",".join(map(str, RNN_BUCKETS))

    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = _run_app([ckpt, "-i", xfile, "--probs", "--device", DEVICE,
                    "--buckets", buckets])
    torch.cuda.synchronize()
    app_launches = K.launch_counts()
    served = _served_probs(out, RNN_SEQS * RNN_N).reshape(
        RNN_SEQS, RNN_N, RNN_OUT)
    wall = time.perf_counter() - t0
    bench = json.loads(_run_app(
        [ckpt, "--bench", "--seq-len", str(RNN_N), "--device", DEVICE,
         "--buckets", buckets]).strip().splitlines()[-1])["latency"]
    log(f"[rnn] serve app: {RNN_SEQS} sequences of {RNN_N} steps through a "
        f"{RNN_IN}->[{RNN_HIDDEN}]->{RNN_OUT} recurrent checkpoint in "
        f"{wall:.1f} s (load, warm-up and one request; the IR scan, no hand "
        f"kernel: launches {app_launches}); --bench --seq-len {RNN_N} over "
        f"buckets {RNN_BUCKETS}: n={bench['n']}, p50 "
        f"{bench['p50_s'] * 1e3:.3f} ms")

    # the same checkpoint on the CPU, in f64 (the reference) and in f32
    # (the drift of an f32 recurrence of 64 steps from f64: the card's f32
    # runs are held to 1e-5 plus twice that, and the printing's rounding)
    arrays, meta = load_arrays(ckpt)
    cpu = {}
    for dt in (torch.float64, torch.float32):
        cb = TorchBackend(dt, "cpu")
        net_c = recurrent_from_arrays(arrays, meta, rnn_model(cb, 0), cb)
        cpu[dt] = SequencePredictor(net_c, cb, buckets=(RNN_SEQS,)).predict(xs)
    drift = float(np.abs(cpu[torch.float32] - cpu[torch.float64]).max())
    rounding = 5e-7
    tol_seq = (1e-5 + 2 * drift, 0.0)
    e_app = max_err(torch.as_tensor(served),
                    torch.as_tensor(cpu[torch.float64]),
                    (tol_seq[0] + rounding, 0.0))
    log(f"[rnn] served trajectories vs the port's SequencePredictor on the "
        f"CPU in f64: max|err| {e_app:.2e} (tol 1e-5 + 2 x {drift:.2e}, the "
        f"CPU f32 run's drift from f64, + {rounding:g} printing)")

    net = load_recurrent(ckpt, rnn_model(be, 0), be)
    wS, wX, b, w2, b2 = net.params
    frnn = FusedRNN(wX, wS, b, net.states[0], "logistic", impl="pallas")
    xs_dev = torch.as_tensor(xs, device=DEVICE)
    K.reset_launch_counts()
    ys = [frnn.seq_forward(x)[0] for x in xs_dev]
    torch.cuda.synchronize()
    counts = K.launch_counts()
    launches = counts["fused_rnn_step.seq"]
    check(launches == RNN_SEQS and counts["fused_rnn_step"] == 0,
          f"FusedRNN(impl='pallas') over {RNN_SEQS} x {RNN_N} steps launched "
          f"fused_rnn_step.seq {launches} and fused_rnn_step "
          f"{counts['fused_rnn_step']} times, want {RNN_SEQS} and 0")
    logistic = K._act_fn("logistic")
    rebuilt = torch.stack([logistic(logistic(y) @ w2.T + b2) for y in ys])
    e_k = max_err(rebuilt, torch.as_tensor(served),
                  (tol_seq[0] + rounding, 0.0))
    e_k64 = max_err(rebuilt, torch.as_tensor(cpu[torch.float64]), tol_seq)
    log(f"[rnn] FusedRNN(impl='pallas') from the served model's cell (params "
        f"0-2, state 0): {launches} fused_rnn_step.seq launches (one a "
        f"sequence) and 0 fused_rnn_step for {RNN_SEQS} "
        f"sequences of {RNN_N}; logistic(logistic(ys) W2^T + b2) vs the "
        f"served trajectories max|err| {e_k:.2e}, vs the CPU f64 run "
        f"{e_k64:.2e} (tol as above)")

    # five SGD steps over the first RNN_TRAIN_N steps of sequence 0
    x_tr = xs[0][:RNN_TRAIN_N]
    m64 = FusedRNN(*(t.detach().double().cpu() for t in (wX, wS, b,
                                                         net.states[0])))
    ys64 = m64.seq_forward(x_tr)[0].numpy()
    tg = ys64 + 0.5 * np.random.default_rng(1).standard_normal(ys64.shape)
    models = {"pallas": frnn, "xla": FusedRNN(wX, wS, b, net.states[0]),
              "cpu f64": m64}
    losses = {k: [] for k in models}
    for _ in range(5):
        for k in models:
            v, models[k] = models[k].train(RNN_TRAIN_RATE, RNN_TRAIN_RATE,
                                           x_tr, tg)
            losses[k].append(v)
    torch.cuda.synchronize()
    check(losses["pallas"][-1] < losses["pallas"][0],
          f"FusedRNN(impl='pallas').train did not lower the loss: "
          f"{losses['pallas']}")
    check(models["pallas"].impl == "pallas", "train lost the impl")

    def params(m):
        return (m.wX, m.wS, m.b, m.s0)

    for ref in ("xla", "cpu f64"):
        e = max(max_err(a, c, TOL_5_STEPS) for a, c in
                zip(params(models["pallas"]), params(models[ref])))
        log(f"[rnn] 5 FusedRNN.train steps (rate {RNN_TRAIN_RATE:g}, "
            f"{RNN_TRAIN_N} steps of sequence 0), impl='pallas' vs {ref}: "
            f"max|err| {e:.2e} tol {TOL_5_STEPS[0]:g}+{TOL_5_STEPS[1]:g}|ref|;"
            f" losses {[round(v, 3) for v in losses['pallas']]}")

    # the sequence gradient with the tape on the card and in pinned host
    # memory: bit for bit
    loss = squared_error(RNN_OUT)
    tgt = torch.as_tensor(np.random.default_rng(2).uniform(
        0, 1, size=(RNN_N, RNN_OUT)), dtype=torch.float32, device=DEVICE)
    args = (xs_dev[0],) + net.states + net.params + (tgt,)
    for remat in (None, 8):
        v_on, g_on = ir.value_and_grad(
            net._seq_graph(loss, RNN_N, remat_every=remat), be, args)
        v_off, g_off = ir.value_and_grad(
            net._seq_graph(loss, RNN_N, remat_every=remat,
                           offload_tape=True), be, args)
        torch.cuda.synchronize()
        check(torch.equal(v_on, v_off) and all(
            torch.equal(a, c) for a, c in zip(g_on, g_off)),
            f"offload_tape (remat_every={remat}) changed the sequence "
            f"gradient")
    scan = seq_scan_op(net.op, RNN_N, 1, None, True)
    _, tape = scan.apply_tape(be, args[:-1])
    torch.cuda.synchronize()
    host = tape[1].slices[0][0]
    check(host.device.type == "cpu" and host.is_pinned() and
          len(tape[1].slices) == RNN_N, "offload_tape did not tape to pinned "
          "host memory")
    log(f"[rnn] sequence gradient (n={RNN_N}) with offload_tape: "
        f"bit-identical to the on-device tape, plain and remat_every=8; "
        f"the {RNN_N} taped carries are pinned host tensors")
    return {"launches": launches, "step launches": counts["fused_rnn_step"],
            "net": net, "frnn": frnn, "be": be,
            "xs": xs_dev, "served_err": e_app}


def phase_rnn_timing(rs) -> dict:
    """Kernel 7's step entry vs its plain version at B = 1 and 256, its
    sequence entry at n = 64, B = 1 vs its plain version and the 64 step
    launches, a FusedRNN sequence's wall and device time, launches and idle
    share, and SequencePredictor requests at buckets 8 and 256 (p50, and
    where a request's time goes)."""
    from tensor_ops_tpu_torch.models import SequencePredictor
    from tensor_ops_tpu_torch.ops import kernels as K

    times = {}
    with torch.inference_mode():
        for B in (1, 256):
            args = rnn_step_inputs(800 + B, B, RNN_IN, RNN_HIDDEN)
            k_ms = _median_ms(lambda: K._fused_rnn_step_cuda(*args,
                                                             "logistic"))
            p_ms = _median_ms(lambda: K.fused_rnn_step_ref(*args,
                                                           "logistic"))
            prof = _profile_steps(lambda: K._fused_rnn_step_cuda(
                *args, "logistic"))
            name = "rnn_step_gemv_kernel" if B == 1 else "rnn_step_gemm_kernel"
            check(list(prof["by_kernel"]) == [name], f"profiler saw "
                  f"{sorted(prof['by_kernel'])} for fused_rnn_step B={B}")
            bound = rnn_step_bound(B)
            log(f"[timing] fused_rnn_step B={B} {RNN_IN}->{RNN_HIDDEN} "
                f"logistic: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, device "
                f"{prof['busy_us']:.2f} us ({name}); bound "
                f"{bound[0] * 1e3:.3f} us by {bound[1]}")
            times[B] = (k_ms, p_ms, prof["busy_us"])

    # the sequence entry alone, at FusedRNN's shape, against its plain
    # version and the 64 step launches it replaces
    with torch.inference_mode():
        args = rnn_seq_inputs(810, RNN_N, 1, RNN_IN, RNN_HIDDEN)
        k_ms = _median_ms(lambda: K._fused_rnn_seq_cuda(*args, "logistic"))
        p_ms = _median_ms(lambda: K.fused_rnn_seq_ref(*args, "logistic"))
        prof = _profile_steps(lambda: K._fused_rnn_seq_cuda(*args,
                                                            "logistic"))
        check(list(prof["by_kernel"]) == ["rnn_seq_kernel"], f"profiler saw "
              f"{sorted(prof['by_kernel'])} for fused_rnn_seq")
        least = rnn_seq_bound(RNN_N, 1)
        log(f"[timing] fused_rnn_seq n={RNN_N} B=1 {RNN_IN}->{RNN_HIDDEN} "
            f"logistic: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; device "
            f"{prof['busy_us']:.2f} us ({prof['busy_us'] / RNN_N:.3f} us a "
            f"step) against {RNN_N} step launches' {RNN_N * times[1][2]:.2f} "
            f"us; bound {least[0] * 1e3:.3f} us by {least[1]} (the {RNN_N} "
            f"dependent steps set the pace, not this bound)")
        times["seq"] = (k_ms, p_ms, prof["busy_us"])

    frnn, xs = rs["frnn"], rs["xs"]
    for x in xs[:2]:
        frnn.seq_forward(x)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for x in xs:
        frnn.seq_forward(x)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / len(xs) * 1e3
    counts = K.launch_counts()
    prof = _profile_steps(lambda: frnn.seq_forward(xs[0]), steps=4)
    log(f"[timing] FusedRNN(impl='pallas').seq_forward n={RNN_N}: "
        f"{wall_ms:.3f} ms/sequence wall, "
        f"{counts['fused_rnn_step.seq'] / len(xs):.0f} fused_rnn_step.seq and "
        f"{counts['fused_rnn_step'] / len(xs):.0f} fused_rnn_step "
        f"launches/sequence; device busy {prof['busy_us']:.1f} us/sequence "
        f"({prof['busy_us'] / RNN_N:.3f} us/step) in "
        f"{prof['launches']:.0f} kernels + {prof['copies']:.0f} copies, idle "
        f"share {1 - prof['busy_us'] / (wall_ms * 1e3):.3f}; largest "
        f"(us/sequence): " + ", ".join(f"{n} {us:.1f}" for n, us in
                                       list(prof["by_kernel"].items())[:3]))

    sp = SequencePredictor(rs["net"], rs["be"], buckets=RNN_BUCKETS)
    sp.warmup([RNN_N])
    r = np.random.default_rng(9)
    for b in RNN_BUCKETS:
        x = r.standard_normal((b, RNN_N, RNN_IN)).astype(np.float32)
        sp.timer.samples.clear()
        for _ in range(20):
            sp.predict(x)
        p50 = sp.latency()["p50_s"] * 1e3
        prof = _profile_steps(lambda: sp.predict(x), steps=2)
        log(f"[timing] SequencePredictor bucket {b}, n={RNN_N}: p50 "
            f"{p50:.3f} ms host clock (n=20); device busy "
            f"{prof['busy_us'] / 1e3:.3f} ms/request in "
            f"{prof['launches']:.0f} kernels + {prof['copies']:.0f} copies, "
            f"idle share {1 - prof['busy_us'] / (p50 * 1e3):.3f}; largest "
            f"(us/request): " + ", ".join(
                f"{n} {us:.1f}" for n, us in
                list(prof["by_kernel"].items())[:3]))
    return times


def _ring_call(phase: str, xs, route: str = "kernel", scale=None):
    """One collective over the per-rank tensors ``xs`` by ``route``:
    "kernel" the public wrapper (the one-shot when the ranks share a card;
    for rs with a scale, the one-shot directly), "plain" its plain version
    ``oneshot_ref``, "ring" the ring protocol called directly, "ring plain"
    the ring protocol's plain version."""
    from tensor_ops_tpu_torch.parallel import collective_kernels as C

    one_way = phase == "one-way ar"
    p = "ar" if one_way else phase
    if route == "kernel":
        if p == "ar":
            fn = C.ring_all_reduce if one_way else C.ring_all_reduce_bidir
            return fn(xs, scale=scale)
        if scale is not None:
            return C._oneshot(xs, p, False, scale)
        return {"rs": C.ring_reduce_scatter, "ag": C.ring_all_gather}[p](xs)
    if route == "plain":
        return C.oneshot_ref(xs, p, one_way, scale)
    if route == "ring":
        return C._ring_cuda(xs, p, one_way)
    return C.ring_all_reduce_ref(xs) if one_way else C.bidir_ring_ref(xs, p)


def _ring_inputs(seed: int, devices, shape, dtype: str):
    """One tensor per rank, on that rank's device: int32 in [-1000, 1000)
    or f32 N(0, 1) from ``default_rng(seed)``."""
    r = np.random.default_rng(seed)
    n = len(devices)
    a = (r.integers(-1000, 1000, size=(n,) + shape).astype(np.int32)
         if dtype == "int32" else
         r.normal(size=(n,) + shape).astype(np.float32))
    return [torch.as_tensor(a[i], device=d) for i, d in enumerate(devices)]


def _same_bits(got, want) -> bool:
    return len(got) == len(want) and all(
        a.dtype == b.dtype and a.shape == b.shape
        and torch.equal(a.contiguous().view(torch.int32).cpu(),
                        b.contiguous().view(torch.int32).cpu())
        for a, b in zip(got, want))


def _ring_kernel_name(phase: str, route: str = "kernel") -> str:
    name = "ring_all_reduce" if phase == "one-way ar" else "bidir_ring"
    return name + ".ring" if route == "ring" else name


def _ring_cases(devices, seed: int, route: str):
    """Every phase against its plain version on the JAX tests' shapes (per
    rank) and the flagship's six parameter shapes, int32 and f32, bit for
    bit: route "kernel" (the wrappers) against ``oneshot_ref`` and the ring
    protocol's plain version, and, for f32 ar and rs, with the 1/R scale
    against ``oneshot_ref`` with it; route "ring" (the ring protocol called
    directly) against its plain version.  Returns the number of cases held
    and skipped (rs needs the leading axis divisible by R), and per kernel
    the largest |kernel - plain| seen (0 where every case is bit-equal)."""
    R = len(devices)
    shapes = [(R * 16, 128), (R * 8, 3, 7), (R * 8, 50), (R * 8,)]
    shapes += list(FLAGSHIP_PARAM_SHAPES)
    held = skipped = 0
    worst = {}
    for phase in RING_PHASES:
        name = _ring_kernel_name(phase, route)
        worst.setdefault(name, 0.0)
        for i, shape in enumerate(shapes):
            if phase == "rs" and shape[0] % R:
                skipped += 2
                continue
            for dtype in ("int32", "float32"):
                xs = _ring_inputs(seed + 10 * i, devices, shape, dtype)
                scales = [None]
                # the wrappers take a scale for ar; rs takes it from the
                # one-shot directly, which runs the ranks of one card
                if (route == "kernel" and dtype == "float32" and phase != "ag"
                        and (phase != "rs" or len(set(devices)) == 1)):
                    scales.append(1.0 / R)
                for scale in scales:
                    got = _ring_call(phase, xs, route, scale)
                    torch.cuda.synchronize()
                    wants = [_ring_call(phase, xs, "ring plain")]
                    if route == "kernel":
                        wants.insert(0, _ring_call(phase, xs, "plain", scale))
                        if scale is not None:
                            wants[1] = [t * scale for t in wants[1]]
                    worst[name] = max([worst[name]] + [
                        float((a.cpu().double() - b.cpu().double()).abs().max())
                        for a, b in zip(got, wants[0]) if a.numel()])
                    for want in wants:
                        check(_same_bits(got, want),
                              f"ring {phase} ({route}) R={R} {shape} {dtype} "
                              f"scale {scale} on {devices}: not bit-equal to "
                              f"its plain version")
                    held += 1
    return held, skipped, worst


# A second interpreter asks for what one card cannot run at once and must
# be refused, not hang: more ranks than one launch takes (ValueError before
# any launch, on both routes), and, with the wrapper told the card holds 4x
# the blocks it does, the ring protocol at 4 ranks of cap blocks each: it
# plans a grid the card cannot hold, and cudaLaunchCooperativeKernel must
# refuse it (RuntimeError).
CORESIDENCY_CHECK = r"""
import torch
from tensor_ops_tpu_torch.parallel import collective_kernels as C
cap = C.ring_capacity("bidir_ring", "cuda:0")
x = torch.zeros(8, device="cuda")
R = C.MAX_LOCAL_RANKS + 1
for route, call in (("one-shot", C.ring_all_reduce_bidir),
                    ("ring", lambda xs: C._ring_cuda(xs, "ar", False))):
    try:
        call([x] * R)
        raise SystemExit(f"R={R} ranks were not refused ({route})")
    except ValueError as e:
        print(f"[ring] {route} refused:", e)
C.ring_capacity = lambda lib, device: 4 * cap
# two pieces of cap * 512 elements per rank: cap blocks per rank
xs = [torch.zeros(4 * cap * C.CHUNK, device="cuda") for _ in range(4)]
try:
    C._ring_cuda(xs, "ar", False)
    torch.cuda.synchronize()
    raise SystemExit(f"4 ranks x {cap} blocks were not refused")
except RuntimeError as e:
    print("[ring] ring refused:", e)
print("[ring] card holds", cap, "blocks")
"""


def phase_ring_kernels() -> dict:
    """Kernels 8 and 9 on one card: the one-shot against its plain version
    (and the ring protocol's) at RING_RANKS ranks, with and without the
    1/R scale; the ring protocol, called directly, against its plain
    version at PROTOCOL_RANKS; two ring-protocol calls back to back on one
    scratch; rs then ag against ar on both routes; and the refusals, in a
    second interpreter with a time limit."""
    worst = {name: 0.0 for name in RING_NAMES}
    for route, ranks in (("kernel", RING_RANKS), ("ring", PROTOCOL_RANKS)):
        for R in ranks:
            held, skipped, errs = _ring_cases([DEVICE] * R, 1000 + 100 * R,
                                              route)
            for name, e in errs.items():
                worst[name] = max(worst[name], e)
            what = ("one-shot (the wrappers) vs oneshot_ref and the ring's "
                    "plain version, f32 ar/rs also with the 1/R scale"
                    if route == "kernel" else
                    "ring protocol (_ring_cuda) vs its plain version")
            log(f"[ring] R={R} ranks on one card, {what}: {held} cases "
                f"(one-way ar, bidirectional ar/rs/ag; int32 and f32 N(0,1); "
                f"the JAX tests' shapes and the flagship's six parameters) "
                f"bit-equal; {skipped} rs cases skipped (shape[0] not "
                f"divisible by R)")
    for phase in RING_PHASES:
        big = _ring_inputs(2000, [DEVICE] * 4, (300, 784), "float32")
        small = _ring_inputs(2001, [DEVICE] * 4, (100,), "float32")
        a = _ring_call(phase, big, "ring")
        b = _ring_call(phase, small, "ring")
        c = _ring_call(phase, big, "ring")
        torch.cuda.synchronize()
        check(_same_bits(a, c) and _same_bits(
            b, _ring_call(phase, small, "ring plain")),
            f"ring {phase}: calls back to back on one scratch differ")
    for R in RING_RANKS:
        xs = _ring_inputs(2100 + R, [DEVICE] * R, (R * 16, 128), "int32")
        routes = [("kernel", lambda p, v: _ring_call(p, v))]
        if R in PROTOCOL_RANKS:
            routes.append(("ring", lambda p, v: _ring_call(p, v, "ring")))
        for route, call in routes:
            check(_same_bits(call("ag", call("rs", xs)), call("ar", xs)),
                  f"rs then ag differs from ar at R={R} ({route})")
    log("[ring] ring protocol back to back on one scratch (300x784, 100, "
        "300x784) bit-equal in every phase; rs then ag == ar (int32) at "
        "R=2, 3, 4, 8 (one-shot) and 2, 4, 8 (ring protocol)")
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-c", CORESIDENCY_CHECK], capture_output=True,
        text=True, timeout=300, cwd=here,
        env=dict(os.environ, PYTHONPATH=here))
    check(proc.returncode == 0, f"co-residency check failed:\n"
          f"{proc.stdout}{proc.stderr[-3000:]}")
    for line in proc.stdout.splitlines():
        log(line)
    return worst


def phase_ring_cross_card() -> None:
    """The wrappers at one rank per card (the ring protocol's route)
    against the ring's plain version, where the machine has several
    cards."""
    from tensor_ops_tpu_torch.parallel import RankGroup

    count = torch.cuda.device_count()
    if count < 2:
        log(f"[ring] cross-card ring not run: {count} card visible (it needs "
            f"two or more)")
        return
    group = RankGroup(count)  # one rank per card; peer access checked
    held, skipped, _ = _ring_cases([str(d) for d in group.devices], 4000,
                                   "kernel")
    log(f"[ring] cross-card: R={count} ranks, one per card: {held} cases "
        f"bit-equal to the plain versions ({skipped} rs cases skipped)")


def phase_dp_slice(tmp: str) -> dict:
    """The flagship at full width (gen_net, seed 0) for DP_STEPS steps of
    dp_megakernel_train_step over DP_RANKS ranks of DP_ROWS rows of the
    synthetic set, on each route (bidirectional ring, then one-way); then
    the JAX call's form on each mesh of DP_MESHES, held bit for bit to the
    rank group of its data axis's size."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.backend.rng import Rng
    from tensor_ops_tpu_torch.models import (FusedMLP, act_logistic,
                                             act_softmax, gen_net)
    from tensor_ops_tpu_torch.ops import kernels as K
    from tensor_ops_tpu_torch.parallel import (RankGroup,
                                               dp_megakernel_train_step,
                                               make_mesh)
    from tensor_ops_tpu_torch.utils.mnist_data import load_mnist

    with no_download(), contextlib.redirect_stdout(io.StringIO()):
        train_raw, _ = load_mnist(tempfile.mkdtemp(dir=tmp))
    B = DP_RANKS * DP_ROWS
    xb = np.stack([d / 255.0 for _, d in train_raw[:B]])
    yb = np.eye(10)[[l for l, _ in train_raw[:B]]]
    x32 = torch.as_tensor(xb, dtype=torch.float32, device=DEVICE)
    y32 = torch.as_tensor(yb, dtype=torch.float32, device=DEVICE)
    be = TorchBackend(torch.float32, DEVICE)
    net = gen_net(be, FLAGSHIP[0], FLAGSHIP[-1],
                  [(h, act_logistic()) for h in FLAGSHIP[1:-1]],
                  act_softmax(), Rng(be, 0))
    fm = FusedMLP.from_network(net)
    ws0 = [w.float() for w in fm.weights]
    bs0 = [b.float() for b in fm.biases]
    acts = ("logistic", "logistic", "identity")
    group = RankGroup(DP_RANKS)
    cpu_group = RankGroup(devices=["cpu"] * DP_RANKS)
    out = {"group": group, "x": x32, "y": y32, "ws": ws0, "bs": bs0,
           "fm": fm}
    for bidirectional in (True, False):
        route = "bidir_ring" if bidirectional else "ring_all_reduce"
        other = "ring_all_reduce" if bidirectional else "bidir_ring"
        step = dp_megakernel_train_step(group, acts, lr=TRAIN_RATE,
                                        bidirectional=bidirectional)
        ws, bs, losses, trail = ws0, bs0, [], []
        K.reset_launch_counts()
        for i in range(DP_STEPS):
            loss, ws, bs = step(x32, y32, ws, bs)
            trail.append((loss, ws, bs))
            if i == 0:
                first = (loss, ws, bs)
            r0 = step.replicas[0][0] + step.replicas[0][1]
            for r, (r_ws, r_bs) in enumerate(step.replicas[1:], 1):
                check(all(torch.equal(a, c) for a, c in zip(r0, r_ws + r_bs)),
                      f"dp {route}: rank {r}'s parameters differ from rank "
                      f"0's after step {i + 1}")
            losses.append(float(loss))
        torch.cuda.synchronize()
        counts = K.launch_counts()
        # one one-shot launch per tensor; the ring protocol is the route of
        # ranks on several cards and runs no time here
        want = {"fused_mlp_train_step": DP_RANKS * DP_STEPS,
                route: 6 * DP_STEPS, other: 0, f"{route}.ring": 0,
                f"{other}.ring": 0}
        check(all(counts[k] == v for k, v in want.items()),
              f"dp {route}: launches {counts}, want {want}")
        check(losses[-1] < losses[0], f"dp {route}: the loss did not fall "
              f"({losses})")
        # one dp step against one step on the whole batch, on the card
        loss1, ws1, bs1 = K._fused_mlp_train_step_cuda(
            x32, y32, ws0, bs0, TRAIN_RATE, acts, "softmax_xent")
        torch.cuda.synchronize()
        e_loss = max_err(first[0], loss1, TOL_LOSS)
        e_par = max(max_err(a, c, TOL_PARAM) for a, c in
                    zip(first[1] + first[2], ws1 + bs1))
        # five steps against the plain dp step in CPU f64
        cpu_step = dp_megakernel_train_step(cpu_group, acts, lr=TRAIN_RATE,
                                            bidirectional=bidirectional)
        w64 = [w.double().cpu() for w in ws0]
        b64 = [b.double().cpu() for b in bs0]
        x64, y64 = torch.as_tensor(xb), torch.as_tensor(yb)
        for _ in range(DP_STEPS):
            _, w64, b64 = cpu_step(x64, y64, w64, b64)
        e5 = max(max_err(a, c, TOL_5_STEPS) for a, c in
                 zip(ws + bs, w64 + b64))
        log(f"[dp] {route}: {DP_STEPS} steps of dp_megakernel_train_step, "
            f"{DP_RANKS} ranks x {DP_ROWS} rows on "
            f"{sorted(set(map(str, group.devices)))}, "
            f"rate {TRAIN_RATE}: losses {[round(v, 5) for v in losses]}; "
            f"launches {counts}; ranks bit-identical after every step; step 1"
            f" vs fused_mlp_train_step on the {B}-row batch max|err| loss "
            f"{e_loss:.2e} (tol {TOL_LOSS[0]:g}+{TOL_LOSS[1]:g}|ref|), params "
            f"{e_par:.2e} (tol {TOL_PARAM[0]:g}+{TOL_PARAM[1]:g}|ref|); "
            f"{DP_STEPS} steps vs the plain dp step in CPU f64 max|err| "
            f"{e5:.2e} (tol {TOL_5_STEPS[0]:g}+{TOL_5_STEPS[1]:g}|ref|)")
        out[route] = {"launches": counts[route], "losses": losses,
                      "protocol launches": counts[f"{route}.ring"]}
        if bidirectional:
            trails = {DP_RANKS: trail}
    # the JAX call's form, a mesh and its data axis: on (4, 1) the rank
    # group of 4; on (2, 2) each model column repeats its data shard's
    # step, so every rank equals the rank group of 2's rank of its data
    # coordinate (rank 2 takes the rows of data shard 1)
    out["mesh launches"] = {"fused_mlp_train_step": 0, "bidir_ring": 0}
    for shape in DP_MESHES:
        dp_n = shape[0]
        if dp_n not in trails:
            ref = dp_megakernel_train_step(RankGroup(dp_n), acts,
                                           lr=TRAIN_RATE)
            ws, bs, trails[dp_n] = ws0, bs0, []
            for _ in range(DP_STEPS):
                loss, ws, bs = ref(x32, y32, ws, bs)
                trails[dp_n].append((loss, ws, bs))
        mesh = make_mesh(DP_RANKS, shape=shape, devices=[DEVICE] * DP_RANKS)
        step = dp_megakernel_train_step(mesh, acts, lr=TRAIN_RATE,
                                        axis="data")
        torch.cuda.synchronize()
        K.reset_launch_counts()
        ws, bs = ws0, bs0
        for i, (l_ref, ws_ref, bs_ref) in enumerate(trails[dp_n]):
            loss, ws, bs = step(x32, y32, ws, bs)
            check(torch.equal(loss, l_ref) and all(
                torch.equal(a, c) for a, c in zip(ws + bs, ws_ref + bs_ref)),
                f"dp on the {shape} mesh: step {i + 1} differs from "
                f"RankGroup({dp_n})'s")
            for r, (r_ws, r_bs) in enumerate(step.replicas):
                check(all(torch.equal(a, c)
                          for a, c in zip(r_ws + r_bs, ws + bs)),
                      f"dp on the {shape} mesh: rank {r}'s parameters "
                      f"differ from rank 0's after step {i + 1}")
        torch.cuda.synchronize()
        counts = K.launch_counts()
        want = {"fused_mlp_train_step": DP_RANKS * DP_STEPS,
                "bidir_ring": 6 * (DP_RANKS // dp_n) * DP_STEPS,
                "ring_all_reduce": 0, "bidir_ring.ring": 0,
                "ring_all_reduce.ring": 0}
        check(all(counts[k] == v for k, v in want.items()),
              f"dp on the {shape} mesh: launches {counts}, want {want}")
        for k in out["mesh launches"]:
            out["mesh launches"][k] += counts[k]
        log(f"[dp] mesh {shape}, axis 'data': {DP_STEPS} steps of "
            f"dp_megakernel_train_step bit-equal to RankGroup({dp_n})'s on "
            f"the same {B} rows (loss and parameters, every step), every "
            f"rank's parameters bit-identical after every step; launches "
            f"{ {k: counts[k] for k in want} } = {want}")
    return out


def ring_bound(phase: str, R: int, shape):
    """(least ms, what bounds it) of one ring call on R ranks of one card,
    for the function and not the ring algorithm: every rank reads its input
    (``size`` f32 elements, the shard for ag) once and writes its output
    once (size for ar, size / R for rs, R * size for ag), and the sum
    takes (R - 1) adds per element reduced:
        bytes = 4 R (size + out)           over HBM_BPS,
        ops   = (R - 1) size for ar and rs over the f32 peak.
    The comm-slot traffic a ring adds is its own cost: ring_slot_ms."""
    p = "ar" if phase == "one-way ar" else phase
    size = math.prod(shape)
    out = {"ar": size, "rs": size // R, "ag": R * size}[p]
    adds = (R - 1) * size if p in ("ar", "rs") else 0
    return _bound(4 * R * (size + out), adds, "f32")


def ring_slot_ms(phase: str, R: int, shape) -> float:
    """The ring algorithm's own HBM traffic on one card, over HBM_BPS: at
    each of its n_steps steps every rank writes one padded chunk (D pieces
    of H f32 elements) into a neighbour's comm slot, which the neighbour
    reads back: 2 * 4 R n_steps D H bytes."""
    from tensor_ops_tpu_torch.parallel import collective_kernels as C

    one_way = phase == "one-way ar"
    p = "ar" if one_way else phase
    D, H = C._layout(p, shape, R, one_way)[:2]
    n_steps = 2 * (R - 1) if p == "ar" else R - 1
    return 2 * 4 * R * n_steps * D * H / HBM_BPS * 1e3


def phase_dp_timing(dp) -> dict:
    """Each phase at the flagship's 300x784 weight on DP_RANKS ranks of one
    card: the one-shot's and one PyTorch call's CUDA-event medians and host
    time per call, taken in turns over 3 repetitions, the one-shot's plain
    version, the profiler's device time and the bound; the ring protocol
    called directly beside it; then a dp step's wall time, kernels, device
    busy time and idle share on each route, and samples/s beside a
    single-rank train_fullfused step on the whole batch."""
    times = {}
    shape = FLAGSHIP_PARAM_SHAPES[0]
    xs = _ring_inputs(3000, [DEVICE] * DP_RANKS, shape, "float32")
    library = {"one-way ar": lambda: torch.stack(xs).sum(0),
               "ar": lambda: torch.stack(xs).sum(0),
               # every rank's block at once
               "rs": lambda: torch.stack(xs).sum(0),
               "ag": lambda: torch.cat(xs)}
    from tensor_ops_tpu_torch.parallel import collective_kernels as C

    wrapper = {"one-way ar": C.ring_all_reduce,
               "ar": C.ring_all_reduce_bidir, "rs": C.ring_reduce_scatter,
               "ag": C.ring_all_gather}
    for phase in RING_PHASES:
        name = _ring_kernel_name(phase)
        reps = []
        fn = wrapper[phase]
        for _ in range(3):
            reps.append((_median_ms(lambda: fn(xs)),
                         _median_ms(library[phase]),
                         _host_us(lambda: fn(xs)),
                         _host_us(library[phase])))
        k_ms, l_ms, k_us, l_us = (statistics.median(rep[i] for rep in reps)
                                  for i in range(4))
        p_ms = _median_ms(lambda: _ring_call(phase, xs, "plain"))
        prof = _profile_steps(lambda: fn(xs))
        dev_us = _per_launch_us(prof, f"{name}_oneshot_kernel")
        check(dev_us > 0, f"the profiler saw {prof['calls']} for the "
              f"one-shot {phase}")
        r_ms = _median_ms(lambda: _ring_call(phase, xs, "ring"))
        rp_ms = _median_ms(lambda: _ring_call(phase, xs, "ring plain"))
        rprof = _profile_steps(lambda: _ring_call(phase, xs, "ring"))
        ring_us = _per_launch_us(rprof, f"{name}_kernel")
        check(ring_us > 0, f"the profiler saw {sorted(rprof['by_kernel'])} "
              f"for the ring protocol {phase}")
        least = ring_bound(phase, DP_RANKS, shape)
        log(f"[timing] {phase} ({name}) R={DP_RANKS} on one card, "
            f"{'x'.join(map(str, shape))} f32 per rank: one-shot device "
            f"{dev_us:.2f} us ({dev_us / (least[0] * 1e3):.2f}x the bound "
            f"{least[0] * 1e3:.3f} us by {least[1]}), {prof['launches']:.0f} "
            f"kernels + {prof['copies']:.0f} copies per call; events, in "
            f"turns over 3 repetitions, one-shot "
            f"{', '.join(f'{rep[0]:.4f}' for rep in reps)} ms vs library "
            f"{', '.join(f'{rep[1]:.4f}' for rep in reps)} ms (medians "
            f"{k_ms:.4f} vs {l_ms:.4f}); host clock per call, in the same "
            f"turns, one-shot {', '.join(f'{rep[2]:.2f}' for rep in reps)} "
            f"us vs library {', '.join(f'{rep[3]:.2f}' for rep in reps)} us "
            f"(medians {k_us:.2f} vs {l_us:.2f}); plain {p_ms:.4f} ms")
        log(f"[timing] {phase} ring protocol (_ring_cuda) R={DP_RANKS} on "
            f"one card: device {ring_us:.2f} us in {rprof['launches']:.0f} "
            f"kernels + {rprof['copies']:.0f} copies, events {r_ms:.4f} ms, "
            f"plain {rp_ms:.4f} ms; its comm-slot traffic "
            f"{ring_slot_ms(phase, DP_RANKS, shape) * 1e3:.3f} us beyond the "
            f"bound")
        if phase in ("one-way ar", "ar"):
            times[name] = (k_ms, p_ms, l_ms, dev_us)
            times[f"{name}.ring"] = (r_ms, rp_ms, l_ms, ring_us)

    from tensor_ops_tpu_torch.parallel import dp_megakernel_train_step

    acts = ("logistic", "logistic", "identity")
    x, y, ws, bs = dp["x"], dp["y"], dp["ws"], dp["bs"]
    routes = {r: dp_megakernel_train_step(
        dp["group"], acts, lr=TRAIN_RATE, bidirectional=(r == "bidir_ring"))
        for r in ("bidir_ring", "ring_all_reduce")}
    routes = {f"dp step, {r}": (r, lambda s=s: s(x, y, ws, bs))
              for r, s in routes.items()}
    routes[f"single rank train_fullfused, B={len(x)}"] = (
        None, lambda: dp["fm"].train_fullfused(TRAIN_RATE, x, y))
    for name, (ring, step) in routes.items():
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) / 20 * 1e6
        prof = _profile_steps(step)
        top = ", ".join(f"{n} {us:.1f}" for n, us in
                        list(prof["by_kernel"].items())[:4])
        extra = ""
        if ring is not None:
            # the profiler's count (the wrappers' counters hold the exact
            # launches in the dp slice phase; the profiler may drop an event)
            ones = prof["calls"].get(f"{ring}_oneshot_kernel", 0)
            elementwise = sum(c for n, c in prof["calls"].items()
                              if "elementwise" in n)
            check(ones > 0, f"{name}: the profiler saw no one-shot launch")
            extra = (f"; {ones:.1f} one-shot launches per step (the 1/n "
                     f"inside them), {elementwise:.1f} elementwise kernels "
                     f"(the loss's sum and 1/n), no parameter multiplies; "
                     f"want {DP_KERNELS_PER_STEP} kernels and 6 one-shot "
                     f"launches per step")
        log(f"[timing] {name}: {wall_us:.1f} us/step wall, "
            f"{len(x) / (wall_us * 1e-6):.0f} samples/s, "
            f"{prof['launches']:.0f} kernels + {prof['copies']:.0f} "
            f"copies/step, device busy {prof['busy_us']:.1f} us/step, idle "
            f"share {1 - prof['busy_us'] / wall_us:.3f}; largest (us/step): "
            f"{top}{extra}")
    return times


def _bound(nbytes: float, ops: float, kind: str):
    """(least ms, what bounds it): the larger of the bytes over the HBM
    rate and the operations over the peak rate of their type."""
    by_bytes = nbytes / HBM_BPS * 1e3
    by_ops = ops / PEAK_OPS[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def bounds() -> dict:
    """Each kernel's bound at the shape its time is taken at: each input
    read once, each output written once, the operations its inputs need."""
    layers = list(zip(FLAGSHIP[:-1], FLAGSHIP[1:]))  # (K, O)

    def per_layer(B, x_bytes, w_bytes, n_vectors, kind):
        parts = [_bound(B * k * x_bytes + o * k * w_bytes
                        + n_vectors * o * 4 + B * o * 4, 2 * B * k * o, kind)
                 for k, o in layers]
        return (sum(ms for ms, _ in parts),
                max(parts, key=lambda p: p[0])[1])

    B = 8
    n, L, Bs = STACK_N, STACK_L, STACK_B
    k, o = layers[-1]
    return {
        # the flagship's identity layer (100 -> 10) at B=8
        "fused_linear": _bound(4 * (B * k + o * k + o + B * o), 2 * B * k * o,
                               "f32"),
        "fused_mlp_forward": mlp_forward_bound(B),
        "fused_mlp_train_step": train_step_bound(FLAGSHIP, 100),
        "fused_linear_w8": w8_bound(B),
        "fused_linear_w8a8": per_layer(B, 4, 1, 2, "int8"),
        "fused_mlp_w8a8_forward": _bound(
            Bs * n * 4 + L * n * n + 2 * L * n * 4 + Bs * n * 4,
            2 * L * Bs * n * n, "int8"),
        # one step at B=1, 32 -> 512 (the per-step function)
        "fused_rnn_step": rnn_step_bound(1),
        # FusedRNN's sequence: 64 steps at B=1, 32 -> 512
        "fused_rnn_step.seq": rnn_seq_bound(RNN_N, 1),
        # the flagship's 300x784 weight over the dp slice's ranks, on
        # either route: the function's bytes, whatever the algorithm
        "ring_all_reduce": ring_bound("one-way ar", DP_RANKS,
                                      FLAGSHIP_PARAM_SHAPES[0]),
        "bidir_ring": ring_bound("ar", DP_RANKS, FLAGSHIP_PARAM_SHAPES[0]),
        "ring_all_reduce.ring": ring_bound("one-way ar", DP_RANKS,
                                           FLAGSHIP_PARAM_SHAPES[0]),
        "bidir_ring.ring": ring_bound("ar", DP_RANKS,
                                      FLAGSHIP_PARAM_SHAPES[0]),
    }


def train_step_bound(dims, B: int):
    """Kernel 3 on the chain ``dims`` at batch B: x and the targets y read,
    the parameters read and written, the loss written; the forward, the
    weight gradients and every input gradient but the first layer's, 2 B
    K O f32 operations each."""
    layers = list(zip(dims[:-1], dims[1:]))
    kos = sum(k * o for k, o in layers)
    params = kos + sum(o for _, o in layers)
    return _bound(4 * (B * dims[0] + B * dims[-1] + 2 * params + 1),
                  2 * B * (3 * kos - layers[0][0] * layers[0][1]), "f32")


def w8_bound(B: int):
    """Kernel 4 over the flagship's three layers at batch B: x, the int8
    codes, the f32 scale and bias read once, y written once; its products
    are bf16 at "default"."""
    parts = [_bound(B * k * 4 + o * k + 2 * o * 4 + B * o * 4, 2 * B * k * o,
                    "bf16") for k, o in zip(FLAGSHIP[:-1], FLAGSHIP[1:])]
    return (sum(ms for ms, _ in parts), max(parts, key=lambda p: p[0])[1])


def rnn_step_bound(B: int):
    """Kernel 7 at the recurrent slice's widths: x, s, Wx, Ws and b read,
    y and s' written, 2 B (I + O) O f32 operations."""
    I, O = RNN_IN, RNN_HIDDEN
    return _bound(4 * (B * I + B * O + O * I + O * O + O + 2 * B * O),
                  2 * B * (I + O) * O, "f32")


def rnn_seq_bound(n: int, B: int):
    """Kernel 7's sequence entry at the recurrent slice's widths: the
    weights and bias once, xs, s0, ys and the final state; 2 n B (I + O) O
    f32 operations.  The n dependent steps set its pace, not this bound."""
    I, O = RNN_IN, RNN_HIDDEN
    return _bound(4 * (O * I + O * O + O + n * B * I + B * O + n * B * O
                       + B * O), 2 * n * B * (I + O) * O, "f32")


# ---------------------------------------------------------------------------
# phases 20-22: chained steps and mixed precision (a second interpreter)
# ---------------------------------------------------------------------------

def _same_fit(a, b, what: str) -> None:
    check(all(torch.equal(x, y) for x, y in zip(a.net.params, b.net.params)),
          f"{what}: parameters differ")
    if a.ema_net is not None:
        check(all(torch.equal(x, y) for x, y in
                  zip(a.ema_net.params, b.ema_net.params)),
              f"{what}: EMA differs")
    check([{k: v for k, v in r.items() if k != "t"} for r in a.history] ==
          [{k: v for k, v in r.items() if k != "t"} for r in b.history],
          f"{what}: history differs")


@contextlib.contextmanager
def _recorded_rows(out: list):
    """Record the row table each chained window's graph read on the card."""
    from tensor_ops_tpu_torch.models import chain as C

    run = C.StepChain.run

    def recording(self, scalars, rows, leaves):
        res = run(self, scalars, rows, leaves)
        out.append(self.idx[:scalars.shape[0]].clone())
        return res

    C.StepChain.run = recording
    try:
        yield
    finally:
        C.StepChain.run = run


def phase_fit_chained(tmp: str) -> None:
    """Phase 20: the fit slice chained.  ``chain_steps=1`` and ``"auto"``
    in turns (bit-equal params, EMA and history; samples/s each); one
    chained window's profile beside one unchained step's; capture time and
    peak memory; the device shuffles (each row once an epoch, from the rows
    the graph read; window caps 4 and 10 bit-equal; crash/resume);
    adam8bit with stochastic rounding chained against unchained."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.backend.rng import Rng
    from tensor_ops_tpu_torch.models import (act_logistic, act_softmax, adam,
                                             adam8bit, cross_entropy, fit,
                                             gen_net)
    from tensor_ops_tpu_torch.models import chain as C
    from tensor_ops_tpu_torch.models.trainer import (_ChainedStep,
                                                     make_opt_step)
    from tensor_ops_tpu_torch.ops import kernels as K
    from tensor_ops_tpu_torch.utils.native import NativeLoader

    tX, tY, vX, vL = synthetic_set(tmp)
    be = TorchBackend(torch.float32, DEVICE)

    def flagship(seed=0):
        return gen_net(be, FLAGSHIP[0], FLAGSHIP[-1],
                       [(h, act_logistic()) for h in FLAGSHIP[1:-1]],
                       act_softmax(), Rng(be, seed))

    net, loss = flagship(), cross_entropy(FLAGSHIP[-1])
    steps = FIT_EPOCHS * (len(tX) // FIT_BATCH)
    kw = dict(epochs=FIT_EPOCHS, batch_size=FIT_BATCH, lr=FIT_LR,
              log_every=FIT_LOG_EVERY, verbose=False, optimizer=adam(),
              ema_decay=CHAIN_EMA, val=(vX, vL),
              checkpoint_every=FIT_CHECKPOINT_EVERY)
    runs, peaks, rates = {}, {}, {}
    K.reset_launch_counts()
    C.reset_chain_counts()
    for i, mode in enumerate(CHAIN_TURNS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = fit(net, loss, be, tX, tY, chain_steps=mode,
                  checkpoint_path=os.path.join(tmp, f"chain{i}.npz"), **kw)
        torch.cuda.synchronize()
        peaks.setdefault(mode, []).append(torch.cuda.max_memory_allocated())
        rates.setdefault(mode, []).append(_fit_rate(res, FIT_BATCH)[0])
        runs.setdefault(mode, []).append(res)
    counts, launches = C.chain_counts(), K.launch_counts()
    ref = runs[1][0]
    for mode, rs in runs.items():
        for r in rs:
            check(r.steps == steps, f"chain_steps={mode!r}: {r.steps} steps")
            _same_fit(r, ref, f"fit chain_steps={mode!r}")
    n_chained = CHAIN_TURNS.count("auto")
    check(counts["captures"] == n_chained and
          counts["replays"] == n_chained * steps,
          f"chained fit: {counts} (want one capture and {steps} replays a "
          f"run)")
    log(f"[chain] flagship fit(adam, B={FIT_BATCH}, {FIT_EPOCHS} epochs = "
        f"{steps} steps, val every {FIT_LOG_EVERY}, ema_decay {CHAIN_EMA}, "
        f"a checkpoint every {FIT_CHECKPOINT_EVERY}), chain_steps in the "
        f"turns {CHAIN_TURNS}: parameters, EMA and history bit-equal; loss "
        f"{ref.history[0]['loss']:.4f} -> {ref.history[-1]['loss']:.4f}; "
        f"{counts['captures']} captures taking "
        f"{counts['capture_s'] / counts['captures'] * 1e3:.1f} ms each "
        f"(host clock: warm-up step and capture), {counts['replays']} graph "
        f"replays; hand-written kernel launches {launches}")
    for mode in (1, "auto"):
        log(f"[chain] fit samples/s over steps {FIT_TIMED_FROM + 1}-{steps} "
            f"(host clock at the log boundaries, val included), chain_steps="
            f"{mode!r}: {', '.join(f'{r:.1f}' for r in rates[mode])}; peak "
            f"device memory {', '.join(map(str, peaks[mode]))} bytes")

    # one unchained step and one chained window, profiled
    opt = adam()
    step_fn = make_opt_step(net, loss, be, opt)
    lr_t = torch.tensor(FIT_LR, device=DEVICE)
    xb = be.asarray(tX[:FIT_BATCH].astype(np.float32))
    yb = be.asarray(tY[:FIT_BATCH].astype(np.float32))
    state = [opt.init(net.params), net.params]

    def one_step():
        v, state[0], state[1] = step_fn(lr_t, xb, yb, state[0], state[1])
        return v

    loader = NativeLoader(tX, tY, batch=FIT_BATCH, seed=0, index_mode=True)
    X_dev, Y_dev = be.asarray(loader.X), be.asarray(loader.Y)
    chain_fn = _ChainedStep(step_fn, None, None, 1, X_dev, Y_dev, FIT_BATCH,
                            be.dtype)
    chain_fn.reserve(CHAIN_WINDOW)
    cstate = [opt.init(net.params), net.params, ()]
    lrs = [FIT_LR] * CHAIN_WINDOW

    def window():
        rows = np.stack([loader.next_indices() for _ in range(CHAIN_WINDOW)])
        v, *cstate[:] = chain_fn(lrs, rows, *cstate)
        return v

    walls = {}
    for name, fn, n in (("unchained", one_step, 1), ("chained", window,
                                                     CHAIN_WINDOW)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) / (20 * n) * 1e6
        p = _profile_steps(fn, 10 if n == 1 else 2)
        log(f"[timing] fit step B={FIT_BATCH}, {name} (adam; per step: wall "
            f"on the host clock over {20 * n} steps, the rest from the "
            f"profiler): {walls[name]:.1f} us wall, host-issued "
            f"{p['graph_launches'] / n:.2f} graph launches + "
            f"{p['other_launches'] / n:.2f} kernel launches and copies; the "
            f"card ran {p['launches'] / n:.1f} kernels + "
            f"{p['copies'] / n:.2f} copies, busy {p['busy_us'] / n:.1f} us, "
            f"idle share {1 - p['busy_us'] / n / walls[name]:.3f}")
    loader.close()

    # the device shuffles: every row once an epoch (the rows each graph
    # read), window caps 4 and 10 bit-equal, a crash/resume chain
    dkw = dict(kw, val=None, ema_decay=None, checkpoint_every=0)
    spe = len(tX) // FIT_BATCH
    for mode in ("device", "device_fixed"):
        rows = []
        with _recorded_rows(rows):
            r4 = fit(net, loss, be, tX, tY, chain_shuffle=mode,
                     chain_steps=4, **dkw)
        r10 = fit(net, loss, be, tX, tY, chain_shuffle=mode, chain_steps=10,
                  **dkw)
        _same_fit(r4, r10, f"{mode}: chain_steps 4 against 10")
        seen = torch.cat(rows).cpu().numpy()
        check(seen.shape == (steps, FIT_BATCH), f"{mode}: {seen.shape} rows")
        for e in range(FIT_EPOCHS):
            check(np.array_equal(np.sort(seen[e * spe:(e + 1) * spe]
                                         .ravel()), np.arange(len(tX))),
                  f"{mode}: epoch {e} does not visit every row once")
        ck = os.path.join(tmp, f"{mode}.npz")
        fit(net, loss, be, tX, tY, chain_shuffle=mode, checkpoint_path=ck,
            **dict(dkw, epochs=1, checkpoint_every=FIT_CHECKPOINT_EVERY))
        res = fit(flagship(99), loss, be, tX, tY, chain_shuffle=mode,
                  checkpoint_path=ck, resume=True, **dkw)
        check(all(torch.equal(a, b) for a, b in
                  zip(res.net.params, r4.net.params)),
              f"{mode}: the crash/resume chain differs from the straight run")
        log(f"[chain] chain_shuffle={mode!r}: each of {FIT_EPOCHS} epochs "
            f"visits every one of {len(tX)} rows once (the row tables the "
            f"graph read on the card); chain_steps 4 and 10 bit-equal; "
            f"crash/resume bit-equal; loss {r4.history[0]['loss']:.4f} -> "
            f"{r4.history[-1]['loss']:.4f}; samples/s "
            f"{_fit_rate(r4, FIT_BATCH)[0]:.1f} (cap 4), "
            f"{_fit_rate(r10, FIT_BATCH)[0]:.1f} (cap 10)")

    akw = dict(dkw, epochs=1, optimizer=adam8bit(stochastic_rounding=True),
               ema_decay=CHAIN_EMA)
    a = fit(net, loss, be, tX, tY, chain_steps=1, **akw)
    b = fit(net, loss, be, tX, tY, chain_steps="auto", **akw)
    _same_fit(a, b, "adam8bit (stochastic rounding) chained")
    log(f"[chain] adam8bit(stochastic_rounding=True), {a.steps} steps: "
        f"chained bit-equal to unchained, EMA included; loss "
        f"{a.history[0]['loss']:.4f} -> {a.history[-1]['loss']:.4f}")


def phase_seq_chained() -> None:
    """Phase 21: the recurrent fit slice chained: ``chain_steps=1`` and
    ``"auto"`` in turns, bit-equal; sequences/s; one chained window's
    profile."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.models import chain as C
    from tensor_ops_tpu_torch.models import fit_sequences, squared_error
    from tensor_ops_tpu_torch.models.trainer import (_ChainedStep,
                                                     _SeqStream,
                                                     _seq_train_step)

    be = TorchBackend(torch.float32, DEVICE)
    net = rnn_model(be)
    r = np.random.default_rng(0)
    XS = r.standard_normal((SEQ_FIT_SEQS, RNN_N, RNN_IN)).astype(np.float32)
    TS = r.standard_normal((SEQ_FIT_SEQS, RNN_N, RNN_OUT)).astype(np.float32)
    loss, B = squared_error(RNN_OUT), SEQ_FIT_BATCH
    spe = SEQ_FIT_SEQS // B
    steps = SEQ_FIT_EPOCHS * spe
    kw = dict(batch_size=B, log_every=SEQ_FIT_LOG_EVERY, verbose=False,
              epochs=SEQ_FIT_EPOCHS, **SEQ_FIT_RATES)
    runs, rates, peaks = {}, {}, {}
    C.reset_chain_counts()
    for mode in CHAIN_TURNS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = fit_sequences(net, loss, be, XS, TS, chain_steps=mode, **kw)
        torch.cuda.synchronize()
        t = {x["step"]: x["t"] for x in res.history}
        rates.setdefault(mode, []).append((steps - 1) * B / (t[steps] - t[1]))
        peaks.setdefault(mode, []).append(torch.cuda.max_memory_allocated())
        runs.setdefault(mode, []).append(res)
    counts = C.chain_counts()
    ref = runs[1][0]
    for mode, rs in runs.items():
        for res in rs:
            check(all(torch.equal(a, b) for a, b in
                      zip(_leaves(res.net), _leaves(ref.net))),
                  f"fit_sequences chain_steps={mode!r}: leaves differ")
            check([x["loss"] for x in res.history] ==
                  [x["loss"] for x in ref.history],
                  f"fit_sequences chain_steps={mode!r}: losses differ")
    log(f"[chain] fit_sequences (Elman {RNN_IN}->[{RNN_HIDDEN}]->{RNN_OUT}, "
        f"n={RNN_N}, B={B}, {SEQ_FIT_SEQS} sequences, dual-rate SGD, "
        f"{steps} steps), chain_steps in the turns {CHAIN_TURNS}: states, "
        f"params and losses bit-equal; {counts['captures']} captures taking "
        f"{counts['capture_s'] / max(counts['captures'], 1):.2f} s each "
        f"(host clock: warm-up step and capture), {counts['replays']} "
        f"replays")
    for mode in (1, "auto"):
        log(f"[chain] fit_sequences sequences/s over steps 2-{steps} (host "
            f"clock at the log boundaries), chain_steps={mode!r}: "
            f"{', '.join(f'{x:.1f}' for x in rates[mode])}; peak device "
            f"memory {', '.join(map(str, peaks[mode]))} bytes")

    stream = _SeqStream(XS, TS, B, 0, 0, spe)
    XS_dev, TS_dev = be.asarray(XS), be.asarray(TS)
    chain_fn = _ChainedStep(_seq_train_step(net, loss, be, RNN_N), None,
                            None, 2, XS_dev, TS_dev, B, be.dtype)
    chain_fn.reserve(SEQ_CHAIN_WINDOW)
    cstate = [net.states, net.params, ()]
    rates_w = [(SEQ_FIT_RATES["rate_state"], SEQ_FIT_RATES["rate_param"])] \
        * SEQ_CHAIN_WINDOW

    def window():
        rows = np.stack([stream.next_indices()
                         for _ in range(SEQ_CHAIN_WINDOW)])
        v, *cstate[:] = chain_fn(rates_w, rows, *cstate)
        return v

    window()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        window()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / (2 * SEQ_CHAIN_WINDOW) * 1e6
    p = _profile_steps(window, 1)
    n = SEQ_CHAIN_WINDOW
    log(f"[timing] fit_sequences step (B={B}), chained (per step: wall on "
        f"the host clock over {2 * n} steps, the rest from the profiler "
        f"over {n}): {wall:.1f} us wall ({B / wall * 1e6:.1f} sequences/s), "
        f"host-issued {p['graph_launches'] / n:.2f} graph launches + "
        f"{p['other_launches'] / n:.2f} kernel launches and copies; the card "
        f"ran {p['launches'] / n:.1f} kernels + {p['copies'] / n:.2f} copies, "
        f"busy {p['busy_us'] / n:.1f} us, idle share "
        f"{1 - p['busy_us'] / n / wall:.3f}")


def phase_mixed_precision(tmp: str) -> None:
    """Phase 22: ``mixed_precision``: the router's measurement and decision
    at the flagship and at a wider MLP; a bf16 run that learns on f32
    masters; one bf16 step's gradients against CPU f64; the bf16 product's
    kernels on the card."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.backend.rng import Rng
    from tensor_ops_tpu_torch.models import (Network, act_logistic,
                                             act_softmax, cross_entropy, fit,
                                             gen_net, sgd)
    from tensor_ops_tpu_torch.models.trainer import make_opt_step

    tX, tY, _, _ = synthetic_set(tmp)
    be = TorchBackend(torch.float32, DEVICE)
    loss = cross_entropy(FLAGSHIP[-1])

    def mlp(dims, seed=0):
        return gen_net(be, dims[0], dims[-1],
                       [(h, act_logistic()) for h in dims[1:-1]],
                       act_softmax(), Rng(be, seed))

    for dims, B in ((FLAGSHIP, FIT_BATCH), (MP_WIDE, MP_WIDE_BATCH)):
        m = os.path.join(tmp, f"mp{dims[1]}.jsonl")
        n = 10 * B
        fit(mlp(dims), loss, be, tX[:n], tY[:n], epochs=1, batch_size=B,
            lr=FIT_LR, mixed_precision=True, metrics_path=m, verbose=False,
            log_every=10)
        with open(m) as f:
            rec = json.loads(f.readline())
        check(rec.get("mp_route") in ("f32", "bf16"),
              f"the router recorded {rec}")
        log(f"[mp] router at {'-'.join(map(str, dims))}, B={B} (sgd; one "
            f"captured step a route, 20 replays by CUDA events, the routes "
            f"in turns, the least of 3): f32 "
            f"{rec['mp_f32_us']} us, bf16 {rec['mp_bf16_us']} us -> "
            f"{rec['mp_route']} (bf16 only when more than 3% faster)")

    net = mlp(FLAGSHIP)
    res = fit(net, loss, be, tX, tY, epochs=FIT_EPOCHS, batch_size=FIT_BATCH,
              lr=FIT_LR, mixed_precision="bf16", log_every=FIT_LOG_EVERY,
              verbose=False)
    h = [x["loss"] for x in res.history]
    half = len(h) // 2
    check(all(math.isfinite(x) for x in h) and h[-1] < h[0] and
          statistics.mean(h[half:]) < statistics.mean(h[:half]),
          f"the bf16 run did not learn: {h}")
    check(all(p.dtype == torch.float32 for p in res.net.params),
          "the bf16 run's masters are not f32")
    log(f"[mp] flagship fit(mixed_precision='bf16', sgd, {res.steps} steps): "
        f"loss {h[0]:.4f} -> {h[-1]:.4f}; masters "
        f"{res.net.params[0].dtype}")

    # one bf16 step's gradients against the full-precision step in f64
    cpu = TorchBackend(torch.float64, "cpu")
    xb, yb = tX[:FIT_BATCH], tY[:FIT_BATCH]
    step_bf16 = make_opt_step(net, loss, be, sgd(), mixed_precision=True)
    _, _, p_card = step_bf16(torch.tensor(1.0, device=DEVICE),
                             be.asarray(xb), be.asarray(yb), (), net.params)
    net64 = Network(net.op, tuple(cpu.asarray(p.cpu()) for p in net.params),
                    net.act_names)
    _, _, p64 = make_opt_step(net64, loss, cpu, sgd())(
        1.0, cpu.asarray(xb), cpu.asarray(yb), (), net64.params)
    worst = 0.0
    for p0, pc, pr in zip(net64.params, p_card, p64):
        g_card, g64 = p0 - pc.double().cpu(), p0 - pr
        rel = float((g_card - g64).abs().max() / g64.abs().max())
        worst = max(worst, rel)
    check(worst <= TOL_BF16_GRAD, f"bf16 gradients {worst:.3e} of the "
          f"largest from f64 (tol {TOL_BF16_GRAD:g})")
    log(f"[mp] one bf16 sgd step (B={FIT_BATCH}) on the card against the "
        f"full-precision step in CPU f64: gradients within {worst:.3e} of each "
        f"leaf's largest (tol {TOL_BF16_GRAD:g})")

    lr_t = torch.tensor(FIT_LR, device=DEVICE)
    xd, yd = be.asarray(xb), be.asarray(yb)
    p = _profile_steps(lambda: step_bf16(lr_t, xd, yd, (), net.params), 3)
    gemms = [n for n in p["names"] if any(
        w in n.lower() for w in ("gemm", "tensorop", "gemv", "xmma"))]
    bf16 = [n for n in gemms if "bf16" in n or "bfloat16" in n]
    f32 = [n for n in gemms if n not in bf16]
    check(any("tensorop" in n and "bf16" in n for n in bf16),
          f"no bf16 tensor-core GEMM among the bf16 step's kernels: {gemms}")
    log(f"[mp] the bf16 step's products on the card: {len(bf16)} kernels "
        f"on bf16 operands, {len(f32)} on others; {p['launches']:.0f} "
        f"kernels a step, busy {p['busy_us']:.1f} us")
    for n in bf16 + f32:
        log(f"[mp]   {'bf16' if n in bf16 else 'other'}: {n[:200]}")


# The mesh's data axis (phase 23): the flagship through fit on a (4, 1) mesh
# whose 4 data ranks share the card, MESH_B = 100 rows a step (25 a rank),
# adam at lr 0.02 for one epoch of the synthetic set (60 steps), log every
# 10, in each configuration of MESH_RUNS.
MESH_DP, MESH_B, MESH_LR, MESH_LOG_EVERY, MESH_CRASH = 4, 100, 0.02, 10, 30
# Kernel 9's launches per step, (ar, rs, ag), as the design predicts them.
# Of the flagship's 6 leaves the ZeRO rule shards 4 over the data axis (the
# first free dimension 4 divides: W0's 784 columns, W1's and b1's 100 rows,
# W2's 100 columns); b0 keeps its model-axis entry and b2 (10) does not
# divide, so both stay whole.  Every step all-reduces the loss (1 ar); the
# gradients are all-reduced (6 ar), or at ZeRO-2/3 the 4 sharded ones
# reduce-scattered (4 rs) and the 2 whole ones all-reduced; at ZeRO-1/2 each
# rank's adam updates its blocks of the 4 sharded leaves and an all-gather
# rebuilds each (4 ag); at ZeRO-3 the 4 sharded params are gathered at use
# (4 ag) and stay sharded after the update.  adam8bit's update is not
# elementwise (one scale per block of 256 elements of the whole leaf): on
# ZeRO-3 it runs on whole leaves, so the 12 sharded int8 code buffers and
# 2 sharded scale buffers are all-gathered first (14 ag); under
# exact_reduction its gradients take the replicated run's 6 ar.  The trained
# leaves come back sharded, as they trained: nothing is gathered at the end.
MESH_RUNS = (
    ("replicated", "adam", {}, (7, 0, 0)),
    ("zero1", "adam", dict(shard_opt_state=True), (7, 0, 4)),
    ("zero2", "adam", dict(zero_stage=2), (3, 4, 4)),
    ("zero3", "adam", dict(zero_stage=3), (3, 4, 4)),
    ("zero3+offload", "adam", dict(zero_stage=3, offload_opt_state=True),
     (3, 4, 4)),
    ("adam8bit replicated", "adam8bit", {}, (7, 0, 0)),
    ("adam8bit exact zero3", "adam8bit exact", dict(zero_stage=3),
     (7, 0, 18)),
)
# ZeRO-2 against the replicated run: 60 adam steps in f32 whose gradient
# sums differ only in order (the reduce-scatter's fold, the all-reduce's).
# A step moves a parameter by lr * m / sqrt(v): a few ulps where the
# gradient is well above its rounding, but up to lr where it is a
# cancellation residue whose sign the two orders round apart (adam's first
# steps take lr * sign(g)).  Such residues are few: the parameters are held
# to 1e-3 + 1e-3|ref| (5x the 2.0e-4 an f32 rehearsal on the CPU measured;
# 1e-4, set before it, was too tight), the losses to TOL_5_STEPS.  ZeRO-3
# takes the same sums as ZeRO-2 (its params gathered at use are ZeRO-2's
# replicated ones): bit for bit.
TOL_MESH = (1e-3, 1e-3)
# the recurrent model of phase 9 on the mesh: adam at ZeRO-2, MESH_SEQ_STEPS
# steps of 256 sequences (64 a rank)
MESH_SEQ_STEPS = 4
# phase 24's split with remat_every (blocks of 8 of the 64 timesteps) and
# offload_activations
SEQ_TP_REMAT = 8


def _opt(name: str):
    from tensor_ops_tpu_torch.models import adam, adam8bit

    # adam8bit with stochastic rounding: nearest rounding explodes the
    # flagship within a few steps (phase 18)
    return {"adam": adam(), "adam8bit": adam8bit(stochastic_rounding=True),
            "adam8bit exact": adam8bit(stochastic_rounding=True,
                                       exact_reduction=True)}[name]


def _bit_equal(a, b) -> bool:
    return ([x["loss"] for x in a.history] == [x["loss"] for x in b.history]
            and all(torch.equal(_whole(x), _whole(y)) for x, y in
                    zip(a.net.params, b.net.params)))


def _flagship_net(be, seed: int = 0):
    """The flagship with random weights from ``seed`` (phases 23-25)."""
    from tensor_ops_tpu_torch.backend.rng import Rng
    from tensor_ops_tpu_torch.models import act_logistic, act_softmax, gen_net

    return gen_net(be, FLAGSHIP[0], FLAGSHIP[-1],
                   [(h, act_logistic()) for h in FLAGSHIP[1:-1]],
                   act_softmax(), Rng(be, seed))


def _mesh_flagship(tmp: str):
    """The mesh phase's configuration: the flagship (seed 0), its loss, the
    backend, the synthetic set, the (MESH_DP, 1) mesh of ranks sharing the
    card and fit's keyword arguments."""
    from types import SimpleNamespace

    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.models import cross_entropy
    from tensor_ops_tpu_torch.parallel import make_mesh

    tX, tY, _, _ = synthetic_set(tmp)
    be = TorchBackend(torch.float32, DEVICE)

    def net(seed=0):
        return _flagship_net(be, seed)

    return SimpleNamespace(
        net=net(), make_net=net, loss=cross_entropy(FLAGSHIP[-1]), be=be,
        tX=tX, tY=tY,
        mesh=make_mesh(MESH_DP, shape=(MESH_DP, 1),
                       devices=[DEVICE] * MESH_DP),
        kw=dict(epochs=1, batch_size=MESH_B, lr=MESH_LR,
                log_every=MESH_LOG_EVERY, verbose=False))


def _mesh_fit_runs(f, names=None):
    """The MESH_RUNS configurations (those in ``names``, else all) through
    fit on the card's mesh, each holding kernel 9's launches to the design's
    counts.  Returns ``(results by name, launches by kernel name)``."""
    from tensor_ops_tpu_torch.models import fit
    from tensor_ops_tpu_torch.ops import kernels as K
    from tensor_ops_tpu_torch.parallel import collective_kernels as CK

    net, loss, be, tX, tY, mesh, kw = (f.net, f.loss, f.be, f.tX, f.tY,
                                       f.mesh, f.kw)
    steps = -(-len(tX) // MESH_B)
    shape = (f"flagship {'-'.join(map(str, FLAGSHIP))}, adam lr {MESH_LR}, "
             f"B={MESH_B} over {MESH_DP} ranks of one card, 1 epoch = "
             f"{steps} steps")
    runs, launches = {}, {n: 0 for n in RING_NAMES}
    for name, opt, zkw, per_step in MESH_RUNS:
        if names is not None and name not in names:
            continue
        torch.cuda.synchronize()
        K.reset_launch_counts()
        CK.reset_phase_counts()
        res = fit(net, loss, be, tX, tY, optimizer=_opt(opt), mesh=mesh,
                  **zkw, **kw)
        torch.cuda.synchronize()
        counts, phases = K.launch_counts(), CK.phase_counts()
        runs[name] = res
        h = res.history
        check(res.steps == steps and all(math.isfinite(x["loss"]) for x in h),
              f"mesh {name}: {res.steps} steps, losses {h}")
        check(h[-1]["loss"] < h[0]["loss"], f"mesh {name}: the loss did not "
              f"fall ({h[0]['loss']} -> {h[-1]['loss']})")
        want = {p: steps * n for p, n in zip(("ar", "rs", "ag"), per_step)}
        check(phases == want and counts["bidir_ring"] == sum(want.values())
              and counts["bidir_ring.ring"] == 0 and sum(want.values()) > 0,
              f"mesh {name}: kernel 9 launches {phases} (bidir_ring "
              f"{counts['bidir_ring']}), the design predicts {want}")
        for n in RING_NAMES:
            launches[n] += counts[n]
        rate, first_ms = _fit_rate(res, MESH_B)
        log(f"[mesh] {name} ({shape}): loss {h[0]['loss']:.4f} -> "
            f"{h[-1]['loss']:.4f}; kernel 9 launches {phases} = per step "
            f"{dict(zip(('ar', 'rs', 'ag'), per_step))} x {steps}, as "
            f"predicted; "
            f"{rate:.1f} samples/s over steps {FIT_TIMED_FROM + 1}-{steps} "
            f"(host clock at the log boundaries); first step "
            f"{first_ms:.1f} ms")
    return runs, launches


def phase_mesh(tmp: str) -> dict:
    """The mesh's data axis on the card (phase 23): returns the kernel
    launches of its fit runs."""
    from tensor_ops_tpu_torch.models import fit, sgd
    from tensor_ops_tpu_torch.models.trainer import (_mesh_setup,
                                                     _offload_state,
                                                     make_opt_step)
    from tensor_ops_tpu_torch.parallel import param_specs
    from tensor_ops_tpu_torch.utils.profiling import training_memory_report

    f = _mesh_flagship(tmp)
    net, loss, be, tX, tY, mesh, kw = (f.net, f.loss, f.be, f.tX, f.tY,
                                       f.mesh, f.kw)
    runs, launches = _mesh_fit_runs(f)
    rep = runs["replicated"]
    check(_bit_equal(runs["zero1"], rep), "mesh zero1 differs from the "
          "replicated run (the same all-reduce, an elementwise update)")
    e = max(max_err(a, b, TOL_MESH) for a, b in
            zip(runs["zero2"].net.params, rep.net.params))
    e_l = max_err(torch.tensor([x["loss"] for x in runs["zero2"].history]),
                  torch.tensor([x["loss"] for x in rep.history]), TOL_5_STEPS)
    log(f"[mesh] zero2 vs the replicated run: params max|err| {e:.2e} (tol "
        f"{TOL_MESH[0]:g}+{TOL_MESH[1]:g}|ref|), losses {e_l:.2e} (tol "
        f"{TOL_5_STEPS[0]:g}+{TOL_5_STEPS[1]:g}|ref|): the reduce-scatter "
        f"sums in another order")
    check(_bit_equal(runs["zero3"], runs["zero2"]),
          "mesh: zero3 differs from zero2 (the same sums)")
    check(_bit_equal(runs["zero3+offload"], runs["zero3"]),
          "mesh: offload_opt_state changed the ZeRO-3 run")
    check(_bit_equal(runs["adam8bit exact zero3"],
                     runs["adam8bit replicated"]),
          "mesh: adam8bit(exact_reduction=True) at ZeRO-3 differs from the "
          "replicated adam8bit run")
    log("[mesh] zero1 bit-equal to the replicated run; zero3 to zero2; "
        "zero3+offload to zero3; adam8bit(exact_reduction=True) at zero3 "
        "to the replicated adam8bit run")

    # a Ctrl-C at step MESH_CRASH of the ZeRO-3 run, resumed to the budget,
    # with the moments on the card and offloaded to pinned host memory
    for name, zkw in (("zero3", {}), ("zero3+offload",
                                      dict(offload_opt_state=True))):
        _crash_resume(f, mesh, zkw, runs["zero3"],
                      os.path.join(tmp, f"mesh{len(zkw)}.npz"), name)

    # 5 sgd steps on the mesh against 5 of fit on one device, the same
    # 100-row batches: the mean of the ranks' means against the batch mean
    # (sgd: TOL_5_STEPS is five sgd steps' bound; adam's sign steps on
    # cancellation residues would exceed it, see TOL_MESH).  sgd moves each
    # parameter by lr times its gradient, so the comparison also holds the
    # 1/dp scale of the ZeRO-2 reduce-scatter (along W0's and W2's columns,
    # W1's and b1's rows) and ZeRO-3's gather at use to the bound (sgd has
    # no state to shard: both rungs warn that ZeRO-1 has nothing to do)
    n5 = 5 * MESH_B
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        single, *five = [fit(net, loss, be, tX[:n5], tY[:n5], optimizer=sgd(),
                             chain_steps=1, **dict(kw, log_every=1), **m)
                         for m in ({}, dict(mesh=mesh),
                                   dict(mesh=mesh, zero_stage=2),
                                   dict(mesh=mesh, zero_stage=3))]
    e5 = [max(max_err(a, b, TOL_5_STEPS) for a, b in
              zip(res.net.params, single.net.params)) for res in five]
    log(f"[mesh] 5 sgd steps on the mesh vs fit on one device: params "
        f"max|err| replicated {e5[0]:.2e}, zero2 {e5[1]:.2e}, zero3 "
        f"{e5[2]:.2e} (tol {TOL_5_STEPS[0]:g}+{TOL_5_STEPS[1]:g}|ref|)")

    # each rank's resident bytes (its shards) against the report's rows
    for name, opt, zkw, _ in MESH_RUNS:
        stage = zkw.get("zero_stage", 1 if zkw.get("shard_opt_state") else 0)
        params, state, _ = _mesh_setup(net.params, param_specs(
            net.param_stack, mesh), _opt(opt), mesh, be, stage)
        if zkw.get("offload_opt_state"):
            state = _offload_state(state, "smoke")
        row = training_memory_report(
            net, optimizer=_opt(opt), batch_size=MESH_B, mesh=mesh,
            zero_stage=stage, offload_opt_state=bool(
                zkw.get("offload_opt_state")))["per_device"]
        moments = [x for x in _tree(state) if x.shape]
        key = ("optimizer_host_bytes" if zkw.get("offload_opt_state")
               else "optimizer_bytes")
        for r in range(MESH_DP):
            got = (sum(p.rank_nbytes(r) for p in params),
                   sum(x.rank_nbytes(r) for x in moments))
            check(got == (row["params_bytes"], row[key]),
                  f"mesh {name}: rank {r} holds {got} bytes of params and "
                  f"moments, training_memory_report says "
                  f"{(row['params_bytes'], row[key])}")
        log(f"[mesh] {name}: each rank holds {got[0]} bytes of params and "
            f"{got[1]} of moments{' (pinned host)' * bool(zkw.get('offload_opt_state'))}"
            f", as training_memory_report's per_device rows")

    # one ZeRO-3 step profiled: kernels, busy time, idle share
    opt = _opt("adam")
    params, state, pins = _mesh_setup(net.params, param_specs(
        net.param_stack, mesh), opt, mesh, be, 3)
    step_fn = make_opt_step(net, loss, be, opt, mesh=mesh, **pins)
    xb = be.asarray(tX[:MESH_B].astype(np.float32))
    yb = be.asarray(tY[:MESH_B].astype(np.float32))
    box = [state, params]

    def one_step():
        v, box[0], box[1] = step_fn(MESH_LR, xb, yb, box[0], box[1])
        return v

    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        one_step()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) / 20 * 1e6
    prof = _profile_steps(one_step)
    top = ", ".join(f"{n} {us:.1f} us" for n, us in
                    list(prof["by_kernel"].items())[:6])
    log(f"[mesh] one zero3 step ({MESH_DP} ranks x {MESH_B // MESH_DP} "
        f"rows): {wall_us:.1f} us wall (host clock, 20 steps between "
        f"synchronises); {prof['launches']:.0f} kernels and "
        f"{prof['copies']:.0f} copies a step, device busy "
        f"{prof['busy_us']:.1f} us, idle share "
        f"{1 - prof['busy_us'] / wall_us:.3f}; most device time: {top}")

    launches_seq = phase_mesh_seq(be, mesh)
    for n in RING_NAMES:
        launches[n] += launches_seq[n]
    if torch.cuda.device_count() >= MESH_DP:
        phase_mesh_cards(f, runs, tmp)
    else:
        log(f"[mesh] {torch.cuda.device_count()} card(s): the {MESH_DP}-card "
            f"mesh (ring protocol) does not run here")
    return launches


def _tree(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _tree(t)]
    return [] if tree is None else [tree]


def phase_mesh_seq(be, mesh) -> dict:
    """fit_sequences on the mesh: the recurrent model (seed 7) with adam at
    ZeRO-2 against fit_sequences on one device, within TOL_SEQ_FIT plus
    twice the distance that regrouping the batch's sum into the mesh's 4
    chunks of 64 sequences (accum_steps=4 on one device) makes."""
    from tensor_ops_tpu_torch.models import adam, fit_sequences, squared_error
    from tensor_ops_tpu_torch.ops import kernels as K
    from tensor_ops_tpu_torch.parallel import collective_kernels as CK
    from tensor_ops_tpu_torch.parallel import mesh as M

    net = rnn_model(be)
    r = np.random.default_rng(0)
    n = MESH_SEQ_STEPS * SEQ_FIT_BATCH
    XS = r.standard_normal((n, RNN_N, RNN_IN)).astype(np.float32)
    TS = r.standard_normal((n, RNN_N, RNN_OUT)).astype(np.float32)
    loss = squared_error(RNN_OUT)
    kw = dict(epochs=1, batch_size=SEQ_FIT_BATCH, log_every=1, verbose=False,
              chain_steps=1, optimizer=adam(), **SEQ_FIT_RATES)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    CK.reset_phase_counts()
    on_mesh = fit_sequences(net, loss, be, XS, TS, mesh=mesh, zero_stage=2,
                            **kw)
    torch.cuda.synchronize()
    counts, phases = K.launch_counts(), CK.phase_counts()
    single = fit_sequences(net, loss, be, XS, TS, **kw)
    chunked = fit_sequences(net, loss, be, XS, TS, accum_steps=MESH_DP, **kw)
    # the design: the loss and each whole leaf all-reduced, each leaf the
    # ZeRO rule shards reduce-scattered and all-gathered after its update
    leaves = list(net.states) + list(net.params)
    specs = [(None,) * s.dim() for s in net.states] + list(
        M.param_specs(net.param_stack, mesh))
    n_z = sum(M.extend_spec(sp, tuple(x.shape), MESH_DP) is not None
              for x, sp in zip(leaves, specs))
    want = {"ar": MESH_SEQ_STEPS * (1 + len(leaves) - n_z),
            "rs": MESH_SEQ_STEPS * n_z, "ag": MESH_SEQ_STEPS * n_z}
    check(phases == want and n_z > 0, f"mesh fit_sequences: kernel 9 "
          f"launches {phases}, the design predicts {want}")
    check(all(math.isfinite(x["loss"]) for x in on_mesh.history),
          "mesh fit_sequences: non-finite loss")
    out = []
    for name, get in (("loss", lambda res: torch.tensor(
            [x["loss"] for x in res.history])),
                      ("leaves", lambda res: torch.cat(
                          [_whole(t).double().cpu().reshape(-1)
                           for t in _leaves(res.net)]))):
        ref = get(single).double()
        drift = float((get(chunked).double() - ref).abs().max())
        tol = TOL_SEQ_FIT + 2 * drift
        e = max_err(get(on_mesh), ref, (tol, 0.0))
        out.append(f"{name} max|err| {e:.2e} (tol {tol:.2e} = "
                   f"{TOL_SEQ_FIT:g} + 2 x accum_steps={MESH_DP}'s "
                   f"{drift:.2e})")
    log(f"[mesh] fit_sequences (Elman {RNN_IN}->[{RNN_HIDDEN}]->{RNN_OUT}, "
        f"n={RNN_N}, B={SEQ_FIT_BATCH} over {MESH_DP} ranks, adam, "
        f"zero_stage=2, {MESH_SEQ_STEPS} steps) vs one device: "
        f"{'; '.join(out)}; kernel 9 launches {phases} as predicted "
        f"({n_z} of {len(leaves)} leaves shard)")
    return counts


def _crash_resume(f, mesh, zkw, straight, ck: str, name: str) -> None:
    """A ZeRO-3 run on ``mesh`` (with ``zkw``) stopped by Ctrl-C at step
    MESH_CRASH, which writes its checkpoint to ``ck``, and resumed from it to
    the budget from other weights: bit-equal to the ``straight`` run."""
    from tensor_ops_tpu_torch.models import fit

    def boom(s):
        if s == MESH_CRASH:
            raise KeyboardInterrupt
        return MESH_LR

    zkw = dict(zkw, zero_stage=3, checkpoint_path=ck)
    try:
        fit(f.net, f.loss, f.be, f.tX, f.tY, optimizer=_opt("adam"),
            mesh=mesh, lr_schedule=boom, **zkw, **f.kw)
        check(False, f"the interrupted mesh fit ({name}) did not stop")
    except KeyboardInterrupt:
        pass
    resumed = fit(f.make_net(99), f.loss, f.be, f.tX, f.tY,
                  optimizer=_opt("adam"), mesh=mesh,
                  lr_schedule=lambda s: MESH_LR, resume=True, **zkw, **f.kw)
    check(resumed.history[0]["step"] == MESH_CRASH + 1 and all(
        torch.equal(_whole(a), _whole(b)) for a, b in
        zip(resumed.net.params, straight.net.params)),
          f"mesh {name}: the crash/resume chain differs from the straight "
          f"ZeRO-3 run")
    log(f"[mesh] {name}: Ctrl-C at step {MESH_CRASH} (its checkpoint), "
        f"resumed to the budget: bit-equal to the straight zero3 run")


def phase_mesh_cards(f, runs, tmp: str) -> None:
    """The replicated and ZeRO-3 runs on 4 cards (the ring protocol):
    bit-equal to the same runs with the 4 ranks on one card; and a ZeRO-3
    run with its moments offloaded, stopped by Ctrl-C at step MESH_CRASH
    (its checkpoint reads the moments' copies from all 4 cards) and
    resumed to the budget, bit-equal to the one-card ZeRO-3 run."""
    from tensor_ops_tpu_torch.models import fit
    from tensor_ops_tpu_torch.ops import kernels as K
    from tensor_ops_tpu_torch.parallel import make_mesh

    mesh4 = make_mesh(MESH_DP, shape=(MESH_DP, 1))
    for name, zkw in (("replicated", {}), ("zero3", dict(zero_stage=3))):
        K.reset_launch_counts()
        res = fit(f.net, f.loss, f.be, f.tX, f.tY, optimizer=_opt("adam"),
                  mesh=mesh4, **zkw, **f.kw)
        torch.cuda.synchronize()
        ring = K.launch_counts()["bidir_ring.ring"]
        check(ring > 0 and _bit_equal(res, runs[name]),
              f"mesh {name} on {MESH_DP} cards: {ring} ring launches; "
              f"bit-equal to one card: {_bit_equal(res, runs[name])}")
        log(f"[mesh] {name} on {MESH_DP} cards: {ring} ring-protocol "
            f"launches, bit-equal to the one-card run")

    _crash_resume(f, mesh4, dict(offload_opt_state=True), runs["zero3"],
                  os.path.join(tmp, "mesh4.npz"),
                  f"zero3+offload on {MESH_DP} cards")


# The mesh's model axis (phase 24): the port's tensor parallelism on the
# one card with its device repeated, meshes (2, 2) and (1, 4).  The flagship's
# layout changes with tp: at tp = 2 W0 (300, 784) is row-parallel, W1 (100,
# 300) column-parallel and W2 (10, 100) row-parallel with the softmax suffix
# after an all-gather; at tp = 4 W2 is column-parallel (10 % 4).  Kernel 9's
# launches, (ar, rs, ag), per request of shard_fused serving (each data
# group serves the whole request, replicated as in the JAX package): at (1,
# 4) the two column-parallel layers' partial sums (2 ar); at (2, 2) per data
# group W1's partial sums and W2's gather (1 ar + 1 ag), twice.
TP_SERVE = (((1, 4), (2, 0, 0)), ((2, 2), (2, 0, 2)))
TP_BUCKETS = (1, 8, 32, 128, 512)
TP_SERVE_TOL = (1e-5, 0.0)
# 784 -> 2048 -> 2048 -> 10 served on (1, 4) at B = 128 (random weights,
# seed 24): layout row, column, column; TP_WIDE_REQUESTS timed requests
TP_WIDE, TP_WIDE_B, TP_WIDE_REQUESTS = (784, 2048, 2048, 10), 128, 50
# fit through the executor (the phase 23 configuration: adam, lr 0.02,
# B = 100, one epoch = 60 steps), kernel 9's launches per step.  At (2, 2) each data group's step takes 2 ar + 1 ag (forward: W1's
# partial sums, W2's gather; backward: the partial input cotangents of W2's
# row-parallel layer; W1's and W0's backward move nothing), the loss 1 ar
# and the 6 leaves' gradients one reduction per model rank each (12 ar, or
# at ZeRO-2/3 8 rs for the 4 leaves the ZeRO rule shards, W0, W1, b1 and
# W2, and 4 ar); ZeRO-1/2 rebuild the 4 sharded leaves after the update
# (8 ag), ZeRO-3 gathers them at use (8 ag).  At (1, 4) a step is 2 ar
# (W1's and W2's partial sums) + 1 ag (the cotangent of W2's sliced input);
# one data rank reduces nothing.  The trained leaves come back sharded, as
# they trained: nothing is gathered at the end.
TP_RUNS = (
    ("replicated", (2, 2), {}, (17, 0, 2)),
    ("zero1", (2, 2), dict(shard_opt_state=True), (17, 0, 10)),
    ("zero2", (2, 2), dict(zero_stage=2), (9, 8, 10)),
    ("zero3", (2, 2), dict(zero_stage=3), (9, 8, 10)),
    ("zero3+offload", (2, 2), dict(zero_stage=3, offload_opt_state=True),
     (9, 8, 10)),
    ("(1, 4) replicated", (1, 4), {}, (2, 0, 1)),
)


def _tp_mesh(shape, devices=None):
    from tensor_ops_tpu_torch.parallel import make_mesh

    n = shape[0] * shape[1]
    return make_mesh(n, shape=shape, devices=devices or [DEVICE] * n)


def _counted(fn):
    """``fn()`` with every launch count reset first; returns (its result,
    the launches by kernel name, kernel 9's by phase)."""
    from tensor_ops_tpu_torch.ops import kernels as K
    from tensor_ops_tpu_torch.parallel import collective_kernels as CK

    torch.cuda.synchronize()
    K.reset_launch_counts()
    CK.reset_phase_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, K.launch_counts(), CK.phase_counts()


def _phases(t) -> dict:
    return dict(zip(("ar", "rs", "ag"), t))


def phase_tp_serving(f) -> dict:
    """shard_fused + Predictor on (1, 4) and (2, 2): every bucket against
    run_xla on one device and the CPU f64 run, no fused kernel launched,
    kernel 9's launches per request as TP_SERVE; then the 2048-wide model
    on (1, 4) timed.  Returns the launches by kernel name."""
    from tensor_ops_tpu_torch.models import FusedMLP, Predictor
    from tensor_ops_tpu_torch.parallel import shard_fused

    fm = FusedMLP.from_network(f.net)
    fm64 = FusedMLP(tuple(w.double().cpu() for w in fm.weights),
                    tuple(b.double().cpu() for b in fm.biases), fm.acts,
                    fm.softmax_out)
    launches = {n: 0 for n in RING_NAMES}
    r = np.random.default_rng(24)
    for shape, per in TP_SERVE:
        p = Predictor(shard_fused(fm, _tp_mesh(shape)), buckets=TP_BUCKETS)
        check(p._sharded, f"tp serving {shape}: the Predictor did not take "
              f"the mesh route")
        errs = []
        for b in TP_BUCKETS:
            x = r.uniform(0, 1, size=(b, FLAGSHIP[0])).astype(np.float32)
            out, counts, phases = _counted(lambda: p.predict(x))
            check(all(counts[k] == 0 for k in SERVE_KERNELS),
                  f"tp serving {shape} B={b}: fused kernels launched "
                  f"{ {k: counts[k] for k in SERVE_KERNELS} }")
            check(phases == _phases(per), f"tp serving {shape} B={b}: kernel "
                  f"9 launches {phases}, the design predicts {_phases(per)}")
            for n in RING_NAMES:
                launches[n] += counts[n]
            with torch.inference_mode():
                one = fm.run_xla(torch.as_tensor(x, device=DEVICE))
                cpu = fm64.run_xla(torch.as_tensor(x, dtype=torch.float64))
            errs.append((max_err(torch.as_tensor(out), one, TP_SERVE_TOL),
                         max_err(torch.as_tensor(out), cpu, TP_SERVE_TOL)))
        log(f"[tp] flagship served on {shape} through shard_fused + "
            f"Predictor at buckets {TP_BUCKETS}: max|err| against run_xla on "
            f"one device {max(e[0] for e in errs):.2e}, against CPU f64 "
            f"{max(e[1] for e in errs):.2e} (tol {TP_SERVE_TOL[0]:g}); kernel "
            f"9 {_phases(per)} a request as predicted, fused_linear and "
            f"fused_mlp_forward 0")

    ws = [torch.as_tensor(r.normal(0, 1 / math.sqrt(i), size=(o, i)),
                          dtype=torch.float32)
          for i, o in zip(TP_WIDE[:-1], TP_WIDE[1:])]
    bs = [torch.zeros(o) for o in TP_WIDE[1:]]
    wide = FusedMLP(tuple(w.to(DEVICE) for w in ws),
                    tuple(b.to(DEVICE) for b in bs),
                    ("logistic", "logistic", "identity"), True)
    p = Predictor(shard_fused(wide, _tp_mesh((1, 4))), buckets=(TP_WIDE_B,))
    x = r.uniform(0, 1, size=(TP_WIDE_B, TP_WIDE[0])).astype(np.float32)
    for _ in range(5):
        p.predict(x)
    p.timer.samples.clear()
    for _ in range(TP_WIDE_REQUESTS):
        p.predict(x)
    p50_us = p.latency()["p50_s"] * 1e6
    with torch.inference_mode():
        e = max_err(torch.as_tensor(p.predict(x)), wide.run_xla(
            torch.as_tensor(x, device=DEVICE)), TP_SERVE_TOL)
    prof = _profile_steps(lambda: p.predict(x))
    top = ", ".join(f"{n} {us:.1f} us" for n, us in
                    list(prof["by_kernel"].items())[:4])
    log(f"[tp] {'-'.join(map(str, TP_WIDE))} served on (1, 4), B="
        f"{TP_WIDE_B}: p50 {p50_us:.1f} us a request (host clock, "
        f"{TP_WIDE_REQUESTS} requests), {prof['launches']:.0f} kernels and "
        f"{prof['copies']:.0f} copies a request, device busy "
        f"{prof['busy_us']:.1f} us, idle share "
        f"{1 - prof['busy_us'] / p50_us:.3f}; max|err| against run_xla on "
        f"one device {e:.2e}; most device time: {top}")
    return launches


def _tp_fit_runs(f, names=None, devices=None):
    """The TP_RUNS configurations (those in ``names``, else all) through
    fit, each holding kernel 9's launches to the design's counts; the
    meshes on ``devices`` (default: the card, repeated).  Returns (results
    by name, launches by kernel name)."""
    from tensor_ops_tpu_torch.models import fit

    steps = -(-len(f.tX) // MESH_B)
    runs, launches = {}, {n: 0 for n in RING_NAMES}
    for name, shape, zkw, per in TP_RUNS:
        if names is not None and name not in names:
            continue
        mesh = _tp_mesh(shape, devices)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # ZeRO at dp = 1 warns
            res, counts, phases = _counted(lambda: fit(
                f.net, f.loss, f.be, f.tX, f.tY, optimizer=_opt("adam"),
                mesh=mesh, **zkw, **f.kw))
        runs[name] = res
        h = res.history
        check(res.steps == steps and all(math.isfinite(x["loss"]) for x in h)
              and h[-1]["loss"] < h[0]["loss"],
              f"tp {name}: {res.steps} steps, losses {h}")
        # one launch a call on one card; across cards the ring protocol
        # launches once a card of the group: at (2, 2) and (1, 4) with one
        # rank a card every group that calls spans max(dp, tp) cards
        per_call = 1 if devices is None else max(shape)
        want = {p: steps * n * per_call for p, n in zip(("ar", "rs", "ag"),
                                                        per)}
        ring = "bidir_ring" if devices is None else "bidir_ring.ring"
        check(phases == want and counts[ring] == sum(want.values()),
              f"tp {name} on {shape}: kernel 9 launches {phases} ({ring} "
              f"{counts[ring]}), the design predicts {want}")
        for n in RING_NAMES:
            launches[n] += counts[n]
        rate, first_ms = _fit_rate(res, MESH_B)
        log(f"[tp] fit {name} on {shape}{' (one rank a card)' * bool(devices)}"
            f": loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}; kernel 9 "
            f"{phases} = per step {_phases(per)} x {steps}, as predicted; "
            f"{rate:.1f} samples/s over steps {FIT_TIMED_FROM + 1}-{steps} "
            f"(host clock); first step {first_ms:.1f} ms; params returned "
            f"sharded on {[p.spec for p in res.net.params[0::2]]}")
    return runs, launches


def phase_model_axis(tmp: str) -> dict:
    """The mesh's model axis on the card (phase 24): returns the kernel
    launches of its runs."""
    from tensor_ops_tpu_torch.models import fit, sgd
    from tensor_ops_tpu_torch.models.trainer import _mesh_setup, make_opt_step
    from tensor_ops_tpu_torch.parallel import param_specs

    f = _mesh_flagship(tmp)
    launches = phase_tp_serving(f)
    runs, fit_launches = _tp_fit_runs(f)
    for n in RING_NAMES:
        launches[n] += fit_launches[n]
    rep = runs["replicated"]
    check(_bit_equal(runs["zero1"], rep), "tp (2, 2): zero1 differs from "
          "the replicated run (the same sums, an elementwise update)")
    check(_bit_equal(runs["zero3"], runs["zero2"]),
          "tp (2, 2): zero3 differs from zero2 (the same sums)")
    check(_bit_equal(runs["zero3+offload"], runs["zero3"]),
          "tp (2, 2): offload_opt_state changed the ZeRO-3 run")
    log("[tp] (2, 2): zero1 bit-equal to the replicated run; zero3 to zero2; "
        "zero3+offload to zero3")
    mesh22 = _tp_mesh((2, 2))
    _crash_resume(f, mesh22, {}, runs["zero3"],
                  os.path.join(tmp, "tp22.npz"), "tp (2, 2) zero3")

    # 5 sgd steps on each mesh against fit on one device (phase 23's bound)
    n5 = 5 * MESH_B
    kw = dict(f.kw, log_every=1)
    single, *five = [fit(f.net, f.loss, f.be, f.tX[:n5], f.tY[:n5],
                         optimizer=sgd(), chain_steps=1, **kw, **m)
                     for m in ({}, dict(mesh=mesh22),
                               dict(mesh=_tp_mesh((1, 4))))]
    e5 = [max(max_err(a, b, TOL_5_STEPS) for a, b in
              zip(res.net.params, single.net.params)) for res in five]
    log(f"[tp] 5 sgd steps vs fit on one device: params max|err| (2, 2) "
        f"{e5[0]:.2e}, (1, 4) {e5[1]:.2e} (tol {TOL_5_STEPS[0]:g}+"
        f"{TOL_5_STEPS[1]:g}|ref|): the column-parallel layers sum their "
        f"partial products in the ring's order")

    # one ZeRO-3 step at (2, 2) profiled
    opt = _opt("adam")
    params, state, pins = _mesh_setup(f.net.params, param_specs(
        f.net.param_stack, mesh22), opt, mesh22, f.be, 3)
    step_fn = make_opt_step(f.net, f.loss, f.be, opt, mesh=mesh22, **pins)
    xb = f.be.asarray(f.tX[:MESH_B].astype(np.float32))
    yb = f.be.asarray(f.tY[:MESH_B].astype(np.float32))
    box = [state, params]

    def one_step():
        v, box[0], box[1] = step_fn(MESH_LR, xb, yb, box[0], box[1])
        return v

    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        one_step()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) / 20 * 1e6
    prof = _profile_steps(one_step)
    top = ", ".join(f"{n} {us:.1f} us" for n, us in
                    list(prof["by_kernel"].items())[:6])
    log(f"[tp] one zero3 step on (2, 2) (2 data ranks x {MESH_B // 2} rows, "
        f"2 model ranks): {wall_us:.1f} us wall (host clock, 20 steps "
        f"between synchronises); {prof['launches']:.0f} kernels and "
        f"{prof['copies']:.0f} copies a step, device busy "
        f"{prof['busy_us']:.1f} us, idle share "
        f"{1 - prof['busy_us'] / wall_us:.3f}; most device time: {top}")

    seq = phase_tp_seq(f.be, mesh22)
    for n in RING_NAMES:
        launches[n] += seq[n]
    return launches


def tp_seq_predicted(dp: int, tp: int, n: int, leaves: int,
                     steps: int, recompute: bool = False) -> dict:
    """Kernel 9's launches (ar, rs, ag) of ``steps`` steps of
    ``fit_sequences`` on ``(dp, tp)`` of the Elman model (32 -> [512] ->
    32: its state weight on (model, None), its input weight on (None,
    model), its bias replicated, the output layer on (model, None) with an
    elementwise activation), from ``parallel/tp_seq.py``.  Each data
    group's step: forward, the input weight's partial products all-reduced
    once a sequence, the state all-gathered at each of the n timesteps,
    the row-split output gathered for the loss; backward, the output
    layer's input cotangent all-reduced, the state's at each timestep, and
    the cell's sliced (wX x + b) cotangent gathered.  Then the loss and
    each leaf's gradient on each model rank reduced over the data axis.
    No weight is gathered.  With ``recompute`` (``remat_every`` or
    ``offload_activations``) the backward recomputes the n timesteps from
    the kept states, their n state gathers again."""
    return {"ar": steps * (1 + tp * leaves + dp * (n + 2)), "rs": 0,
            "ag": steps * dp * (n + 2 + (n if recompute else 0))}


def phase_tp_seq(be, mesh) -> dict:
    """fit_sequences on (2, 2): the recurrent model (seed 7), its cell split
    over the model axis (parallel/tp_seq.py: each model rank its rows of
    the state weight, no weight gathered, no warning), with adam and with
    the reference's dual-rate sgd.  Against one device: the loss curves of
    both within TOL_5_STEPS, the bound phase 24 holds its tensor-parallel
    fit runs to, and the leaves after sgd.  Against the same run on one
    device in f64 on the card: the losses and leaves of both within a
    floor (TOL_SEQ_FIT for sgd, TOL_MESH's for adam) plus twice the
    one-device f32 run's distance from it, as the recurrent fit slice
    holds the card to CPU f64.  The split sums the input weight's partial
    products, the state's cotangent over the model ranks and a sequence's
    weight gradient in one contraction, in another order than the
    one-device scan, so the losses (~2,000 here) differ by ulps, above
    TOL_SEQ_FIT's 1e-5 (one f32 ulp of 2,048 is 2.4e-4); adam's first
    steps move a weight by lr * sign(g), so a gradient that is a
    cancellation residue takes the sign its order rounds to and the weight
    lands up to 2 lr away (see TOL_MESH): there one device itself lies
    ~0.1 from f64 (tools/seq_tp_against_f64.py), so adam's leaves are held
    to f64 and not to one device, while sgd moves each by lr * g.  The
    distance that regrouping the batch
    into the data axis's chunks makes (the gathered route's bound,
    TOL_SEQ_FIT plus twice it) is printed beside.  Then the sgd leg with
    ``remat_every=SEQ_TP_REMAT`` and ``offload_activations`` (the kept
    states through pinned host memory): within TOL_5_STEPS of the sgd
    leg (only the state weight's gradient sums block by block).  Kernel
    9's launches as :func:`tp_seq_predicted`."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.models import adam, fit_sequences, squared_error
    from tensor_ops_tpu_torch.models.recurrent import RecurrentNetwork
    from tensor_ops_tpu_torch.parallel import mesh as M

    net = rnn_model(be)
    r = np.random.default_rng(0)
    n = MESH_SEQ_STEPS * SEQ_FIT_BATCH
    XS = r.standard_normal((n, RNN_N, RNN_IN)).astype(np.float32)
    TS = r.standard_normal((n, RNN_N, RNN_OUT)).astype(np.float32)
    loss = squared_error(RNN_OUT)
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    leaves = list(net.states) + list(net.params)
    specs = [(None,) * s.dim() for s in net.states] + list(
        M.param_specs(net.param_stack, mesh))
    check(specs[len(net.states):] == [
        ("model", None), (None, "model"), (None,), ("model", None),
        ("model",)], f"tp fit_sequences: the leaves' specs {specs}")
    want = tp_seq_predicted(dp, tp, RNN_N, len(leaves), MESH_SEQ_STEPS)
    launches = {k: 0 for k in RING_NAMES}
    be64 = TorchBackend(torch.float64, DEVICE)
    net64 = RecurrentNetwork(net.op, tuple(s.double() for s in net.states),
                             tuple(p.double() for p in net.params), net.arch)

    def curve(res):
        return torch.tensor([x["loss"] for x in res.history],
                            dtype=torch.float64)

    def flat(res):
        return torch.cat([_whole(t).double().cpu().reshape(-1)
                          for t in _leaves(res.net)])

    for opt_name, opt in (("adam", adam()), ("dual-rate sgd", None)):
        kw = dict(epochs=1, batch_size=SEQ_FIT_BATCH, log_every=1,
                  verbose=False, chain_steps=1, optimizer=opt,
                  **SEQ_FIT_RATES)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            on_mesh, counts, phases = _counted(lambda: fit_sequences(
                net, loss, be, XS, TS, mesh=mesh, **kw))
            wall = time.perf_counter() - t0
        said = [str(x.message) for x in w if "model" in str(x.message)]
        check(not said, f"tp fit_sequences ({opt_name}): warned {said}")
        check(phases == want, f"tp fit_sequences ({opt_name}): kernel 9 "
              f"launches {phases}, the design predicts {want}")
        check(on_mesh.net.params[0].spec == ("model", None), f"tp "
              f"fit_sequences ({opt_name}): the state weight came back on "
              f"{on_mesh.net.params[0].spec}")
        for k in RING_NAMES:
            launches[k] += counts[k]
        single = fit_sequences(net, loss, be, XS, TS, **kw)
        chunked = fit_sequences(net, loss, be, XS, TS, accum_steps=dp, **kw)
        f64 = fit_sequences(net64, loss, be64, XS.astype(np.float64),
                            TS.astype(np.float64), **kw)
        out = []
        for name, get in (("loss", curve), ("leaves", flat)):
            ref = get(single)
            drift = float((get(chunked) - ref).abs().max())
            if name == "leaves" and opt is not None:
                e = float((get(on_mesh) - ref).abs().max())
                out.append(f"leaves max|err| {e:.2e} (held to f64 below: "
                           f"adam's sign steps; the chunked run's distance "
                           f"{drift:.2e})")
                continue
            e = max_err(get(on_mesh), ref, TOL_5_STEPS)
            out.append(f"{name} max|err| {e:.2e} (tol {TOL_5_STEPS[0]:g}+"
                       f"{TOL_5_STEPS[1]:g}|ref|; the chunked run's distance "
                       f"{drift:.2e})")
        ref = {"f64_loss": curve(f64), "f64_leaves": flat(f64),
               "f32_loss": curve(single), "f32_leaves": flat(single)}
        out.append("vs the one-device run in f64 on the card: " + _held_to_f64(
            on_mesh, ref, TOL_SEQ_FIT if opt is None else TOL_MESH[0],
            "the one-device f32 run"))
        log(f"[tp] fit_sequences (Elman {RNN_IN}->[{RNN_HIDDEN}]->{RNN_OUT}, "
            f"n={RNN_N}, B={SEQ_FIT_BATCH}, {opt_name}, {MESH_SEQ_STEPS} "
            f"steps) on {dp, tp} vs one device: {'; '.join(out)}; kernel 9 "
            f"{phases} as predicted (the cell split over the model axis: the "
            f"state gathered at each timestep, no weight gathered, no "
            f"warning); the run {wall:.2f} s (host clock)")
    sgd = on_mesh
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        memo, counts, phases = _counted(lambda: fit_sequences(
            net, loss, be, XS, TS, mesh=mesh, remat_every=SEQ_TP_REMAT,
            offload_activations=True, **kw))
    said = [str(x.message) for x in w if "model" in str(x.message)]
    check(not said, f"tp fit_sequences (remat, offload): warned {said}")
    want = tp_seq_predicted(dp, tp, RNN_N, len(leaves), MESH_SEQ_STEPS,
                            recompute=True)
    check(phases == want, f"tp fit_sequences (remat, offload): kernel 9 "
          f"launches {phases}, the design predicts {want}")
    for k in RING_NAMES:
        launches[k] += counts[k]
    e_loss = max_err(torch.tensor([x["loss"] for x in memo.history]),
                     torch.tensor([x["loss"] for x in sgd.history]),
                     TOL_5_STEPS)
    e_leaves = max(max_err(a, b, TOL_5_STEPS) for a, b in
                   zip(_leaves(memo.net), _leaves(sgd.net)))
    log(f"[tp] fit_sequences on {dp, tp}, dual-rate sgd with remat_every="
        f"{SEQ_TP_REMAT} and offload_activations (the block-entry states "
        f"through pinned host memory) vs without: loss max|err| "
        f"{e_loss:.2e}, leaves {e_leaves:.2e} (tol {TOL_5_STEPS[0]:g}+"
        f"{TOL_5_STEPS[1]:g}|ref|); kernel 9 {phases} as predicted (the "
        f"backward's recomputed state gathers included), no warning")
    return launches


def phase_model_axis_cards(f, tmp: str) -> None:
    """The (2, 2) and (1, 4) replicated fit runs with one rank a card (the
    ring protocol) bit-equal to the same meshes on one card."""
    names = ("replicated", "(1, 4) replicated")
    one, _ = _tp_fit_runs(f, names)
    cards = [f"cuda:{i}" for i in range(4)]
    four, _ = _tp_fit_runs(f, names, devices=cards)
    for name in names:
        check(_bit_equal(four[name], one[name]), f"tp {name} on 4 cards "
              f"differs from the same mesh on one card")
    log(f"[tp] {' and '.join(names)} on 4 cards (ring protocol) bit-equal to "
        f"the same meshes on one card")


# Phase 25: the pipelines (parallel.pipeline) at phase 24's width: a
# PipelineMLP 784 -> 2048 x 8 -> 10 (random weights, seed 25; the 8 h -> h
# layers are one array, shaped (S, L) for each form, so every form computes
# the same chain), B = 512, PIPE_STEPS SGD steps at PIPE_LR, the ranks on the
# card named several times.  (name, schedule, mesh shape, n_stages, layers
# a stage, microbatches.)
PIPE_I, PIPE_H, PIPE_O, PIPE_B, PIPE_LAYERS = 784, 2048, 10, 512, 8
PIPE_LR, PIPE_STEPS, PIPE_TIMED = 0.01, 5, 20
PIPE_RUNS = (
    ("gpipe", "gpipe", (4,), 4, 2, 4),
    ("dp x pp", "gpipe", (2, 2), 2, 4, 4),
    ("dp x pp x tp", "gpipe", (2, 2, 2), 2, 4, 4),
    ("circular M=2", "circular", (2,), 4, 2, 2),
    ("circular M=4", "circular", (2,), 4, 2, 4),
)
# Each form's forward is held to the one-device sequential net on the card
# and to the sequential net in CPU f64 at TOL_P (its probabilities), its
# losses and parameters after PIPE_STEPS steps at TOL_5_STEPS: the stages
# multiply microbatches of 64-128 rows where the sequential net multiplies
# all 512 (cuBLAS may take other algorithms, other roundings), and the
# tensor-parallel form's gather moves whole rows, so only f32 rounding
# separates them.


def pipe_predicted(shape, n: int, L: int, M: int, train: bool) -> dict:
    """Kernel 9's launches (ar, rs, ag) of one forward or one step of a
    pipeline, from parallel/pipeline.py: the model group's all-gather after
    each layer of each valid tick (dp * n_stages * M * L when tp > 1; the
    backward's reduce-scatter as many), the stage psum on each (data, model)
    group (dp * tp; its transpose only on the group feeding each data
    group's loss, dp), the rows gathered over the data groups (forward) or
    the loss summed over them (step) when dp > 1, and each leaf's gradient
    summed over the ranks that hold it (the 4 projections over every rank,
    the 2 stage arrays over each data group: 2 * S * tp calls when dp >
    1)."""
    names = {1: ("stage",), 2: ("data", "stage"),
             3: ("data", "stage", "model")}[len(shape)]
    dims = dict(zip(names, shape))
    dp, S, tp = dims.get("data", 1), dims["stage"], dims.get("model", 1)
    gathers = dp * n * M * L if tp > 1 else 0
    psums = dp * tp if S > 1 else 0
    if not train:
        return {"ar": psums, "rs": 0, "ag": gathers + (dp > 1)}
    grads = 4 * (dp * S * tp > 1) + (2 * S * tp if dp > 1 else 0)
    return {"ar": psums + (dp if S > 1 else 0) + (dp > 1) + grads,
            "rs": gathers, "ag": gathers}


def _pipe_arrays():
    """The model's six arrays (the 8 layers stacked; each weight normal
    over the square root of its fan-in, so that the softmax starts near
    uniform and SGD lowers the loss) and the batch, f32."""
    r = np.random.default_rng(25)
    h = PIPE_H
    arrays = [r.standard_normal((h, PIPE_I)) / np.sqrt(PIPE_I),
              0.1 * r.standard_normal(h),
              r.standard_normal((PIPE_LAYERS, h, h)) / np.sqrt(h),
              0.1 * r.standard_normal((PIPE_LAYERS, h)),
              r.standard_normal((PIPE_O, h)) / np.sqrt(h),
              0.1 * r.standard_normal(PIPE_O)]
    X = r.uniform(0, 1, size=(PIPE_B, PIPE_I))
    Y = np.eye(PIPE_O)[r.integers(0, PIPE_O, size=PIPE_B)]
    return ([a.astype(np.float32) for a in arrays], X.astype(np.float32),
            Y.astype(np.float32))


def _pipe_sequential(arrays, X, Y, device, dtype):
    """The plain chain on one device: its forward, and the losses and
    parameters of PIPE_STEPS SGD steps (torch autograd)."""
    ps = [torch.tensor(a, dtype=dtype, device=device) for a in arrays]
    x = torch.tensor(X, dtype=dtype, device=device)
    y = torch.tensor(Y, dtype=dtype, device=device)

    def fwd(ps):
        h = torch.sigmoid(torch.addmm(ps[1], x, ps[0].T))
        for k in range(ps[2].shape[0]):
            h = torch.sigmoid(torch.addmm(ps[3][k], h, ps[2][k].T))
        return torch.softmax(torch.addmm(ps[5], h, ps[4].T), dim=-1)

    with torch.no_grad():
        p0 = fwd(ps)
    losses = []
    for _ in range(PIPE_STEPS):
        ps = [p.detach().requires_grad_() for p in ps]
        loss = -torch.mean(torch.sum(y * torch.log(fwd(ps) + 1e-30), dim=-1))
        gs = torch.autograd.grad(loss, ps)
        losses.append(float(loss.detach()))
        ps = [(p - PIPE_LR * g).detach() for p, g in zip(ps, gs)]
    return p0, losses, ps


def _pipe_run(kind, shape, n, L, M, arrays, X, Y, devices=None):
    """One form on the card (``devices``: the ranks' devices, default the
    card repeated): its forward, kernel 9's launches of the forward and of
    the PIPE_STEPS steps, the losses, and the parameters whole, in the
    sequential layout (the 8 layers stacked)."""
    from tensor_ops_tpu_torch.parallel import pipeline as PP

    size = int(np.prod(shape))
    make = {1: PP.make_pipeline_mesh, 2: PP.make_dp_pipeline_mesh,
            3: PP.make_3d_pipeline_mesh}[len(shape)]
    mesh = make(*shape, devices=devices or [DEVICE] * size)
    h = PIPE_H
    a = list(arrays)
    a[2] = a[2].reshape(n, L, h, h)
    a[3] = a[3].reshape(n, L, h)
    model = PP.PipelineMLP.from_arrays(*a, device=DEVICE)
    circ = kind == "circular"
    model = (PP.shard_circular_model if circ else PP.shard_pipeline_model)(
        model, mesh)
    fwd = PP.circular_pipeline_forward if circ else PP.pipeline_forward
    step = (PP.circular_pipeline_train_step if circ
            else PP.pipeline_train_step)(model, mesh, M)
    x = torch.tensor(X, device=DEVICE)
    y = torch.tensor(Y, device=DEVICE)
    p0, counts_f, phases_f = _counted(lambda: fwd(model, mesh, x, M))
    box = [model.params(), []]

    def steps():
        for _ in range(PIPE_STEPS):
            v, box[0] = step(PIPE_LR, x, y, *box[0])
            box[1].append(v)

    _, counts_s, phases_s = _counted(steps)
    params = [_whole(p) for p in box[0]]
    S = mesh.shape["stage"]
    for i in (2, 3):
        if circ:
            params[i] = PP._interleave_chunks(params[i], n // S)
        params[i] = params[i].reshape((PIPE_LAYERS,) + tuple(
            params[i].shape[2:]))
    return dict(p0=p0, losses=[float(v) for v in box[1]], params=params,
                fwd=(counts_f, phases_f), steps=(counts_s, phases_s),
                step=step, model=model, x=x, y=y, mesh=mesh)


def phase_pipelines() -> dict:
    """The pipelines on the card (phase 25): returns kernel 9's launches of
    their forwards and steps."""
    from tensor_ops_tpu_torch.models import FusedMLP, Predictor
    from tensor_ops_tpu_torch.ops import kernels as K
    from tensor_ops_tpu_torch.parallel import shard_fused

    arrays, X, Y = _pipe_arrays()
    seq_p0, seq_losses, seq_ps = _pipe_sequential(arrays, X, Y, DEVICE,
                                                  torch.float32)
    launches = {n: 0 for n in RING_NAMES}
    runs = {}
    for name, kind, shape, n, L, M in PIPE_RUNS:
        run = _pipe_run(kind, shape, n, L, M, arrays, X, Y)
        runs[name] = run
        want_f = pipe_predicted(shape, n, L, M, False)
        want_s = {p: PIPE_STEPS * c for p, c in
                  pipe_predicted(shape, n, L, M, True).items()}
        for (counts, phases), want, what in ((run["fwd"], want_f, "forward"),
                                             (run["steps"], want_s, "steps")):
            check(phases == want and counts["bidir_ring"] == sum(
                want.values()) and counts["bidir_ring.ring"] == 0,
                f"pipeline {name} {what}: kernel 9 launches {phases} "
                f"(bidir_ring {counts['bidir_ring']}), the design predicts "
                f"{want}")
            for k in RING_NAMES:
                launches[k] += counts[k]
        e_f = max_err(run["p0"], seq_p0, TOL_P)
        e_l = max_err(torch.tensor(run["losses"]), torch.tensor(seq_losses),
                      TOL_5_STEPS)
        e_p = max(max_err(a, b, TOL_5_STEPS)
                  for a, b in zip(run["params"], seq_ps))
        check(run["losses"][-1] < run["losses"][0], f"pipeline {name}: the "
              f"loss did not fall ({run['losses']})")
        run["err_card"] = (e_f, e_l, e_p)
        log(f"[pipe] {name} on {shape} ({kind}, n_stages {n}, {L} layers a "
            f"stage, M={M}; {PIPE_I}->{PIPE_H}x{PIPE_LAYERS}->{PIPE_O}, "
            f"B={PIPE_B}): vs the one-device sequential net on the card "
            f"forward max|err| {e_f:.2e} (tol {TOL_P[0]:g}), {PIPE_STEPS} "
            f"sgd steps losses {e_l:.2e}, params {e_p:.2e} (tol "
            f"{TOL_5_STEPS[0]:g}+{TOL_5_STEPS[1]:g}|ref|); loss "
            f"{run['losses'][0]:.4f} -> {run['losses'][-1]:.4f}; kernel 9 "
            f"a forward {want_f}, a step "
            f"{pipe_predicted(shape, n, L, M, True)}, as predicted")

    # one GPipe step on (4,) timed: samples/s, wall, kernels, busy time
    g = runs["gpipe"]
    box = [g["model"].params()]

    def one_step():
        v, box[0] = g["step"](PIPE_LR, g["x"], g["y"], *box[0])
        return v

    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PIPE_TIMED):
        one_step()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) / PIPE_TIMED * 1e6
    prof = _profile_steps(one_step)
    top = ", ".join(f"{k} {us:.1f} us" for k, us in
                    list(prof["by_kernel"].items())[:6])
    log(f"[pipe] one gpipe step on (4,) (S=4, L=2, M=4, B={PIPE_B}): "
        f"{wall_us:.1f} us wall (host clock, {PIPE_TIMED} steps between "
        f"synchronises), {PIPE_B / wall_us * 1e6:.1f} samples/s; "
        f"{prof['launches']:.0f} kernels and {prof['copies']:.0f} copies a "
        f"step, device busy {prof['busy_us']:.1f} us, idle share "
        f"{1 - prof['busy_us'] / wall_us:.3f}; most device time: {top}")

    # Queue 3's second fault: a (2, 1) placement shards nothing, so the
    # Predictor serves rank 0's whole copy through the kernels below
    # xla_threshold (bucket 8: kernel 2, no collective)
    from tensor_ops_tpu_torch import TorchBackend

    fm = FusedMLP.from_network(_flagship_net(TorchBackend(torch.float32,
                                                          DEVICE)))
    p21 = Predictor(shard_fused(fm, _tp_mesh((2, 1))), buckets=(8,))
    p21.warmup()  # its request graph: a request then replays it
    x8 = np.random.default_rng(8).uniform(0, 1, size=(8, FLAGSHIP[0]))
    got, counts, _ = _counted(lambda: p21.predict(x8))
    want = Predictor(fm, buckets=(8,)).predict(x8)
    check(not p21._serving[3] and counts["fused_mlp_forward"] == 1
          and counts["bidir_ring"] == 0 and np.array_equal(got, want),
          f"(2, 1) shard_fused at bucket 8: sharded route {p21._serving[3]}, "
          f"fused_mlp_forward {counts['fused_mlp_forward']}, bidir_ring "
          f"{counts['bidir_ring']}, equal to the whole model "
          f"{np.array_equal(got, want)}")
    log("[pipe] (2, 1) shard_fused + Predictor at bucket 8: served whole "
        "from rank 0's copy, 1 fused_mlp_forward launch, no collective, "
        "bit-equal to the unplaced model")

    # the CPU f64 sequential net, last (a full-width CPU run in a process
    # that profiles the card can leave the profiler losing device events)
    c_p0, c_losses, c_ps = _pipe_sequential(arrays, X, Y, "cpu",
                                            torch.float64)
    for name, run in runs.items():
        e_f = max_err(run["p0"], c_p0, TOL_P)
        e_l = max_err(torch.tensor(run["losses"]), torch.tensor(c_losses),
                      TOL_5_STEPS)
        e_p = max(max_err(a, b, TOL_5_STEPS)
                  for a, b in zip(run["params"], c_ps))
        log(f"[pipe] {name} vs the CPU f64 sequential net: forward max|err| "
            f"{e_f:.2e}, losses {e_l:.2e}, params {e_p:.2e}")
    e_seq = max_err(seq_p0, c_p0, TOL_P)
    log(f"[pipe] the card's sequential net vs CPU f64: forward max|err| "
        f"{e_seq:.2e}")
    return launches


def phase_pipeline_cards() -> None:
    """The (4,) GPipe forward and PIPE_STEPS steps with one stage a card
    (hand-offs as peer copies, kernel 9 on the ring protocol): bit-equal to
    the same run with the 4 ranks on one card."""
    arrays, X, Y = _pipe_arrays()
    name, kind, shape, n, L, M = PIPE_RUNS[0]
    one = _pipe_run(kind, shape, n, L, M, arrays, X, Y)
    four = _pipe_run(kind, shape, n, L, M, arrays, X, Y,
                     devices=[f"cuda:{i}" for i in range(4)])
    ring = four["fwd"][0]["bidir_ring.ring"] + four["steps"][0][
        "bidir_ring.ring"]
    same = (torch.equal(four["p0"].to(DEVICE), one["p0"])
            and four["losses"] == one["losses"]
            and all(torch.equal(a.to(DEVICE), b)
                    for a, b in zip(four["params"], one["params"])))
    check(ring > 0 and same, f"gpipe (4,) on 4 cards: {ring} ring launches, "
          f"bit-equal to one card: {same}")
    log(f"[pipe] gpipe (4,) with one stage a card: {ring} ring-protocol "
        f"launches; forward, {PIPE_STEPS} steps' losses and parameters "
        f"bit-equal to the 4 ranks on one card")


# Phase 26: the staged-IR pipelines (parallel.ir_pipeline) and fit's
# pipeline mode at phase 25's width.  Three gen_net chains from seeded
# arrays (seed 26; weights normal over the square root of the fan-in, biases
# 0.1 normal): the uniform 784 -> 2048 x 9 -> 10 softmax (a pre of 784 ->
# 2048, a body of eight 2048 -> 2048 segments, a post of 2048 -> 10), the
# flagship and the autoencoder 784 -> 128 -> 32 -> 128 -> 784 (squared
# error), with the ranks on the card named several times.  (name, chain,
# schedule, mesh shape, microbatches, batch rows.)
IRP_LR, IRP_STEPS, IRP_TIMED = 0.01, 5, 20
IRP_RUNS = (
    ("gpipe", "uniform", "gpipe", (4,), 4, 512),
    ("dp x pp", "uniform", "gpipe", (2, 2), 4, 512),
    ("circular M=2", "uniform", "circular", (2,), 2, 512),
    ("circular M=4", "uniform", "circular", (2,), 4, 512),
    ("hetero", "flagship", "gpipe", (3,), 4, 100),
    ("hetero dp x pp", "flagship", "gpipe", (2, 2), 2, 100),
    ("hetero circular", "autoencoder", "circular", (2,), 2, 100),
)
IRP_CHAINS = {"uniform": ((784,) + (2048,) * 9 + (10,), "softmax"),
              "flagship": (FLAGSHIP, "softmax"),
              "autoencoder": ((784, 128, 32, 128, 784), "logistic")}
# fit on the meshes: the flagship on (2, 2) (M = 2, B = 100) through the
# ZeRO rungs (adam, IRP_FIT_STEPS steps); kernel 9's launches per step,
# (ar, rs, ag): the stage psum and its transpose on each data group (4),
# the loss averaged over the data groups (1) and the packed leaf's gradient
# averaged over the data axis on each stage rank (2 ar, or 2 rs where ZeRO-2
# and 3 shard it); ZeRO-1 and 2 gather the updated leaf on each stage rank
# (2 ag), ZeRO-3 gathers it at use instead, and once more at the run's end
# (the returned net is the parameter stack: each stage's data blocks
# gathered on its stage's ranks, 2 ag a run).
IRP_FIT_STEPS, IRP_FIT_B, IRP_FIT_M, IRP_CRASH = 20, 100, 2, 5
IRP_FIT_RUNS = (
    ("replicated", {}, (7, 0, 0), 0),
    ("zero1", dict(shard_opt_state=True), (7, 0, 2), 0),
    ("zero2", dict(zero_stage=2), (5, 2, 2), 0),
    ("zero3", dict(zero_stage=3), (5, 2, 2), 2),
    ("zero3+offload", dict(zero_stage=3, offload_opt_state=True), (5, 2, 2),
     2),
)
# the uniform chain's fit on (4,) (M = 4): the timed run's batch, and the
# batch of the 5 sgd steps held to one device (whose per-sample gradients
# of the 35M parameters at once bound its batch: 128 rows hold 18 GB)
IRP_TIMED_B, IRP_SGD_B = 512, 128


def irp_predicted(shape, n_leaves: int, n_repl: int, train: bool) -> dict:
    """Kernel 9's launches (ar, rs, ag) of one forward or one SGD step of
    a staged-IR pipeline, from parallel/ir_pipeline.py: the stage psum once
    per data group (dp; its transpose dp more in a step), the rows gathered
    over the data groups (forward) or the loss averaged over them (step)
    when dp > 1, each replicated leaf's gradient summed over each data
    group's stage ranks (n_repl * dp), and each leaf's gradient averaged
    over the data axis on each stage rank (n_leaves * S when dp > 1)."""
    dp, S = (1,) * (2 - len(shape)) + tuple(shape)
    psum = dp * (S > 1)
    if not train:
        return {"ar": psum, "rs": 0, "ag": int(dp > 1)}
    return {"ar": 2 * psum + n_repl * psum + (dp > 1)
            + (n_leaves * S if dp > 1 else 0), "rs": 0, "ag": 0}


def irp_tp_predicted(shape, M: int, n_segs: int, n_leaves: int,
                     n_repl: int, train: bool) -> dict:
    """Kernel 9's launches (ar, rs, ag) of one forward or one SGD step of
    a staged-IR pipeline on a (dp, S, tp) mesh whose partition row-splits
    over the model axis, from parallel/ir_pipeline.py: each data group
    all-gathers every segment's activation over its model group once a
    microbatch (dp * M * n_segs ag; as many rs transposes in a step), takes
    the stage psum of its home column (dp; its transpose dp more in a
    step); the rows gather over the data groups (forward) or the loss
    averages over them (step) when dp > 1; each replicated leaf's gradient
    is summed over each data group's stage and model ranks (n_repl * dp),
    and each leaf's averaged over the data axis on each stage and model
    rank (n_leaves * S * tp when dp > 1)."""
    dp, S, tp = shape
    gathers = dp * M * n_segs * (tp > 1)
    psum = dp * (S > 1)
    if not train:
        return {"ar": psum, "rs": 0, "ag": gathers + (dp > 1)}
    return {"ar": 2 * psum + n_repl * dp + (dp > 1)
            + (n_leaves * S * tp if dp > 1 else 0),
            "rs": gathers, "ag": gathers}


def _irp_arrays(chain: str):
    """The chain's parameter arrays (f32, seed 26) and its activations."""
    widths, out_act = IRP_CHAINS[chain]
    r = np.random.default_rng(26)
    arrays = []
    for i, o in zip(widths[:-1], widths[1:]):
        arrays += [r.standard_normal((o, i)) / np.sqrt(i),
                   0.1 * r.standard_normal(o)]
    acts = ["logistic"] * (len(widths) - 2) + [out_act]
    return [a.astype(np.float32) for a in arrays], acts


def _irp_net(chain: str, be, arrays=None):
    """The port's gen_net chain holding ``arrays`` (default the seeded
    ones) on ``be``, and its loss."""
    from tensor_ops_tpu_torch.backend.rng import Rng
    from tensor_ops_tpu_torch.models import (Network, act_logistic,
                                             act_softmax, cross_entropy,
                                             gen_net, squared_error)

    widths, out_act = IRP_CHAINS[chain]
    arrays = arrays if arrays is not None else _irp_arrays(chain)[0]
    tmpl = gen_net(be, widths[0], widths[-1],
                   [(h, act_logistic()) for h in widths[1:-1]],
                   act_softmax() if out_act == "softmax" else act_logistic(),
                   Rng(be, 0))
    loss = (cross_entropy if out_act == "softmax" else squared_error)(
        widths[-1])
    return Network(tmpl.op, tuple(be.asarray(a) for a in arrays),
                   tmpl.act_names), loss


def _irp_batch(chain: str, B: int):
    r = np.random.default_rng(27)
    widths, out_act = IRP_CHAINS[chain]
    X = r.uniform(0, 1, size=(B, widths[0])).astype(np.float32)
    Y = (np.eye(widths[-1])[r.integers(0, widths[-1], size=B)]
         if out_act == "softmax" else X).astype(np.float32)
    return X, Y


def _irp_plain(chain: str, X, Y, device, dtype):
    """The plain chain on one device (torch autograd): its output, the
    gradients at the start, and the losses and parameters of IRP_STEPS SGD
    steps."""
    arrays, acts = _irp_arrays(chain)
    ps = [torch.tensor(a, dtype=dtype, device=device) for a in arrays]
    x = torch.tensor(X, dtype=dtype, device=device)
    y = torch.tensor(Y, dtype=dtype, device=device)

    def fwd(ps):
        h = x
        for k, act in enumerate(acts):
            z = torch.addmm(ps[2 * k + 1], h, ps[2 * k].T)
            h = torch.softmax(z, dim=-1) if act == "softmax" else \
                torch.sigmoid(z)
        return h

    def loss(p):
        if acts[-1] == "softmax":
            return -torch.mean(torch.sum(y * torch.log(p), dim=-1))
        return torch.mean(torch.sum((y - p) ** 2, dim=-1))

    with torch.no_grad():
        out0 = fwd(ps)
    losses, grads0 = [], None
    for _ in range(IRP_STEPS):
        ps = [p.detach().requires_grad_() for p in ps]
        v = loss(fwd(ps))
        gs = torch.autograd.grad(v, ps)
        grads0 = grads0 or [g.detach() for g in gs]
        losses.append(float(v.detach()))
        ps = [(p - IRP_LR * g).detach() for p, g in zip(ps, gs)]
    return dict(out=out0, grads=grads0, losses=losses, params=ps)


def _irp_mesh(shape, devices=None):
    from tensor_ops_tpu_torch.parallel import pipeline as PP

    n = int(np.prod(shape))
    make = (PP.make_pipeline_mesh, PP.make_dp_pipeline_mesh,
            PP.make_3d_pipeline_mesh)[len(shape) - 1]
    return make(*shape, devices=devices or [DEVICE] * n)


def _irp_run(name, chain, sched, shape, M, B):
    """One form on the card: its forward, gradients and IRP_STEPS SGD steps
    through ``parallel.ir_pipeline``, each with kernel 9's launches, the
    results as the network's parameter stack."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.parallel import ir_pipeline as IP

    be = TorchBackend(torch.float32, DEVICE)
    net, loss = _irp_net(chain, be)
    mesh = _irp_mesh(shape)
    X, Y = _irp_batch(chain, B)
    x, y = torch.tensor(X, device=DEVICE), torch.tensor(Y, device=DEVICE)
    loss_fn, pnet = IP.make_ir_pipeline_loss(net, loss, be, mesh, M,
                                             schedule=sched, n_chunks=2)
    step, _ = IP.ir_pipeline_train_step(net, loss, be, mesh, M,
                                        schedule=sched, n_chunks=2)
    flat = IP.shard_pipelined_params(pnet, mesh).flat_params()
    out, _, ph_f = _counted(lambda: loss_fn.forward(flat, x))
    (v, g), _, ph_g = _counted(lambda: loss_fn.value_and_grad(flat, x, y))
    box = [flat, []]

    def steps():
        for _ in range(IRP_STEPS):
            v, box[0] = step(IRP_LR, x, y, *box[0])
            box[1].append(float(v))

    _, counts_s, ph_s = _counted(steps)
    specs = IP.pipelined_specs(pnet, mesh)
    n_repl = sum("stage" not in s for s in specs)
    if len(shape) == 3:
        n_segs = (pnet.n_body if isinstance(pnet, IP.PipelinedNetwork) else
                  sum(len(ops) for ops in getattr(pnet, "stage_ops", None)
                      or pnet.chunk_ops))
        want_f, want_s = (irp_tp_predicted(shape, M, n_segs, len(specs),
                                           n_repl, t) for t in (False, True))
    else:
        want_f, want_s = (irp_predicted(shape, len(specs), n_repl, t)
                          for t in (False, True))
    for got, want, what in ((ph_f, want_f, "forward"),
                            (ph_g, want_s, "gradient"),
                            (ph_s, {k: IRP_STEPS * n for k, n in
                                    want_s.items()}, "steps")):
        check(got == want, f"ir pipeline {name} {what}: kernel 9 launches "
              f"{got}, the design predicts {want}")
    check(counts_s["bidir_ring.ring"] == 0, f"ir pipeline {name}: the ring "
          f"protocol ran on one card")
    launches = sum(ph_f.values()) + sum(ph_g.values()) + sum(ph_s.values())
    return dict(out=out, grads=list(pnet.unflatten(g).to_network_params()),
                losses=box[1], kind=type(pnet).__name__, launches=launches,
                params=list(pnet.unflatten(box[0]).to_network_params()),
                per=(want_f, want_s), text=IP.describe_partition(pnet))


_IRP_PLAIN = {}


def _irp_plain_cached(chain: str, B: int, device, dtype):
    """:func:`_irp_plain` of the chain's seeded batch of ``B`` rows, once a
    process (phases 26 and 27 hold the same chains to it)."""
    key = (chain, B, str(device), dtype)
    if key not in _IRP_PLAIN:
        X, Y = _irp_batch(chain, B)
        _IRP_PLAIN[key] = _irp_plain(chain, X, Y, device, dtype)
    return _IRP_PLAIN[key]


def _irp_forms(forms) -> tuple:
    """Each form of ``forms`` (IRP_RUNS' tuples) on the card against the
    one-device plain chain; returns (kernel 9's launches, the runs)."""
    total, runs = 0, {}
    for name, chain, sched, shape, M, B in forms:
        ref = _irp_plain_cached(chain, B, DEVICE, torch.float32)
        run = _irp_run(name, chain, sched, shape, M, B)
        runs[name] = (chain, B, run)
        tol_out = TOL_P if IRP_CHAINS[chain][1] == "softmax" else TOL_Z
        e_f = max_err(run["out"], ref["out"], tol_out)
        e_g = max(max_err(a, b, TOL_P)
                  for a, b in zip(run["grads"], ref["grads"]))
        e_l = max_err(torch.tensor(run["losses"]),
                      torch.tensor(ref["losses"]), TOL_5_STEPS)
        e_p = max(max_err(a, b, TOL_5_STEPS)
                  for a, b in zip(run["params"], ref["params"]))
        check(run["losses"][-1] < run["losses"][0], f"ir pipeline {name}: "
              f"the loss did not fall ({run['losses']})")
        total += run["launches"]
        log(f"[irp] {name} on {shape} ({run['kind']}, {sched}, M={M}, "
            f"B={B}, {'-'.join(map(str, IRP_CHAINS[chain][0][:3]))}..."
            f"{IRP_CHAINS[chain][0][-1]}): vs the one-device plain chain on "
            f"the card forward max|err| {e_f:.2e} (tol {tol_out[0]:g}), "
            f"gradients {e_g:.2e} (tol {TOL_P[0]:g}), {IRP_STEPS} sgd steps "
            f"losses {e_l:.2e}, params {e_p:.2e} (tol {TOL_5_STEPS[0]:g}+"
            f"{TOL_5_STEPS[1]:g}|ref|); loss {run['losses'][0]:.4f} -> "
            f"{run['losses'][-1]:.4f}; kernel 9 a forward {run['per'][0]}, "
            f"a step {run['per'][1]}, as predicted")
    return total, runs


def irp_cpu_check(runs: dict) -> None:
    """Every form of phases 26 and 27 against the plain chain in CPU f64
    (after both: a full-width CPU run in a process that profiles the card
    can leave the profiler losing device events)."""
    for name, (chain, B, run) in runs.items():
        cpu = _irp_plain_cached(chain, B, "cpu", torch.float64)
        tol_out = TOL_P if IRP_CHAINS[chain][1] == "softmax" else TOL_Z
        e_f = max_err(run["out"], cpu["out"], tol_out)
        e_g = max(max_err(a, b_, TOL_P)
                  for a, b_ in zip(run["grads"], cpu["grads"]))
        e_l = max_err(torch.tensor(run["losses"]),
                      torch.tensor(cpu["losses"]), TOL_5_STEPS)
        e_p = max(max_err(a, b_, TOL_5_STEPS)
                  for a, b_ in zip(run["params"], cpu["params"]))
        log(f"[irp] {name} vs the CPU f64 plain chain: forward max|err| "
            f"{e_f:.2e}, gradients {e_g:.2e}, losses {e_l:.2e}, params "
            f"{e_p:.2e}")


def phase_ir_pipelines(tmp: str) -> tuple:
    """The staged-IR pipelines and fit's pipeline mode on the card (phase
    26): returns kernel 9's launches and the forms' runs (held to CPU f64
    by :func:`irp_cpu_check`)."""
    launches = {n: 0 for n in RING_NAMES}
    n, runs = _irp_forms(IRP_RUNS)
    launches["bidir_ring"] += n
    log("[irp] partitions: " + " | ".join(
        runs[n][2]["text"].splitlines()[0] for n in ("gpipe", "hetero",
                                                     "hetero circular")))
    launches["bidir_ring"] += phase_ir_fit(tmp)
    return launches, runs


def _irp_fit(chain, shape, X, Y, M, devices=None, **kw):
    """``fit`` of the chain on the stage mesh of ``shape`` (``None``: one
    device), with kernel 9's launches by phase."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.models import fit

    be = TorchBackend(torch.float32, DEVICE)
    net, loss = _irp_net(chain, be)
    mesh = None if shape is None else _irp_mesh(shape, devices)
    extra = {} if shape is None else dict(mesh=mesh, pipeline_microbatches=M)
    kw = dict(dict(epochs=1, log_every=1, verbose=False, lr=IRP_LR), **kw)
    return _counted(lambda: fit(net, loss, be, X, Y, **extra, **kw))


_IRP_ONE = {}


def _irp_fit_one(chain, X, Y, B):
    """5 sgd steps of ``fit`` of the chain on one device (unchained), once
    a process for a given batch."""
    from tensor_ops_tpu_torch.models import sgd

    key = (chain, len(X), B)
    if key not in _IRP_ONE:
        _IRP_ONE[key] = _irp_fit(chain, None, X, Y, 4, batch_size=B,
                                 optimizer=sgd(), chain_steps=1)[0]
    return _IRP_ONE[key]


def _irp_whole(res):
    return [p.to(DEVICE) for p in res.net.params]


def phase_ir_fit(tmp: str) -> int:
    """fit's pipeline mode on the card: returns kernel 9's launches."""
    from tensor_ops_tpu_torch.models import sgd

    tX, tY, _, _ = synthetic_set(tmp)
    total = 0
    # 5 sgd steps on each mesh against fit on one device, the same batches
    for chain, shape, M, B in (("flagship", (2, 2), IRP_FIT_M, IRP_FIT_B),
                               ("uniform", (4,), 4, IRP_SGD_B)):
        X, Y = tX[:5 * B], tY[:5 * B]
        one = _irp_fit_one(chain, X, Y, B)
        pp, _, ph = _irp_fit(chain, shape, X, Y, M, batch_size=B,
                             optimizer=sgd())
        total += sum(ph.values())
        e_l = max_err(torch.tensor([h["loss"] for h in pp.history]),
                      torch.tensor([h["loss"] for h in one.history]),
                      TOL_5_STEPS)
        e_p = max(max_err(a, b, TOL_5_STEPS)
                  for a, b in zip(_irp_whole(pp), _irp_whole(one)))
        log(f"[irp] fit {chain} on {shape} (M={M}, B={B}), 5 sgd steps vs "
            f"fit on one device: losses max|err| {e_l:.2e}, params {e_p:.2e} "
            f"(tol {TOL_5_STEPS[0]:g}+{TOL_5_STEPS[1]:g}|ref|)")

    # the flagship on (2, 2) through the ZeRO rungs (adam)
    n = IRP_FIT_STEPS * IRP_FIT_B
    X, Y = tX[:n], tY[:n]
    runs = {}
    for name, zkw, per_step, end in IRP_FIT_RUNS:
        res, counts, ph = _irp_fit("flagship", (2, 2), X, Y, IRP_FIT_M,
                                   batch_size=IRP_FIT_B, optimizer=_opt(
                                       "adam"), **zkw)
        want = {p: IRP_FIT_STEPS * k for p, k in zip(("ar", "rs", "ag"),
                                                      per_step)}
        want["ag"] += end
        check(ph == want and counts["bidir_ring.ring"] == 0,
              f"ir fit {name}: kernel 9 launches {ph}, the design predicts "
              f"{want}")
        h = res.history
        check(res.steps == IRP_FIT_STEPS and h[-1]["loss"] < h[0]["loss"],
              f"ir fit {name}: {res.steps} steps, loss {h[0]['loss']} -> "
              f"{h[-1]['loss']}")
        total += sum(ph.values())
        runs[name] = res
    for a, b in (("zero1", "replicated"), ("zero3", "zero2"),
                 ("zero3+offload", "zero3")):
        check(_bit_equal(runs[a], runs[b]), f"ir fit: {a} differs from {b}")
    e = max(max_err(a, b, TOL_MESH) for a, b in
            zip(runs["zero2"].net.params, runs["replicated"].net.params))
    log(f"[irp] fit flagship on (2, 2) (hetero, M={IRP_FIT_M}, "
        f"B={IRP_FIT_B}, adam, {IRP_FIT_STEPS} steps): kernel 9 per step "
        f"{', '.join(f'{n} {p}' for n, _, p, _ in IRP_FIT_RUNS)} (+2 ag at a "
        f"ZeRO-3 run's end) as predicted; "
        f"zero1 bit-equal to replicated, zero3 to zero2, zero3+offload to "
        f"zero3; zero2 vs replicated params max|err| {e:.2e}; loss "
        f"{runs['replicated'].history[0]['loss']:.4f} -> "
        f"{runs['replicated'].history[-1]['loss']:.4f}")

    # bf16 on f32 masters: the loss falls
    res, _, ph = _irp_fit("flagship", (2, 2), X, Y, IRP_FIT_M,
                          batch_size=IRP_FIT_B, optimizer=_opt("adam"),
                          mixed_precision="bf16")
    total += sum(ph.values())
    h = res.history
    check(h[-1]["loss"] < h[0]["loss"] and all(p.dtype == torch.float32
                                               for p in res.net.params),
          f"ir fit bf16: loss {h[0]['loss']} -> {h[-1]['loss']}")
    log(f"[irp] fit flagship on (2, 2) in bf16 (f32 masters): loss "
        f"{h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}")

    # accum_steps=2, Ctrl-C at step IRP_CRASH, resumed: bit-equal
    ck = os.path.join(tmp, "irp.npz")
    akw = dict(batch_size=2 * IRP_FIT_B, accum_steps=2,
               optimizer=_opt("adam"))
    straight, _, ph = _irp_fit("flagship", (2, 2), X, Y, IRP_FIT_M, **akw)
    total += sum(ph.values())

    def boom(s):
        if s == IRP_CRASH:
            raise KeyboardInterrupt
        return IRP_LR

    try:
        _, _, ph = _irp_fit("flagship", (2, 2), X, Y, IRP_FIT_M,
                            lr_schedule=boom, checkpoint_path=ck, **akw)
        check(False, "the interrupted pipeline fit did not stop")
    except KeyboardInterrupt:
        pass
    resumed, _, ph = _irp_fit("flagship", (2, 2), X, Y, IRP_FIT_M,
                              lr_schedule=lambda s: IRP_LR,
                              checkpoint_path=ck, resume=True, **akw)
    total += sum(ph.values())
    check(resumed.history[0]["step"] == IRP_CRASH + 1 and all(
        torch.equal(a, b) for a, b in zip(resumed.net.params,
                                          straight.net.params)),
          "ir fit: the accum_steps=2 crash/resume chain differs from the "
          "straight run")
    log(f"[irp] fit flagship on (2, 2), accum_steps=2: Ctrl-C at step "
        f"{IRP_CRASH}, resumed to the budget: bit-equal to the straight run")

    # a circular resume of a GPipe checkpoint is refused; a stage mesh with
    # a model axis of 2 trains (the autoencoder's hetero-tp cut)
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.models import fit

    ck2 = os.path.join(tmp, "irp_layout.npz")
    _irp_fit("autoencoder", (2,), X[:200], X[:200], 2, batch_size=100,
             checkpoint_path=ck2, checkpoint_every=1)
    be = TorchBackend(torch.float32, DEVICE)
    net, loss = _irp_net("autoencoder", be)
    try:
        fit(net, loss, be, X[:200], X[:200], batch_size=100,
            pipeline_microbatches=2, verbose=False, mesh=_irp_mesh((2,)),
            pipeline_schedule="circular", checkpoint_path=ck2, resume=True)
        check(False, "ir fit: a circular resume of a GPipe checkpoint was "
              "not refused")
    except ValueError as e:
        check("layout" in str(e), f"ir fit: refused with {e!r}, not naming "
              f"the layout")
    res, _, ph = _irp_fit("autoencoder", (1, 2, 2), X[:400], X[:400], 2,
                          batch_size=100)
    total += sum(ph.values())
    h = res.history
    check(res.steps == 4 and h[-1]["loss"] < h[0]["loss"] and ph["ag"] > 0,
          f"ir fit on (1, 2, 2): {res.steps} steps, loss {h[0]['loss']} -> "
          f"{h[-1]['loss']}, kernel 9 {ph}")
    log(f"[irp] a circular resume of a GPipe checkpoint is refused by its "
        f"layout; the autoencoder on (1, 2, 2) (a model axis of 2) trains: "
        f"loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f} in 4 steps, kernel "
        f"9 {ph}")

    # samples/s of the uniform chain's fit on (4,) (adam, M=4), and one
    # step's wall, kernels, busy time and idle share
    return total + _irp_timing(tX, tY, (4,), 4)


def _irp_timing(tX, tY, shape, M: int) -> int:
    """The uniform chain's fit on ``shape`` (adam, M microbatches, B =
    IRP_TIMED_B, IRP_TIMED steps): samples/s over the later steps; then one
    step's wall (host clock), kernels, busy time and idle share.  Returns
    kernel 9's launches of the fit."""
    B = IRP_TIMED_B
    Xu = np.concatenate([tX] * (-(-IRP_TIMED * B // len(tX))))[:IRP_TIMED * B]
    Yu = np.concatenate([tY] * (-(-IRP_TIMED * B // len(tY))))[:IRP_TIMED * B]
    res, _, ph = _irp_fit("uniform", shape, Xu, Yu, M, batch_size=B,
                          optimizer=_opt("adam"))
    rate, first_ms = _fit_rate(res, B)
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.models.trainer import _mesh_setup, make_opt_step
    from tensor_ops_tpu_torch.parallel import ir_pipeline as IP

    be = TorchBackend(torch.float32, DEVICE)
    net, loss = _irp_net("uniform", be)
    mesh = _irp_mesh(shape)
    part = IP.partition_network(net, shape[-2 if len(shape) == 3 else -1],
                                mesh)
    opt = _opt("adam")
    params, state, pins = _mesh_setup(part.flat_params(),
                                      IP.pipelined_specs(part, mesh), opt,
                                      mesh, be, 0)
    step_fn = make_opt_step(net, loss, be, opt, mesh=mesh,
                            pipeline=(part.skeleton(), M, "gpipe"), **pins)
    xb = be.asarray(Xu[:B].astype(np.float32))
    yb = be.asarray(Yu[:B].astype(np.float32))
    box = [state, params]

    def one_step():
        v, box[0], box[1] = step_fn(IRP_LR, xb, yb, box[0], box[1])
        return v

    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        one_step()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) / 5 * 1e6
    prof = _profile_steps(one_step, steps=3)
    top = ", ".join(f"{k} {us:.1f} us" for k, us in
                    list(prof["by_kernel"].items())[:6])
    log(f"[irp] fit uniform 784->2048x9->10 on {shape} (gpipe, M={M}, "
        f"B={B}, adam, {type(part).__name__}): {rate:.1f} samples/s over "
        f"steps {FIT_TIMED_FROM + 1}-{res.steps} (host clock at the log "
        f"boundaries); first step {first_ms:.1f} ms; one step "
        f"{wall_us:.1f} us wall (host clock, 5 steps between synchronises), "
        f"{prof['launches']:.0f} kernels and {prof['copies']:.0f} copies a "
        f"step, device busy {prof['busy_us']:.1f} us, idle share "
        f"{1 - prof['busy_us'] / wall_us:.3f}; most device time: {top}")
    return sum(ph.values())


# Phase 27: the tensor-parallel pipelines on the (data, stage, model) mesh,
# at phase 26's widths and seeds: the uniform chain's body row-split over
# the model axis (GPipe on (2, 2, 2), circular on (1, 2, 2)), the
# flagship's hetero-tp cut on (1, 3, 2) and the autoencoder's hetero-tp
# circular cut on (1, 2, 2).  (name, chain, schedule, mesh shape,
# microbatches, batch rows.)
IRP_TP_RUNS = (
    ("uniform tp", "uniform", "gpipe", (2, 2, 2), 4, 512),
    ("uniform tp circular", "uniform", "circular", (1, 2, 2), 4, 512),
    ("hetero tp", "flagship", "gpipe", (1, 3, 2), 4, 100),
    ("hetero tp circular", "autoencoder", "circular", (1, 2, 2), 2, 100),
)
# fit of the uniform chain on (2, 2, 2) (M = 4, B = IRP_SGD_B, adam,
# IRP_TP_FIT_STEPS steps) through the ZeRO rungs; kernel 9's launches per
# step, (ar, rs, ag): each data group's activation gathers over its model
# group, 4 microbatches x 8 body segments (64 ag for the 2 groups, 64 rs
# transposes), the stage psum and its transpose (4), the 4 replicated
# leaves' gradient sums over each data group's 4 ranks (8), the loss over
# the data groups (1) and each of the 6 leaves' gradient averaged over the
# data axis on each of the 4 (stage, model) ranks (24 ar; ZeRO-2 and 3
# reduce-scatter the 5 leaves with a free dimension dp divides: 20 rs and
# 4 ar).  ZeRO-1 and 2 gather those 5 updated leaves (20 ag), ZeRO-3
# gathers them at use instead, and once more at the run's end (the
# returned parameter stack, 20 ag a run).
IRP_TP_FIT_STEPS = 5
# adam at IRP_LR drives the 2048-wide chain's loss up within 5 steps; the
# rungs and the crash/resume chain take a step size at which it falls
IRP_TP_ADAM_LR = 3e-5
IRP_TP_FIT_RUNS = (
    ("replicated", {}, (37, 64, 64), 0),
    ("zero1", dict(shard_opt_state=True), (37, 64, 84), 0),
    ("zero2", dict(zero_stage=2), (17, 84, 84), 0),
    ("zero3", dict(zero_stage=3), (17, 84, 84), 20),
    ("zero3+offload", dict(zero_stage=3, offload_opt_state=True),
     (17, 84, 84), 20),
)


def phase_ir_tp(tmp: str) -> tuple:
    """The tensor-parallel pipelines on the card (phase 27): returns kernel
    9's launches and the forms' runs (held to CPU f64 by
    :func:`irp_cpu_check`)."""
    launches = {n: 0 for n in RING_NAMES}
    n, runs = _irp_forms(IRP_TP_RUNS)
    launches["bidir_ring"] += n
    log("[irp-tp] partitions: " + " | ".join(
        runs[n][2]["text"].splitlines()[0] for n in (
            "hetero tp", "hetero tp circular")))
    launches["bidir_ring"] += phase_ir_tp_fit(tmp)
    return launches, runs


def phase_ir_tp_fit(tmp: str) -> int:
    """fit of the uniform chain on (2, 2, 2) on the card: returns kernel 9's
    launches."""
    from tensor_ops_tpu_torch.models import sgd

    tX, tY, _, _ = synthetic_set(tmp)
    shape, M, B = (2, 2, 2), 4, IRP_SGD_B
    total = 0
    # 5 sgd steps against fit on one device, the same batches
    X, Y = tX[:5 * B], tY[:5 * B]
    one = _irp_fit_one("uniform", X, Y, B)
    pp, _, ph = _irp_fit("uniform", shape, X, Y, M, batch_size=B,
                         optimizer=sgd())
    total += sum(ph.values())
    e_l = max_err(torch.tensor([h["loss"] for h in pp.history]),
                  torch.tensor([h["loss"] for h in one.history]),
                  TOL_5_STEPS)
    e_p = max(max_err(a, b, TOL_5_STEPS)
              for a, b in zip(_irp_whole(pp), _irp_whole(one)))
    log(f"[irp-tp] fit uniform on {shape} (M={M}, B={B}), 5 sgd steps vs "
        f"fit on one device: losses max|err| {e_l:.2e}, params {e_p:.2e} "
        f"(tol {TOL_5_STEPS[0]:g}+{TOL_5_STEPS[1]:g}|ref|)")

    # the ZeRO rungs (adam)
    n = IRP_TP_FIT_STEPS * B
    X, Y = tX[:n], tY[:n]
    runs = {}
    for name, zkw, per_step, end in IRP_TP_FIT_RUNS:
        res, counts, ph = _irp_fit("uniform", shape, X, Y, M, batch_size=B,
                                   optimizer=_opt("adam"),
                                   lr=IRP_TP_ADAM_LR, **zkw)
        want = {p: IRP_TP_FIT_STEPS * k for p, k in zip(("ar", "rs", "ag"),
                                                         per_step)}
        want["ag"] += end
        check(ph == want and counts["bidir_ring.ring"] == 0,
              f"ir tp fit {name}: kernel 9 launches {ph}, the design "
              f"predicts {want}")
        h = res.history
        check(res.steps == IRP_TP_FIT_STEPS and h[-1]["loss"] < h[0]["loss"],
              f"ir tp fit {name}: {res.steps} steps, loss {h[0]['loss']} -> "
              f"{h[-1]['loss']}")
        total += sum(ph.values())
        runs[name] = res
    for a, b in (("zero1", "replicated"), ("zero3", "zero2"),
                 ("zero3+offload", "zero3")):
        check(_bit_equal(runs[a], runs[b]), f"ir tp fit: {a} differs from "
              f"{b}")
    e = max(max_err(a, b, TOL_MESH) for a, b in
            zip(runs["zero2"].net.params, runs["replicated"].net.params))
    log(f"[irp-tp] fit uniform on {shape} (M={M}, B={B}, adam, "
        f"{IRP_TP_FIT_STEPS} steps): kernel 9 per step "
        f"{', '.join(f'{n} {p}' for n, _, p, _ in IRP_TP_FIT_RUNS)} (+20 ag "
        f"at a ZeRO-3 run's end) as predicted; zero1 bit-equal to "
        f"replicated, zero3 to zero2, zero3+offload to zero3; zero2 vs "
        f"replicated params max|err| {e:.2e}; loss "
        f"{runs['replicated'].history[0]['loss']:.4f} -> "
        f"{runs['replicated'].history[-1]['loss']:.4f}")

    # accum_steps=2, Ctrl-C at step IRP_CRASH, resumed: bit-equal
    n = (IRP_CRASH + 3) * B
    X, Y = tX[:n], tY[:n]
    ck = os.path.join(tmp, "irp_tp.npz")
    akw = dict(batch_size=B, accum_steps=2, optimizer=_opt("adam"),
               lr=IRP_TP_ADAM_LR)
    straight, _, ph = _irp_fit("uniform", shape, X, Y, M, **akw)
    total += sum(ph.values())

    def boom(s):
        if s == IRP_CRASH:
            raise KeyboardInterrupt
        return IRP_TP_ADAM_LR

    try:
        _, _, ph = _irp_fit("uniform", shape, X, Y, M, lr_schedule=boom,
                            checkpoint_path=ck, **akw)
        check(False, "the interrupted tensor-parallel fit did not stop")
    except KeyboardInterrupt:
        pass
    resumed, _, ph = _irp_fit("uniform", shape, X, Y, M,
                              lr_schedule=lambda s: IRP_TP_ADAM_LR,
                              checkpoint_path=ck, resume=True, **akw)
    total += sum(ph.values())
    check(resumed.history[0]["step"] == IRP_CRASH + 1 and all(
        torch.equal(a, b) for a, b in zip(resumed.net.params,
                                          straight.net.params)),
          "ir tp fit: the accum_steps=2 crash/resume chain differs from the "
          "straight run")
    log(f"[irp-tp] fit uniform on {shape}, accum_steps=2: Ctrl-C at step "
        f"{IRP_CRASH}, resumed to the budget: bit-equal to the straight run")

    # samples/s, one step's wall, kernels, busy time and idle share
    return total + _irp_timing(tX, tY, shape, M)


def phase_ir_tp_cards(tmp: str) -> None:
    """The uniform chain's fit on (1, 2, 2) with one rank a card (5 sgd
    steps): bit-equal to the same run with the 4 ranks on one card; counts
    the ring calls that waited for another thread's (autograd's backward
    threads, one a card, issue them at once; the launch lock orders them)."""
    from tensor_ops_tpu_torch.models import sgd
    from tensor_ops_tpu_torch.parallel import collective_kernels as CK

    tX, tY, _, _ = synthetic_set(tmp)
    X, Y = tX[:5 * IRP_SGD_B], tY[:5 * IRP_SGD_B]
    shape = (1, 2, 2)
    one, _, _ = _irp_fit("uniform", shape, X, Y, 4, batch_size=IRP_SGD_B,
                         optimizer=sgd())
    waits = CK._ring_waits
    four, counts, _ = _irp_fit("uniform", shape, X, Y, 4,
                               devices=[f"cuda:{i}" for i in range(4)],
                               batch_size=IRP_SGD_B, optimizer=sgd())
    waits = CK._ring_waits - waits
    same = ([h["loss"] for h in one.history]
            == [h["loss"] for h in four.history]
            and all(torch.equal(a.to(DEVICE), b) for a, b in
                    zip(four.net.params, one.net.params)))
    check(counts["bidir_ring.ring"] > 0 and same,
          f"ir tp fit (1, 2, 2) on 4 cards: {counts['bidir_ring.ring']} "
          f"ring launches, bit-equal to one card: {same}")
    log(f"[irp-tp] fit uniform on (1, 2, 2) with one rank a card: "
        f"{counts['bidir_ring.ring']} ring-protocol launches, {waits} calls "
        f"waited for another thread's; 5 sgd steps' losses and parameters "
        f"bit-equal to the 4 ranks on one card")


def phase_ir_pipeline_cards(tmp: str) -> None:
    """The uniform chain's fit on (4,) with one stage a card (5 sgd steps):
    bit-equal to the same run with the 4 ranks on one card."""
    from tensor_ops_tpu_torch.models import sgd

    tX, tY, _, _ = synthetic_set(tmp)
    X, Y = tX[:5 * IRP_SGD_B], tY[:5 * IRP_SGD_B]
    one, _, _ = _irp_fit("uniform", (4,), X, Y, 4, batch_size=IRP_SGD_B,
                         optimizer=sgd())
    four, counts, _ = _irp_fit("uniform", (4,), X, Y, 4,
                               devices=[f"cuda:{i}" for i in range(4)],
                               batch_size=IRP_SGD_B, optimizer=sgd())
    devs = {str(p.device) for p in four.net.params}
    same = ([h["loss"] for h in one.history]
            == [h["loss"] for h in four.history]
            and all(torch.equal(a.to(DEVICE), b) for a, b in
                    zip(four.net.params, one.net.params)))
    check(counts["bidir_ring.ring"] > 0 and len(devs) == 4 and same,
          f"ir fit (4,) on 4 cards: {counts['bidir_ring.ring']} ring "
          f"launches, leaves on {sorted(devs)}, bit-equal to one card: "
          f"{same}")
    log(f"[irp] fit uniform on (4,) with one stage a card: "
        f"{counts['bidir_ring.ring']} ring-protocol launches, the returned "
        f"leaves on {len(devs)} cards; 5 sgd steps' losses and parameters "
        f"bit-equal to the 4 ranks on one card")


# ---------------------------------------------------------------------------
# Phase 28: several processes
# ---------------------------------------------------------------------------

# Phase 28: PROC_N processes share the card, PROC_RANKS ranks each (the
# chip machine has one card); cards_main runs one process a card.  The
# flagship's fit on (2, 2) at B = 512 (ZeRO-3, adam, PROC_FLAG_STEPS steps:
# 2, a checkpoint from process 0, then a resume to 5), fit_sequences of the
# Elman 32 -> [512] -> 32 on (2, 2) (PROC_SEQ_N sequences of PROC_SEQ_LEN
# steps, B = PROC_SEQ_B: 2 steps), and the uniform chain's staged-IR fit on
# (data=2, stage=2) and on (4,) at B = 512, M = 4 (PROC_IRP_STEPS sgd
# steps).  The datasets hold one batch of a step (an epoch is one step),
# drawn from seed 28 on the host alike in every process.
PROC_N, PROC_RANKS, PROC_TIMEOUT_S = 2, 2, 420
PROC_FLAG_B, PROC_FLAG_LR, PROC_FLAG_STEPS = 512, 0.002, 5
PROC_SEQ_N, PROC_SEQ_LEN, PROC_SEQ_B = 128, 16, 64
PROC_IRP_B, PROC_IRP_M, PROC_IRP_STEPS = 512, 4, 3
PROC_TIMED_STEPS = 5
# the flagship's dp step on a (4,) data mesh of both processes' ranks:
# PROC_DP_STEPS steps on phase 28's B = 512 rows, 128 a rank
PROC_DP_STEPS = 3
PROC_DEVICE = "cuda:0"  # phase 28's card (every process's ranks on it)
PROC_CARD = "cuda:{}"   # cards_main's card of process p (one card each)
PROC_RUNS = ("flagship (2, 2)", "fit_sequences (2, 2)", "staged IR (2, 2)",
             "staged IR (4,)", "dp step (4,)")
CARDS_PROC_RUNS = ("flagship (4, 1)", "staged IR (4,)")


def proc_predicted(name: str, M: int = PROC_IRP_M) -> dict:
    """Kernel 9's calls across processes (ar, rs, ag) that process 0 makes
    in each phase-28 run (one launch each on the card), from the code:

    * flagship, ZeRO-3 (W1, W2, b2 and W3 shard over the data axis; b1 and
      b3 have no free dimension): per step each sharded leaf gathered at
      use and its gradient reduce-scattered, each other gradient
      all-reduced, once per data group (one a model rank), and the loss
      averaged over the data ranks once;
    * fit_sequences (dual-rate SGD): each of the 6 leaves' gradients (the
      state and 5 parameters) all-reduced once per data group, and the loss
      (the cell's calls over the model axis stay inside a process: a model
      group lies in one);
    * staged IR on (data=2, stage=2): the batch's rows all-gathered over the
      data ranks, x and y (M > 1 microbatches cut each data rank's rows from
      every process's block), the loss, and each of the 6 flat leaves'
      gradients all-reduced once per data group (one a stage rank);
    * staged IR on (4,) (no data axis: each process loads the full stream):
      each hand-off of a microbatch across the processes' boundary and its
      reverse (an all-gather over the pair, M each way), the stage psum
      and its transpose, the loss copied to every process (an all-reduce of
      the home's value and zeros), and the 4 replicated leaves' gradients
      (the chain's first and last layers) summed over the stage ranks;
    * the dp step on (4,) (one data group over both processes): each of
      the flagship's 6 updated leaves all-reduced once; the loss's other
      ranks come over gloo (no kernel-9 call).

    Returns the counts for the whole run."""
    groups = 1 if name.endswith("(4, 1)") else 2  # data groups
    per_step, steps = {
        "flagship": ((2 * groups + 1, 4 * groups, 4 * groups),
                     PROC_FLAG_STEPS),
        "fit_sequences": ((6 * 2 + 1, 0, 0), 2),
        "staged IR (2, 2)": ((1 + 6 * 2, 0, 2), PROC_IRP_STEPS),
        "staged IR (4,)": ((2 + 1 + 4, 0, 2 * M), PROC_IRP_STEPS),
        "dp": ((6, 0, 0), PROC_DP_STEPS),
    }[name if name.startswith("staged") else name.split()[0]]
    return {p: steps * n for p, n in zip(("ar", "rs", "ag"), per_step)}


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _proc_data():
    """Phase 28's data and initial leaves (numpy), the same in every
    process: the flagship's (seed 0) and the Elman model's (seed 7) drawn
    on the CPU, the uniform chain's (seed 26)."""
    from tensor_ops_tpu_torch import TorchBackend

    cpu = TorchBackend(torch.float32, "cpu")
    r = np.random.default_rng(28)
    X = r.uniform(0, 1, size=(PROC_FLAG_B, FLAGSHIP[0])).astype(np.float32)
    Y = np.eye(FLAGSHIP[-1])[r.integers(0, FLAGSHIP[-1], size=PROC_FLAG_B)]
    XS = r.uniform(-1, 1, size=(PROC_SEQ_N, PROC_SEQ_LEN, RNN_IN))
    TS = r.uniform(0, 1, size=(PROC_SEQ_N, PROC_SEQ_LEN, RNN_OUT))
    rnet = rnn_model(cpu)
    cX, cY = _irp_batch("uniform", PROC_IRP_B)
    return dict(
        X=X, Y=Y.astype(np.float32), XS=XS.astype(np.float32),
        TS=TS.astype(np.float32),
        flag=[p.numpy() for p in _flagship_net(cpu, 0).params],
        rnn=([s.numpy() for s in rnet.states],
             [p.numpy() for p in rnet.params]),
        cX=cX, cY=cY, chain=_irp_arrays("uniform")[0])


def _proc_nets(d, be):
    """The flagship, the Elman model and the uniform chain holding phase
    28's initial leaves on ``be``, with their losses."""
    from tensor_ops_tpu_torch.models import Network, cross_entropy, squared_error
    from tensor_ops_tpu_torch.models.recurrent import RecurrentNetwork

    flag = _flagship_net(be, 0)
    flag = Network(flag.op, tuple(be.asarray(a) for a in d["flag"]),
                   flag.act_names)
    rt = rnn_model(be)
    rnet = RecurrentNetwork(rt.op, tuple(be.asarray(a) for a in d["rnn"][0]),
                            tuple(be.asarray(a) for a in d["rnn"][1]),
                            rt.arch)
    chain, closs = _irp_net("uniform", be, d["chain"])
    return dict(flag=(flag, cross_entropy(FLAGSHIP[-1])),
                rnn=(rnet, squared_error(RNN_OUT)), chain=(chain, closs))


def _proc_fit(name: str, d, be, mesh, ck: str):
    """One phase-28 run through ``fit`` / ``fit_sequences`` on ``mesh``
    (its own process's or one spanning processes): the flagship in two
    legs (checkpoints every 2 steps, then a resume), the others in one.
    Returns ``(losses, result)``."""
    from tensor_ops_tpu_torch.models import adam, fit, fit_sequences, sgd

    nets = _proc_nets(d, be)
    kw = dict(log_every=1, verbose=False, chain_steps=1)
    if name.startswith("flagship"):
        net, loss = nets["flag"]
        run = dict(kw, batch_size=PROC_FLAG_B, lr=PROC_FLAG_LR, mesh=mesh,
                   zero_stage=3, checkpoint_path=ck, checkpoint_every=2)
        r1 = fit(net, loss, be, d["X"], d["Y"], epochs=2,
                 optimizer=adam(), **run)
        net, _ = _proc_nets(d, be)["flag"]
        r2 = fit(net, loss, be, d["X"], d["Y"], epochs=PROC_FLAG_STEPS,
                 optimizer=adam(), resume=True, **run)
        return [h["loss"] for h in r1.history + r2.history], r2
    if name.startswith("fit_sequences"):
        rnet, loss = nets["rnn"]
        res = fit_sequences(rnet, loss, be, d["XS"], d["TS"], epochs=1,
                            batch_size=PROC_SEQ_B, mesh=mesh,
                            **SEQ_FIT_RATES, **kw)
        return [h["loss"] for h in res.history], res
    net, loss = nets["chain"]
    res = fit(net, loss, be, d["cX"], d["cY"], epochs=PROC_IRP_STEPS,
              batch_size=PROC_IRP_B, lr=IRP_LR, optimizer=sgd(), mesh=mesh,
              pipeline_microbatches=PROC_IRP_M, **kw)
    return [h["loss"] for h in res.history], res


def _proc_mesh(name: str, devices=None):
    from tensor_ops_tpu_torch.parallel import (Mesh, make_dp_pipeline_mesh,
                                               make_mesh, make_pipeline_mesh)
    from tensor_ops_tpu_torch.parallel.mesh import mesh_devices

    if name.startswith("dp step"):
        return Mesh(mesh_devices(devices, 4, name), ("data",))
    if name.endswith("(4,)"):
        return make_pipeline_mesh(4, devices=devices)
    if name.startswith("staged IR"):
        return make_dp_pipeline_mesh(2, 2, devices=devices)
    shape = (4, 1) if name.endswith("(4, 1)") else (2, 2)
    return make_mesh(4, shape=shape, devices=devices)


def _host_leaves(res, mesh) -> list:
    from tensor_ops_tpu_torch.models.trainer import _global_host_tree

    leaves = tuple(getattr(res.net, "states", ())) + tuple(res.net.params)
    return [np.asarray(x) for x in _global_host_tree(leaves, mesh)]


def _proc_step_timing(step_fn, profile: bool) -> dict:
    """One warm step, then PROC_TIMED_STEPS timed on the host clock, then
    as many under ``torch.profiler`` where ``profile`` (process 0; the
    others run them unprofiled, so that every process makes the same
    calls): a step's wall time, kernels, device busy time and idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    step_fn()
    _sync()
    t0 = time.perf_counter()
    for _ in range(PROC_TIMED_STEPS):
        step_fn()
    _sync()
    wall = (time.perf_counter() - t0) / PROC_TIMED_STEPS
    if not profile:
        for _ in range(PROC_TIMED_STEPS):
            step_fn()
        _sync()
        return {"wall_ms": wall * 1e3}
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(PROC_TIMED_STEPS):
            step_fn()
        _sync()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / PROC_TIMED_STEPS
    kernels = sum(1 for e in dev if not e.name.startswith(
        ("Memcpy", "Memset"))) / PROC_TIMED_STEPS
    return {"wall_ms": wall * 1e3, "kernels": kernels,
            "busy_ms": busy / 1e3,
            "idle": 1 - busy / 1e3 / (wall * 1e3) if dev else float("nan")}


def _proc_dp_step(d, be, mesh):
    """The flagship's dp step on ``mesh`` (the data-parallel slice's
    activations and rate) and its arguments: phase 28's B rows and initial
    leaves on ``be``, which every process passes alike."""
    from tensor_ops_tpu_torch.parallel import dp_megakernel_train_step

    step = dp_megakernel_train_step(mesh, ("logistic", "logistic",
                                           "identity"), lr=TRAIN_RATE)
    # the flagship's leaves alternate (w, b) a layer
    return step, (be.asarray(d["X"]), be.asarray(d["Y"]),
                  [be.asarray(a) for a in d["flag"][0::2]],
                  [be.asarray(a) for a in d["flag"][1::2]])


def _proc_dp(d, be, mesh) -> tuple:
    """PROC_DP_STEPS dp steps on ``mesh``: each step's loss, the last
    step's leaves (host) and the loss's gathers over gloo; every local
    rank's leaves bit-identical after every step."""
    step, (x, y, ws, bs) = _proc_dp_step(d, be, mesh)
    losses = []
    for i in range(PROC_DP_STEPS):
        loss, ws, bs = step(x, y, ws, bs)
        losses.append(float(loss))
        for r in mesh.local_ranks:
            r_ws, r_bs = step.replicas[r]
            check(all(torch.equal(a, c) for a, c in zip(r_ws + r_bs, ws + bs)),
                  f"dp step: rank {r}'s leaves differ from the first local "
                  f"rank's after step {i + 1}")
    return (losses, [np.asarray(t.cpu()) for t in ws + bs],
            step.loss_gathers)


def _proc_step(name: str, d, be, mesh):
    """A mesh step of the run's configuration and its arguments (fixed
    inputs: the timing's step, the data's first batch)."""
    from tensor_ops_tpu_torch.models import adam, sgd
    from tensor_ops_tpu_torch.models.trainer import (_like, _mesh_setup,
                                                     _scalars, make_opt_step)
    from tensor_ops_tpu_torch.parallel import ir_pipeline as IP
    from tensor_ops_tpu_torch.parallel.mesh import global_batch, param_specs

    if name.startswith("dp step"):
        step, (x, y, ws, bs) = _proc_dp_step(d, be, mesh)
        return (lambda: step(x, y, ws, bs)), PROC_FLAG_B
    nets = _proc_nets(d, be)
    if name.startswith("flagship"):
        net, loss = nets["flag"]
        opt, B, X, Y = adam(), PROC_FLAG_B, d["X"], d["Y"]
        leaves, specs, pipe, z = (net.params, param_specs(net.param_stack,
                                                          mesh), None, 3)
    else:
        net, loss = nets["chain"]
        opt, B, X, Y = sgd(), PROC_IRP_B, d["cX"], d["cY"]
        part = IP.partition_network(net, mesh.shape["stage"], mesh)
        leaves, specs, z = part.flat_params(), IP.pipelined_specs(part,
                                                                  mesh), 0
        pipe = (part.skeleton(), PROC_IRP_M, "gpipe")
    params, state, pins = _mesh_setup(leaves, specs, opt, mesh, be, z)
    step = make_opt_step(net, loss, be, opt, mesh=mesh, pipeline=pipe,
                         **pins)
    xb, yb = be.asarray(X[:B]), be.asarray(Y[:B])
    if mesh.multi and "data" in mesh.axis_names:
        from tensor_ops_tpu_torch.parallel import distributed as D

        n, p = D.process_count(), D.process_index()
        b = B // n
        chunks = 1 if pipe is None else PROC_IRP_M
        xb = global_batch(xb[p * b:(p + 1) * b], mesh, chunks)
        yb = global_batch(yb[p * b:(p + 1) * b], mesh, chunks)
    lr = _scalars([0.01], _like(params))[0]
    box = [state, params]

    def run():
        _, box[0], box[1] = step(lr, xb, yb, box[0], box[1])

    return run, B


def _proc_collectives() -> int:
    """Kernels 8-9 over the global mesh's ranks (every process's): each
    process passes its ranks' inputs (drawn alike everywhere, seed 28) and
    Remote markers for the others', and its ranks' results must equal the
    plain version over every rank's input on its card, bit for bit: ``ar``
    with and without the 1/n scale, ``rs``, ``ag`` (f32 N(0, 1), and an
    int32 ``ar``), and the one-way ring, at the flagship's first weight's
    size and at sizes that do not fill whole pieces.  Returns the calls."""
    from tensor_ops_tpu_torch.parallel import collective_kernels as CK
    from tensor_ops_tpu_torch.parallel import distributed as D
    from tensor_ops_tpu_torch.parallel import make_mesh

    mesh = make_mesh(shape=(len(D.global_devices()), 1))
    n, dev = mesh.size, mesh.rank_devices[mesh.local_ranks[0]]
    g = torch.Generator().manual_seed(28)
    calls = 0
    for shape in ((n * 75, 784), (n * 3, 37), (n,)):
        for dtype in (torch.float32, torch.int32):
            every = [torch.randn(shape, generator=g) for _ in range(n)]
            if dtype == torch.int32:
                every = [(1000 * e).to(torch.int32) for e in every]
            xs = [every[r].to(mesh.rank_devices[r]) if mesh.is_local(r)
                  else mesh.remote(r) for r in range(n)]
            here = [e.to(dev) for e in every]
            cases = [("ar", False, None), ("ag", False, None),
                     ("ar", True, None)]
            if dtype == torch.float32:
                cases += [("ar", False, 1 / n), ("rs", False, 1 / n)]
            for phase, one_way, scale in cases:
                fn = {("ar", True): CK.ring_all_reduce,
                      ("ar", False): CK.ring_all_reduce_bidir,
                      ("rs", False): CK.ring_reduce_scatter,
                      ("ag", False): CK.ring_all_gather}[(phase, one_way)]
                got = fn(xs) if phase == "ag" else fn(xs, scale=scale)
                want = CK.oneshot_ref(here, phase, one_way, scale)
                for r in mesh.local_ranks:
                    check(torch.equal(got[r].to(dev), want[r]),
                          f"{phase}{' one-way' * one_way} across processes "
                          f"at {shape} {dtype}: rank {r} differs from the "
                          f"plain version")
                calls += 1
    return calls


def _proc_runs(names, d, be, mesh_of, shared: str, profile: bool) -> dict:
    """The runs ``names`` on the meshes ``mesh_of(name)`` gives: each
    ``fit`` run's losses, whole leaves (host), launch counts and its
    calls across processes; the timed steps of the flagship and of the
    chain on (4,)."""
    from tensor_ops_tpu_torch.ops import kernels as K
    from tensor_ops_tpu_torch.parallel import collective_kernels as CK

    out = {"collectives": _proc_collectives()}
    for name in names:
        mesh = mesh_of(name)
        _sync()
        K.reset_launch_counts()
        CK.reset_phase_counts()
        CK.reset_xproc_counts()
        gathers = None
        if name.startswith("dp step"):
            losses, leaves, gathers = _proc_dp(d, be, mesh)
        else:
            losses, res = _proc_fit(name, d, be, mesh, os.path.join(
                shared, f"p28_{len(out)}.npz"))
            leaves = _host_leaves(res, mesh)
        _sync()
        out[name] = dict(losses=losses, counts=K.launch_counts(),
                         phases=CK.phase_counts(), xproc=CK.xproc_counts(),
                         leaves=leaves, gathers=gathers)
        if name.startswith("flagship") or name.endswith("(4,)"):
            run, B = _proc_step(name, d, be, mesh)
            t = _proc_step_timing(run, profile)
            t["samples_per_s"] = B / t["wall_ms"] * 1e3
            out[name]["timing"] = t
    return out


def _shard_batches(X, Y, B: int, n_proc: int, steps: int, drop_last: bool):
    """The global batches of ``n_proc`` processes' loader shards (fit's
    split: each process's ``NativeLoader(shard=(p, n_proc))`` of B / n_proc
    rows), concatenated in process order."""
    from tensor_ops_tpu_torch.utils.native import NativeLoader

    loaders = [NativeLoader(X, Y, batch=B // n_proc, seed=0,
                            shard=(k, n_proc), drop_last=drop_last)
               for k in range(n_proc)]
    try:
        for _ in range(steps):
            xs, ys = zip(*(ld.next() for ld in loaders))
            yield np.concatenate(xs), np.concatenate(ys)
    finally:
        for ld in loaders:
            ld.close()


def _proc_one(name: str, d, be, mesh, n_proc: int, shared: str):
    """The run ``name`` in one process on ``mesh`` (``None``: one device),
    with the several-process run's batches: ``fit_sequences`` and the
    stage-only fit load the same stream anyway; the data-axis fits take the
    ``n_proc`` shards concatenated (fit's own loader would order the rows
    otherwise), through the same step, uninterrupted.  Returns ``(losses,
    whole leaves)``."""
    from tensor_ops_tpu_torch.models import adam, sgd
    from tensor_ops_tpu_torch.models.trainer import (_like, _mesh_setup,
                                                     _scalars, make_opt_step)
    from tensor_ops_tpu_torch.parallel import ir_pipeline as IP
    from tensor_ops_tpu_torch.parallel.mesh import param_specs

    if name.startswith("dp step"):
        return _proc_dp(d, be, mesh)[:2]
    if name.startswith("fit_sequences") or name.endswith("(4,)"):
        losses, res = _proc_fit(name, d, be, mesh,
                                os.path.join(shared, "one.npz"))
        leaves = tuple(getattr(res.net, "states", ())) + tuple(res.net.params)
        return losses, [np.asarray(_whole(x).cpu()) for x in leaves]
    nets = _proc_nets(d, be)
    pipe = name.startswith("staged IR")
    net, loss = nets["chain" if pipe else "flag"]
    opt = sgd() if pipe else adam()
    lr = IRP_LR if pipe else PROC_FLAG_LR
    B, X, Y = ((PROC_IRP_B, d["cX"], d["cY"]) if pipe else
               (PROC_FLAG_B, d["X"], d["Y"]))
    steps = PROC_IRP_STEPS if pipe else PROC_FLAG_STEPS
    part = None
    if mesh is None:
        params, state = tuple(net.params), opt.init(tuple(net.params))
        step = make_opt_step(net, loss, be, opt)
    else:
        if pipe:
            part = IP.partition_network(net, mesh.shape["stage"], mesh)
            leaves, specs = part.flat_params(), IP.pipelined_specs(part, mesh)
        else:
            leaves, specs = net.params, param_specs(net.param_stack, mesh)
        params, state, pins = _mesh_setup(leaves, specs, opt, mesh, be,
                                          0 if pipe else 3)
        step = make_opt_step(
            net, loss, be, opt, mesh=mesh, pipeline=None if part is None
            else (part.skeleton(), PROC_IRP_M, "gpipe"), **pins)
    losses = []
    for xb, yb in _shard_batches(X, Y, B, n_proc, steps, drop_last=pipe):
        lr_t = _scalars([lr], _like(params))[0]
        v, state, params = step(lr_t, be.asarray(xb), be.asarray(yb), state,
                                params)
        losses.append(float(v))
    if part is not None:
        whole = tuple(torch.as_tensor(np.asarray(p)) for p in params)
        params = part.skeleton().unflatten(whole).to_network_params()
    return losses, [np.asarray(_whole(p).cpu()) if hasattr(p, "shards")
                    else np.asarray(p.detach().cpu()) for p in params]


def _chain_f64(d, batches) -> tuple:
    """The uniform chain's sgd steps on ``batches`` by plain autograd on
    the CPU in float64 (the staged-IR runs' reference): losses and
    leaves."""
    arrays, acts = _irp_arrays("uniform")
    ps = [torch.tensor(a, dtype=torch.float64) for a in arrays]
    losses = []
    for xb, yb in batches:
        x = torch.tensor(xb, dtype=torch.float64)
        y = torch.tensor(yb, dtype=torch.float64)
        ps = [p.detach().requires_grad_() for p in ps]
        h = x
        for k, act in enumerate(acts):
            z = torch.addmm(ps[2 * k + 1], h, ps[2 * k].T)
            h = torch.softmax(z, dim=-1) if act == "softmax" else \
                torch.sigmoid(z)
        v = -torch.mean(torch.sum(y * torch.log(h), dim=-1))
        gs = torch.autograd.grad(v, ps)
        losses.append(float(v.detach()))
        ps = [(p - IRP_LR * g).detach() for p, g in zip(ps, gs)]
    return losses, [p.numpy() for p in ps]


def _proc_f64(name: str, d, n_proc: int) -> tuple:
    """The run's semantics on the CPU in float64, on its batches."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.utils.native import NativeLoader

    if name.startswith("dp step"):
        return _proc_dp(d, TorchBackend(torch.float64, "cpu"),
                        _proc_mesh(name, ["cpu"] * 4))[:2]
    if name.startswith("staged IR"):
        if name.endswith("(4,)"):
            ld = NativeLoader(d["cX"], d["cY"], batch=PROC_IRP_B, seed=0,
                              drop_last=True)
            batches = [ld.next() for _ in range(PROC_IRP_STEPS)]
            ld.close()
        else:
            batches = list(_shard_batches(d["cX"], d["cY"], PROC_IRP_B,
                                          n_proc, PROC_IRP_STEPS, True))
        return _chain_f64(d, batches)
    be = TorchBackend(torch.float64, "cpu")
    if name.startswith("fit_sequences"):
        losses, res = _proc_fit(name, d, be, None, "")
        return losses, [x.numpy() for x in tuple(res.net.states)
                        + tuple(res.net.params)]
    return _proc_one(name, d, be, None, n_proc, "")


def proc_worker() -> None:
    """A process of phase 28 (or of cards_main's runs across processes)
    other than process 0: ``init_distributed`` from the ``TOPS_*``
    variables, then the runs that ``TOPS_PROC_RUNS`` names, as process 0
    makes them, checkpoints in ``TOPS_PROC_DIR`` (process 0's)."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.parallel.distributed import (
        init_distributed, shutdown_distributed)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed()
    be = TorchBackend(torch.float32,
                      os.environ["TOPS_LOCAL_DEVICES"].split(",")[0])
    _proc_runs(os.environ["TOPS_PROC_RUNS"].split(";"), _proc_data(), be,
               _proc_mesh, os.environ["TOPS_PROC_DIR"], profile=False)
    shutdown_distributed()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def procs_main(out: str, cards: bool = False) -> None:
    """Phase 28 (or, ``cards=True``, cards_main's runs across processes):
    this interpreter is process 0 and starts the others
    (:func:`proc_worker`), every process ``init_distributed`` through the
    ``TOPS_*`` variables; then each run is held bit for bit to the same
    mesh's ranks in this one process, and to CPU float64 (losses within
    TOL_5_STEPS, parameters too after sgd, within TOL_MESH after adam);
    kernel 9's calls across processes to
    :func:`proc_predicted`, all on the card's route (none through the
    host).  Writes process 0's launches to ``out``."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.parallel import distributed as D

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = 4 if cards else PROC_N
    local = ([[PROC_CARD.format(p)] for p in range(n)] if cards
             else [[PROC_DEVICE] * PROC_RANKS] * n)
    names = CARDS_PROC_RUNS if cards else PROC_RUNS
    route = "ring" if cards else "oneshot"
    if torch.device(local[0][0]).type == "cuda":
        check(torch.cuda.is_available(), "several processes on cards: no "
              "card is visible")
    else:
        route = "cpu"  # a rehearsal, PROC_DEVICE or PROC_CARD set to "cpu"
    here = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    d = _proc_data()
    with tempfile.TemporaryDirectory() as shared:
        env = dict(os.environ, PYTHONPATH=here,
                   TOPS_COORDINATOR=f"localhost:{port}",
                   TOPS_NUM_PROCESSES=str(n), TOPS_PROC_DIR=shared,
                   TOPS_PROC_RUNS=";".join(names))
        workers = [subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; "
             "chip_smoke.proc_worker()"], cwd=here,
            env=dict(env, TOPS_PROCESS_ID=str(p),
                     TOPS_LOCAL_DEVICES=",".join(local[p])))
            for p in range(1, n)]
        try:
            t0 = time.perf_counter()
            D.init_distributed(f"localhost:{port}", n, 0,
                               local_devices=local[0])
            be = TorchBackend(torch.float32, local[0][0])
            multi = _proc_runs(names, d, be, _proc_mesh, shared, profile=True)
            D.shutdown_distributed()
            rcs = [w.wait(timeout=PROC_TIMEOUT_S) for w in workers]
            wall = time.perf_counter() - t0
        finally:
            for w in workers:
                if w.poll() is None:
                    w.kill()
                    w.wait()
        check(rcs == [0] * (n - 1), f"processes 1-{n - 1} exited {rcs}")
        devices = [x for row in local for x in row]
        launches = {k: 0 for k in RING_NAMES + ("fused_mlp_train_step",)}
        for name in names:
            m = multi[name]
            one = _proc_one(name, d, be, _proc_mesh(name, devices), n, shared)
            same = (m["losses"] == one[0] and len(m["leaves"]) == len(one[1])
                    and all(np.array_equal(a, b)
                            for a, b in zip(m["leaves"], one[1])))
            check(same, f"{name} in {n} processes: not bit-equal to one "
                  f"process on the same ranks (losses {m['losses']} vs "
                  f"{one[0]})")
            # the losses at TOL_5_STEPS; the parameters too after sgd,
            # and at TOL_MESH after adam (phase 23: its sign steps on
            # cancellation residues exceed five sgd steps' bound)
            f64 = _proc_f64(name, d, n)
            tol = TOL_MESH if name.startswith("flagship") else TOL_5_STEPS
            err = max(max_err(torch.tensor(m["losses"]),
                              torch.tensor(f64[0]), TOL_5_STEPS),
                      max(max_err(torch.from_numpy(a), torch.from_numpy(b),
                                  tol)
                          for a, b in zip(m["leaves"], f64[1])))
            want = proc_predicted(name)
            x = m["xproc"]
            got = {k: x[k] for k in want}
            routes = {k: x[k] for k in ("cpu", "oneshot", "ring")}
            check(got == want and routes[route] == sum(want.values())
                  and sum(routes.values()) == routes[route],
                  f"{name}: kernel 9 across processes {got} (routes "
                  f"{routes}), predicted {want} on the {route} route")
            for k in launches:
                launches[k] += m["counts"][k]
            if name.startswith("dp step"):
                k3 = m["counts"]["fused_mlp_train_step"]
                check(k3 == len(local[0]) * PROC_DP_STEPS
                      and m["gathers"] == PROC_DP_STEPS,
                      f"{name}: {k3} train-step launches and "
                      f"{m['gathers']} loss gathers in process 0, want "
                      f"{len(local[0])} and 1 a step")
                log(f"[procs] {name}: process 0 launched kernel 3 {k3} "
                    f"times ({len(local[0])} a step); the loss's other "
                    f"ranks came over gloo, {m['gathers']} gathers (one a "
                    f"step, apart from kernel 9's calls)")
            where = "1 rank(s) each, one card a process" if cards else (
                f"{PROC_RANKS} rank(s) each, one card")
            log(f"[procs] {name} in {n} processes ({where}): losses "
                f"{m['losses'][0]:.6f} -> {m['losses'][-1]:.6f}, "
                f"bit-equal to one process on the same ranks, max |err| "
                f"{err:.3e} from CPU f64 (tol {tol}); kernel 9 across "
                f"processes {got} = predicted, {x[route]} "
                f"{route} launches ({m['counts']['bidir_ring']} bidir_ring, "
                f"{m['counts']['bidir_ring.ring']} bidir_ring.ring in all)")
            if "timing" in m:
                t = m["timing"]
                t1 = _proc_one_timing(name, d, be, devices)
                log(f"[timing] {name} step in {n} processes: "
                    f"{t['samples_per_s']:.1f} samples/s, wall "
                    f"{t['wall_ms']:.2f} ms, {t['kernels']:.0f} kernels, "
                    f"busy {t['busy_ms']:.2f} ms, idle {t['idle']:.3f} "
                    f"(process 0's); one process on the same ranks: "
                    f"{t1['samples_per_s']:.1f} samples/s, wall "
                    f"{t1['wall_ms']:.2f} ms, {t1['kernels']:.0f} kernels, "
                    f"busy {t1['busy_ms']:.2f} ms, idle {t1['idle']:.3f} "
                    f"(wall: host clock over {PROC_TIMED_STEPS} steps after "
                    f"one; kernels and busy: torch.profiler over "
                    f"{PROC_TIMED_STEPS} more)")
        log(f"[procs] kernels 8-9 across the {n} processes: "
            f"{multi['collectives']} calls (ar, ar scaled, rs, ag, one-way; "
            f"f32 and int32) bit-equal to the plain version over every "
            f"rank's input, in every process")
        log(f"[procs] the {n} processes' runs took {wall:.1f} s")
    with open(out, "w") as f:
        json.dump(launches, f)


def _proc_one_timing(name: str, d, be, devices) -> dict:
    run, B = _proc_step(name, d, be, _proc_mesh(name, devices))
    t = _proc_step_timing(run, True)
    t["samples_per_s"] = B / t["wall_ms"] * 1e3
    return t


def phase_procs(tmp: str, cards: bool = False) -> dict:
    """Run :func:`procs_main` (phase 28) in an interpreter of its own with
    a time limit; its lines print as they come; returns its launches."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(tmp, "procs_launches.json")
    sys.stdout.flush()
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.procs_main(sys.argv[1], sys.argv[2] == '1')", out,
         "1" if cards else "0"],
        timeout=PROC_TIMEOUT_S + 120, cwd=here,
        env=dict(os.environ, PYTHONPATH=here))
    check(proc.returncode == 0, f"the several-process phase failed (exit "
          f"{proc.returncode})")
    with open(out) as f:
        return json.load(f)


def cards_main() -> None:
    """The phases that need several cards, alone (on a machine with 4):
    the cross-card ring against its plain versions, the 4-card runs of
    :func:`phase_mesh_cards`, :func:`phase_model_axis_cards` and
    :func:`phase_pipeline_cards` against the same runs on one card, and
    4 processes of one card each (:func:`procs_main`, ``cards=True``: the
    ring protocol over CUDA IPC) against one process on the 4 cards.
    ``python3 -c "import chip_smoke; chip_smoke.cards_main()"``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    check(torch.cuda.device_count() >= MESH_DP, f"cards_main needs "
          f"{MESH_DP} cards, {torch.cuda.device_count()} visible")
    timed("cross-card ring", phase_ring_cross_card)
    with tempfile.TemporaryDirectory() as tmp:
        f = _mesh_flagship(tmp)
        runs, _ = _mesh_fit_runs(f, ("replicated", "zero3"))
        timed("mesh on 4 cards", phase_mesh_cards, f, runs, tmp)
        timed("model axis on 4 cards", phase_model_axis_cards, f, tmp)
        timed("staged-IR fit on 4 cards", phase_ir_pipeline_cards, tmp)
        timed("tensor-parallel pipeline fit on 4 cards", phase_ir_tp_cards,
              tmp)
        timed("4 processes, one card each", phase_procs, tmp, True)
    timed("pipelines on 4 cards", phase_pipeline_cards)
    from tensor_ops_tpu_torch.parallel import collective_kernels as CK

    log(f"[ring] {CK._ring_waits} ring-protocol calls of this process "
        f"waited for another thread's call (the launch lock)")


def mesh_main(out: str) -> None:
    """Phases 23 to 27 in their own interpreter (after every profiled phase
    of the smoke's process); writes their kernel launches to ``out``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        launches = timed("mesh", phase_mesh, tmp)
        tp = timed("model axis", phase_model_axis, tmp)
    pipe = timed("pipelines", phase_pipelines)
    with tempfile.TemporaryDirectory() as tmp:
        irp, runs = timed("staged-IR pipelines", phase_ir_pipelines, tmp)
        irp_tp, runs_tp = timed("tensor-parallel pipelines", phase_ir_tp,
                                tmp)
    timed("staged-IR pipelines vs CPU f64", irp_cpu_check,
          dict(runs, **runs_tp))
    for n in RING_NAMES:
        launches[n] += tp[n] + pipe[n] + irp[n] + irp_tp[n]
    with open(out, "w") as f:
        json.dump(launches, f)


def phase_mesh_proc(tmp: str) -> dict:
    """Run :func:`mesh_main` (phases 23-27) in a second interpreter;
    its lines print as they come; returns its kernel launches."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(tmp, "mesh_launches.json")
    sys.stdout.flush()
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.mesh_main(sys.argv[1])", out],
        timeout=800, cwd=here, env=dict(os.environ, PYTHONPATH=here))
    check(proc.returncode == 0, f"the mesh phase failed (exit "
          f"{proc.returncode})")
    with open(out) as f:
        return json.load(f)


def chained_main() -> None:
    """Phases 20-22 in their own interpreter (the profiler of the smoke's
    process has run 14 profiles and the recurrent fit by then)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        timed("fit chained", phase_fit_chained, tmp)
        timed("fit_sequences chained", phase_seq_chained)
        timed("mixed precision", phase_mixed_precision, tmp)


def phase_chained() -> None:
    """Run :func:`chained_main` in a second interpreter; its lines print as
    they come."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.stdout.flush()
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.chained_main()"],
        timeout=900, cwd=here, env=dict(os.environ, PYTHONPATH=here))
    check(proc.returncode == 0, "the chained-steps and mixed-precision "
          f"phases failed (exit {proc.returncode})")



# ---------------------------------------------------------------------------
# Phase 29: the tooling (utils/profiling.py, ops/autotune.py)
# ---------------------------------------------------------------------------

TOOL_TIMEOUT_S = 420
# the sweeps: (kernel 1) the flagship's layers at B = 8 and 100
TUNE_LINEAR = tuple((B, FLAGSHIP[i], FLAGSHIP[i + 1],
                     "identity" if i == 2 else "logistic")
                    for B in (8, 100) for i in range(3))
PLAN_CACHE_DIR = os.path.join(os.path.expanduser("~"), ".cache",
                              "tensor_ops_tpu_torch")


def _trace_kernel_names(logdir: str) -> dict:
    """{kernel name: device events} of the trace files under ``logdir``."""
    names = {}
    for path in sorted(glob.glob(os.path.join(logdir, "**", "*.json"),
                                 recursive=True)):
        with open(path) as f:
            for e in json.load(f).get("traceEvents", []):
                if e.get("cat") == "kernel":
                    n = _kernel_name(e.get("name", ""))
                    names[n] = names.get(n, 0) + 1
    return names


def _traced(what: str, run, base: str) -> dict:
    """``run()`` under ``device_trace`` into a directory of ``base``; the
    trace's device kernels by name.  The profiler has now and then handed
    back no device events: trace again, at most twice more, and fail the
    phase if the last trace has none either."""
    from tensor_ops_tpu_torch.utils.profiling import device_trace

    for attempt in range(3):
        d = os.path.join(base, f"{what}-{attempt}")
        with device_trace(d):
            run()
        names = _trace_kernel_names(d)
        if names:
            return names
    check(False, f"{what}: no device events in the trace after 3 tries")


def _tool_layer(seed: int, B: int, Kd: int, O: int):
    r = np.random.default_rng(seed)
    x = torch.tensor(r.uniform(0, 1, size=(B, Kd)), dtype=torch.float32)
    w = torch.tensor(r.normal(size=(O, Kd)) / math.sqrt(Kd),
                     dtype=torch.float32)
    b = torch.tensor(r.normal(size=(O,)) * 0.1, dtype=torch.float32)
    return x.to(DEVICE), w.to(DEVICE), b.to(DEVICE)


def _tool_sweeps() -> list:
    """(label, autotune entry, its arguments, candidates, call(plan), plain(),
    held(out, ref) -> max |err|, plan(card name) -> the wrappers' plan) of
    each sweep: every kernel with a plan, at one main-path shape each
    (kernel 1 at each flagship layer)."""
    from tensor_ops_tpu_torch.ops import kernels as K

    dev = torch.cuda.current_device()
    sms = K._sm_count(dev)
    sweeps = []

    def tensors(out):
        return K._tensors(out)

    def close(tol):
        def held(out, ref):
            return max(max_err(a, b, tol)
                       for a, b in zip(tensors(out), tensors(ref)))
        return held

    def exact(out, ref):
        check(all(torch.equal(a, b) for a, b in
                  zip(tensors(out), tensors(ref))), "not bit-equal to the "
              "plain version")
        return 0.0

    for n, (B, Kd, O, act) in enumerate(TUNE_LINEAR):
        x, w, b = _tool_layer(2900 + n, B, Kd, O)
        sweeps.append((
            f"fused_linear B={B} {Kd}->{O}", "autotune_linear",
            ((B, Kd, O), dict(act=act)),
            K.linear_candidates(B, Kd, O, torch.float32, True, sms),
            lambda p, x=x, w=w, b=b, act=act: K.fused_linear(x, w, b, act,
                                                             plan=p),
            lambda x=x, w=w, b=b, act=act: K.fused_linear_ref(x, w, b, act),
            close(TOL_Z),
            lambda name, B=B, Kd=Kd, O=O: K.linear_plan(
                B, Kd, O, torch.float32, True, sms, device_name=name)))
    acts = ["logistic", "logistic", "identity"]
    layers = [_tool_layer(2910 + k, 8, FLAGSHIP[k], FLAGSHIP[k + 1])
              for k in range(3)]
    x8 = layers[0][0]
    ws, bs = [l[1] for l in layers], [l[2] for l in layers]
    sweeps.append((
        "fused_mlp_forward B=8 784-300-100-10", "autotune_mlp_forward",
        ((8, FLAGSHIP, acts), {}), K.mlp_forward_candidates(8, FLAGSHIP),
        lambda p: K.fused_mlp_forward(x8, ws, bs, acts, True, plan=p),
        lambda: K.fused_mlp_forward_ref(x8, ws, bs, acts, True),
        close(TOL_P),
        lambda name: K.mlp_forward_plan(8, FLAGSHIP, device_name=name)))
    x100 = _tool_layer(2913, 100, FLAGSHIP[0], 1)[0]
    y100 = torch.eye(10, device=DEVICE)[torch.arange(100) % 10]
    cap = K._train_step_capacity(dev)

    def held_step(out, ref):
        e = max_err(out[0], ref[0], TOL_LOSS)
        return max([e] + [max_err(a, b, TOL_PARAM) for a, b in
                          zip(out[1] + out[2], ref[1] + ref[2])])

    sweeps.append((
        "fused_mlp_train_step B=100 784-300-100-10",
        "autotune_mlp_train_step", ((100, FLAGSHIP, acts), {}),
        K.train_grid_candidates(cap, sms, 100, FLAGSHIP),
        lambda g: K.fused_mlp_train_step(x100, y100, ws, bs, 0.1, acts,
                                         plan=g),
        lambda: K.fused_mlp_train_step_ref(x100, y100, ws, bs, 0.1, acts),
        held_step,
        lambda name: K.train_grid(cap, sms, 100, FLAGSHIP, device_name=name)))
    q, sc = K.quantize_weights_int8(ws[0])
    sweeps.append((
        "fused_linear_w8 B=8 784->300", "autotune_linear_w8",
        ((8, 784, 300), dict(act="logistic")),
        K.w8_candidates(8, 784, 300, "default", sms),
        lambda p: K.fused_linear_w8(x8, q, sc, bs[0], "logistic", plan=p),
        lambda: K.fused_linear_w8_ref(x8, q, sc, bs[0], "logistic"),
        close(TOL_Z),
        lambda name: K.w8_plan(8, 784, 300, "default", sms,
                               device_name=name)))
    xs8 = x8 * 4 - 2  # signed activations
    sweeps.append((
        "fused_linear_w8a8 B=8 784->300", "autotune_linear_w8a8",
        ((8, 784, 300), {}), K.w8a8_candidates(8, 784, 300, sms),
        lambda p: K.fused_linear_w8a8(xs8, q, sc, bs[0], "identity", plan=p),
        lambda: K.fused_linear_w8a8_ref(xs8, q, sc, bs[0], "identity"),
        exact,
        lambda name: K.w8a8_plan(8, 784, 300, sms, device_name=name)))
    r = np.random.default_rng(2920)
    wq6 = torch.tensor(r.integers(-127, 128, size=(3, 512, 512)),
                       dtype=torch.int8, device=DEVICE)
    sw6 = torch.tensor(r.uniform(0.002, 0.01, size=(3, 512)),
                       dtype=torch.float32, device=DEVICE)
    b6 = torch.tensor(r.normal(size=(3, 512)) * 0.1, dtype=torch.float32,
                      device=DEVICE)
    x6 = torch.tensor(r.normal(size=(16, 512)), dtype=torch.float32,
                      device=DEVICE)
    sweeps.append((
        "fused_mlp_w8a8_forward B=16 3x512", "autotune_mlp_w8a8",
        ((16, 512, 3), {}), K.mlp_w8a8_candidates(16, 512, 3, sms),
        lambda p: K.fused_mlp_w8a8_forward(x6, wq6, sw6, b6, "relu", plan=p),
        lambda: K.fused_mlp_w8a8_forward_ref(x6, wq6, sw6, b6, "relu"),
        exact,
        lambda name: K.mlp_w8a8_plan(16, 512, 3, sms, device_name=name)))
    xs7 = torch.tensor(r.normal(size=(64, 1, 32)), dtype=torch.float32,
                       device=DEVICE)
    wx7, ws7 = (torch.tensor(r.normal(size=sh) * 0.5 / math.sqrt(sh[1]),
                             dtype=torch.float32, device=DEVICE)
                for sh in ((512, 32), (512, 512)))
    b7 = torch.tensor(r.normal(size=(512,)) * 0.1, dtype=torch.float32,
                      device=DEVICE)
    s7 = torch.zeros(1, 512, device=DEVICE)
    sweeps.append((
        "fused_rnn_seq n=64 B=1 32->512", "autotune_rnn_step",
        ((1, 32, 512), {}), K.rnn_seq_candidates(1, 32, 512),
        lambda p: K.fused_rnn_seq(xs7, s7, wx7, ws7, b7, "logistic", plan=p),
        lambda: K.fused_rnn_seq_ref(xs7, s7, wx7, ws7, b7, "logistic"),
        close(TOL_SEQ),
        lambda name: K.rnn_seq_plan(1, 32, 512, device_name=name)))
    return sweeps


def phase_autotune() -> None:
    """Each of the seven sweeps at its main-path shape: every candidate
    held to the plain version and rerun bit for bit; the rule's plan among
    the candidates; the winner on disk with its provenance, seen by a fresh
    ``TileCache``; the wrappers' next call at the shape on the tuned plan,
    bit-equal to an explicit ``plan=`` call."""
    from tensor_ops_tpu_torch.ops import autotune
    from tensor_ops_tpu_torch.ops import kernels as K

    path = autotune._CACHE.path
    card = torch.cuda.get_device_name(0)
    cache = autotune.TileCache(path)
    with torch.no_grad():
        for (label, entry, (args, kw), cands, call, plain, held,
             planned) in _tool_sweeps():
            ref = plain()
            worst = 0.0
            for p in cands:
                out = call(p)
                again = call(p)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(
                    K._tensors(out), K._tensors(again))),
                    f"{label}: plan {p}: a rerun differs")
                worst = max(worst, held(out, ref))
            report = {}
            best = getattr(autotune, entry)(*args, cache=cache, report=report,
                                            **kw)
            check(report.get("rule") is not None and best in cands,
                  f"{label}: the rule's plan or the winner is not a "
                  f"candidate")
            with open(path) as f:
                disk = json.load(f)[report["key"]]
            check(disk["plan"] == report["best"] and disk["us"] > 0
                  and disk["candidates"] == len(cands)
                  and disk["spread_us"] >= 0,
                  f"{label}: the winner on disk is {disk}")
            check(autotune.TileCache(path).get(report["key"]) == disk,
                  f"{label}: a fresh TileCache does not see the winner")
            check(planned(card) == best, f"{label}: the plan does not take "
                  f"the tuned entry")
            tuned, explicit = call(None), call(best)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(
                K._tensors(tuned), K._tensors(explicit))),
                f"{label}: the tuned call differs from plan={best}")
            timer = ("a host-launched stream" if entry == "autotune_rnn_step"
                     else "device time in a CUDA graph")
            each = [(p, round(us, 2), round(sp, 2))
                    for p, us, sp in report["results"]]
            log(f"[tune] {label}: {len(cands)} candidates, each within its "
                f"tolerance of the plain version (max|err| {worst:.2e}) and "
                f"bit-equal on a rerun; winner {report['best']} "
                f"{report['best_us']:.2f} us (spread "
                f"{disk['spread_us']:.2f}), the rule {report['rule']} "
                f"{report['rule_us']:.2f} us, per call by {timer}, the median "
                f"of 5 rounds; each candidate (plan, us, spread): {each}; "
                f"the tuned call bit-equal to plan=")
    K.clear_plan_caches()


def phase_costs() -> None:
    """``profile_step`` of a ``train_fullfused`` step at B = 100 (kernel
    3): its flops equal ``cost_analysis`` of the plain step on the CPU, its
    rates below the card's peaks; the NaN checks on the card."""
    from tensor_ops_tpu_torch.models import FusedMLP
    from tensor_ops_tpu_torch.utils.profiling import (cost_analysis,
                                                      enable_nan_checks,
                                                      profile_step)
    from tensor_ops_tpu_torch.ops import kernels as K

    r = np.random.default_rng(2930)
    ws = [r.normal(size=(FLAGSHIP[k + 1], FLAGSHIP[k])).astype(np.float32)
          / np.float32(math.sqrt(FLAGSHIP[k])) for k in range(3)]
    bs = [np.zeros(d, np.float32) for d in FLAGSHIP[1:]]
    acts = ["logistic", "logistic", "identity"]
    xb = r.uniform(0, 1, size=(100, FLAGSHIP[0])).astype(np.float32)
    yb = np.eye(10, dtype=np.float32)[r.integers(0, 10, 100)]
    fm = FusedMLP.from_numpy(ws, bs, acts, device=DEVICE)
    x, y = torch.tensor(xb, device=DEVICE), torch.tensor(yb, device=DEVICE)

    def step(m):
        return m.train_fullfused(0.05, x, y)[1]

    K.reset_launch_counts()
    for steps in ((20, 120), (50, 500), (100, 2000)):
        stats = profile_step(step, fm, steps=steps, reps=3)
        if stats["per_step_s"] > 0:
            break
    check(K.launch_counts()["fused_mlp_train_step"] > 0,
          "profile_step did not launch kernel 3")
    cpu = FusedMLP.from_numpy(ws, bs, acts, device="cpu")
    plain = cost_analysis(lambda m: m.train_fullfused(
        0.05, torch.tensor(xb), torch.tensor(yb)), cpu)
    check(stats["flops"] == plain["flops"] > 0, f"kernel 3's step counts "
          f"{stats['flops']} flops, the plain step on the CPU "
          f"{plain['flops']}")
    check(0 < stats["tflops_per_s"] < PEAK_OPS["f32"] / 1e12
          and 0 < stats["gbytes_per_s"] < HBM_BPS / 1e9,
          f"profile_step's rates out of range: {stats}")
    log(f"[tools] profile_step train_fullfused B=100: "
        f"{stats['per_step_s'] * 1e6:.1f} us a step (steps {steps[0]} and "
        f"{steps[1]}, host-launched), {stats['flops']:.0f} flops (the plain "
        f"step on the CPU: {plain['flops']:.0f}), "
        f"{stats['bytes_accessed']:.0f} bytes, "
        f"{stats['tflops_per_s']:.4f} TFLOP/s, "
        f"{stats['gbytes_per_s']:.2f} GB/s, first call "
        f"{stats['compile_s'] * 1e3:.1f} ms")

    w, b = (torch.tensor(a, device=DEVICE) for a in (ws[0], bs[0]))
    xn = x[:8].clone()
    xn[0, 3] = float("nan")
    tids = []
    v = torch.ones(4, device=DEVICE, requires_grad=True)
    v.register_hook(lambda g: tids.append(threading.get_ident()) or g)
    (v * 2).sum().backward()
    enable_nan_checks(True)
    try:
        try:
            K.fused_linear(xn, w, b, "logistic")
            check(False, "a NaN through fused_linear did not raise")
        except FloatingPointError as e:
            check("fused_linear" in str(e), f"the NaN check named: {e}")
        z = torch.zeros(4, device=DEVICE, requires_grad=True)
        loss = (torch.sqrt(z) * 0).sum()
        try:
            loss.backward()
            check(False, "a NaN first made in the backward did not raise")
        except FloatingPointError as e:
            caught = str(e)
    finally:
        enable_nan_checks(False)
    y_nan = K.fused_linear(xn, w, b, "logistic")
    z = torch.zeros(4, device=DEVICE, requires_grad=True)
    (torch.sqrt(z) * 0).sum().backward()
    check(bool(torch.isnan(y_nan).any()) and bool(torch.isnan(z.grad).all()),
          "with the checks off the NaNs should pass through")
    log(f"[tools] NaN checks on the card: a NaN in x through fused_linear "
        f"raised naming fused_linear; a NaN first made in the backward "
        f"raised ({caught}; autograd ran the card's backward on thread "
        f"{tids[0]}, the caller is {threading.get_ident()}); with the checks "
        f"off neither raised")


def phase_traces(tmp: str) -> None:
    """``device_trace`` over a bucket-8 request and a ``train_fullfused``
    step: the hand kernels' device events under their names; ``fit(
    profile_dir=...)`` of the flagship for 6 steps: a trace with device
    events, parameters bit-equal to the same ``fit`` with
    ``chain_steps=1``."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.models import (FusedMLP, Predictor, adam,
                                             cross_entropy, fit)

    be = TorchBackend(torch.float32, DEVICE)
    net = _flagship_net(be)
    fm = FusedMLP.from_network(net)
    pred = Predictor(fm, buckets=(8,))
    rows = np.random.default_rng(2940).uniform(0, 1, size=(5, FLAGSHIP[0]))
    pred.predict(rows)
    names = _traced("request", lambda: pred.predict(rows), tmp)
    check("mlp_forward_kernel" in names, f"the request's trace: {names}")
    x = torch.rand(100, FLAGSHIP[0], device=DEVICE,
                   generator=torch.Generator(DEVICE).manual_seed(1))
    y = torch.eye(10, device=DEVICE)[torch.arange(100) % 10]
    fm.train_fullfused(0.05, x, y)
    steps = _traced("train_fullfused", lambda: fm.train_fullfused(0.05, x, y),
                    tmp)
    check("mlp_train_step_kernel" in steps, f"the step's trace: {steps}")
    log(f"[tools] device_trace: a bucket-8 request traced {names} and a "
        f"train_fullfused step {steps} (device events by kernel)")

    r = np.random.default_rng(2941)
    X = r.uniform(0, 1, size=(600, FLAGSHIP[0]))
    Y = np.eye(10)[r.integers(0, 10, 600)]
    kw = dict(epochs=1, batch_size=100, lr=0.02, optimizer=adam(),
              verbose=False, log_every=1)
    plain = fit(net, cross_entropy(10), be, X, Y, chain_steps=1, **kw)
    for attempt in range(3):
        d = os.path.join(tmp, f"fit-{attempt}")
        res = fit(net, cross_entropy(10), be, X, Y, profile_dir=d, **kw)
        traced = _trace_kernel_names(d)
        if traced:
            break
    check(bool(traced), "fit(profile_dir=...): no device events in its "
          "trace after 3 runs")
    check(res.steps == plain.steps == 6
          and all(torch.equal(a, b) for a, b in zip(res.net.params,
                                                    plain.net.params)),
          "fit(profile_dir=...) is not bit-equal to chain_steps=1")
    log(f"[tools] fit(profile_dir=...) of the flagship, 6 steps: a trace of "
        f"steps 2-5 with {sum(traced.values())} device kernel events "
        f"({len(traced)} kernels), parameters bit-equal to chain_steps=1")


def phase_plan_and_budget() -> None:
    """``examples/plan_and_budget.py`` on the card: its forward's measured
    bytes at B = 4096 are exactly X and the parameters in, B x 10 f32
    out."""
    from tensor_ops_tpu_torch.examples import plan_and_budget

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = plan_and_budget.main([])
    ma = out["memory"]
    params = sum(FLAGSHIP[k] * FLAGSHIP[k + 1] + FLAGSHIP[k + 1]
                 for k in range(3)) * 4
    check(ma["argument_size_in_bytes"] == 4096 * FLAGSHIP[0] * 4 + params
          and ma["output_size_in_bytes"] == 4096 * 10 * 4,
          f"memory_analysis of the forward at B=4096: {ma}")
    check(math.isfinite(out["loss"]), "plan_and_budget: the step's loss")
    log(f"[tools] plan_and_budget on the card: winner "
        f"(dp={out['mesh']['data']}, tp={out['mesh']['model']}); "
        f"memory_analysis of the flagship forward at B=4096: {ma}; "
        f"the step's loss {out['loss']:.4f}")


def _pinned_plan_cache() -> str:
    """The plan cache this process uses, which must be the file that
    ``TENSOR_OPS_TPU_TORCH_PLAN_CACHE`` names, outside ``~/.cache``: the
    sweeps write their winners there, and a winner that reached the home's
    cache would change the plans of every later run on the machine."""
    from tensor_ops_tpu_torch.ops import autotune

    env = os.environ.get(autotune.ENV_VAR)
    path = autotune._CACHE.path
    cache_dir = os.path.join(os.path.realpath(os.path.expanduser("~")),
                             ".cache") + os.sep
    check(bool(env) and path == env
          and not os.path.realpath(path).startswith(cache_dir),
          f"the plan cache is {path}: set {autotune.ENV_VAR} to a file "
          f"outside {cache_dir}")
    return path


def tooling_main() -> None:
    """Phase 29 in its own interpreter: the sweeps, the costs and the NaN
    checks, the traces (into a temporary directory of its own), the
    example.  ``TENSOR_OPS_TPU_TORCH_PLAN_CACHE`` must name the phase's
    cache file, outside ``~/.cache``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[tools] the plan cache: {_pinned_plan_cache()}")
    timed("autotune sweeps", phase_autotune)
    with tempfile.TemporaryDirectory() as tmp:
        timed("costs and NaN checks", phase_costs)
        timed("traces", phase_traces, tmp)
    timed("plan_and_budget", phase_plan_and_budget)


def _listing(top: str) -> list:
    """(path, size, mtime) of every file under ``top``, sorted."""
    out = []
    for root, _, files in os.walk(top):
        for f in files:
            st = os.stat(os.path.join(root, f))
            out.append((os.path.join(root, f), st.st_size, st.st_mtime_ns))
    return sorted(out)


def phase_tooling(tmp: str) -> None:
    """Run :func:`tooling_main` (phase 29) in an interpreter of its own with
    a time limit, its plan cache a file of ``tmp``; nothing under
    ``~/.cache/tensor_ops_tpu_torch`` may be written or removed by it."""
    here = os.path.dirname(os.path.abspath(__file__))
    before = _listing(PLAN_CACHE_DIR)
    sys.stdout.flush()
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.tooling_main()"],
        timeout=TOOL_TIMEOUT_S, cwd=here,
        env=dict(os.environ, PYTHONPATH=here,
                 TENSOR_OPS_TPU_TORCH_PLAN_CACHE=os.path.join(
                     tmp, "plans.json")))
    check(proc.returncode == 0, f"the tooling phase failed (exit "
          f"{proc.returncode})")
    after = _listing(PLAN_CACHE_DIR)
    check(after == before, f"the tooling phase changed {PLAN_CACHE_DIR}: "
          f"{before} -> {after}")
    log(f"[tools] {PLAN_CACHE_DIR} unchanged by the phase ({len(after)} "
        f"files before and after)")


# ---------------------------------------------------------------------------
# Phase 30: the dry run (tensor_ops_tpu_torch.dryrun) and entry()
# ---------------------------------------------------------------------------

DRYRUN_N, DRYRUN_TIMEOUT_S = 8, 300
DRYRUN_DEVICE = "cuda:0"  # the card every rank of the dry run shares
# every run of the JAX package's dry run at 8 ranks, in its order
DRYRUN_KEYS = (
    "dp_tp", "fit", "fit_adam", "fit_zero2", "fit_zero3", "fit_zero3_offload",
    "gpipe", "staged_ir", "staged_ir_circular", "staged_ir_circular_hetero",
    "staged_ir_flagship", "fit_dp_pipeline", "dp_megakernel", "pipeline_3d",
    "mesh_3d", "hetero_tp_pyramid", "hetero_tp_flagship",
    "hetero_tp_circular", "serve_reload", "fit_sequences")
# its dp-megakernel run: kernel 3 once a rank; kernel 9 (the one-shot) once
# a tensor, 2 weights and 2 biases
DRYRUN_DP_LAUNCHES = {"fused_mlp_train_step": DRYRUN_N, "bidir_ring": 4,
                      "ring_all_reduce": 0, "bidir_ring.ring": 0,
                      "ring_all_reduce.ring": 0}
TOL_ENTRY = (1e-5, 0.0)


def dryrun_main(out: str) -> None:
    """Phase 30 in its own interpreter: ``dryrun_multichip``'s runs on
    DRYRUN_N ranks of the card (each run's loss, wall time and launches;
    every key of DRYRUN_KEYS, every loss finite, the dp-megakernel run's
    launches DRYRUN_DP_LAUNCHES), then ``entry()`` on the card against
    ``entry(device="cpu")`` in f64.  Writes the dry run's launches of
    kernels 3, 8 and 9 to ``out``."""
    from tensor_ops_tpu_torch import dryrun
    from tensor_ops_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = RING_NAMES + ("fused_mlp_train_step",)
    launches = dict.fromkeys(names, 0)
    runs = {}
    _sync()
    K.reset_launch_counts()
    t0 = t_all = time.perf_counter()
    for key, loss in dryrun.dryrun_runs(DRYRUN_N, [DRYRUN_DEVICE] * DRYRUN_N):
        _sync()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        runs[key] = counts
        for k in names:
            launches[k] += counts[k]
        check(math.isfinite(loss), f"dry run {key}: loss {loss}")
        log(f"[dryrun] {key}: {loss:.6f} in {wall:.2f} s wall (host clock "
            f"to a synchronise); launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        K.reset_launch_counts()
        t0 = time.perf_counter()
    total = time.perf_counter() - t_all
    check(tuple(runs) == DRYRUN_KEYS, f"the dry run's runs {tuple(runs)}, "
          f"want {DRYRUN_KEYS}")
    dp = {k: runs["dp_megakernel"][k] for k in DRYRUN_DP_LAUNCHES}
    check(dp == DRYRUN_DP_LAUNCHES, f"the dry run's dp-megakernel run "
          f"launched {dp}, want {DRYRUN_DP_LAUNCHES}")
    log(f"[dryrun] {len(runs)} runs on {DRYRUN_N} ranks of {DRYRUN_DEVICE} in "
        f"{total:.1f} s, every loss finite and every check of the JAX dry "
        f"run held; the dp-megakernel run launched {dp}; kernels 3, 8 and 9 "
        f"in all {launches}")
    fn, args = dryrun.entry()
    got = fn(*args)
    _sync()
    check(got.device.type == "cuda" and tuple(got.shape) == (32, FLAGSHIP[-1]),
          f"entry() gave {tuple(got.shape)} on {got.device}")
    rows = max_err(got.sum(1), torch.ones(32), TOL_ENTRY)
    fn_c, args_c = dryrun.entry(device="cpu")
    e64 = max_err(got, fn_c(*(a.double() for a in args_c)), TOL_ENTRY)
    log(f"[dryrun] entry(): {tuple(got.shape)} on {got.device}, rows sum to "
        f"1 within {rows:.2e}, max |err| {e64:.2e} from entry(device='cpu') "
        f"in f64 (tol {TOL_ENTRY[0]:g})")
    with open(out, "w") as f:
        json.dump(launches, f)


def phase_dryrun(tmp: str) -> dict:
    """Run :func:`dryrun_main` (phase 30) in an interpreter of its own with
    a time limit; its lines print as they come; returns its launches."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(tmp, "dryrun_launches.json")
    sys.stdout.flush()
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.dryrun_main(sys.argv[1])", out],
        timeout=DRYRUN_TIMEOUT_S, cwd=here,
        env=dict(os.environ, PYTHONPATH=here))
    check(proc.returncode == 0, f"the dry-run phase failed (exit "
          f"{proc.returncode})")
    with open(out) as f:
        return json.load(f)


# Phase 31, request graphs: the flagship's single-device Predictor routes
# at the Predictor's default buckets (kernel 2 below xla_threshold = 64,
# run_xla above; kernel 1, 4 and 5 routes at every bucket), the 4 x 4096
# stack at its bucket, the staged-IR Network route, and the recurrent
# model's SequencePredictor at RNN_BUCKETS, n = RNN_N.  GRAPH_BEYOND rows
# take a bucket beyond the top one (its graph captured at first use).
GRAPH_BUCKETS = (1, 8, 32, 128, 512)
GRAPH_BEYOND = 600
GRAPH_ROUNDS, GRAPH_TIMED = 3, 20
GRAPH_SOAK_THREADS, GRAPH_SOAK_SWAPS = 4, 6
# the soak's arms, (bucket, rows a request): kernel 2 against kernel 5, and
# run_xla (cuBLAS) against kernel 5
GRAPH_SOAK_ARMS = ((8, 5), (128, 100))
# the soak's race arm: rounds of direct cuBLAS calls on streams torch's pool
# hands out (every pooled stream recurs) and of new captures, while request
# graphs of run_xla replay
GRAPH_RACE_ROUNDS, GRAPH_RACE_STREAMS = 12, 64
# a stream of requests of mixed sequence lengths on a SequencePredictor
# none of whose lengths was warmed: GRAPH_MIX_REPEAT requests of each
# length at bucket 8, in a shuffled order
GRAPH_MIX_LENGTHS = (16, 24, 32, 40, 48, 56, 72, 80, 88, 96, 104, 112)
GRAPH_MIX_REPEAT = 3
GRAPH_TIMEOUT_S = 300
# the hand-written kernels a request's graph holds at bucket 8 (the stack
# at its bucket), by the profiler's names
GRAPH_KERNELS = {
    "f32 fused": {"mlp_forward_kernel": 1},
    "f32 per-layer": {"linear_gemv_kernel": 3},
    "bf16": {"mlp_forward_kernel": 1},
    "w8": {"w8_gemv_kernel": 3},
    "w8a8": {"w8a8_kernel": 3},
    "4x4096 stack": {"mlp_w8a8_kernel": 1},
    "Network": {}, "SequencePredictor": {}}


def _direct_request(pred, x):
    """A request of exactly a bucket's rows by the private direct forward
    (every kernel launched from the host), as ``predict`` ran before
    request graphs."""
    from tensor_ops_tpu_torch.models import serve as S

    st = pred._serving
    if isinstance(pred, S.SequencePredictor):
        out = S._seq_run(st[0], st[1], st[1].asarray(x))
    else:
        out = pred._forward(st, pred._as(st, x))
    return out.cpu().numpy()


def _graph_routes(be):
    """Phase 31's predictors: (name, predictor, buckets, input shape)."""
    from tensor_ops_tpu_torch.models import (FusedMLP, Predictor,
                                             QuantizedMLP, SequencePredictor)

    net = _flagship_net(be)
    fm = FusedMLP.from_network(net)
    r = np.random.default_rng(0)
    ws = [(r.normal(size=(STACK_N, STACK_N)) * math.sqrt(2.0 / STACK_N))
          .astype(np.float32) for _ in range(STACK_L)]
    stack = QuantizedMLP.from_fused(FusedMLP.from_numpy(
        ws, [np.zeros(STACK_N, np.float32)] * STACK_L, STACK_ACTS,
        softmax_out=False, device=DEVICE))
    flat = (FLAGSHIP[0],)
    return [
        ("f32 fused", Predictor(fm, buckets=GRAPH_BUCKETS), GRAPH_BUCKETS,
         flat),
        ("f32 per-layer", Predictor(fm, buckets=GRAPH_BUCKETS,
                                    use_fused_kernel=False), GRAPH_BUCKETS,
         flat),
        ("bf16", Predictor(fm, buckets=GRAPH_BUCKETS, dtype="bf16"),
         GRAPH_BUCKETS, flat),
        ("w8", Predictor(QuantizedMLP.from_fused(fm, mode="w8"),
                         buckets=GRAPH_BUCKETS), GRAPH_BUCKETS, flat),
        ("w8a8", Predictor(QuantizedMLP.from_fused(fm),
                           buckets=GRAPH_BUCKETS), GRAPH_BUCKETS, flat),
        ("4x4096 stack", Predictor(stack, buckets=(STACK_B,)), (STACK_B,),
         (STACK_N,)),
        ("Network", Predictor(net, be, buckets=GRAPH_BUCKETS), GRAPH_BUCKETS,
         flat),
        ("SequencePredictor", SequencePredictor(rnn_model(be), be,
                                                buckets=RNN_BUCKETS),
         RNN_BUCKETS, (RNN_N, RNN_IN)),
    ]


def _device_bytes() -> tuple:
    """(allocated, reserved) device bytes, after ``empty_cache``; torch's
    cuBLAS workspaces stay (graphs read the ones they were captured
    with), so a graph's bytes include a workspace its capture stream had
    not held before."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


def _graph_bytes(pred, buckets, shape, key) -> list:
    """The device bytes each bucket's request graph holds, captured one
    after another as ``warmup`` captures them: allocated and reserved
    (after ``empty_cache``) before and after the capture of ``key(b)``,
    the model's own caches made first by a direct request at each
    bucket.  [(bucket, allocated, reserved)]."""
    for b in buckets:
        _direct_request(pred, np.zeros((b,) + shape, np.float32))
    graphs = pred._serving[-1]
    out, prev = [], _device_bytes()
    for b in buckets:
        graphs.get(key(b), keep=True)
        now = _device_bytes()
        out.append((b, now[0] - prev[0], now[1] - prev[1]))
        prev = now
    return out


def _graph_mixed_lengths(be) -> None:
    """A SequencePredictor none of whose lengths was warmed serves a
    shuffled stream of GRAPH_MIX_REPEAT requests of each of
    GRAPH_MIX_LENGTHS at bucket 8: one capture per length (at its first
    request), every response bit-equal to the direct forward; host-clock
    p50 of the first requests of a length (warm-up and capture) and of the
    others (replays); the device bytes each length's graph holds."""
    from tensor_ops_tpu_torch.models import SequencePredictor
    from tensor_ops_tpu_torch.models import serve as S

    pred = SequencePredictor(rnn_model(be), be, buckets=RNN_BUCKETS)
    r = np.random.default_rng(311)
    order = [n for n in GRAPH_MIX_LENGTHS for _ in range(GRAPH_MIX_REPEAT)]
    r.shuffle(order)
    xs = {n: r.uniform(0, 1, size=(8, n, RNN_IN)).astype(np.float32)
          for n in GRAPH_MIX_LENGTHS}
    want = {n: _direct_request(pred, x) for n, x in xs.items()}
    c0 = S.graph_counts()["captures"]
    first, again, held = [], [], {}
    prev = _device_bytes()
    for n in order:
        t0 = time.perf_counter()
        got = pred.predict(xs[n])
        (again if n in held else first).append(
            (time.perf_counter() - t0) * 1e6)
        check(np.array_equal(got, want[n]), f"request graphs: the mixed "
              f"stream's length {n} is not bit-equal to its direct forward")
        if n not in held:  # the bytes its capture took, outside the timing
            now = _device_bytes()
            held[n] = (now[0] - prev[0], now[1] - prev[1])
            prev = now
    caps = S.graph_counts()["captures"] - c0
    check(caps == len(GRAPH_MIX_LENGTHS), f"request graphs: the mixed "
          f"stream of {len(GRAPH_MIX_LENGTHS)} lengths captured {caps}")
    log(f"[graphs] SequencePredictor, mixed lengths {GRAPH_MIX_LENGTHS} at "
        f"bucket 8, {len(order)} requests shuffled, none warmed: {caps} "
        f"captures (one a length), every response bit-equal to the direct "
        f"forward; host-clock p50 {statistics.median(first) / 1e3:.1f} ms "
        f"for a length's first request (warm-up and capture), "
        f"{statistics.median(again) / 1e3:.2f} ms for the others "
        f"(replays); the {caps} graphs hold "
        f"{sum(a for a, _ in held.values())} bytes allocated, "
        f"{sum(r for _, r in held.values())} reserved; by length "
        + ", ".join(f"{n}: {held[n][0]} / {held[n][1]}"
                    for n in sorted(held)))


def _graph_soak(fm, bucket: int, rows: int) -> None:
    """The JAX package's serving soak (tests/test_serve.py:490) on the
    card: GRAPH_SOAK_THREADS threads predict ``rows`` rows (bucket
    ``bucket``) while GRAPH_SOAK_SWAPS reloads alternate the flagship's
    FusedMLP and its w8a8 QuantizedMLP; no error, every response bit-equal
    to one model's direct forward, and captures only in warmup and
    reload."""
    import threading

    from tensor_ops_tpu_torch.models import Predictor, QuantizedMLP
    from tensor_ops_tpu_torch.models import serve as S

    qm = QuantizedMLP.from_fused(fm)
    x = np.random.default_rng(31).uniform(0, 1, size=(rows, FLAGSHIP[0]))
    x = x.astype(np.float32)
    xb = np.pad(x, ((0, bucket - rows), (0, 0)))
    want = [_direct_request(Predictor(m, buckets=(bucket,)), xb)[:rows]
            for m in (fm, qm)]
    check(not np.allclose(want[0], want[1]), "soak: the two models agree")
    S.reset_graph_counts()
    pred = Predictor(fm, buckets=(bucket,))
    t0 = time.perf_counter()
    pred.warmup()
    warmup_s = time.perf_counter() - t0
    errors, torn, lat = [], [], []
    stop = threading.Event()

    def client():
        while not stop.is_set():
            t = time.perf_counter()
            try:
                out = pred.predict(x)
            except Exception as e:  # noqa: BLE001 — collected, checked
                errors.append(repr(e))
                return
            lat.append(time.perf_counter() - t)
            if not any(np.array_equal(out, w) for w in want):
                torn.append(out)
                return

    threads = [threading.Thread(target=client)
               for _ in range(GRAPH_SOAK_THREADS)]
    for t in threads:
        t.start()
    captures, reloads = [], []
    try:
        for k in range(GRAPH_SOAK_SWAPS):
            t0 = time.perf_counter()
            pred.reload(qm if k % 2 == 0 else fm)
            reloads.append(time.perf_counter() - t0)
            captures.append(S.graph_counts()["captures"])
            time.sleep(0.1)
    finally:
        stop.set()
        for t in threads:
            t.join()
    counts = S.graph_counts()
    check(not errors, f"soak: predict raised under reload: {errors[:3]}")
    check(not torn, "soak: a response was neither model's output")
    check(len(lat) > 50, f"soak: only {len(lat)} requests")
    check(captures == list(range(2, GRAPH_SOAK_SWAPS + 2))
          and counts["captures"] == GRAPH_SOAK_SWAPS + 1,
          f"soak: captures after each reload {captures}, in all "
          f"{counts['captures']}: a request captured")
    check(pred.latency()["n"] == len(lat), "soak: the timer lost requests")
    s = np.sort(lat)
    log(f"[graphs] soak: {GRAPH_SOAK_THREADS} threads, {GRAPH_SOAK_SWAPS} "
        f"reloads alternating the flagship f32 and w8a8 at bucket "
        f"{bucket} ({rows} rows): {len(lat)} requests, 0 errors, every response "
        f"bit-equal to one model's direct forward, {counts['captures']} "
        f"captures (1 warm-up + 1 a reload, none in a request), "
        f"{counts['replays']} replays; request p50 {s[len(s) // 2] * 1e6:.1f}"
        f" us, p99 {s[int(0.99 * (len(s) - 1))] * 1e6:.1f} us, max "
        f"{s[-1] * 1e6:.1f} us (host clock); the warm-up's capture "
        f"{warmup_s * 1e3:.1f} ms, a reload (conversion and capture) "
        f"{statistics.median(reloads) * 1e3:.1f} ms median, "
        f"{max(reloads) * 1e3:.1f} ms at most")


def _graph_race_soak(be, fm) -> None:
    """The soak's race arm: GRAPH_SOAK_THREADS threads replay the request
    graph of the flagship's run_xla (cuBLAS) at bucket 128 (100 rows)
    while this thread, GRAPH_RACE_ROUNDS times, runs a direct cuBLAS call
    on each of GRAPH_RACE_STREAMS streams torch's pool hands out (each
    pooled stream comes back, the capture streams of older graphs among
    them before every graph captured on the card's own) and then captures
    graphs whose warm-ups call cuBLAS: a request graph of run_xla at a new
    bucket, the engine's ``batched_run`` at a new row count.  Every
    response must be bit-equal to the direct forward: no warm-up and no
    direct call wrote the workspace a replaying graph reads."""
    import threading

    from tensor_ops_tpu_torch import engine
    from tensor_ops_tpu_torch.models import Predictor
    from tensor_ops_tpu_torch.models import serve as S
    from tensor_ops_tpu_torch.models import training as TT

    r = np.random.default_rng(33)
    x = r.uniform(0, 1, size=(100, FLAGSHIP[0])).astype(np.float32)
    pred = Predictor(fm, buckets=(128,))
    want = _direct_request(pred, np.pad(x, ((0, 28), (0, 0))))[:100]
    pred.warmup()
    net = _flagship_net(be)
    X = be.asarray(r.uniform(0, 1, size=(300, FLAGSHIP[0])))
    a = torch.rand(1024, FLAGSHIP[0], device=DEVICE)
    b = torch.rand(FLAGSHIP[0], 1024, device=DEVICE)
    errors, torn, done = [], [], [0]
    stop = threading.Event()

    def client():
        while not stop.is_set():
            try:
                out = pred.predict(x)
            except Exception as e:  # noqa: BLE001 — collected, checked
                errors.append(repr(e))
                return
            done[0] += 1
            if not np.array_equal(out, want):
                torn.append(out)
                return

    e0, s0 = engine.graph_counts()["captures"], S.graph_counts()["captures"]
    threads = [threading.Thread(target=client)
               for _ in range(GRAPH_SOAK_THREADS)]
    for t in threads:
        t.start()
    try:
        for k in range(GRAPH_RACE_ROUNDS):
            cur = torch.cuda.current_stream()
            for _ in range(GRAPH_RACE_STREAMS):
                side = torch.cuda.Stream()
                side.wait_stream(cur)
                with torch.cuda.stream(side):
                    (a @ b).sum()
                cur.wait_stream(side)
            Predictor(fm, buckets=(136 + 8 * k,)).warmup()
            TT.batched_run(net, be)(X[:200 + k], *net.params)
    finally:
        stop.set()
        for t in threads:
            t.join()
    caps = (engine.graph_counts()["captures"] - e0,
            S.graph_counts()["captures"] - s0)
    check(not errors, f"race soak: predict raised: {errors[:3]}")
    check(not torn, "race soak: a response was not the direct forward's")
    check(done[0] > 50, f"race soak: only {done[0]} requests")
    check(caps == (GRAPH_RACE_ROUNDS, GRAPH_RACE_ROUNDS),
          f"race soak: {caps} captures (engine, request graphs)")
    log(f"[graphs] race soak: {GRAPH_SOAK_THREADS} threads replayed the "
        f"run_xla request graph at bucket 128 ({done[0]} requests) while "
        f"{GRAPH_RACE_ROUNDS} rounds ran a direct cuBLAS call on each of "
        f"{GRAPH_RACE_STREAMS} pooled streams and captured {caps[1]} request "
        f"graphs and {caps[0]} engine graphs, their warm-ups calling cuBLAS: "
        f"0 errors, every response bit-equal to the direct forward")


def graphs_main() -> None:
    """Phase 31 in its own interpreter: every single-device route of
    ``Predictor`` and the ``SequencePredictor`` served from request graphs,
    each bucket bit-equal to the direct forward, and again after every
    other graph was captured; the launches a graph holds equal the direct
    forward's; one graph launch a request and the kernels in it; p50s
    graph against direct in interleaved rounds with idle shares; kernel
    5's two instances by request graph; the soak; the graphs' bytes."""
    from tensor_ops_tpu_torch import TorchBackend
    from tensor_ops_tpu_torch.models import FusedMLP, Predictor
    from tensor_ops_tpu_torch.models import serve as S
    from tensor_ops_tpu_torch.ops import kernels as K

    be = TorchBackend(torch.float32, DEVICE)
    routes = _graph_routes(be)
    r = np.random.default_rng(310)
    xs, want = {}, {}
    S.reset_graph_counts()
    for name, pred, buckets, shape in routes:
        t0 = time.perf_counter()
        if isinstance(pred, Predictor):
            pred.warmup()
        else:
            pred.warmup([RNN_N])
        cap_s = time.perf_counter() - t0
        held = []
        for b in buckets:
            x = r.uniform(0, 1, size=(b,) + shape).astype(np.float32)
            xs[name, b] = x
            torch.cuda.synchronize()
            K.reset_launch_counts()
            want[name, b] = _direct_request(pred, x)
            direct = K.launch_counts()
            K.reset_launch_counts()
            got = pred.predict(x)
            graph = K.launch_counts()
            check(np.array_equal(got, want[name, b]), f"request graphs: "
                  f"{name} at bucket {b} is not bit-equal to its direct "
                  f"forward (max |diff| "
                  f"{np.abs(got - want[name, b]).max():.3g})")
            check(graph == direct, f"request graphs: {name} at bucket {b} "
                  f"counted {graph}, its direct forward {direct}")
            held.append(f"{b}: " + (", ".join(
                f"{k} x{v}" for k, v in graph.items() if v) or "none"))
        log(f"[graphs] {name}: {len(buckets)} graphs captured in "
            f"{cap_s * 1e3:.1f} ms, each bucket bit-equal to the direct "
            f"forward; hand-written launches a request (held = direct): "
            + "; ".join(held))
    name, pred, _, shape = routes[0]
    x = r.uniform(0, 1, size=(GRAPH_BEYOND,) + shape).astype(np.float32)
    before = S.graph_counts()["captures"]
    got = pred.predict(x)
    top = -(-GRAPH_BEYOND // GRAPH_BUCKETS[-1]) * GRAPH_BUCKETS[-1]
    check(S.graph_counts()["captures"] == before + 1
          and np.array_equal(got, _direct_request(
              pred, np.pad(x, ((0, top - GRAPH_BEYOND), (0, 0))))[
                  :GRAPH_BEYOND]),
          f"request graphs: {GRAPH_BEYOND} rows (bucket {top}) were not "
          f"captured at first use or differ from the direct forward")
    # every graph replayed again, in reverse order, after the last capture
    for name, pred, buckets, shape in reversed(routes):
        for b in reversed(buckets):
            check(np.array_equal(pred.predict(xs[name, b]), want[name, b]),
                  f"request graphs: {name} at bucket {b} changed after "
                  f"the later captures")
    log(f"[graphs] {GRAPH_BEYOND} rows captured at first use at bucket "
        f"{top}, bit-equal; then every bucket of every route replayed in "
        f"reverse order after the last capture: all still bit-equal; "
        f"{S.graph_counts()['captures']} captures in all")

    # one graph launch a request, and the kernels inside it; the device
    # busy time of a request at that bucket by each arm
    busy = {}
    for name, pred, buckets, shape in routes:
        b = 8 if 8 in buckets else buckets[0]
        prof = _profile_steps(lambda: pred.predict(xs[name, b]), steps=5,
                              whole=True)
        busy[name, "graph"] = prof["busy_us"]
        busy[name, "direct"] = _profile_steps(
            lambda: _direct_request(pred, xs[name, b]), steps=5)["busy_us"]
        calls = prof["calls"]
        for kname, n in GRAPH_KERNELS[name].items():
            check(calls.get(kname) == n, f"request graphs: {name} at bucket "
                  f"{b} ran {calls.get(kname)} {kname}, want {n}")
        check(prof["graph_launches"] == 1, f"request graphs: {name} at "
              f"bucket {b}: {prof['graph_launches']} graph launches a "
              f"request")
        log(f"[graphs] {name} bucket {b}, profiler per request: "
            f"{prof['graph_launches']:g} graph launch, "
            f"{prof['other_launches']:g} other host launches (copies), "
            f"{prof['launches']:g} kernels and {prof['copies']:g} copies on "
            f"the card: " + ", ".join(f"{k} x{v:g}" for k, v in calls.items()))

    # graph against direct, interleaved rounds
    for name, pred, buckets, shape in routes:
        line = []
        for b in buckets:
            x = xs[name, b]
            arms = {"graph": lambda: pred.predict(x),
                    "direct": lambda: _direct_request(pred, x)}
            ts = {a: [] for a in arms}
            for _ in range(GRAPH_ROUNDS):
                for a, fn in arms.items():
                    for _ in range(3):
                        fn()
                    torch.cuda.synchronize()
                    for _ in range(GRAPH_TIMED):
                        t0 = time.perf_counter()
                        fn()
                        ts[a].append((time.perf_counter() - t0) * 1e6)
            p50 = {a: statistics.median(t) for a, t in ts.items()}
            part = f"{b}: graph {p50['graph']:.1f} us"
            if b == (8 if 8 in buckets else buckets[0]):
                idle = {a: 1 - busy[name, a] / p50[a] for a in arms}
                part += (f" (idle {idle['graph']:.3f}), direct "
                         f"{p50['direct']:.1f} us (idle {idle['direct']:.3f})")
            else:
                part += f", direct {p50['direct']:.1f} us"
            line.append(part)
        log(f"[graphs] {name} p50 per request by bucket (host clock, "
            f"{GRAPH_ROUNDS} interleaved rounds of {GRAPH_TIMED}; at the "
            f"profiled bucket the idle share, 1 - profiler busy / p50): "
            + "; ".join(line))

    w8a8_request_turns(routes[4][1].model, xs["w8a8", W8A8_DIRECT_B])
    for bucket, rows in GRAPH_SOAK_ARMS:
        _graph_soak(routes[0][1].model, bucket, rows)
    _graph_race_soak(be, routes[0][1].model)
    _graph_mixed_lengths(be)

    for name, pred, buckets, shape in (routes[0], routes[5], routes[7]):
        if isinstance(pred, Predictor):
            fresh, key = Predictor(pred.model, buckets=buckets), int
        else:
            fresh = type(pred)(pred.rnet, pred.be, buckets=buckets)
            key = lambda b: (b, RNN_N)  # noqa: E731
        held = _graph_bytes(fresh, buckets, shape, key)
        log(f"[graphs] device bytes held by the request graphs of a "
            f"{name} at buckets {buckets}: {sum(h[1] for h in held)} "
            f"allocated, {sum(h[2] for h in held)} reserved; by bucket "
            + ", ".join(f"{b}: {a} / {r}" for b, a, r in held)
            + " (torch.cuda memory_allocated / memory_reserved after "
            "empty_cache, before and after each bucket's capture)")


def phase_graphs() -> None:
    """Run :func:`graphs_main` (phase 31) in an interpreter of its own with
    a time limit; its lines print as they come."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.stdout.flush()
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.graphs_main()"],
        timeout=GRAPH_TIMEOUT_S, cwd=here,
        env=dict(os.environ, PYTHONPATH=here))
    check(proc.returncode == 0, f"the request-graph phase failed (exit "
          f"{proc.returncode})")


# Phase 32, compiled entry points: every entry point the JAX package jits,
# on the card from one CUDA graph per shape (engine.Compiled) or, for the
# per-sample fold and the induction loop, one captured step replayed once a
# step (engine.Loop): the flagship (random weights, seed 0) at one sample,
# at the app's minibatch of 100, at a 1,000-sample fold chunk and at 5,000
# induction steps; the recurrent model of phase 9 (n = 64, 8 sequences);
# the 784-128-32-128-784 autoencoder at 100 rows; FusedRNN at the recurrent
# cell's 32 -> 512 (kernel 7's sequence launch) and at 32 -> 1024, a cell
# too wide for the sequence kernel (one step launch a step).
COMPILED_TIMEOUT_S = 300
COMPILED_B = 100
COMPILED_FOLD, COMPILED_FOLD_PROFILED = 1000, 100
COMPILED_INDUCE, COMPILED_INDUCE_PROFILED = 5000, 500
COMPILED_VAL = 1000
COMPILED_RNN_WIDE = 1024
COMPILED_TURNS, COMPILED_CALLS = 2, 20
# the forwards of item 11b at the serving buckets 8 and 64: run_xla
# compiled, FusedMLP.run, the two QuantizedMLP.run modes and the
# one-launch calls direct; QuantizedMLP.run_fused on a uniform int8 stack
# of COMPILED_STACK_L layers of COMPILED_STACK_N (relu, softmax out)
COMPILED_BUCKETS = (8, 64)
COMPILED_STACK_N, COMPILED_STACK_L = 1024, 3
# the forwards of several launches, timed at each bucket
COMPILED_FORWARDS = ("FusedMLP.run", "FusedMLP.run_xla",
                     "QuantizedMLP w8 run", "QuantizedMLP w8a8 run")
# the calls that run direct, capturing nothing (entry names begin so):
# those of one kernel launch, and the forwards a graph made no faster
COMPILED_DIRECT = ("FusedMLP.train_fullfused", "FusedAutoencoder.train",
                   "FusedMLP.run_fused_inference", "QuantizedMLP.run_fused",
                   "FusedMLP.run (", "QuantizedMLP w8 run",
                   "QuantizedMLP w8a8 run")
# the mnist app's routes, each one epoch of the synthetic set
COMPILED_APP_ROUTES = ((), ("--minibatch", "100"),
                       ("--minibatch", "100", "--fused"), ("--induce", "3"))
# entry points that replay an earlier entry's graph (the same compiled
# function at the same shapes): their first call captures nothing
COMPILED_SHARED = {"Network.network_gradient": "Network.net_grad",
                   "Network.induce": "Network.net_grad",
                   "RecurrentNetwork.train": "RecurrentNetwork.seq_grad",
                   "Encoder.train": "Encoder.grad",
                   "accuracy": "batched_run", "confusion": "batched_run",
                   "seq_batch_loss": "seq_losses"}


def _out_leaves(out) -> list:
    """The tensors and numbers of an entry point's result, the parameters
    (and states) of the models in it included."""
    from tensor_ops_tpu_torch.models import (Encoder, FusedAutoencoder,
                                             FusedMLP, FusedRNN, Network,
                                             RecurrentNetwork)

    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _out_leaves(o)]
    if isinstance(out, Network):
        return list(out.params)
    if isinstance(out, RecurrentNetwork):
        return list(out.states) + list(out.params)
    if isinstance(out, Encoder):
        return _out_leaves((out.encoder, out.decoder))
    if isinstance(out, FusedAutoencoder):
        return _out_leaves(out.mlp)
    if isinstance(out, FusedMLP):
        return list(out.to_params())
    if isinstance(out, FusedRNN):
        return [out.wX, out.wS, out.b, out.s0]
    return [out]


def _same_out(a, b) -> bool:
    la, lb = _out_leaves(a), _out_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor) != isinstance(y, torch.Tensor):
            return False
        if isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                return False
        elif not np.array_equal(np.asarray(x), np.asarray(y)):
            return False
    return True


def _compiled_entries(be):
    """Phase 32's entry points: (item, name, call)."""
    from tensor_ops_tpu_torch.models import (FusedMLP, FusedRNN, QuantizedMLP,
                                             cross_entropy, squared_error)
    from tensor_ops_tpu_torch.models import training as TT

    net = _flagship_net(be)
    loss = cross_entropy(FLAGSHIP[-1])
    r = np.random.default_rng(320)
    X = be.asarray(r.uniform(0, 1, size=(COMPILED_FOLD, FLAGSHIP[0])))
    labels = r.integers(0, FLAGSHIP[-1], size=COMPILED_FOLD)
    Y = be.asarray(np.eye(FLAGSHIP[-1])[labels])
    x1, y1 = X[0], Y[0]
    xb, yb = X[:COMPILED_B], Y[:COMPILED_B]
    rnet = rnn_model(be)
    rloss = squared_error(RNN_OUT)
    XS = be.asarray(r.uniform(0, 1, size=(RNN_SEQS, RNN_N, RNN_IN)))
    TS = be.asarray(r.uniform(0, 1, size=(RNN_SEQS, RNN_N, RNN_OUT)))
    xs, ts = XS[0], TS[0]
    enc, fae = _compiled_autoencoder(be)
    eloss = squared_error(AE_DIMS[0])
    fm = FusedMLP.from_network(net)
    rnns = {}
    for o in (RNN_HIDDEN, COMPILED_RNN_WIDE):
        w = np.random.default_rng(o)
        s = 1 / math.sqrt(RNN_IN + o)
        for impl in ("pallas", "xla") if o == RNN_HIDDEN else ("pallas",):
            rnns[o, impl] = FusedRNN.from_numpy(
                *(np.asarray(a, np.float32) for a in (
                    w.normal(size=(o, RNN_IN)) * s, w.normal(size=(o, o)) * s,
                    w.normal(size=o) * 0.1, w.normal(size=o) * 0.5)),
                impl=impl, device=DEVICE)
    rxs = np.asarray(r.normal(size=(RNN_N, RNN_IN)), np.float32)
    rtg = {o: np.asarray(0.3 * r.normal(size=(RNN_N, o)), np.float32)
           for o in (RNN_HIDDEN, COMPILED_RNN_WIDE)}
    qms = {mode: QuantizedMLP.from_fused(fm, mode) for mode in ("w8", "w8a8")}
    uq, xu = _uniform_int8_stack()
    out = [
        (1, "Network.run", lambda: net.run(be, x1)),
        (1, "Network.net_grad", lambda: net.net_grad(loss, be, x1, y1)),
        (1, "Network.network_gradient",
         lambda: net.network_gradient(loss, be, x1, y1)),
        (1, "Network.loss_value", lambda: net.loss_value(loss, be, x1, y1)),
        (1, "Network.induce", lambda: net.induce(loss, 0.5, be, y1, x1)),
        (1, "RecurrentNetwork.run", lambda: rnet.run(be, xs[0])),
        (1, "RecurrentNetwork.run_seq", lambda: rnet.run_seq(be, xs)),
        (1, "RecurrentNetwork.seq_grad",
         lambda: rnet.seq_grad(rloss, be, xs, ts)),
        (1, "RecurrentNetwork.seq_loss",
         lambda: rnet.seq_loss(rloss, be, xs, ts)),
        (1, "RecurrentNetwork.train",
         lambda: rnet.train(rloss, 0.01, 0.05, be, xs, ts)),
        (1, "Encoder.test_loss", lambda: enc.test_loss(eloss, be, X[1])),
        (1, "Encoder.grad", lambda: enc.grad(eloss, be, X[1])),
        (1, "Encoder.train", lambda: enc.train(eloss, 0.5, be, X[1])),
        (2, "Network.train", lambda: net.train(loss, TRAIN_RATE, be, x1,
                                               y1)),
        (3, "train_fold", lambda: TT.train_fold(net, loss, be, TRAIN_RATE,
                                                X, Y)),
        (3, "induce_many", lambda: net.induce_many(
            loss, 1.0, be, y1, X[2], COMPILED_INDUCE)),
        (4, "batched_run", lambda: TT.batched_run(net, be)(X, *net.params)),
        (4, "accuracy", lambda: TT.accuracy(net, be, X, labels)),
        (4, "confusion", lambda: TT.confusion(net, be, X, labels, 10)),
        (4, "train_minibatch", lambda: TT.train_minibatch(
            net, loss, be, TRAIN_RATE, xb, yb)),
        (4, "batch_loss", lambda: TT.batch_loss(net, loss, be, xb, yb)),
        (4, "seq_losses", lambda: TT.seq_losses(rnet, rloss, be, XS, TS)),
        (4, "seq_batch_loss", lambda: TT.seq_batch_loss(rnet, rloss, be, XS,
                                                        TS)),
        (4, "RecurrentNetwork.train_batch", lambda: rnet.train_batch(
            rloss, 0.01, 0.05, be, XS, TS)),
        (5, "FusedMLP.train", lambda: fm.train(TRAIN_RATE, xb, yb)),
        (5, "FusedMLP.train_fullfused",
         lambda: fm.train_fullfused(TRAIN_RATE, xb, yb)),
        (5, "FusedAutoencoder.train", lambda: fae.train(AE_RATE, xb)),
    ]
    for (o, impl), m in rnns.items():
        out.append((5, f"FusedRNN {RNN_IN}->{o} {impl} seq_forward",
                    lambda m=m: m.seq_forward(rxs)))
        out.append((5, f"FusedRNN {RNN_IN}->{o} {impl} train",
                    lambda m=m, o=o: m.train(0.01, 0.001, rxs, rtg[o])))
    for b in COMPILED_BUCKETS:
        xq = X[:b]
        out += [
            ("11b", f"FusedMLP.run (B={b})", lambda x=xq: fm.run(x)),
            ("11b", f"FusedMLP.run_xla (B={b})", lambda x=xq: fm.run_xla(x)),
            ("11b", f"QuantizedMLP w8 run (B={b})",
             lambda x=xq: qms["w8"].run(x)),
            ("11b", f"QuantizedMLP w8a8 run (B={b})",
             lambda x=xq: qms["w8a8"].run(x)),
            ("11b", f"FusedMLP.run_fused_inference (B={b})",
             lambda x=xq: fm.run_fused_inference(x)),
            ("11b", f"QuantizedMLP.run_fused (B={b})",
             lambda x=xu[:b]: uq.run_fused(x))]
    return out


def _compiled_autoencoder(be):
    """Phase 32's autoencoder (AE_DIMS, seed 0): the staged-IR ``Encoder``
    and its ``FusedAutoencoder``."""
    from tensor_ops_tpu_torch.backend.rng import Rng
    from tensor_ops_tpu_torch.models import (Encoder, FusedAutoencoder,
                                             act_logistic, gen_net)

    rng = Rng(be, 0)
    i, h, z = AE_DIMS[0], AE_DIMS[1], AE_DIMS[2]
    enc = Encoder(gen_net(be, i, z, [(h, act_logistic())], act_logistic(),
                          rng),
                  gen_net(be, z, i, [(h, act_logistic())], act_logistic(),
                          rng))
    return enc, FusedAutoencoder.from_encoder(enc)


def _uniform_int8_stack():
    """Phase 32's uniform int8 stack (seed 323; weights normal over the
    square root of the width) on the card and its input rows."""
    from tensor_ops_tpu_torch.models import FusedMLP, QuantizedMLP

    r = np.random.default_rng(323)
    n, L = COMPILED_STACK_N, COMPILED_STACK_L
    ws = [np.asarray(r.normal(size=(n, n)) / math.sqrt(n), np.float32)
          for _ in range(L)]
    bs = [np.asarray(0.1 * r.normal(size=n), np.float32) for _ in range(L)]
    fm = FusedMLP.from_numpy(ws, bs, ("relu",) * (L - 1) + ("identity",),
                             device=DEVICE)
    x = torch.as_tensor(np.asarray(r.uniform(0, 1, size=(
        max(COMPILED_BUCKETS), n)), np.float32), device=DEVICE)
    return QuantizedMLP.from_fused(fm, "w8a8"), x


def _call_counted(call):
    """``call()``, the hand-written launches it counted and its wall
    microseconds (host clock, the card drained before and after)."""
    from tensor_ops_tpu_torch.ops import kernels as K

    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) * 1e6
    return out, {k: v for k, v in K.launch_counts().items() if v}, us


def _compiled_checks(be) -> dict:
    """Every entry point bit-equal to its direct call at its first call (a
    capture) and at a replay, the launches each counts equal, captures only
    at the first call (exactly one for ``run_xla``); the calls that run
    direct (``COMPILED_DIRECT``) capture nothing; returns the entries by
    name and the wall microseconds of each direct call."""
    from tensor_ops_tpu_torch import engine

    entries = _compiled_entries(be)
    walls = {}
    for item, name, call in entries:
        with engine.direct():
            want, direct, walls[name] = _call_counted(call)
        c0 = engine.graph_counts()["captures"]
        first, n_first, _ = _call_counted(call)
        c1 = engine.graph_counts()["captures"]
        again, n_again, _ = _call_counted(call)
        c2 = engine.graph_counts()["captures"]
        check(_same_out(first, want) and _same_out(again, want),
              f"compiled entry points: {name} is not bit-equal to its "
              f"direct call (first call {_same_out(first, want)}, replay "
              f"{_same_out(again, want)})")
        check(n_first == direct and n_again == direct,
              f"compiled entry points: {name} counted {n_first} at its "
              f"capture and {n_again} at a replay, its direct call "
              f"{direct}")
        shared = COMPILED_SHARED.get(name)
        one = name.startswith(COMPILED_DIRECT)
        captured = (c1 == c0 if shared or one
                    else c1 == c0 + 1 if item == "11b" else c1 > c0)
        check(captured and c2 == c1,
              f"compiled entry points: {name} captured {c1 - c0} graphs at "
              f"its first call and {c2 - c1} at its second")
        log(f"[compiled] item {item} {name}: "
            + (f"replays {shared}'s graph" if shared
               else "direct: no capture" if one
               else f"{c1 - c0} capture(s)")
            + f", first call and "
            + ("second call" if one else "replay")
            + " bit-equal to the direct call; hand-written launches a call "
            + ("(direct = second call): " if one
               else "(direct = capture = replay): ")
            + (", ".join(f"{k} x{v}" for k, v in direct.items()) or "none"))
    want_kernels = {"FusedMLP.train": ("fused_linear", 3),
                    "FusedMLP.train_fullfused": ("fused_mlp_train_step", 1),
                    "FusedAutoencoder.train": ("fused_mlp_train_step", 1),
                    f"FusedRNN {RNN_IN}->{RNN_HIDDEN} pallas train":
                        ("fused_rnn_step.seq", 1),
                    f"FusedRNN {RNN_IN}->{COMPILED_RNN_WIDE} pallas train":
                        ("fused_rnn_step", RNN_N)}
    for b in COMPILED_BUCKETS:
        want_kernels.update({
            f"FusedMLP.run (B={b})": ("fused_linear", 3),
            f"QuantizedMLP w8 run (B={b})": ("fused_linear_w8", 3),
            f"QuantizedMLP w8a8 run (B={b})": ("fused_linear_w8a8", 3),
            f"FusedMLP.run_fused_inference (B={b})": ("fused_mlp_forward",
                                                      1),
            f"QuantizedMLP.run_fused (B={b})": ("fused_mlp_w8a8_forward",
                                                1)})
    by_name = {name: call for _, name, call in entries}
    for name, (kname, n) in want_kernels.items():
        _, got, _ = _call_counted(by_name[name])
        check(got.get(kname) == n, f"compiled entry points: a "
              f"{'call' if name.startswith(COMPILED_DIRECT) else 'replay'} "
              f"of {name} counted {got}, want {kname} x{n}")
    for b in COMPILED_BUCKETS:
        _, got, _ = _call_counted(by_name[f"FusedMLP.run_xla (B={b})"])
        check(not got, f"compiled entry points: a replay of FusedMLP.run_xla "
              f"(B={b}) counted {got}, want no hand-written launch")
    return by_name, walls


def _second_rates(be, by_name) -> None:
    """A new rate replays the graph of the first and gives the direct
    result at that rate."""
    from tensor_ops_tpu_torch import engine
    from tensor_ops_tpu_torch.models import FusedMLP, cross_entropy
    from tensor_ops_tpu_torch.models import training as TT

    net = _flagship_net(be, seed=1)
    fm = FusedMLP.from_network(net)
    loss = cross_entropy(FLAGSHIP[-1])
    r = np.random.default_rng(321)
    X = be.asarray(r.uniform(0, 1, size=(COMPILED_B, FLAGSHIP[0])))
    Y = be.asarray(np.eye(FLAGSHIP[-1])[r.integers(0, 10, COMPILED_B)])
    calls = {"Network.train": lambda v: net.train(loss, v, be, X[0], Y[0]),
             "train_fold": lambda v: TT.train_fold(net, loss, be, v, X, Y),
             "train_fullfused (direct, kernel 3's rate by value)":
                 lambda v: fm.train_fullfused(v, X, Y)}
    for what, call in calls.items():
        call(TRAIN_RATE)
        c0 = engine.graph_counts()["captures"]
        for v in (0.05, 0.7):
            with engine.direct():
                want = call(v)
            check(_same_out(call(v), want), f"compiled entry points: "
                  f"{what} at rate {v} is not its direct result")
        check(engine.graph_counts()["captures"] == c0, f"compiled entry "
              f"points: a new rate of {what} captured")
    log(f"[compiled] new rates (0.05, 0.7 after {TRAIN_RATE}) replay the "
        f"graph of the first (train_fullfused: no graph), each bit-equal to "
        f"its direct call: " + ", ".join(calls))
    # beside bf16 weights a rate keys the graph by its value (a 0-d float32
    # rate would be rounded to bf16 on the card)
    fm16 = fm.astype(torch.bfloat16)
    caps = []
    for v in (TRAIN_RATE, 0.05, TRAIN_RATE):
        with engine.direct():
            want = fm16.train(v, X, Y)
        c0 = engine.graph_counts()["captures"]
        check(_same_out(fm16.train(v, X, Y), want), f"compiled entry "
              f"points: bf16 FusedMLP.train at rate {v} is not its direct "
              f"result")
        check(_same_out(fm16.train(v, X, Y), want), f"compiled entry "
              f"points: a replay of bf16 FusedMLP.train at rate {v} is not "
              f"its direct result")
        caps.append(engine.graph_counts()["captures"] - c0)
    check(caps == [1, 1, 0], f"compiled entry points: bf16 FusedMLP.train "
          f"captured {caps} at rates {TRAIN_RATE}, 0.05, {TRAIN_RATE}")
    log(f"[compiled] bf16 FusedMLP.train at rates {TRAIN_RATE}, 0.05, "
        f"{TRAIN_RATE}: {caps} captures (a graph per rate's value), the "
        f"first call and a replay of each bit-equal to its direct call")


def _turns(arms: dict, calls: int, turns: int = COMPILED_TURNS) -> dict:
    """Host-clock microseconds per call of each arm, ``turns`` turns of
    ``calls`` calls each, the arms interleaved (the order reversed every
    other turn), the garbage collected before the turns, the card drained
    before and after each turn; the median of the turns."""
    ts = {a: [] for a in arms}
    names = list(arms)
    gc.collect()   # an earlier route's garbage is not these turns'
    for t in range(turns):
        for a in (names if t % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                arms[a]()
            torch.cuda.synchronize()
            ts[a].append((time.perf_counter() - t0) / calls * 1e6)
    return {a: statistics.median(v) for a, v in ts.items()}


def _compiled_timing(be, by_name, walls) -> None:
    """Each route graph against direct: wall per call (host clock,
    interleaved turns; the fold's and the induction's direct call once, in
    the checks, ``walls``), kernels, graph launches and device busy time
    per call (profiler), the idle share (1 - busy / wall).  A call that
    runs direct (``COMPILED_DIRECT``) is timed direct only."""
    from tensor_ops_tpu_torch import engine
    from tensor_ops_tpu_torch.models import FusedMLP, cross_entropy
    from tensor_ops_tpu_torch.models import training as TT

    net = _flagship_net(be)
    loss = cross_entropy(FLAGSHIP[-1])
    r = np.random.default_rng(322)
    X = be.asarray(r.uniform(0, 1, size=(COMPILED_FOLD, FLAGSHIP[0])))
    Y = be.asarray(np.eye(FLAGSHIP[-1])[r.integers(0, 10, COMPILED_FOLD)])
    Xv = be.asarray(r.uniform(0, 1, size=(COMPILED_VAL, FLAGSHIP[0])))
    small = {"fold": lambda: TT.train_fold(net, loss, be, TRAIN_RATE,
                                           X[:COMPILED_FOLD_PROFILED],
                                           Y[:COMPILED_FOLD_PROFILED]),
             "induce": lambda: net.induce_many(loss, 1.0, be, Y[0], X[1],
                                               COMPILED_INDUCE_PROFILED)}
    fm = FusedMLP.from_network(net)
    fae = _compiled_autoencoder(be)[1]
    uq, xu = _uniform_int8_stack()
    xb, yb = X[:COMPILED_B], Y[:COMPILED_B]
    # (name, call, (small run, scale) or None, calls, direct only)
    routes = [
        ("--minibatch step (train_minibatch, B=100)",
         by_name["train_minibatch"], None, COMPILED_CALLS, False),
        ("FusedMLP.train (B=100)", by_name["FusedMLP.train"], None,
         COMPILED_CALLS, False),
        ("--fused step (train_fullfused, B=100)",
         lambda: fm.train_fullfused(TRAIN_RATE, xb, yb), None,
         COMPILED_CALLS, True),
        ("Network.train (one sample)", by_name["Network.train"], None,
         COMPILED_CALLS, False),
        (f"validation (batched_run, {COMPILED_VAL} rows)",
         lambda: TT.batched_run(net, be)(Xv, *net.params), None,
         COMPILED_CALLS, False),
        (f"fold (train_fold, {COMPILED_FOLD} samples)",
         by_name["train_fold"],
         ("fold", COMPILED_FOLD // COMPILED_FOLD_PROFILED), 1, False),
        (f"--induce (induce_many, {COMPILED_INDUCE} steps)",
         by_name["induce_many"],
         ("induce", COMPILED_INDUCE // COMPILED_INDUCE_PROFILED), 1, False),
        (f"FusedRNN {RNN_IN}->{RNN_HIDDEN} pallas train (n={RNN_N})",
         by_name[f"FusedRNN {RNN_IN}->{RNN_HIDDEN} pallas train"], None,
         COMPILED_CALLS, False),
        ("FusedAutoencoder.train (B=100)", lambda: fae.train(AE_RATE, xb),
         None, COMPILED_CALLS, True),
    ]
    for b in COMPILED_BUCKETS:
        for name in COMPILED_FORWARDS:
            entry = f"{name} (B={b})"
            routes.append((entry, by_name[entry], None, COMPILED_CALLS,
                           entry.startswith(COMPILED_DIRECT)))
        routes.append((f"FusedMLP.run_fused_inference (B={b})",
                       lambda x=X[:b]: fm.run_fused_inference(x), None,
                       COMPILED_CALLS, True))
        routes.append((f"QuantizedMLP.run_fused (B={b})",
                       lambda x=xu[:b]: uq.run_fused(x), None,
                       COMPILED_CALLS, True))

    def direct(fn):
        def run():
            with engine.direct():
                return fn()
        return run

    once = {"fold": walls["train_fold"], "induce": walls["induce_many"]}
    for name, fn, scaled, calls, direct_only in routes:
        arms = ({"direct": fn} if direct_only
                else {"graph": fn, "direct": direct(fn)})
        if scaled is None:
            for arm in arms.values():
                arm()
            wall = _turns(arms, calls)
        else:
            fn()
            wall = _turns({"graph": fn}, calls)
            wall["direct"] = once[scaled[0]]
        line = []
        for a, arm in arms.items():
            if scaled is None:
                prof, k = _profile_steps(arm, steps=5, whole=True), 1
            else:
                sub = small[scaled[0]]
                prof = _profile_steps(sub if a == "graph" else direct(sub),
                                      steps=1, whole=True)
                k = scaled[1]
            busy = prof["busy_us"] * k
            line.append(
                f"{a} {wall[a]:.1f} us (kernels {prof['launches'] * k:.0f}, "
                f"graph launches {prof['graph_launches'] * k:.0f}, busy "
                f"{busy:.1f} us, idle {1 - busy / wall[a]:.3f})")
        log(f"[compiled] {name}, per call: " + "; ".join(line)
            + (f" (the direct wall from one call, in the checks; kernels, "
               f"launches and busy from a profile of 1/{scaled[1]} of the "
               f"call, times {scaled[1]})" if scaled else "")
            + (" (the call runs direct)" if direct_only else ""))


def _stack_graph_bytes() -> None:
    """``FusedMLP.run_xla``'s graph at the 4 x 4096 serving stack (f32,
    seed 324, B = STACK_B // 2): it reads the model's weights where they
    lie, so its static buffers are its input and output rows alone,
    whatever the weights' size; bit-equal to the direct call."""
    from tensor_ops_tpu_torch import engine
    from tensor_ops_tpu_torch.models import FusedMLP

    r = np.random.default_rng(324)
    n, b = STACK_N, STACK_B // 2
    fm = FusedMLP.from_numpy(
        [np.asarray(r.normal(size=(n, n)) / math.sqrt(n), np.float32)
         for _ in range(STACK_L)],
        [np.asarray(0.1 * r.normal(size=n), np.float32)
         for _ in range(STACK_L)], ("relu",) * STACK_L, device=DEVICE)
    x = torch.rand(b, n, device=DEVICE)
    with torch.inference_mode():
        with engine.direct():
            want = fm.run_xla(x)
        got = [fm.run_xla(x) for _ in range(2)]
    check(all(torch.equal(g, want) for g in got), "compiled entry points: "
          "FusedMLP.run_xla at the 4x4096 stack is not bit-equal to its "
          "direct call")
    weights = sum(t.numel() * t.element_size() for t in fm.to_params())
    static = fm._cache["fwd_xla"].static_bytes()
    rows = x.numel() * x.element_size() + want.numel() * want.element_size()
    check(static == rows, f"compiled entry points: FusedMLP.run_xla's graph "
          f"at the 4x4096 stack holds {static} static bytes, want its input "
          f"and output rows' {rows} (the weights read in place)")
    log(f"[compiled] FusedMLP.run_xla's graph at the {STACK_L}x{STACK_N} "
        f"stack, B={b}: {static} static bytes (its input and output rows; "
        f"the weights, {weights} bytes, read in place), bit-equal to its "
        f"direct call")


def compiled_main() -> None:
    """Phase 32 in its own interpreter: every compiled entry point (items
    1-5 and 11b) bit-equal to its direct call on the card, its launches
    equal, captures only on a new shape, new rates without a capture; the
    one-launch calls direct; each route graph against direct; the mnist
    app's default fold, ``--minibatch 100``, ``--fused`` and ``--induce``
    on the synthetic set; the bytes the engine's graphs hold."""
    from tensor_ops_tpu_torch import TorchBackend, engine

    torch.backends.cuda.matmul.allow_tf32 = False
    be = TorchBackend(torch.float32, DEVICE)
    engine.reset_graph_counts()
    a0, r0 = _device_bytes()
    by_name, walls = _compiled_checks(be)
    _second_rates(be, by_name)
    _compiled_timing(be, by_name, walls)
    _stack_graph_bytes()
    with tempfile.TemporaryDirectory() as tmp:
        for extra in COMPILED_APP_ROUTES:
            c0 = engine.graph_counts()
            run = run_mnist_app(tmp, list(extra))
            c1 = engine.graph_counts()
            log(f"[compiled] mnist {' '.join(extra) or '(default fold)'}: "
                f"{run['samples_per_s']:.0f} training samples/s (batches "
                f"2-6, --metrics); {c1['captures'] - c0['captures']} "
                f"captures, {c1['replays'] - c0['replays']} replays")
    a1, r1 = _device_bytes()
    pool = engine.pool_bytes(DEVICE)
    counts = engine.graph_counts()
    log(f"[compiled] the engine's graphs after every route: "
        f"{counts['captures']} captures ({counts['capture_s']:.2f} s of host "
        f"time), {counts['replays']} replays; their memory pool "
        f"{pool['reserved']} bytes reserved, {pool['allocated']} allocated; "
        f"the phase's device bytes (graphs, their static buffers and what "
        f"the phase keeps) {a1 - a0} allocated, {r1 - r0} reserved "
        f"(memory_allocated / memory_reserved after empty_cache)")


def phase_compiled() -> None:
    """Run :func:`compiled_main` (phase 32) in an interpreter of its own
    with a time limit; its lines print as they come."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.stdout.flush()
    proc = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.compiled_main()"],
        timeout=COMPILED_TIMEOUT_S, cwd=here,
        env=dict(os.environ, PYTHONPATH=here))
    check(proc.returncode == 0, f"the compiled-entry phase failed (exit "
          f"{proc.returncode})")


def timed(name: str, fn, *args):
    """``fn(*args)``, logging the phase's wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    """The whole smoke, its plan cache an empty temporary file: every plan
    of phases 1-28 is the fixed rule's whatever the home's cache holds, and
    no sweep of phase 29 can reach the home."""
    with tempfile.TemporaryDirectory() as plans:
        os.environ["TENSOR_OPS_TPU_TORCH_PLAN_CACHE"] = os.path.join(
            plans, "plans.json")
        return smoke()


def smoke() -> int:
    t_start = time.perf_counter()
    name, card = phase_environment()
    _pinned_plan_cache()
    timed("build", phase_build)
    worst = timed("kernels 1-3", phase_kernels)
    qm, weights, xs = timed("4x4096 stack on the CPU", int8_stack_cpu)
    stack = {"model": qm, "weights": weights, "x": xs}
    worst.update(timed("int8 kernels", phase_int8_kernels, stack))
    worst["fused_rnn_step"] = timed("recurrent kernel", phase_rnn_kernels)
    worst["fused_rnn_step.seq"] = timed("recurrent sequence kernel",
                                        phase_rnn_seq_kernel)
    worst.update(timed("ring kernels", phase_ring_kernels))
    timed("cross-card ring", phase_ring_cross_card)
    with tempfile.TemporaryDirectory() as tmp:
        sl = timed("serving slice", phase_slice, tmp)
        sv = timed("int8 serving", phase_int8_serving, tmp, sl["ckpt"],
                   stack)
        tr = timed("training slice", phase_train, tmp)
        rs = timed("recurrent slice", phase_rnn_slice, tmp)
        dp = timed("data-parallel slice", phase_dp_slice, tmp)
        timed("fit slice", phase_fit, tmp)
        timed("autoencoder", phase_autoencoder, tmp)
        timed("dots app", phase_dots)
    times = timed("serving timing", phase_timing, sl["model"])
    times.update(timed("int8 timing", phase_int8_timing, sv, stack))
    timed("training routes", phase_train_routes)
    rnn_times = timed("recurrent timing", phase_rnn_timing, rs)
    times["fused_rnn_step"] = rnn_times[1]
    times["fused_rnn_step.seq"] = rnn_times["seq"]
    times.update(timed("data-parallel timing", phase_dp_timing, dp))
    # the recurrent loop's phases run after every profiled phase above: run
    # before them, they left torch.profiler losing device events of the
    # int8 request's profile (the same 10-20% in two runs)
    with tempfile.TemporaryDirectory() as tmp:
        sf = timed("recurrent fit slice", phase_seq_fit, tmp)
        timed("production fit", phase_production_fit, tmp)
        timed("adam8bit fit", phase_adam8bit_fit, tmp)
    timed("recurrent fit timing", phase_seq_fit_timing, sf)
    timed("chained steps and mixed precision", phase_chained)
    with tempfile.TemporaryDirectory() as tmp:
        mesh_launches = timed("mesh (second interpreter)", phase_mesh_proc,
                              tmp)
        proc_launches = timed("several processes (own interpreter)",
                              phase_procs, tmp)
        timed("tooling (own interpreter)", phase_tooling, tmp)
        dry_launches = timed("dry run (own interpreter)", phase_dryrun, tmp)
    timed("request graphs (own interpreter)", phase_graphs)
    timed("compiled entry points (own interpreter)", phase_compiled)
    for route in ("fused", "minibatch"):
        log(f"[timing] mnist app --minibatch 100{' --fused' * (route == 'fused')}"
            f": {tr[route]['samples_per_s']:.0f} training samples/s "
            f"(host clock, batches 2-6, the app's --metrics record)")
    # each kernel's launches are those of the path it serves: the serving
    # slice for the two forward kernels, the --fused mnist run for the step,
    # the int8 serve app's route for each int8 kernel, FusedRNN over the
    # served sequences for the Elman sequence (one launch each; the step
    # kernel, the route of a cell too wide for the cluster and of the
    # per-step function, is launched 0 times there)
    launches = dict(sl["launches"])
    launches["fused_mlp_train_step"] = (
        tr["fused"]["launches"]["fused_mlp_train_step"])
    launches.update(sv["launches"])
    launches["fused_rnn_step"] = rs["step launches"]
    launches["fused_rnn_step.seq"] = rs["launches"]
    # the dp slice's DP_STEPS steps on each ring's route: the one-shot's
    # launches, and the ring protocol's (the route of ranks on several
    # cards: 0 on one card)
    for n in ("ring_all_reduce", "bidir_ring"):
        launches[n] = dp[n]["launches"]
        launches[f"{n}.ring"] = dp[n]["protocol launches"]
    # and kernel 9 on the mesh's fit and fit_sequences runs and the model
    # axis's serving and training and the pipelines (phases 23-27), and
    # process 0's in phase 28's runs across processes, and the dry run's
    # (phase 30); kernel 3 and 9 on the dp step's mesh form (phase 11), and
    # kernel 3 on the dp step of phases 28 and 30
    for n in RING_NAMES:
        launches[n] += (mesh_launches[n] + proc_launches[n]
                        + dry_launches[n])
    launches["bidir_ring"] += dp["mesh launches"]["bidir_ring"]
    launches["fused_mlp_train_step"] += (
        dp["mesh launches"]["fused_mlp_train_step"]
        + proc_launches["fused_mlp_train_step"]
        + dry_launches["fused_mlp_train_step"])
    least = bounds()
    for n in KERNELS:
        log(f"[bound] {n}: {least[n][0]:.6f} ms by {least[n][1]} (H100 SXM "
            f"peaks: {HBM_BPS / 1e12:g} TB/s, {PEAK_OPS})")
    b256 = rnn_step_bound(256)
    log(f"[bound] fused_rnn_step at B=256: {b256[0]:.6f} ms by {b256[1]}")
    # library_ms: torch.addmm for kernel 1's identity layer and
    # torch.stack(xs).sum(0) for the collectives' all-reduce; no single PyTorch
    # call computes the others with their epilogues (activation, softmax,
    # SGD update, int8 rescale, both y and act(z)), so null
    kernels = [dict(name=n, **KERNELS[n], launches=launches[n],
                    max_abs_err=worst[n], ms=times[n][0],
                    plain_ms=times[n][1], bound_ms=least[n][0],
                    bound_by=least[n][1],
                    library_ms=times[n][2] if n in (
                        "fused_linear",) + RING_NAMES else None)
               for n in KERNELS]
    log(f"[phase] the whole smoke: {time.perf_counter() - t_start:.1f} s")
    log(f"[card] every time above was taken on: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
