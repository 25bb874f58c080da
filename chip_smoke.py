#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpu_air_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs a CUDA card, ``nvcc`` and ``g++``; it imports nothing of JAX or
``tpu_air``.  Every runtime it starts runs on the port's default path: the
C++ shared-memory object arena and, where ``protoc``, the protobuf headers
and Python protobuf are installed, the GCS control-plane daemon.

Phases, each fatal on failure:

1. build    — print the native toolchain (g++, protoc, protobuf headers,
              Python protobuf) and whether the GCS daemon can be built here;
              compile every kernel of ``tpu_air_torch/ops/csrc`` (one nvcc per
              source, started together) and, beside them, the arena library
              and (where the toolchain allows) the GCS daemon into
              ``tpu_air_torch/_build/`` (a native build failure is fatal);
              print, from ``ptxas -v``, each
              kernel's registers, shared memory and spills, and the card's
              name and power limit; then, from ``cuobjdump -sass``, each
              kernel's count of tensor-core instructions (HMMA for
              ``mma.sync``, HGMMA for ``wgmma``): every ``*_mma_kernel``
              must have HMMA, every ``*_wgmma_kernel`` HGMMA, the flash
              forward and the backward's dq and dk/dv a bf16 and an f16
              wgmma instance for every head dim (and the backward no
              ``mma.sync`` kernel), no tensor-core kernel may spill, and
              ptxas may serialise no wgmma kernel's products; the bf16/f16
              decode kernel needs a bf16 and an f16 instance for every head
              dim, each with the bulk copy (``UBLKCP``) in its SASS, and no
              decode kernel may spill;
2. compare  — each T5 kernel against its plain PyTorch version on the card, at
              the generation path's shapes and at edge cases (masked rows,
              causal, ragged lengths, int8 slabs), and the decode kernel where
              it splits L into chunks (``SPLIT_CASES``: several chunks, whole
              masked chunks, live keys in one chunk, an all-pad row, L no
              multiple of the chunk, both int8 scale kinds), and at W1's
              shapes (the flash forward at the training step's, decode at
              those of generation from the W1 checkpoint, its cross step
              split into chunks), against a stated tolerance;
3. main     — FLAN-T5-base width (12+12 layers, d_model 768, 12 heads, vocab
              32128) in bf16 with weights from a numpy seed at T5's initializer
              scales: the ``T5GenerativePredictor`` generates greedily for 64
              prompts of 512 tokens (padded lengths, one all-pad row), 128 new
              tokens; every kernel's launch count is read around the first
              such run; then encode and decode-step times, and the decode
              step's device busy time from ``torch.profiler``;
4. parity   — the same model in f32 generates for a few prompts through the
              kernels and through the plain versions on the card; greedy
              tokens must agree;
5. timing   — device time (``device_ms``: CUDA events around calls queued
              behind a sleep kernel) of each T5 kernel, its plain version and
              one PyTorch library call (``scaled_dot_product_attention``) at
              the generation path's shapes (and a cross step of 8 rows of
              4096 keys, split over L, and the b 8 steps of W1 generation,
              the serve predictor and the T5 window engine), beside the
              least time the card could take (bytes over 3.35 TB/s, flops
              over 989 TFLOP/s, the H100 SXM data-sheet peaks); split
              decode calls at the LM engine's shape under the profiler, in
              bf16 and f16, must record no device work but
              ``decode_ring_kernel``, at most once a call;
6. backward — the flash backward kernels (dq, dk/dv) against
              ``flash_attention_backward_reference`` on the card: head dims
              16-128, causal or not, key masks with a fully masked row (whose
              gradients must be exactly 0), a nonzero lse cotangent, ragged L,
              f32 and bf16; then the LM training shape in f32 and bf16,
              where the forward is held against its plain version too and
              each tensor to its own norm (``NORM_TOL``);
7. lm       — ``LMTrainer.fit()`` on the 136M long-context LM (d_model 1024,
              8 layers, 8 heads of 128, vocab 32000; bf16, batch 1, 8192
              tokens, synthetic seeded tokens; its checkpoint is kept for
              phase 22): one warm-up step, then
              measured steps; launches per step (8 forward, 8 dq, 8 dk/dv),
              each step's loss, step time, tokens/s and the step's device idle
              share; (c) two more steps of the step ``LMTrainer`` runs under
              ``profile_trace(device="cuda:0")`` and ``step_timer(span_name=
              "lm.step")`` with tracing on: the Chrome trace must parse and
              name 8 forward, 8 dq and 8 dk/dv launches a step, equal to the
              launch counters (taken again when short, failing after three),
              and ``profiler.xplane_trace`` must carry its directory; once
              with the host's ops recorded and once with device activity only
              (``host_tracer_level=0``): the step's wall from ``step_timer``,
              the card's busy time from the trace, the idle share, the idle
              gaps by length and the five longest, each with the host op over
              it; the heaviest kernels and the flash kernels' device ms a
              launch come from the first trace;
8. lm parity — the same width in f32 at a cut depth and length: two train
              steps through the kernels and through the plain versions on the
              card from the same weights; losses and step-1 gradients agree;
9. lm timing — device time of the forward, dq and dk/dv kernels at the LM
              shape beside their bound, their plain versions and SDPA's
              forward and backward; the backward kernels' host time a call,
              registers and HGMMA count;
10. w1       — W1: ``T5Trainer.fit()`` fine-tunes FLAN-T5-base (full width and
              depth, dropout 0.1, bf16 compute on f32 parameters, random
              weights from numpy seed 0) for one epoch of 6 steps of 8 rows
              of 512 source and 512 label tokens, with a 16-row eval split and
              a checkpoint; per-step time and loss, tokens/s, the step's
              device busy share and heaviest kernels, peak memory; then
              ``T5GenerativePredictor.from_checkpoint(dtype="bfloat16")`` on
              the best checkpoint generates 32 tokens for 8 prompts through
              both inference kernels;
11. w1 parity — f32, full width, depth cut to 2+2 layers, dropout 0: one
              training step's loss and every parameter's gradient (the
              relative-position biases' included) through the kernels and
              through the plain versions on the card;
12. w1 timing — the flash forward at the two W1 training shapes (encoder:
              bias and key mask; decoder: causal, bias and key mask) beside
              its bound, its plain version and SDPA;
13. f16 compare — each of the four kernels in float16 (the reference's W3
              load type) against its plain version in float16, at the shapes
              of phases 2 and 6;
14. f16 timing — the four kernels in f16 at their main-path shapes beside
              their bounds, plain versions and SDPA, the bf16 kernel timed
              in turns with each;
15. batch    — W3 as the reference runs it: FLAN-T5-base width and depth,
              random weights from numpy seed 0 written in the JAX package's
              checkpoint format (params.msgpack, about 1 GB), then
              ``tpu_air_torch.init()`` and ``BatchPredictor.from_checkpoint(
              ..., dtype="float16").predict(ds, num_gpus_per_worker=1,
              batch_size=64, max_new_tokens=128)``: one scoring actor leases
              the card, generates for 64 prompts of 512 tokens (ragged, one
              all-pad row) and reports its device and launches; its outputs
              must equal the in-process predictor's row for row; wall time,
              generated tokens/s, the share of the wall outside the actor's
              predict, f16 finiteness, and how many tokens the kernel-free
              plain path in f16 matches (not asserted); the runtime's arena
              must have taken the phase's objects (live objects and sealed
              bytes grew, ``leaked_bytes`` 0) and its GCS list this host
              alive;
16. w2       — W2 as the reference runs it: ``tune.Tuner(T5Trainer(...))``
              over FLAN-T5-base (full width and depth, dropout 0.1, bf16 on
              f32 parameters, random weights from numpy seed 0 in every
              trial, W1's batch of 8 x 512/512), the reference's search space
              (lr, epochs, weight decay) under ``trainer_init_config``,
              ``ASHAScheduler(max_t=16)`` on eval_loss, seed 0; each trial
              trains in its own actor on the leased card (cut: 2 of the
              reference's 4 samples, an epoch is 2 steps, evaluation 8 rows)
              and reports, from inside the
              actor, its device (must be cuda:0), the card's free memory at
              its start and its launches (flash forward in every epoch's
              eval); the sweep's wall time and trained tokens/s; the best
              result (a checkpoint, the least finite eval_loss) generates 32
              tokens for 8 prompts in bf16 through the kernels, equal to the
              plain versions' tokens on the card;
17. w7       — W7 as the reference runs it: SegFormer at MiT-b0's published
              width (150 labels, f32, random weights from numpy seed 0 at HF's
              initializer scales) in the JAX package's checkpoint format; 64
              ragged ADE-like images (384-683 x 512-683), processor size 512,
              batches of 16, through the reference's five architectures:
              sequential in process, tasks that reload the predictor from an
              object-store reference, two actors with a ``wait`` loop,
              ``ActorPool.map_unordered`` over them, and
              ``BatchPredictor.predict(ds, batch_size=16,
              num_gpus_per_worker=1)``; each prints its wall, images/s, device
              (the card for all five) and the pixels its masks differ from the
              sequential run's (at most 0.01%; every mask its image's size);
              the sequential yardstick runs under the TF32 flags the workers
              report.  Also the forward ms of a batch of 16, the device's idle
              share over one in-process predict, peak memory;
18. w6       — W6: ``SegformerTrainer`` over MiT-b0 (dropout and drop-path
              0.1, f32, numpy seed 0), AdamW lr 1e-4, batch 8, one epoch of
              6 steps, the port's ``images_preprocessor`` (size 512,
              ``do_reduce_labels``) over 48 train and 16 eval images, one
              worker on the card: each step's time and loss, images/s, a
              profiled step's idle share and heaviest kernels, peak memory,
              eval_loss; every loss finite and the batch norm's running stats
              moved; the best checkpoint's ``SemanticSegmentationPredictor``
              predicts the 16 eval images on the card;
19. w6 parity — one f32 step at MiT-b0 width, depths cut to 1, batch 2 at
              128^2, dropout 0, TF32 off, on the card and on the CPU from the
              same weights: loss, every gradient and the running stats;
20. w8       — W8 as the reference runs it, through
              ``examples/torch_xgboost_e2e.py``'s functions: 2000 seeded
              taxi-shaped rows, ``GBDTTrainer`` (binary:logistic, 50 rounds)
              over a MinMaxScaler, ``Tuner`` with 3 samples, then
              ``serve.run(PredictorDeployment.options(name="XGBoostService",
              num_replicas=2, route_prefix="/rayair").bind(GBDTPredictor,
              best_ckpt, http_adapter=pandas_read_json))`` on the host; 64
              single-row POSTs and one POST of the 64 rows, equal to the
              in-process ``GBDTPredictor.predict``; requests/s, p50/p99
              latency;
21. serve t5 — the ``[batch]`` phase's FLAN-T5-base checkpoint in bf16
              through the serve plane, one replica leasing the card at a
              time: (a) ``PredictorDeployment`` over
              ``T5GenerativePredictor``, 8 prompts in one POST, equal to the
              in-process predictor; (b) ``EngineDeployment`` over the T5
              window engine (``max_batch=8, max_input_len=512,
              max_new_tokens=64``): 16 ragged prompts (64-512 tokens) as two
              blocking POSTs of 8, then as submit/poll streams from 4 client
              threads, every answer token-identical to greedy decoding with
              ``make_t5_prefill_fn``/``make_t5_decode_step_fn`` in process at
              the window's shape; the replica reports its device (the card),
              its launches of both kernels and the engine's TTFT and
              decode-step times; (c) f32, depth cut to 2+2: the same two
              POSTs through ``EngineDeployment`` with the kernels and with
              the plain versions in the replica give equal tokens;
22. lm serve — the ``[lm]`` phase's checkpoint (the 136M LM at full width:
              d_model 1024, 8 layers, 8 heads of 128, vocab 32000) loaded in
              bf16 and served, every 1-token step through the decode
              kernel, prefill dense as in the JAX package: (a)
              ``LMGenerativePredictor.from_checkpoint(dtype="bfloat16")``,
              16 seeded prompts x 512 tokens -> 128 new, greedy, no EOS:
              decode launches must be 8 x 127 and flash launches 0; wall,
              tokens/s, the decode step's median and p90; (b)
              ``InferenceEngine(EngineConfig(num_slots=16, slot_len=1024,
              page_len=16, max_new_tokens=64, eos_token_id=None))``, paged,
              32 prompts of 64-512 tokens (8 behind one 256-token prefix)
              as a burst and the first 4 trickled 4 in flight: the two
              runs' tokens must be identical per prompt; TTFT, decode step, tokens/s, prefix
              hits, copy-on-write copies, peak pool pages, the profiled
              decode step's idle share; (c) the slab engine, burst: tokens
              agreeing with (b) and with per-prompt offline ``generate`` of
              the first 8 prompts, printed; (d) ``EngineDeployment`` over the checkpoint, one
              replica leasing the card: 16 of the prompts as two blocking
              POSTs of 8 and as submit/poll streams from 4 client threads,
              every answer equal to (b)'s; the replica's device, launches,
              TTFT and step times; (e) f32, full width, depth cut to 2:
              offline ``generate``, the slab and the paged engine through
              the kernel and through ``decode_attention_reference``, all
              six token streams equal; (f) the decode kernel timed at the
              engine's shape (b 16, L 1024, 8 x 128, bf16, per-row mask)
              beside its bound, its plain version and SDPA.  Cuts: 32 engine
              prompts and 64 new tokens, (b)'s trickle 4 and (c)'s offline
              generate 8 of them (the phase runs in about 70 s).
23. lm live — live weights, LoRA head-delta adapters and migration on
              phase 22's checkpoint, engine configuration and prompts, bf16,
              every 1-token step through the decode kernel: (a) the paged
              engine with a bank of 4 adapter rows of rank 4 and 3 seeded
              tenants, the first 16 prompts as one burst, a quarter on each
              tenant and on the base: the base rows equal phase 22 (b)'s
              burst (the zero row is exact), each tenant changes some
              tokens; agreement with per-tenant ``offline_greedy`` on each
              tenant's first row, the
              decode step against phase 22's, the step with the banks and
              without in turns from one state, and the launches are
              printed;
              (b) ``swap_params`` to byte-identical weights mid-burst (a
              burst of the first 16 prompts) changes no token; a swap to v2 (the embedding E as 1 - E), then
              ``rollback_params``: a prompt gives phase 22's tokens again,
              and a second rollback raises; each stall printed; (c) two
              engines, each on its own copy of the checkpoint: 16 prompts
              on A, ``migrate_out`` after 8 decode steps, ``submit_migrated``
              on B: tokens equal the unmigrated run's, no prefill chunk
              runs on B; pages, bytes and ms printed; (d)
              ``EngineDeployment`` (adapter bank of 4) with
              ``attach_weights`` on a ``WeightStore`` in the run's work
              directory: v1, the serving weights, promotes through the
              exact-logit probe gate; v2, published under a
              ``weights.publish`` corrupt fault, rolls back (``/-/stats``:
              ``rollbacks`` 1); a tenant adapter promotes through the gate,
              and one POST under it equals (a)'s tokens; the replica's device
              and launches; (e) f32, full width, depth cut to 2, through the
              kernel and through ``decode_attention_reference``: mixed
              tenants equal per-tenant ``offline_greedy``, a swap, a
              rollback and a migration equal the unswapped and unmigrated
              tokens, and the exact-fingerprint canary gate passes on an
              in-process replica's ``weights_probe``.  Cuts: as phase 22's,
              (a)'s burst 16 prompts, 2 probe prompts of 64 tokens (the
              phase aims at 80 s).
24. obs serve — the observability plane over phase 22's served engine, in a
              runtime of its own: ``init(include_dashboard=True,
              dashboard_port=0)`` with ``TPU_AIR_TRACE=1`` and
              ``TPU_AIR_POSTMORTEM_DIR`` set, the default SLO monitor over
              ``dashboard.slo_source``, airwatch (``WatchConfig(seed=0,
              interval_s=0.5)``), ``EngineDeployment`` over the checkpoint in
              bf16 (phase 22's engine configuration): (a) ``serve.run``
              starts the fleet scraper; (b) phase 22's 32 prompts as
              submit/poll streams from 4 client threads, then 8 of them in
              one blocking POST, 64 new tokens, all equal to phase 22's
              burst, and so are phase 22 (d)'s 16 streams driven again and the
              POST;
              (c) every dashboard route answers 200: ``/api/engines`` totals
              equal the replica's ``stats()``, ``/metrics`` parses as
              Prometheus text with ``tpu_air_engine_*`` and
              ``tpu_air_slo_*`` families, ``/api/traces`` lists the POST's
              trace and the last 4 streams' final polls, and
              ``/api/traces/export`` of each has one event a span (the span
              ring drops the older polls), ``/api/slo`` evaluates every
              default objective,
              ``/api/watch`` counts scrapes, ``/api/tenants`` has card-seconds
              per 1k tokens above 0; (d) the autoscaler's default sources
              return the monitor's and the detector's lists, a same-weights
              ``WeightsController.promote`` passes its soak, and fails it under
              an installed SLO every request breaks; (e) the decode step of
              phase 22 (d)'s 16 streams, driven again after (b)'s 32 with the
              plane on, against phase 22's (the difference reported); then
              an actor on the
              leased card exits with status 17 and its flight record must load
              naming ``WorkerCrashed``, the actor and its card;
25. batch lane — revocable leases and the batch lane over phase 22's
              checkpoint, engine configuration and 32 prompts in bf16, in a
              runtime of its own with the dashboard and airwatch:
              ``EngineDeployment`` with 2 replicas of ``num_chips=0.5``
              sharing the card, each on it; (b) ``BatchJob`` over a
              ``Dataset`` of the prompts (4 blocks, 2 shards, 4-row chunks,
              window 8, ``best_effort``, 64 new tokens) killed by a
              ``batch.runner`` fault at its 3rd chunk commit, then resumed by
              a fresh job of the same id: every row exactly once across the
              committed chunks, a chunk resumed, each row's tokens equal to
              phase 22 (b)'s burst, the rows billed to tenant
              ``batch:chip-batch``, a ``batch.job`` span with a
              ``batch.chunk`` child per chunk; rows/s, shed and submit
              retries, the replicas' decode launches and step p50; (c) 16
              prompts as streams, replica A handed back once one of its
              streams has 8 tokens, through the lane's return path (``shrink_target``,
              ``mark_borrowed``, the ``borrow_return`` RPC with a 5 s
              notice): the preemption watcher migrates A's live streams
              into B's process, every stream equal to phase 22's, one borrow
              return, no replica spawned in A's place, no prefill chunk
              re-run on B; pages, bytes and ms a page; (d) ``/api/batch``,
              ``/metrics`` and ``/-/stats`` report the job, ``/api/objects``
              the arena and ``/api/cluster`` this host's node; the arena took
              the phase's objects with ``leaked_bytes`` 0.  Borrowing on a
              trough waits for a whole free card, so with one card it runs
              only in the CPU tests;
26. native   — the object arena and the GCS daemon under a leased card
              actor, in runtimes of their own: (a) the toolchain line; (b)
              the actor makes phase 25's payload shape on its card (one 0.5
              MiB K/V page, and 135 pages in one object; as
              ``migrate_out``'s tensors and as one byte array), copies it to
              the host and puts it; the driver gets it, moves it back to the
              card and checks it bitwise against the same seed's payload:
              through the arena (the default runtime), then through the file
              store (a second runtime whose arena is too small for either),
              ms an object and a page for each, the pins of the arena's
              values 0 once they die, no block leaked; (c) where the daemon
              builds: ``nodes()`` lists host-0 alive with 1 card, the actor
              is in the GCS actor directory on card 0 and marked dead after
              ``kill``, and the KV round-trips;
27. ring     — long-context attention split over sp ranks, at the ``[lm]``
              phase's width (B 1, H 8, D 128, global L 8192): every rank of
              a sequence held in this process, rotated in memory, through
              ``ring_attention_in_memory`` (the hops, merges and kernels of
              the point-to-point ring, which needs a card a rank): (a) bf16
              and f32, sp 2 and 4, causal and not: the output and dq, dk,
              dv (the backward of a seeded ``dO``), put together over the
              ranks, against one whole-sequence call of the kernels and
              against the plain versions on the same card tensors, each
              tensor within ``NORM_TOL`` of its norm and ``TOL`` scaled;
              (b) the forward, dq and dk/dv launches over (a) equal the
              live hops, P(P+1)/2 causal and P^2 not (a masked hop launches
              nothing); (c) bf16: each hop type alone at L/sp (the diagonal
              causal, the visible hop non-causal) through the three kernels
              beside its bound, its plain version and SDPA, and the whole
              causal ring's forward and forward + backward beside the
              whole-sequence kernels'; (d) ``LMTrainer.fit()`` with
              ``optimizer="adafactor"`` at the 136M width, sp 1, 3 one-step
              epochs of 8192 tokens: finite losses, 8 launches of each
              flash kernel a step, step ms; (e)
              ``LMTrainer(scaling_config=ScalingConfig(num_workers=1,
              sequence_parallel=2)).fit()`` raises ``check_slots``' error
              (2 cards needed, the runtime has 1 slot) before any rank
              starts, no kernel launched.  The NCCL ring between cards needs a card a
              rank, so it runs only in the CPU tests (gloo);
28. dist     — sharded and disaggregated serving over phase 22's checkpoint,
              engine configuration and 32 prompts in bf16: (a)
              ``MeshEngine`` with every shard on the one card, bursts of
              the first 16 prompts: dp 2 x tp 1 (admissions per replica
              printed) must equal the single-card engine's at 8 slots, a
              replica's rows (a row's bf16 tokens depend on the batch shape
              it rides in, not on its neighbours); tp 2 and dp 2 x tp 2,
              decode launches layers x shards x replicas a step at 4 heads
              of 128; each mesh's share of prompts equal to phase 22 (b)'s
              and the first differing positions are printed; the first
              decode step over 8 prompts: the tp meshes' f32 logits against
              the single-card bf16 engine's (printed) and against the same
              weights in f32, which must be within twice the single-card
              bf16 engine's own distance from f32;
              then f32 at 2 layers: dp 2 x tp 2 through the kernel
              and through ``decode_attention_reference`` equal the
              single-card f32 engine's streams, their first decode step's
              logits within the scaled 1e-4 of its; (b) in a runtime of its own
              (arena on, ``TPU_AIR_TRACE=1``) ``DisaggRouter`` with 2
              ``PrefillWorker`` actors on the card (each worker's device
              printed, and ``cuda``): the burst equals phase 22 (b)'s with 32
              handoffs, no fallback and no re-route; pages and bytes shipped,
              ms a handoff (``engine.kv_transfer`` spans), TTFT p50 beside
              phase 22 (b)'s, each request one trace id with its prefill in
              a worker's process; then a router whose worker 0 dies at its
              first prefill and worker 1 at its second (``prefill.worker``
              faults): a re-route, then fallbacks, every stream equal; (c)
              ``EngineDeployment`` through ``serve.run`` with
              ``disagg={"prefill_replicas": 2}`` in that runtime, then with
              ``mesh=(2, 2)`` in a runtime of 4 chip slots on the one card:
              one blocking POST of 8 prompts each, equal to (b)'s and (a)'s,
              the replica's stats empty before it and carrying
              ``topology`` (and ``disagg``) after; (d) the decode kernel at
              the meshes' shard shapes (dp 2: b 8, 8 heads; tp 2: b 16, 4
              heads; tp 4: b 16, 2 heads; L 1024, d 128) beside its bound,
              its plain version and SDPA;
29. tp       — tensor-parallel training, every shard on the one card (lease
              ids 0 and 1 wrap onto it): (a) ``LMTrainer(scaling_config=
              ScalingConfig(num_workers=1, model_parallel=2)).fit()`` at the
              ``[lm]`` phase's width, rows and type, 3 one-step epochs:
              finite losses (beside ``[lm]``'s), ``mesh_model`` 2,
              ``params_bytes_per_device`` under ``params_bytes_total``, the
              checkpoint's logical parameters, and the forward, dq and dk/dv
              launches each layers x shards x steps; the step's ms beside the
              tp 1 step's (the shards run in turn: no speedup on one card);
              then two f32 steps at ``[lm parity]``'s cut depth and length at
              tp 2 and 4 against the single-card step: losses to 1e-5
              relative, step-1 gradients to 1e-5 of their norm, launches
              layers x shards x steps; (b) ``T5Trainer`` at tp 2 on W1's
              width, rows and arguments, 3 steps (dropout: the dense path)
              timed on the device clock beside ``[w1]``'s median step,
              its eval (the flash forward per shard: its launches equal the
              attention calls x 2) and generation from its checkpoint in
              bf16; (c) the kernels at the tp 2 shard shapes: the flash
              forward, dq and dk/dv at B1 H4 L8192 D128 causal, the flash
              forward at W1's encoder shard (B8 H6 L512 D64, bias, key mask),
              each against its plain version and beside its bound and SDPA,
              and the decode kernel at the 2 x 2 mesh's shard (b 8, 4 heads,
              L 1024, d 128);
30. multihost — two emulated hosts on the one card
              (``spawn_local_cluster(2, devices_per_process=4)``: this
              process is host 0, an agent process host 1, every host's 4
              chip slots on ``cuda:0``, their gradients summed over a gloo
              group of one rank a host) under a runtime of the cluster's 8
              slots: first a line says why the GCS, and with it the
              cross-host object plane, does not run (no ``protoc``); (a)
              ``T5Trainer(scaling_config=ScalingConfig(num_workers=4,
              model_parallel=2))`` on W1's width, rows and arguments at
              per-device batch 2 (dp 4 x tp 2: each host 2 replicas of 2
              shards), 3 steps (dropout: the dense path), host 0's steps on
              the device clock, each host's gradient all-reduce (wall ms,
              bytes, backend) and its launches read through
              ``cluster.run``, then its eval (the flash forward a shard,
              replica and attention call on each host) and generation of 8
              prompts from its checkpoint on the card in bf16; the hosts'
              parameter digests (sha256) must be equal; (b) the same fit in
              f32 at depth 2+2, dropout 0, 2 steps, against one host running
              dp 4 x tp 2 in this process before the cluster starts: losses
              and eval losses to 1e-5 relative, every final parameter to
              1e-5 of its norm; (c) a ``TorchTrainer`` whose 8-slot lease a
              ``runtime.lease`` ``notice`` revokes 0.8 s after its grant:
              both hosts stop at the same report, the run shrinks to 4 slots
              on one host (in its trial actor, ``world() == (0, 1)``) and
              resumes from the retained checkpoint with ``max_failures=0``;
              (d) the flash forward at (a)'s replica shard (B 2, H 6, L
              512, D 64; bias and a source key mask, and causal with a
              label key mask) against its plain version, beside its bound
              and SDPA;
31. actors   — training in runtime actors, in a runtime of 4 chip slots on
              the one card: (a) ``Tuner(T5Trainer(scaling_config=
              ScalingConfig(num_workers=2, use_gpu=True)))`` at FLAN-T5-base
              width and depth, bf16 on f32, W1's global batch of 8 x
              512/512 over 2 ranks, W2's lr and weight decay, 2 samples
              under ASHA, epochs of 2 steps: each trial's runner leases 2
              slots and runs its attempt on 2 rank actors placed on them
              (gloo, both on ``cuda:0``), both trials at once; the ranks'
              parameter digests are equal at every report, each rank's
              eval launches the flash forward, and the best checkpoint
              generates through the kernels with tokens equal to the plain
              path's; (b) ``T5Trainer.fit()`` at that width over 2 ranks,
              rank 1 dying outright (``os._exit``) at its report 2,
              ``FailureConfig(max_failures=1)``: the retry resumes from
              report 2's checkpoint and ends, then the 4 slots are free and
              no rank's process is left; (c) one f32 step at ``[w1
              parity]``'s cut depth, dropout 0, over 2 ranks (the gradient
              all-reduce over gloo) against 1 rank at the doubled batch:
              losses within 1e-6 relative, parameters within 1e-6 in norm;
              (d) the flash forward at a rank's eval shape in (a) and (b)
              (B 4, H 12, L 512, D 64; bias and a source key mask, and
              causal with a label key mask) against its plain version,
              beside its bound and SDPA.

Every ``fit()`` runs its attempt in a trial actor of the port's runtime (a
runtime of the card's one slot that ``fit()`` starts for it, or, for the
tensor-parallel and one-host fits of phases 29 and 30, a runtime of 2 or 8
slots on the card): what its training function launched, its steps on the
device clock and its peak memory are recorded there (``actor_probe``) and
read from the run's directory.

The counts of kernel launches are set to 0 just before each main path (T5
generation, W1's generation, W2's generation, each of phase 22's and phase
23's in-process paths) and read just after it, and in the trial actor of
each ``fit()`` (LM training, W1 and W6 fine-tuning) around its training
function (the ``[lm]`` phase's traced steps are counted apart, against
their trace);
the W3 batch path's are counted in its scoring actor, a fresh process,
around the batch it scores, and W2's trials' in each trial's actor, around
its training function, and the serve replicas' in each replica (a fresh
process) over its whole life, phase 24's replica and phase 25's two too
(the returned one's read just after its notice: the watcher ends its
process after the migration), phase 27's around each ring's forward
and backward in (a) and in (d)'s trial actor, and phase 28's around each of
(a)'s engine runs, around (b)'s burst in the decode engine (this process)
and in (c)'s replicas over their lives, and phase 29's in (a)'s trial actor,
around each of its f32 steps, in (b)'s trial actor and around its
generation, and phase 30's on each host (read through the agent plane)
around (a)'s and (b)'s fits, and in this process around (a)'s generation,
and phase 31's in each rank actor of its sweep and fits, around its
training function, and in this process around (a)'s generation.  The SegFormer
phases launch none of the four kernels (no Pallas kernel lies on that path),
which W7's in-process run and W6's fit check.
The line before the last is the ``{"kernels": [...]}`` summary; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import functools
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16_FLOP_S = 989e12   # H100 SXM dense bf16 tensor cores
COLD_BYTES = 100_000_000    # slabs cycled through when timing decode: twice the 50 MB L2
# Tolerances on |kernel - plain| / max(1, |plain|).  Both compute in f32 from
# the same inputs and differ in summation order (f32: 1e-4); a bf16 output is
# one rounding of that f32 value, up to 2^-7 of it apart (bf16: 2e-2).
# An f16 output likewise, up to 2^-10 of it apart (f16: 5e-3, tighter than bf16).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 5e-3}
# At the LM shape most gradients and outputs are far below 1, where the
# max(1, |plain|) above would make TOL an absolute bound as large as the values
# themselves.  There each tensor is held to ||kernel - plain|| / ||plain||:
# f32 differs in summation order only (1e-4); each bf16 element is one
# rounding of the f32 one, at most one ulp apart, and one ulp is at most 2^-7
# of the element, so the ratio is at most 2^-7 = 7.8e-3 (1e-2); in f16 at most
# 2^-10 = 9.8e-4 (2e-3).
NORM_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2, torch.float16: 2e-3}
TAG = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
SEED = 0
# how each kernel computes its products in bf16, the type the main paths run
DESIGN = {"flash_attention": "wgmma bf16 on a TMA-fed K/V ring, producer warpgroup, persistent",
          "decode_attention": "bulk-copy K/V rings in shared memory (a copy a unit of positions, "
                              "every head), split-K merged in a thread-block cluster, one launch",
          "flash_attention_bwd_dq": "wgmma bf16 on a TMA-fed K/V ring, producer warpgroup, "
                                    "persistent",
          "flash_attention_bwd_dkv": "wgmma bf16 on a TMA-fed Q/dO ring, producer warpgroup, "
                                     "persistent"}
# main-path dials: W3 batch generation at the reference's max_new_tokens=128
BATCH, PROMPT_LEN, NEW_TOKENS = 64, 512, 128
SMALL_BATCH, RAGGED_LEN = 8, 200          # edge cases of the compare phase
# split-K cases of the decode kernel (b, L, kind): b*h = 12 or 96 blocks
# cannot fill the card, so L is cut into chunks; b = 1 "cross" is one all-pad
# row, "one_chunk" has its live keys in one chunk, b = 8 "cross" has padded
# rows whose tails are whole masked chunks, and 4133 is no multiple of a chunk
SPLIT_CASES = ((1, 4096, "cross"), (1, 4096, "one_chunk"), (8, 4096, "cross"),
               (8, 4096, "self"), (8, 4133, "cross"), (8, 4133, "int8_pos"),
               (1, 4133, "int8_chan"))
PARITY_BATCH, PARITY_NEW = 4, 32
PREDICT_REPEATS = 3                       # timed predict runs (median reported)
# LM dials: the 136M long-context LM of BASELINE.md, batch 1, 8192 tokens
LM_LEN, LM_STEPS = 8192, 4                # measured steps after one warm-up step
LM_PARITY_LAYERS, LM_PARITY_LEN = 2, 2048  # f32 parity: full width, cut depth/length
BWD_LEN, BWD_RAGGED_LEN = 128, 200        # edge cases of the backward compare
# W1 dials: FLAN-T5 fine-tuning with padding="max_length" at T5's 512-token
# model_max_length for sources and labels, per-device batch 8
W1_BATCH, W1_LEN, W1_STEPS, W1_EVAL_ROWS = 8, 512, 6, 16
W1_PROMPTS, W1_NEW = 8, 32                # generation from the trained checkpoint
W1_PARITY_LAYERS, W1_PARITY_BATCH = 2, 4  # f32 parity: full width, cut depth
# W2 dials: the reference's sweep (Model_finetuning...ipynb cc-51-59) over W1,
# trials of 1 worker under ASHA(max_t=16) on eval_loss, its search space as
# it is; cut: 2 of its 4 samples (the run's time), an epoch is 2 steps of
# W1_BATCH rows (16 rows), evaluation 8 rows
W2_SPACE = {"learning_rate": [2e-5, 2e-4, 2e-3, 2e-2], "epochs": [2, 4, 8, 16],
            "weight_decay": [0.01, 0.1, 1, 10]}
W2_SAMPLES, W2_MAX_T, W2_STEPS, W2_EVAL_ROWS = 2, 16, 2, 8
# SegFormer dials: MiT-b0 at its published width, ADE20K's 150 labels.  W7:
# the reference's batch inference (64 ragged images, processor size 512,
# batches of 16, 2 actors); W6: its fine-tuning, batch 8, one 6-step epoch
# over 48 train and 16 eval images; parity: depths cut to 1, batch 2 at 128^2
SEG_IMAGES, SEG_SIZE, SEG_BATCH, SEG_ACTORS = 64, 512, 16, 2
W6_BATCH, W6_STEPS, W6_TRAIN, W6_EVAL = 8, 6, 48, 16
W6_PARITY_BATCH, W6_PARITY_HW = 2, 128
# W8 dials: the reference's tabular arc (Introduction_to_Ray_AI_Runtime.ipynb
# cc-21-74): 2000 taxi-shaped rows, 50 boosting rounds, 3 Tune samples, then
# 64 single-row POSTs and one POST of the 64 rows to two replicas
W8_ROWS, W8_ROUNDS, W8_SAMPLES, W8_POSTS = 2000, 50, 3, 64
# serve dials: FLAN-T5-base through PredictorDeployment (8 prompts of 512
# tokens, 32 new) and through EngineDeployment's window engine (16 ragged
# prompts of 64-512 tokens, 4 client threads); parity at depth 2+2 in f32
SERVE_BATCH, SERVE_NEW = 8, 32
SERVE_CFG = {"max_batch": 8, "max_input_len": 512, "max_new_tokens": 64}
SERVE_PROMPTS, SERVE_CLIENTS, SERVE_PARITY_LAYERS = 16, 4, 2
# LM serving dials (phase 22), over the [lm] phase's 136M checkpoint in bf16:
# (a) LMGenerativePredictor, 16 prompts of 512 tokens -> 128 new, greedy, no
# EOS; (b) the paged engine, 16 slots of 1024 positions in pages of 16, 64 new
# tokens, 32 prompts of 64-512 tokens (8 behind one 256-token prefix), as a
# burst and trickled 4 in flight; (c) the slab engine, burst; (d) 16 of the
# prompts served; (e) f32 at full width, depth cut to 2: 8 prompts, 32 new
LM_GEN_PROMPTS, LM_GEN_LEN, LM_GEN_NEW = 16, 512, 128
LM_ENGINE = {"num_slots": 16, "slot_len": 1024, "page_len": 16, "max_new_tokens": 64,
             "eos_token_id": None}
LM_ENGINE_PROMPTS, LM_PREFIX_LEN, LM_PREFIX_PROMPTS, LM_TRICKLE = 32, 256, 8, 4
# depth cuts of phase 22: (b)'s trickled run takes the first 4 prompts (8
# before phase 29 was added; the burst keeps all 32, the yardstick of phases
# 23-25 and 28), (c)'s per-prompt offline generate the first 8
LM_TRICKLE_PROMPTS, LM_OFFLINE_PROMPTS = 4, 8
LM_PROMPT_LENS = (64, 512)
LM_SERVED, LM_SERVE_PARITY_LAYERS, LM_SERVE_PARITY_PROMPTS, LM_SERVE_PARITY_NEW = 16, 2, 8, 32
# LM live dials (phase 23), phase 22's checkpoint, engine and prompts: (a) 3
# tenants of rank 4 in a bank of 4 rows, a and b drawn at LM_LIVE_SCALE; (b) the
# swaps after LM_LIVE_SWAP_AT engine steps of the burst; (c) 16 prompts
# migrated after 8 decode steps; (d) 2 canary probes of 64 tokens -> 8 new
# (a depth cut: 4 before phase 28 was added)
LM_LIVE_TENANTS, LM_LIVE_RANK, LM_LIVE_SCALE, LM_LIVE_SWAP_AT = 3, 4, (1 / 32, 0.5), 24
LM_LIVE_MIGRATED, LM_LIVE_MIGRATE_AFTER, LM_LIVE_PROBES, LM_LIVE_PROBE_NEW = 16, 8, 2, 8
# depth cuts of phase 23 (a): per-tenant offline_greedy agreement (printed,
# not asserted) on each tenant's first row; the mixed-tenant burst over the
# first 16 prompts (32 before phase 29 was added; a row's tokens do not
# depend on the prompts after it at 16 slots)
LM_LIVE_OFFLINE_ROWS, LM_LIVE_ADAPTER_PROMPTS = 1, 16
# depth cut of phase 23 (b): the swap mid-burst over the first 16 prompts (all
# 32 before phase 31 was added; at 16 slots a row's tokens do not depend on
# the prompts after it)
LM_LIVE_SWAP_PROMPTS = 16
# observability dials: [lm] (c) traces LM_TRACE_STEPS train steps and prints
# the LM_TRACE_GAPS longest device-idle gaps; [obs serve]'s airwatch scrapes
# every OBS_WATCH_S seconds, its traced POST carries OBS_POST prompts, and
# the traces of the last OBS_LAST_STREAMS streams to finish must be listed
LM_TRACE_STEPS, LM_TRACE_GAPS = 2, 5
OBS_WATCH_S, OBS_POST, OBS_LAST_STREAMS = 0.5, 8, 4
# batch lane dials (phase 25), phase 22's checkpoint, engine and prompts: 2
# replicas of half the card each; (b) the 32 prompts in 4 blocks through a
# job of 2 shards, 4-row chunks and a window of 8, killed at its 3rd chunk
# commit; (c) 16 streams, replica A returned with a 5 s notice after 8 tokens
LANE_REPLICA_CHIPS, LANE_BLOCKS, LANE_SHARDS, LANE_CHUNK_ROWS, LANE_WINDOW = 0.5, 4, 2, 4, 8
LANE_KILL_AT, LANE_STREAMS, LANE_RETURN_AFTER, LANE_NOTICE_S = 3, 16, 8, 5.0
# native dials (phase 26): phase 25's migration payload shape (0.5 MiB a K/V
# page over the LM's 8 layers) as 1 page and as phase 25's 135 pages in one
# object, NATIVE_REPS round trips each; the file-store runtime's arena is
# NATIVE_SMALL_ARENA bytes, too small for either
NATIVE_PAGES, NATIVE_REPS, NATIVE_SMALL_ARENA = (1, 135), 3, 64 << 10
# sharded and disaggregated serving dials (phase 28), phase 22's checkpoint,
# engine configuration and 32 prompts: (a) MeshEngine meshes on the one card
# in bf16 (16 prefill chunks a step: tokens do not depend on the schedule),
# every burst over the first DIST_MESH_PROMPTS prompts (a depth cut: 32
# took 75-100 s of the run's 1200; fewer than 9 leave dp 2's second replica
# empty)
# and in f32 at phase 22 (e)'s cut depth; (b) the router's fault run over the
# first DIST_FAULT_PROMPTS prompts; (c) one POST of DIST_POST prompts a
# deployment; (d) the decode kernel at (label, b, h) of the meshes' shards
DIST_ENGINE = {**LM_ENGINE, "prefill_chunks_per_step": 16}
# f32 (kernel and plain) on the 2 x 2 mesh alone, whose replicas are tp 2
# meshes (a depth cut: tp 2 alone ran too before phase 30 was added)
DIST_BF16_MESHES, DIST_F32_MESHES = ((2, 1), (1, 2), (2, 2)), ((2, 2),)
DIST_FAULT_PROMPTS, DIST_POST, DIST_FIRST, DIST_MESH_PROMPTS = 6, 8, 8, 16
DIST_TIMING = (("dp 2", 8, 8), ("tp 2", 16, 4), ("tp 4", 16, 2))
# tensor-parallel training dials (phase 29): (a) the [lm] phase's LM and rows
# at tp 2, TP_LM_STEPS one-step epochs (the first a warm-up), and its f32 step
# at [lm parity]'s cut depth and length at each tp of TP_PARITY; (b) W1 at tp
# 2 for TP_W1_STEPS steps of the [w1] phase's rows, then its eval and
# generation from its checkpoint
TP_LM_STEPS, TP_PARITY, TP_W1_STEPS = 3, (2, 4), 3
# multi-host dials (phase 30): (a) W1 at dp 4 x tp 2 over 2 emulated hosts
# for TP_W1_STEPS steps of the [w1] phase's rows; (b) its f32 fit at depth
# MH_PARITY_LAYERS + MH_PARITY_LAYERS for MH_PARITY_STEPS steps
MH_PARITY_LAYERS, MH_PARITY_STEPS = 2, 2
# training in runtime actors (phase 31), in a runtime of 4 chip slots on the
# one card: (a) W2 at W1's width and global batch over 2 ranks (per-device
# W1_BATCH // 2, gloo), ACT_SAMPLES trials at once, W2's lr and weight decay,
# ACT_EPOCHS epochs of W2_STEPS steps under ASHA(max_t=ACT_EPOCHS) (a depth
# cut of W2's epochs), W2_EVAL_ROWS eval rows; (b) W1 at that width over 2
# ranks, ACT_FIT_EPOCHS one-step epochs, rank 1 dying outright at its report
# ACT_DIE_AT, one retry; (c) one f32 step at [w1 parity]'s cut depth, dropout
# 0, over 2 ranks against 1 rank at the doubled batch
ACT_SAMPLES, ACT_EPOCHS, ACT_FIT_EPOCHS, ACT_DIE_AT = 2, 2, 2, 2
T5_STEP = "tpu_air_torch.train.t5_trainer:make_t5_train_step"


def model_config():
    from tpu_air_torch.models.t5.config import T5Config

    cfg = T5Config.flan_t5_base()
    cfg.dropout_rate = 0.0
    return cfg



PR_SET_CHILD_SUBREAPER = 36


def adopt_orphans() -> bool:
    """Make this process the child subreaper of everything it starts, so a
    process whose parent exits first (a runtime worker forked by the
    forkserver) is handed to this process, not to init, and
    ``stop_processes`` can see it, stop it and reap it.  False where the
    kernel refuses."""
    libc = ctypes.CDLL(None, use_errno=True)
    return libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) == 0


def _proc_table() -> dict:
    """{pid: (ppid, state)} of every process visible in /proc."""
    table = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:  # exited while listed
            continue
        table[int(name)] = (int(fields[1]), fields[0])
    return table


def _descendants() -> set:
    table = _proc_table()
    found, frontier = set(), {os.getpid()}
    while frontier:
        frontier = {p for p, (pp, _) in table.items() if pp in frontier} - found
        found |= frontier
    return found


def _reap(pids) -> None:
    for pid in pids:
        with contextlib.suppress(ChildProcessError):
            os.waitpid(pid, os.WNOHANG)


def stop_processes(timeout_s: float = 20.0) -> None:
    """Stop and reap every process this run started: the runtime's workers,
    the multiprocessing forkserver and resource tracker (both outlive
    ``tpu_air_torch.shutdown()`` and otherwise exit only after this process
    does) and anything they left.  Raises if one survives ``SIGKILL``."""
    import multiprocessing.forkserver
    import multiprocessing.resource_tracker

    started = _descendants()
    # closing their pipes is how multiprocessing asks these two to exit;
    # _stop() does so and waits for the process
    multiprocessing.forkserver._forkserver._stop()
    multiprocessing.resource_tracker._resource_tracker._stop()
    deadline, sig = time.monotonic() + timeout_s, signal.SIGTERM
    while True:
        table = _proc_table()
        _reap(p for p, (pp, st) in table.items() if pp == os.getpid() and st == "Z")
        live = {p for p in started | _descendants() if p in table and table[p][1] != "Z"}
        if not live:
            return
        if time.monotonic() > deadline:
            if sig == signal.SIGKILL:
                raise AssertionError(f"[processes] still running after SIGKILL: {sorted(live)}")
            sig, deadline = signal.SIGKILL, time.monotonic() + timeout_s
        for pid in live:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        time.sleep(0.2)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events), after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 50) -> float:
    """Host time of one call without waiting for the device (launch cost)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return t


def cycled(calls):
    """One function that makes the next of ``calls`` at each call, in turn."""
    it = itertools.cycle(calls)
    return lambda: next(it)()


def step_times_ms(fn, n: int):
    """Device-clock time of each of ``n`` back-to-back calls of ``fn``, gaps
    waiting for the host included (CUDA events between calls)."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    events[0].record()
    for e in events[1:]:
        fn()
        e.record()
    events[-1].synchronize()
    return np.array([a.elapsed_time(b) for a, b in zip(events, events[1:])])


def device_kernels(prof, steps: int) -> dict:
    """{name: (device ms, launches) per step} of the kernels and copies in a
    profile of ``steps`` steps, without the user annotations (such as
    ``Optimizer.step``) that the profiler also lays over them on the
    device's timeline."""
    return {e.key: (e.self_device_time_total / 1e3 / steps, e.count / steps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)}


# kernel-name fragments of the classes a training step's device time splits into
KERNEL_CLASSES = (("GEMM", ("gemm", "nvjet", "xmma", "cutlass")),
                  ("softmax", ("softmax",)),
                  ("reduction", ("reduce_kernel",)),
                  ("optimizer", ("multi_tensor", "adam")),
                  ("gather/scatter", ("index", "embedding", "gather", "scatter")),
                  ("elementwise", ("elementwise",)))


def kernel_classes(kernels: dict) -> dict:
    """{class: (device ms, launches)} of {kernel name: (ms, launches)}; a
    name takes the first class one of whose fragments it holds."""
    out: dict = {}
    for name, (t, c) in kernels.items():
        cls = next((k for k, frags in KERNEL_CLASSES if any(f in name.lower() for f in frags)),
                   "other")
        ms, n = out.get(cls, (0.0, 0.0))
        out[cls] = (ms + t, n + c)
    return out


def device_busy(fn, steps: int):
    """Device time per call of ``fn`` summed over the kernels the profiler
    saw, the heaviest kernels: [(name, ms per call, launches per call)], and
    the kernels and copies per call (``complete_profile``)."""
    kernels = complete_profile(fn, steps)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    return (sum(t for t, _ in kernels.values()),
            [(name[:60], t, c) for name, (t, c) in top],
            sum(c for _, c in kernels.values()))


def needed_keys(mask, L: int):
    """Keys each batch row needs: its valid keys, or all L for an all-pad row
    (whose output is the mean of V)."""
    keys = (mask > 0).sum(dim=1).cpu()
    return torch.where(keys == 0, torch.full_like(keys, L), keys)


def complete_profile(fn, iters: int) -> dict:
    """{kernel: (device ms, launches) per call} of ``iters`` calls of ``fn``
    (after one unprofiled call), checked whole.  The profiler can lose
    kernel records: on the H100, after the W1 phases, it recorded 6 or 7 of
    10 launches of one kernel, profile after profile.  A profile in which
    some kernel's launches are not a whole number per call is taken again,
    and after three the phase fails rather than report part of the
    launches as a call's time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = device_kernels(prof, iters)
        if all(float(c).is_integer() for _, c in kernels.values()):
            return kernels
    raise AssertionError(f"the profiler recorded a partial set of launches over {iters} "
                         f"calls: {[(k[:40], c * iters) for k, (_, c) in kernels.items()]}")


SLEEP_CYCLES = 200_000_000    # about 0.1 s of the card's clock


def device_ms(fn, iters: int) -> float:
    """Device time of one call of ``fn``: CUDA events around ``iters``
    calls that the host queued while the card ran a sleep kernel, so the
    card runs them back to back and the host's dispatch, slower than a
    small kernel, adds no gaps (the profiler is not used here: it loses
    kernel records, see ``complete_profile``).  If queueing the calls took
    the host longer than the sleep, the sleep doubles and the time is taken
    again."""
    fn()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    for _ in range(4):
        slept0, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        slept0.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if host_ms < slept0.elapsed_time(start):
            return start.elapsed_time(end) / iters
        cycles *= 2
    raise AssertionError(f"the host took {host_ms:.1f} ms to queue {iters} calls, longer "
                         "than the card slept: the card would idle between them")


def bwd_kernel_calls(q, k, v, do, out, lse, scale, causal) -> dict:
    """{name: call} launching one backward kernel (dq, or dk/dv) on these
    (B, H, L, D) inputs, with delta and the outputs prepared once, so that
    ``device_ms`` times each kernel alone.  These launches are not counted."""
    from tpu_air_torch.ops import flash_attention as fa

    b, h, lq, _ = q.shape
    delta = (do.float() * out.float()).sum(-1).reshape(b * h, lq).contiguous()
    lse2 = lse.float().reshape(b * h, lq).contiguous()
    dq, dk, dv = fa._grads_like(q, lq), fa._grads_like(k, k.shape[2]), fa._grads_like(v, v.shape[2])
    return {"flash_attention_bwd_dq": partial(fa._launch_bwd, "flash_attention_bwd_dq", q, k,
                                              v, do, lse2, delta, None, (dq,), scale, causal),
            "flash_attention_bwd_dkv": partial(fa._launch_bwd, "flash_attention_bwd_dkv", q, k,
                                               v, do, lse2, delta, None, (dk, dv), scale,
                                               causal)}


def bound_ms(nbytes: float, flops: float, flop_rate: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flash_work(B: int, H: int, L: int, D: int, lens, causal: bool) -> tuple:
    """(bytes, flops) the bf16 flash forward must spend on a batch whose
    rows need ``lens`` keys (:func:`needed_keys`), with a [1, H, L, L] f32
    bias: q and out, k and v of the live keys, the bias columns some row
    reads, the key mask and the f32 lse; 4 H D flops a live (query, key)
    pair.  Causal, query i of a row of n keys sees min(i + 1, n) of them,
    and of the bias only min(i + 1, longest row) columns are read (the
    kernel skips key tiles past the diagonal); otherwise every query sees
    its row's keys and reads the bias up to the longest row."""
    lens = np.asarray(lens, dtype=np.int64)
    top = int(lens.max())
    tri = np.arange(1, L + 1)
    if causal:
        pairs = int(sum(np.minimum(tri, int(n)).sum() for n in lens))
        bias_cols = int(np.minimum(tri, top).sum())
    else:
        pairs, bias_cols = L * int(lens.sum()), L * top
    nbytes = (2 * B * H * L * D * 2 + 2 * H * D * 2 * int(lens.sum()) + H * bias_cols * 4
              + B * L * 4 + B * H * L * 4)
    return nbytes, 4 * H * D * pairs


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def scaled_err(got, want) -> float:
    want = want.float()
    return ((got.float() - want).abs() / want.abs().clamp(min=1.0)).max().item()


def norm_err(got, want) -> float:
    """||got - want|| / ||want||: the error on the tensor's own scale."""
    want = want.float()
    return ((got.float() - want).norm() / want.norm()).item()


def _demangle(sym: str) -> str:
    """``flash_bwd_dq_kernel<bf16,128>`` from an Itanium-mangled kernel name
    (a template in an anonymous namespace, as the sources declare them)."""
    import re

    rest, name = sym[2:].lstrip("N"), ""
    while rest[:1].isdigit():                     # <length><identifier>...
        n = re.match(r"\d+", rest).group(0)
        name, rest = rest[len(n):len(n) + int(n)], rest[len(n) + int(n):]
    labels, named, rest = [], "?", rest[1:] if rest.startswith("I") else ""
    while rest and rest[0] != "E":                # template arguments up to their E
        if rest[0] == "L":                        # a constant: L<type><value>E
            m = re.match(r"L[a-z](\d+)E", rest)
            if m is None:
                break
            labels.append(m.group(1))
            rest = rest[m.end():]
        elif rest[0].isdigit():                   # a named type
            n = re.match(r"\d+", rest).group(0)
            ident = rest[len(n):len(n) + int(n)]
            labels.append({"__nv_bfloat16": "bf16", "__half": "f16"}.get(ident, ident))
            named = labels[-1]
            rest = rest[len(n) + int(n):]
        elif rest[0] == "S":                      # S<id>_: a named type repeated;
            m = re.match(r"S[0-9A-Z]*_", rest)    # the sources repeat only the last
            if m is None:
                break
            labels.append(named)
            rest = rest[m.end():]
        else:                                     # a builtin type
            labels.append({"f": "f32", "a": "int8"}.get(rest[0], rest[0]))
            rest = rest[1:]
    return f"{name}<{','.join(labels)}>"


def ptxas_usage(log: str) -> list:
    """[(kernel instantiation, registers, static smem bytes, spill store
    bytes)] from an ``nvcc -Xptxas -v`` report."""
    import re

    rows = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(_Z\w+)'", line)
        if m:
            rows.append([_demangle(m.group(1)), 0, 0, 0])
        elif rows and (m := re.search(r"(\d+) bytes spill stores", line)):
            rows[-1][3] += int(m.group(1))
        elif rows and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1][1], rows[-1][2] = int(m.group(1)), int(smem.group(1)) if smem else 0
    return rows


# -- phase 1 -----------------------------------------------------------------


def mma_counts(sass: str) -> dict:
    """{kernel instantiation: {"HMMA": n, "HGMMA": m}} from the output of
    ``cuobjdump -sass``: the ``mma.sync`` and the ``wgmma`` tensor-core
    instructions of each kernel."""
    import re

    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (_Z\w+)", line)
        if m:
            fn = _demangle(m.group(1))
            counts[fn] = {"HMMA": 0, "HGMMA": 0}
        elif fn is not None and (m := re.search(r"\b(HGMMA|HMMA)\.", line)):
            counts[fn][m.group(1)] += 1
    return counts


def bulk_copy_counts(sass: str) -> dict:
    """{kernel instantiation: n} from the output of ``cuobjdump -sass``: the
    bulk copies (``cp.async.bulk`` global to shared, opcode ``UBLKCP``) in
    each kernel."""
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (_Z\w+)", line)
        if m:
            fn = _demangle(m.group(1))
            counts[fn] = 0
        elif fn is not None and re.search(r"\bUBLKCP\.", line):
            counts[fn] += 1
    return counts


# the tensor-core kernel families and the instruction each must contain
TENSOR_CORE_KINDS = (("_wgmma_kernel", "HGMMA"), ("_mma_kernel", "HMMA"))
FLASH_HEAD_DIMS = (16, 32, 64, 128)
# the wgmma kernels each source must hold a bf16 and an f16 instance of for
# every head dim
WGMMA_KERNELS = {"flash_attention": ("flash_fwd_wgmma_kernel",),
                 "flash_attention_bwd": ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel")}
# the LM step's flash kernels, as the profiler names them
LM_PROFILED_KERNELS = (("flash_attention", "flash_fwd_wgmma_kernel"),
                       ("flash_attention_bwd_dq", "flash_bwd_dq_wgmma_kernel"),
                       ("flash_attention_bwd_dkv", "flash_bwd_dkv_wgmma_kernel"))


def tensor_core_kind(fn: str):
    """("_wgmma_kernel", "HGMMA"), ("_mma_kernel", "HMMA") or None."""
    name = fn.split("<")[0]
    return next((k for k in TENSOR_CORE_KINDS if name.endswith(k[0])), None)


# the bulk-copy kernels each source must hold a bf16 and an f16 instance of
# for every head dim, each with UBLKCP and 0 spill bytes
BULK_COPY_KERNELS = {"decode_attention": ("decode_ring_kernel",)}


def check_bulk_copy_kernels(src: str, counts: dict, spills: dict) -> None:
    """Raise unless every kernel of ``BULK_COPY_KERNELS[src]`` (the bf16/f16
    decode kernel) has a bf16 and an f16 instance for every head dim, every
    instance holds the bulk copy's opcode (``UBLKCP``) in its SASS, and no
    kernel of ``src`` spills.  ``counts``: ``bulk_copy_counts``; ``spills``:
    {kernel: spill bytes}, empty when the source was built by an earlier
    run."""
    for kernel in BULK_COPY_KERNELS.get(src, ()):
        for ty in ("bf16", "f16"):
            for d in FLASH_HEAD_DIMS:
                inst = [fn for fn in counts if re.match(rf"{kernel}<{ty},{d}[,>]", fn)]
                if not inst or any(counts[fn] == 0 for fn in inst):
                    raise AssertionError(f"[build] {kernel}<{ty}, {d}>: instances {inst}, "
                                         "none may lack the bulk copy (UBLKCP)")
        spilled = [fn for fn, n in spills.items() if n]
        if spilled:
            raise AssertionError(f"[build] {src}.cu kernels that spill: {spilled}")


def check_tensor_core_kernels(src: str, counts: dict, spills: dict) -> None:
    """Raise unless every tensor-core kernel of ``src`` has its instruction
    and a bf16 and an f16 instance, none spills, and each kernel of
    ``WGMMA_KERNELS[src]`` (the flash forward; the backward's dq and dk/dv)
    has a bf16 and an f16 instance for every head dim, each with HGMMA and 0
    spill bytes; the backward keeps no ``mma.sync`` kernel.  ``spills``:
    {kernel: spill bytes}."""
    idle = [fn for fn, n in counts.items()
            if tensor_core_kind(fn) and n[tensor_core_kind(fn)[1]] == 0]
    if idle:
        raise AssertionError(f"[build] tensor-core kernels without their HMMA/HGMMA: {idle}")
    spilled = [fn for fn, n in spills.items() if tensor_core_kind(fn) and n]
    if spilled:
        raise AssertionError(f"[build] tensor-core kernels that spill: {spilled}")
    tc = [fn for fn in counts if tensor_core_kind(fn)]
    for ty in ("bf16", "f16"):
        if tc and not any(f"<{ty}," in fn for fn in tc):
            raise AssertionError(f"[build] {src}.cu has no {ty} tensor-core instance: {tc}")
    for kernel in WGMMA_KERNELS.get(src, ()):
        for ty in ("bf16", "f16"):
            for d in FLASH_HEAD_DIMS:
                inst = [fn for fn in counts
                        if re.match(rf"{kernel}<{ty},{d}[,>]", fn)]
                if not inst or any(counts[fn]["HGMMA"] == 0 or spills.get(fn, 0)
                                   for fn in inst):
                    raise AssertionError(f"[build] {kernel}<{ty}, {d}>: instances "
                                         f"{inst}, none may lack HGMMA or spill")
    if src == "flash_attention_bwd":
        left = [fn for fn in counts if tensor_core_kind(fn) == TENSOR_CORE_KINDS[1]]
        if left:
            raise AssertionError(f"[build] {src}.cu still holds mma.sync kernels: {left}")


def build() -> dict:
    """Phase 1.  Returns {kernel instantiation: {"regs", "spill", "HMMA",
    "HGMMA", "UBLKCP"}}."""
    import shutil
    import threading

    from tpu_air_torch import _native
    from tpu_air_torch.ops import _build

    tools, missing = native_toolchain()
    log(f"[native] toolchain: g++ {tools['g++']!r}, protoc {tools['protoc']!r}, protobuf "
        f"headers {tools['protobuf_headers']!r}, Python protobuf {tools['python_protobuf']!r}")
    log("[native] gcs: buildable here" if missing is None
        else f"[native] gcs: not buildable here ({missing})")
    native, native_err = {}, []

    def build_native():     # g++ beside the nvcc processes
        try:
            t = time.perf_counter()
            native["arena"] = _native.build_store()
            native["arena_s"] = time.perf_counter() - t
            if missing is None:
                t = time.perf_counter()
                native["gcs"] = _native.build_gcs()
                native["gcs_s"] = time.perf_counter() - t
        except Exception as e:  # noqa: BLE001 — raised below, after nvcc
            native_err.append(e)

    native_thread = threading.Thread(target=build_native, name="native-build")
    names = _build.sources()
    t0 = time.perf_counter()
    native_thread.start()
    try:
        logs = _build.build(names)
    finally:
        native_thread.join()
    log(f"[build] {names} built for sm_90a in {time.perf_counter() - t0:.1f} s")
    if native_err:
        raise AssertionError(f"[build] the native parts failed to build: {native_err[0]}")
    _native.load_store_lib()
    log(f"[build] native: arena library {os.path.basename(native['arena'])} "
        f"({native['arena_s']:.1f} s, loaded); GCS daemon "
        + (f"{os.path.basename(native['gcs'])} ({native['gcs_s']:.1f} s)" if missing is None
           else f"not built ({missing})")
        + f", both in {os.path.relpath(_native.BUILD_DIR)}")
    spills, built, serialised = {}, {}, []
    for src, report in sorted(logs.items()):    # registers, static smem, spill stores
        usage = ptxas_usage(report)
        log(f"[build] ptxas {src}.cu: " + "; ".join(
            f"{fn} {regs} regs {smem} B smem {spill} B spill" for fn, regs, smem, spill in usage))
        for line in report.splitlines():         # e.g. wgmma serialised by ptxas
            if line.startswith("ptxas warning") or "Performance Loss" in line:
                log(f"[build] {src}.cu: {line.strip()}")
                if "Performance Loss" in line and "wgmma" in line:
                    serialised.append(line.strip())
        spills.update({fn: spill for fn, _, _, spill in usage})
        built.update({fn: {"regs": regs, "spill": spill} for fn, regs, _, spill in usage})
    if serialised:
        raise AssertionError(f"[build] ptxas serialised wgmma products: {serialised}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(cuobjdump):
        raise AssertionError("[build] cuobjdump not found: HMMA/HGMMA counts not read")
    for src in names:
        sass = subprocess.run([cuobjdump, "-sass", _build._lib_path(src)], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        counts, bulk = mma_counts(sass), bulk_copy_counts(sass)
        log(f"[build] tensor-core and bulk-copy instructions in {src}.cu (cuobjdump -sass): "
            + "; ".join(f"{fn} HMMA {n['HMMA']} HGMMA {n['HGMMA']} UBLKCP {bulk[fn]}"
                        for fn, n in sorted(counts.items())))
        src_spills = {fn: n for fn, n in spills.items() if fn in counts} if src in logs else {}
        check_tensor_core_kernels(src, counts, src_spills)
        check_bulk_copy_kernels(src, bulk, src_spills)
        for fn, n in counts.items():
            built.setdefault(fn, {}).update(n, UBLKCP=bulk[fn])
    return built


# -- phase 2 -----------------------------------------------------------------


def flash_inputs(rng, b, h, L, d, dtype, dev, bias=True, mask=True):
    def t(shape, dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dt)

    # the model's layout: [b, L, h, d] projections seen as (b, h, L, d) views
    q, k, v = (t((b, L, h, d)).transpose(1, 2) for _ in range(3))
    bias_t = t((1, h, L, L), torch.float32) if bias else None
    mask_t = None
    if mask:
        lens = rng.integers(L // 8, L + 1, b)
        lens[0], lens[-1] = L, 0                    # one full row, one all-pad
        mask_t = torch.from_numpy((np.arange(L)[None] < lens[:, None]).astype(np.float32)).to(dev)
    return q, k, v, bias_t, mask_t


def flash_plain(q, k, v, bias, mask, causal=False):
    from tpu_air_torch.ops.flash_attention import flash_attention_reference

    b, h, lq, d = q.shape
    flat = [x.reshape(b * h, x.shape[2], d) for x in (q, k, v)]
    b3 = None if bias is None else bias[0]
    return flash_attention_reference(*flat, b3, mask, 1.0, causal)[0].reshape(b, h, lq, d)


def decode_inputs(rng, b, L, h, d, dtype, dev, kind):
    def t(shape, dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dt)

    q = t((b, 1, h, d))
    kw = {}
    if kind.startswith("int8"):
        k = torch.from_numpy(rng.integers(-127, 128, (b, L, h * d), dtype=np.int8)).to(dev)
        v = torch.from_numpy(rng.integers(-127, 128, (b, L, h * d), dtype=np.int8)).to(dev)
        shape = (b, L, h) if kind == "int8_pos" else (b, 1, h * d)
        kw["k_scale"] = torch.from_numpy(rng.uniform(1e-3, 2e-2, shape).astype(np.float32)).to(dev)
        kw["v_scale"] = torch.from_numpy(rng.uniform(1e-3, 2e-2, shape).astype(np.float32)).to(dev)
    else:
        k, v = t((b, L, h * d)), t((b, L, h * d))
    if kind in ("self", "int8_pos"):
        # the decode self step: position bias plus the causal row at -1e9
        pos = L // 2
        causal = np.where(np.arange(L) <= pos, 0.0, -1e9).astype(np.float32)
        kw["bias"] = (t((h, L), torch.float32) + torch.from_numpy(causal).to(dev)).contiguous()
    if kind in ("cross", "int8_chan"):
        lens = rng.integers(L // 8, L + 1, b)
        lens[0], lens[-1] = L, 0
        kw["kv_mask"] = torch.from_numpy((np.arange(L)[None] < lens[:, None]).astype(np.float32)).to(dev)
    if kind == "one_chunk":   # live keys inside the fourth chunk only
        c = decode_chunk(b, h, d, L, dtype, dev)
        m = np.zeros((b, L), np.float32)
        m[:, 3 * c + 5:3 * c + 60] = 1.0
        kw["kv_mask"] = torch.from_numpy(m).to(dev)
    return q, k, v, kw


def w1_flash_inputs(rng, cfg, dev) -> dict:
    """Flash inputs at the W1 training shapes (B 8, L 512, bf16): the
    encoder's self-attention (bias [1, H, L, L], ragged source key mask)
    and the decoder's (causal, bias, label key mask that always admits the
    start position).  {part: (q, k, v, bias, mask, causal)}"""
    B, H, L, D = W1_BATCH, cfg.num_heads, W1_LEN, cfg.d_kv
    q, k, v, bias, mask = flash_inputs(rng, B, H, L, D, torch.bfloat16, dev)
    out = {"encoder": (q, k, v, bias, mask, False)}
    q, k, v, bias, _ = flash_inputs(rng, B, H, L, D, torch.bfloat16, dev, mask=False)
    lens = rng.integers(16, 129, B)
    lens[0] = L
    dec = torch.from_numpy((np.arange(L)[None] < lens[:, None]).astype(np.float32)).to(dev)
    out["decoder"] = (q, k, v, bias, dec, True)
    return out


def decode_chunk(b, h, d, L, dtype, dev, masked: bool = True) -> int:
    """The positions per block the decode kernel takes at this shape."""
    from tpu_air_torch.ops.decode_attention import plan_chunk

    return plan_chunk(b, h, d, L, dtype, torch.cuda.get_device_properties(dev).multi_processor_count,
                      masked)


def compare(dev, dtypes=(torch.float32, torch.bfloat16), phase: str = "compare") -> dict:
    """The T5 kernels against their plain versions in ``dtypes`` (the
    ``[f16 compare]`` phase passes float16); the W1 shapes in bf16 only."""
    from tpu_air_torch.ops.decode_attention import decode_attention, decode_attention_reference
    from tpu_air_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(SEED)
    cfg = model_config()
    B, H, L, D, SB = BATCH, cfg.num_heads, PROMPT_LEN, cfg.d_kv, SMALL_BATCH
    errs = {}

    def check(name, got, want, dtype):
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"[{phase}] {name}: non-finite output")
        err, rel = max_err(got, want), scaled_err(got, want)
        log(f"[{phase}] {name}: max abs err {err:.3e}, scaled {rel:.3e} "
            f"(tol {TOL[dtype]:.0e})")
        if not rel < TOL[dtype]:
            raise AssertionError(f"[{phase}] {name}: {rel} >= {TOL[dtype]}")
        errs[name] = err

    # kernel 1 at the encoder shape: batch-shared bias, padded key mask with
    # a fully-masked row, scale 1.0; then no bias, causal, ragged L
    for dtype in dtypes:
        tag = TAG[dtype]
        q, k, v, bias, mask = flash_inputs(rng, B, H, L, D, dtype, dev)
        check(f"flash {tag} encoder bias+mask",
              flash_attention(q, k, v, bias, kv_mask=mask, scale=1.0),
              flash_plain(q, k, v, bias, mask), dtype)
        q, k, v, _, mask = flash_inputs(rng, SB, H, L, D, dtype, dev, bias=False)
        check(f"flash {tag} B{SB} no bias", flash_attention(q, k, v, kv_mask=mask, scale=1.0),
              flash_plain(q, k, v, None, mask), dtype)
        q, k, v, bias, _ = flash_inputs(rng, SB, H, L, D, dtype, dev, mask=False)
        check(f"flash {tag} B{SB} causal",
              flash_attention(q, k, v, bias, scale=1.0, causal=True),
              flash_plain(q, k, v, bias, None, causal=True), dtype)
        q, k, v, bias, mask = flash_inputs(rng, SB, H, RAGGED_LEN, D, dtype, dev)
        check(f"flash {tag} B{SB} L{RAGGED_LEN} ragged bias+mask",
              flash_attention(q, k, v, bias, kv_mask=mask, scale=1.0),
              flash_plain(q, k, v, bias, mask), dtype)

    # kernel 1 at the W1 training shapes, in the type W1 computes in
    if torch.bfloat16 in dtypes:
        for part, (q, k, v, bias, mask, causal) in w1_flash_inputs(rng, cfg, dev).items():
            check(f"flash bf16 W1 {part}", flash_attention(q, k, v, bias, kv_mask=mask,
                                                           scale=1.0, causal=causal),
                  flash_plain(q, k, v, bias, mask, causal=causal), torch.bfloat16)
    del q, k, v, bias, mask

    # kernel 2 at the decode step shapes: self (L = 128 + 1, bias with the
    # causal row) and cross (L = 512, key mask), full-width and int8
    for dtype in dtypes:
        tag = TAG[dtype]
        for kind, Lk in (("self", NEW_TOKENS + 1), ("cross", L),
                         ("int8_pos", NEW_TOKENS + 1), ("int8_chan", L)):
            q, k, v, kw = decode_inputs(rng, B, Lk, H, D, dtype, dev, kind)
            check(f"decode {tag} {kind}", decode_attention(q, k, v, **kw),
                  decode_attention_reference(q, k, v, **kw), dtype)
        # and where it splits L into chunks
        for b, Lk, kind in SPLIT_CASES:
            q, k, v, kw = decode_inputs(rng, b, Lk, H, D, dtype, dev, kind)
            chunks = -(-Lk // decode_chunk(b, H, D, Lk, dtype, dev, "kv_mask" in kw))
            if chunks < 2:
                raise AssertionError(f"[{phase}] decode b{b} L{Lk}: {chunks} chunk, no split")
            check(f"decode {tag} {kind} b{b} L{Lk} ({chunks} chunks)",
                  decode_attention(q, k, v, **kw), decode_attention_reference(q, k, v, **kw),
                  dtype)
        # and at the shapes of generation from the W1 checkpoint: self over
        # W1_NEW + 1 positions, cross over the W1 prompts' own padded mask,
        # which b 8 x h 12 splits into chunks
        q, k, v, kw = decode_inputs(rng, W1_PROMPTS, W1_NEW + 1, H, D, dtype, dev, "self")
        check(f"decode {tag} self b{W1_PROMPTS} L{W1_NEW + 1} (W1)",
              decode_attention(q, k, v, **kw), decode_attention_reference(q, k, v, **kw), dtype)
        q, k, v, _ = decode_inputs(rng, W1_PROMPTS, W1_LEN, H, D, dtype, dev, "none")
        _, m = prompts(W1_PROMPTS, W1_LEN, cfg.vocab_size, SEED + 42)
        kw = {"kv_mask": torch.from_numpy(m.astype(np.float32)).to(dev)}
        chunks = -(-W1_LEN // decode_chunk(W1_PROMPTS, H, D, W1_LEN, dtype, dev))
        if chunks < 2:
            raise AssertionError(f"[{phase}] decode b{W1_PROMPTS} L{W1_LEN}: {chunks} chunk, "
                                 f"W1 generation splits its cross step")
        check(f"decode {tag} cross b{W1_PROMPTS} L{W1_LEN} ({chunks} chunks, W1)",
              decode_attention(q, k, v, **kw), decode_attention_reference(q, k, v, **kw), dtype)
        del q, k, v, kw
        torch.cuda.empty_cache()
    return errs


# -- phases 3 and 4 ------------------------------------------------------------


def base_model(dtype: str, dev):
    """The W3 model, its weights cast to ``dtype`` once, as an inference load
    casts them."""
    from tpu_air_torch.models.t5.modeling import T5ForConditionalGeneration, torch_dtype

    cfg = model_config()
    cfg.dtype = dtype
    return T5ForConditionalGeneration(cfg, device=dev).init_weights(SEED).to(torch_dtype(dtype))


def prompts(n: int, L: int, vocab: int, seed: int):
    rng = np.random.default_rng(seed)
    lens = rng.integers(L // 4, L + 1, n)
    lens[0] = L
    lens[-1] = 0                                    # one all-pad row
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int64)
    ids = rng.integers(2, vocab, (n, L)) * mask
    return ids, mask


def main_path(dev) -> dict:
    from tpu_air_torch.models.t5.generate import init_cache
    from tpu_air_torch.ops.decode_attention import decode_attention
    from tpu_air_torch.ops.flash_attention import flash_attention
    from tpu_air_torch.predict.predictors import T5GenerativePredictor

    t0 = time.perf_counter()
    model = base_model("bfloat16", dev)
    cfg = model.config
    log(f"[main] {cfg.d_model} wide, {cfg.num_layers}+{cfg.num_decoder_layers} layers, bf16, "
        f"{sum(p.numel() for p in model.parameters())} "
        f"params from numpy seed {SEED}, built in {time.perf_counter() - t0:.1f} s")
    predictor = T5GenerativePredictor(model)
    n, L, new = BATCH, PROMPT_LEN, NEW_TOKENS
    ids, mask = prompts(n, L, cfg.vocab_size, SEED + 1)
    batch = {"input_ids": ids, "attention_mask": mask}
    predictor.predict(batch, max_new_tokens=2)      # warm-up at the same shapes

    flash_attention.launches = 0
    decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = predictor.predict(batch, max_new_tokens=new)
    walls = [time.perf_counter() - t0]
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    for _ in range(PREDICT_REPEATS - 1):         # more samples of the wall time
        t0 = time.perf_counter()
        again = predictor.predict(batch, max_new_tokens=new)
        walls.append(time.perf_counter() - t0)
        if list(again["generated_output"]) != list(out["generated_output"]):
            raise AssertionError("[main] greedy outputs changed between runs")
    wall = float(np.median(walls))

    rows = [np.array(s.split(), dtype=np.int64) for s in out["generated_output"]]
    toks = np.stack(rows)
    if toks.shape != (n, new):
        raise AssertionError(f"[main] generated {toks.shape}, expected {(n, new)}")
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError("[main] token ids out of the vocabulary")
    if (toks[-1] != cfg.pad_token_id).any():
        raise AssertionError("[main] the all-pad row did not stay finished")
    emitted = 0
    for row in toks[:-1]:
        eos = np.flatnonzero(row == cfg.eos_token_id)
        emitted += int(eos[0]) + 1 if eos.size else new
    steps = launches["decode_attention"] // (2 * cfg.num_decoder_layers)
    log(f"[main] predict: {n} prompts x {L} tokens -> {new} new tokens, median of "
        f"{len(walls)} runs {wall:.3f} s (runs {', '.join(f'{w:.3f}' for w in walls)}), "
        f"{emitted / wall:.1f} generated tokens/s, {steps} decode steps")
    log(f"[main] launches: {launches} (expect flash = {cfg.num_layers} per generate, "
        f"decode = 2 x {cfg.num_decoder_layers} per step)")
    if launches["flash_attention"] != cfg.num_layers:
        raise AssertionError(f"[main] flash launches {launches['flash_attention']}")
    if launches["decode_attention"] <= 0 or \
            launches["decode_attention"] != steps * 2 * cfg.num_decoder_layers:
        raise AssertionError(f"[main] decode launches {launches['decode_attention']}")

    # phase times through the model's own entry points (not counted above)
    tids = torch.from_numpy(ids).to(dev)
    tmask = torch.from_numpy(mask).to(dev)
    with torch.no_grad():
        enc_ms = time_ms(lambda: model.encode(tids, tmask), iters=5, warmup=1)
        enc = model.encode(tids, tmask)
        cache = init_cache(model, n, new + 1, enc, tmask)
        tok = torch.zeros(n, 1, dtype=torch.long, device=dev)
        model.decode(tok, cache=cache)                   # warm-up step
        steps_ms = step_times_ms(lambda: model.decode(tok, cache=cache), new - 1)
        step_ms, step_p90 = float(np.median(steps_ms)), float(np.percentile(steps_ms, 90))
        cache = init_cache(model, n, new + 1, enc, tmask)
        busy_ms, top, step_kernels = device_busy(lambda: model.decode(tok, cache=cache),
                                                 steps=8)
    log(f"[main] encode {enc_ms:.3f} ms; decode step median {step_ms:.3f} ms, p90 "
        f"{step_p90:.3f} ms over {new - 1} steps (b={n}, cache L={new + 1}, "
        f"encoder L={L})")
    log(f"[main] decode step device busy {busy_ms:.3f} ms of {step_ms:.3f} ms "
        f"(median; idle share {1 - busy_ms / step_ms:.3f}), {step_kernels:g} kernels a step; "
        "heaviest kernels per step: "
        + "; ".join(f"{k} {t:.3f} ms x{c:g}" for k, t, c in top))
    del model, predictor, cache, enc
    torch.cuda.empty_cache()
    return {"launches": launches, "tokens_per_s": emitted / wall, "encode_ms": enc_ms,
            "decode_step_ms": step_ms, "decode_step_p90_ms": step_p90,
            "decode_step_device_busy_ms": busy_ms, "decode_step_kernels": step_kernels,
            "wall_s": wall, "wall_s_runs": walls, "steps": steps}


@contextlib.contextmanager
def plain_attention():
    """Route the model's attention through the plain versions, on the card,
    for the duration (the port itself always launches the kernels there)."""
    from tpu_air_torch.models.t5 import modeling
    from tpu_air_torch.ops.decode_attention import decode_attention_reference

    def flash(q, k, v, bias=None, *, kv_mask=None, scale=None, causal=False):
        return flash_plain(q, k, v, bias, kv_mask, causal)

    saved = modeling.flash_attention, modeling.decode_attention
    modeling.flash_attention, modeling.decode_attention = flash, decode_attention_reference
    try:
        yield
    finally:
        modeling.flash_attention, modeling.decode_attention = saved


def kernel_vs_plain(model, ids, mask, dev):
    """Greedy tokens and encoder output through the kernels, then through the
    plain versions, on the card."""
    from tpu_air_torch.models.t5.generate import generate
    from tpu_air_torch.ops.decode_attention import decode_attention
    from tpu_air_torch.ops.flash_attention import flash_attention

    tids, tmask = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
    out = {}
    for path in ("kernel", "plain"):
        ctx = plain_attention() if path == "plain" else contextlib.nullcontext()
        with ctx, torch.no_grad():
            before = flash_attention.launches, decode_attention.launches
            toks = generate(model, ids, mask, max_new_tokens=PARITY_NEW).cpu()
            enc = model.encode(tids, tmask)
            launched = (flash_attention.launches, decode_attention.launches) != before
        if launched != (path == "kernel"):
            raise AssertionError(f"[parity] the {path} path launched kernels: {launched}")
        out[path] = toks, enc
    live = torch.from_numpy(mask.sum(1) > 0).to(dev)
    enc_err = max_err(out["kernel"][1][live], out["plain"][1][live])
    return out["kernel"][0], out["plain"][0], enc_err


def parity(dev) -> dict:
    model = base_model("float32", dev)
    ids, mask = prompts(PARITY_BATCH, PROMPT_LEN, model.config.vocab_size, SEED + 2)
    kernel, plain, enc_err = kernel_vs_plain(model, ids, mask, dev)
    same = bool((kernel == plain).all())
    log(f"[parity] f32, {PARITY_BATCH} prompts x {PROMPT_LEN}, {PARITY_NEW} new tokens: "
        f"greedy tokens identical = {same}; encoder output max abs err {enc_err:.3e}")
    if not same:
        raise AssertionError(f"[parity] tokens differ:\n{kernel}\n{plain}")
    # f32 order differences over 12 layers; the encoder outputs are O(1)
    if not enc_err < 1e-4:
        raise AssertionError(f"[parity] encoder outputs differ by {enc_err}")
    del model
    torch.cuda.empty_cache()
    return {"tokens_identical": same, "encoder_max_abs_err": enc_err}


# -- phase 5 -----------------------------------------------------------------


def decode_one_kernel(dev, calls: int = 10) -> dict:
    """Calls of the decode kernel at the LM engine's shape (b 16, L 1024, 8
    heads of 128, per-row mask; split over L, a cluster a row) under the
    profiler, in bf16 and in f16: the only device work recorded must be
    ``decode_ring_kernel``, at most once a call (no merge kernel, no
    workspace, no copy).  The profiler can drop records of cluster launches
    (on the H100 it kept 1 of 3), so the count is bounded, not matched.
    These launches are not counted."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_air_torch.ops.decode_attention import decode_attention

    b, L, h, d = LM_ENGINE["num_slots"], LM_ENGINE["slot_len"], 8, 128
    rng = np.random.default_rng(SEED + 44)
    pos = rng.integers(L // 16, L, b)
    pos[0] = 0
    mask = torch.from_numpy((np.arange(L)[None] <= pos[:, None]).astype(np.float32)).to(dev)
    out = {}
    for dt in (torch.bfloat16, torch.float16):
        q, k, v, _ = decode_inputs(rng, b, L, h, d, dt, dev, "plain")
        chunks = -(-L // decode_chunk(b, h, d, L, dt, dev))
        before = decode_attention.launches
        decode_attention(q, k, v, kv_mask=mask)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                decode_attention(q, k, v, kv_mask=mask)
            torch.cuda.synchronize()
        decode_attention.launches = before
        names = [(name[:80], c * calls) for name, (_, c) in device_kernels(prof, calls).items()]
        log(f"[timing] decode_attention {TAG[dt]} at the LM engine's shape, {chunks} chunks a "
            f"row, {calls} calls profiled: device records {names}")
        if chunks < 2 or len(names) != 1 or "decode_ring_kernel" not in names[0][0] \
                or not 1 <= names[0][1] <= calls:
            raise AssertionError(f"[timing] decode_attention {TAG[dt]} split over {chunks} "
                                 f"chunks: device records over {calls} calls {names}, expect "
                                 "decode_ring_kernel alone, at most once a call")
        out[TAG[dt]] = {"chunks": chunks, "calls": calls, "device_records": names}
    return out


def timing(dev, errs: dict, launches: dict) -> list:
    from tpu_air_torch.ops.decode_attention import decode_attention, decode_attention_reference
    from tpu_air_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(SEED + 3)
    dt = torch.bfloat16
    cfg = model_config()
    B, H, L, D = BATCH, cfg.num_heads, PROMPT_LEN, cfg.d_kv
    q, k, v, bias, mask = flash_inputs(rng, B, H, L, D, dt, dev)
    # library yardstick: one SDPA call with the same function as an additive
    # float mask (bias + key mask, built outside the timed region)
    lib_mask = (bias + ((1.0 - mask) * -1e30)[:, None, None, :]).to(dt)
    f_kernel = lambda: flash_attention(q, k, v, bias, kv_mask=mask, scale=1.0)  # noqa: E731
    f_plain = lambda: flash_plain(q, k, v, bias, mask)  # noqa: E731
    f_lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask, scale=1.0)  # noqa: E731
    # Work this run's data needs: keys of a padded row past its length carry
    # weight 0 and need no bytes or flops (an all-pad row needs all of V for
    # its mean); the batch-shared bias is needed up to the longest row.
    keys = needed_keys(mask, L)
    nbytes = (2 * B * H * L * D * 2 + 2 * H * D * 2 * int(keys.sum())
              + H * L * int(keys.max()) * 4 + B * L * 4 + B * H * L * 4)
    flops = 4 * H * L * D * int(keys.sum())
    b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16_FLOP_S)
    flash_row = {
        "name": "flash_attention", "route": "cuda", "design": DESIGN["flash_attention"],
        "source": "tpu_air_torch/ops/csrc/flash_attention.cu",
        "replaces": "tpu_air/ops/flash_attention.py:59",
        "launches": launches["flash_attention"],
        "max_abs_err": errs["flash bf16 encoder bias+mask"], "tol": TOL[dt],
        "ms": device_ms(f_kernel, 10), "plain_ms": device_ms(f_plain, 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": device_ms(f_lib, 10),
        "back_to_back_ms": time_ms(f_kernel, 10),
        "host_us_per_call": host_us(f_kernel, 10),
        "shape": f"B{B} H{H} L{L} D{D} bf16, bias [1,H,L,L] f32, key mask",
        "bytes": nbytes, "flops": flops,
    }
    del q, k, v, bias, mask, lib_mask
    torch.cuda.empty_cache()

    rows = {}
    # the two decode steps of the main path, and a cross step split over L.
    # Each call reads another copy of the inputs, COLD_BYTES of slabs or more
    # in all, so that the slabs come from device memory as in the decode
    # loop, where every layer reads its own cache (back to back on one copy,
    # a slab that fits the 50 MB L2, as the self step's does, is read from
    # there: "warm_ms", kept for comparison with earlier timings).
    # the b 8 steps: generation from the W1 checkpoint and the serve
    # predictor (self over 32 + 1 positions, cross over 512) and the T5
    # window engine (self over 64 + 1)
    for key, b, kind, Lk in (("cross", B, "cross", L), ("self", B, "self", NEW_TOKENS + 1),
                             ("split", SMALL_BATCH, "cross", 4096),
                             ("b8_cross", SMALL_BATCH, "cross", L),
                             ("b8_self33", SMALL_BATCH, "self", W1_NEW + 1),
                             ("b8_self65", SMALL_BATCH, "self", SERVE_CFG["max_new_tokens"] + 1)):
        h, d = H, D
        copies = max(2, -(-COLD_BYTES // (2 * b * Lk * h * d * 2)))
        sets = [decode_inputs(rng, b, Lk, h, d, dt, dev, kind) for _ in range(copies)]
        kernels_, plains, libs = [], [], []
        for q_, k_, v_, kw_ in sets:
            q4 = q_.transpose(1, 2)                             # [b, h, 1, d]
            k4 = k_.view(b, Lk, h, d).transpose(1, 2)
            v4 = v_.view(b, Lk, h, d).transpose(1, 2)
            if kind == "cross":
                lib_mask = torch.where(kw_["kv_mask"] > 0, 0.0, -1e20)[:, None, None, :].to(dt)
            else:
                lib_mask = kw_["bias"][None, :, None, :].to(dt)
            kernels_.append(partial(decode_attention, q_, k_, v_, **kw_))
            plains.append(partial(decode_attention_reference, q_, k_, v_, **kw_))
            libs.append(partial(F.scaled_dot_product_attention, q4, k4, v4, attn_mask=lib_mask,
                                scale=1.0))
        f_kernel, f_plain, f_lib = cycled(kernels_), cycled(plains), cycled(libs)
        q, k, v, kw = sets[0]
        if kind == "cross":
            keys = needed_keys(kw["kv_mask"], Lk)
            extra = b * Lk * 4                                  # the key mask
        else:   # keys after the query position carry weight 0
            keys = torch.full((b,), int((kw["bias"][0] > -1e8).sum()))
            extra = h * int(keys[0]) * 4                        # the bias row
        nbytes = 2 * h * d * 2 * int(keys.sum()) + 2 * b * h * d * 2 + extra
        flops = 4 * h * d * int(keys.sum())
        b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16_FLOP_S)
        chunks = -(-Lk // decode_chunk(b, h, d, Lk, dt, dev, kind == "cross"))
        rows[key] = {
            "max_abs_err": errs[f"decode bf16 {kind}"] if key in ("cross", "self")
            else max_err(kernels_[0](), plains[0]()), "tol": TOL[dt],
            "ms": device_ms(f_kernel, 200), "plain_ms": device_ms(f_plain, 20),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": device_ms(f_lib, 200),
            "warm_ms": device_ms(kernels_[0], 200),
            "library_warm_ms": device_ms(libs[0], 200),
            "back_to_back_ms": time_ms(f_kernel, 200),
            "host_us_per_call": host_us(f_kernel),
            "shape": f"b{b} L{Lk} h{h} d{d} bf16, " + ("key mask" if kind == "cross"
                                                       else "bias [h,L] with causal row")
            + f", {chunks} chunk{'s' if chunks > 1 else ''}",
            "bytes": nbytes, "flops": flops, "chunks": chunks, "input_copies": copies,
        }
        del sets, kernels_, plains, libs, f_kernel, f_plain, f_lib, q, k, v, kw
        del q4, k4, v4, lib_mask
        torch.cuda.empty_cache()
    decode_row = {
        "name": "decode_attention", "route": "cuda", "design": DESIGN["decode_attention"],
        "source": "tpu_air_torch/ops/csrc/decode_attention.cu",
        "replaces": "tpu_air/ops/decode_attention.py:61",
        "launches": launches["decode_attention"], **rows["cross"],
        "self_step": rows["self"], "split_cross_step": rows["split"],
        "b8_cross_step": rows["b8_cross"], "b8_self_step_33": rows["b8_self33"],
        "b8_self_step_65": rows["b8_self65"], "one_kernel_a_call": decode_one_kernel(dev),
    }
    for r in (flash_row, decode_row):   # aliases of ms and max_abs_err
        r["kernel_ms"], r["max_err"] = r["ms"], r["max_abs_err"]
    rows["self"]["label"] = "decode_attention self step"
    rows["split"]["label"] = "decode_attention cross step split over L"
    for key in ("b8_cross", "b8_self33", "b8_self65"):
        rows[key]["label"] = f"decode_attention {'cross' if 'cross' in key else 'self'} step b 8"
    for r in (flash_row, decode_row, rows["self"], rows["split"], rows["b8_cross"],
              rows["b8_self33"], rows["b8_self65"]):
        warm = ""
        if "warm_ms" in r:
            warm = (f"; L2 warm (one input set back to back) kernel {r['warm_ms']:.4f} ms, "
                    f"SDPA {r['library_warm_ms']:.4f} ms")
        log(f"[timing] {r.get('name', r.get('label'))} "
            f"({DESIGN[r.get('name', 'decode_attention')]}) {r['shape']}: kernel "
            f"{r['ms']:.4f} ms device time ({r['back_to_back_ms']:.4f} ms back to back, "
            f"host {r['host_us_per_call']:.1f} us/call), plain "
            f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}{warm}")
    return [flash_row, decode_row]


# -- phase 6 -----------------------------------------------------------------


def lm_config(dtype: str = "bfloat16", n_layers: int = 8):
    from tpu_air_torch.models.lm import LMConfig

    return LMConfig(vocab_size=32000, d_model=1024, n_layers=n_layers, n_heads=8,
                    max_seq_len=LM_LEN, dtype=dtype)


def backward_inputs(rng, b, h, L, d, dtype, dev, mask=True, causal=False):
    """q, k, v, do as (b, h, L, d) views of [b, L, h, d] tensors; the
    forward's (out, lse); a nonzero lse cotangent; a key mask with one full,
    one padded and one fully masked row."""
    from tpu_air_torch.ops.flash_attention import flash_attention_with_lse

    def t(shape=(b, L, h, d), dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dt)

    q, k, v, do = (t().transpose(1, 2) for _ in range(4))
    mask_t = None
    if mask:
        lens = rng.integers(L // 8, L + 1, b)
        lens[0], lens[-1] = L, 0
        mask_t = torch.from_numpy((np.arange(L)[None] < lens[:, None]).astype(np.float32)).to(dev)
    with torch.no_grad():
        out, lse = flash_attention_with_lse(q, k, v, kv_mask=mask_t, causal=causal)
    return q, k, v, do, mask_t, out, lse, t((b, h, L), torch.float32)


def backward_plain(q, k, v, mask, out, lse, do, glse, scale, causal):
    from tpu_air_torch.ops.flash_attention import flash_attention_backward_reference

    b, h, L, d = q.shape

    def flat(x):
        return x.reshape(b * h, L, d)

    return flash_attention_backward_reference(
        flat(q), flat(k), flat(v), mask, flat(out), lse.reshape(b * h, L), flat(do),
        None if glse is None else glse.reshape(b * h, L), scale, causal)


def compare_backward(dev, dtypes=(torch.float32, torch.bfloat16),
                     phase: str = "backward") -> dict:
    """Both backward kernels against the plain backward on the card, and the
    forward against the plain forward at the LM shape, in ``dtypes``."""
    from tpu_air_torch.ops.flash_attention import (flash_attention_backward,
                                                   flash_attention_reference)

    rng = np.random.default_rng(SEED + 10)
    errs = {}

    def check(name, q, k, v, do, mask, out, lse, glse, causal, dtype, by_norm=False):
        """The scaled error against TOL, or with ``by_norm`` the error on each
        tensor's own norm against NORM_TOL."""
        scale = q.shape[-1] ** -0.5
        tol = (NORM_TOL if by_norm else TOL)[dtype]
        got = flash_attention_backward(q, k, v, mask, out, lse, do, glse, scale, causal)
        torch.cuda.synchronize()
        want = backward_plain(q, k, v, mask, out, lse, do, glse, scale, causal)
        b, h, L, d = q.shape
        worst = {}
        for g_name, g, w in zip(("dq", "dk", "dv"), got, want):
            g = g.reshape(b * h, L, d)
            if not torch.isfinite(g.float()).all():
                raise AssertionError(f"[{phase}] {name} {g_name}: non-finite")
            if mask is not None:
                dead = (mask.sum(1) == 0).repeat_interleave(h)
                if dead.any() and g[dead].abs().max().item() != 0.0:
                    raise AssertionError(f"[{phase}] {name} {g_name}: a fully masked "
                                         "row has a nonzero gradient")
            rel = norm_err(g, w) if by_norm else scaled_err(g, w)
            if not rel < tol:
                raise AssertionError(f"[{phase}] {name} {g_name}: {rel} >= {tol}")
            w = w.float()
            # what a kernel that left the later half of the sequence at 0 would score
            half = (w[:, L // 2:].norm() / w.norm()).item()
            worst[g_name] = (max_err(g, w), rel, w.abs().max().item(), half)
        if by_norm:
            log(f"[{phase}] {name}: " + ", ".join(
                f"{n} max abs err {e:.2e} (plain max |x| {top:.3e}), ||err|| / ||plain|| "
                f"{r:.2e}, later half's share of ||plain|| {hf:.3f}"
                for n, (e, r, top, hf) in worst.items()) + f" (tol {tol:.0e})")
        else:
            log(f"[{phase}] {name}: max abs err " + ", ".join(
                f"{n} {e:.2e} (scaled {r:.2e})" for n, (e, r, _, _) in worst.items())
                + f" (tol {tol:.0e})")
        errs[name] = {n: e for n, (e, *_) in worst.items()}
        errs[name].update({f"{n}_rel": r for n, (_, r, *_) in worst.items()})

    for dtype in dtypes:
        tag = TAG[dtype]
        for d in (16, 32, 64, 128):
            for causal in (False, True):
                for L, mask in ((BWD_LEN, False), (BWD_LEN, True), (BWD_RAGGED_LEN, True)):
                    args = backward_inputs(rng, 3, 2, L, d, dtype, dev, mask, causal)
                    check(f"{tag} d{d} L{L}{' causal' if causal else ''}"
                          f"{' mask' if mask else ''}", *args, causal, dtype)
    cfg = lm_config()
    h, d = cfg.n_heads, cfg.head_dim
    for dtype in dtypes:
        tag = TAG[dtype]
        q, k, v, do, _, out, lse, _ = backward_inputs(rng, 1, h, LM_LEN, d, dtype, dev,
                                                      mask=False, causal=True)
        check(f"{tag} LM shape B1 H{h} L{LM_LEN} D{d} causal", q, k, v, do, None, out, lse,
              None, True, dtype, by_norm=True)
        want_out, want_lse = flash_attention_reference(
            *(x.reshape(h, LM_LEN, d) for x in (q, k, v)), None, None, d ** -0.5, True)
        got_out = out.reshape(h, LM_LEN, d)
        rel = norm_err(got_out, want_out)
        lse_err = (lse.reshape(h, LM_LEN) - want_lse).abs().max().item()
        errs[f"forward {tag} LM shape"] = max_err(got_out, want_out)
        errs[f"forward {tag} LM shape rel"] = rel
        log(f"[{phase}] {tag} forward at the LM shape: max abs err "
            f"{errs[f'forward {tag} LM shape']:.2e}, ||err|| / ||plain|| {rel:.2e} "
            f"(tol {NORM_TOL[dtype]:.0e}); lse {lse_err:.2e} (tol 1e-3)")
        if not (rel < NORM_TOL[dtype] and lse_err < 1e-3):
            raise AssertionError(f"[{phase}] {tag} forward at the LM shape: {rel}, "
                                 f"lse {lse_err}")
        del want_out, want_lse, got_out
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return errs


# -- phases 7 and 8 --------------------------------------------------------------


def lm_rows(n: int, L: int, seed: int) -> np.ndarray:
    """Periodic token rows with a per-row phase (examples/long_context_lm.py's
    synthetic corpus): next-token loss can fall within a few steps."""
    phase = np.random.default_rng(seed).integers(0, 17, (n, 1))
    return (2 + (np.arange(L)[None] + phase) % 17).astype(np.int32)


def lm_main_path(dev, storage: str) -> dict:
    """Phase 7.  The run's directory (``storage``) is kept: phase 22 serves
    its checkpoint, and ``main`` removes the work directory at the end."""
    import pandas as pd

    from tpu_air_torch.train import (CheckpointConfig, LMTrainer, RunConfig,
                                     TrainingArguments)

    cfg = lm_config()
    steps = 1 + LM_STEPS
    # one row, one step per epoch: each epoch's report is one step's loss and time
    rows = pd.DataFrame({"input_ids": list(lm_rows(1, LM_LEN, SEED + 20))})
    os.makedirs(storage, exist_ok=True)
    args = TrainingArguments(learning_rate=3e-4, per_device_train_batch_size=1,
                             num_train_epochs=steps, seed=SEED, evaluation_strategy="no")
    trainer = probed(LMTrainer(model_config=cfg, training_args=args, datasets={"train": rows},
                               run_config=RunConfig(storage_path=storage,
                                                    checkpoint_config=CheckpointConfig(
                                                        num_to_keep=1)),
                               device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = trainer.fit()
    wall = time.perf_counter() - t0
    if result.error is not None:
        raise AssertionError(f"[lm] fit failed: {result.error}")
    # counted in the fit's trial actor, around its training function
    probe, = read_probes(result.path)
    launches = {k: probe["launches"][k] for k in FLASH_KERNELS}
    hist = result.metrics_history
    if len(hist) != steps or any(m["steps"] != 1 for m in hist):
        raise AssertionError(f"[lm] expected {steps} one-step epochs: {hist}")
    ckpt_keys = len(result.checkpoint.get_params())
    losses = [m["loss"] for m in hist]
    step_ms = [LM_LEN / m["train_tokens_per_sec"] * 1e3 for m in hist]
    per_step = {k: n / steps for k, n in launches.items()}
    log(f"[lm] LMTrainer.fit: {cfg.d_model} wide, {cfg.n_layers} layers, {cfg.n_heads} heads "
        f"of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, bf16, batch 1, "
        f"L={LM_LEN}, {steps} steps in {wall:.1f} s (checkpoint of {ckpt_keys} tensors "
        f"each epoch) in its trial actor (pid {probe['pid']}, lease {probe['lease']}, "
        f"{probe['device']}, peak {probe['peak_gb']:.2f} GB)")
    log("[lm] loss per step: " + ", ".join(f"{x:.4f}" for x in losses))
    log("[lm] step ms (first is the warm-up): " + ", ".join(f"{x:.1f}" for x in step_ms))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[lm] non-finite loss: {losses}")
    log(f"[lm] launches: {launches} = {per_step} per step (expect {cfg.n_layers} each)")
    if any(n != cfg.n_layers for n in per_step.values()):
        raise AssertionError(f"[lm] launches per step {per_step}")
    med = float(np.median(step_ms[1:]))
    trace = lm_trace(dev, cfg, os.path.join(storage, "trace"), med)
    top = sorted(trace["kernels"].items(), key=lambda kv: -kv[1][0])[:8]
    log(f"[lm] median step {med:.1f} ms over {LM_STEPS} steps = {LM_LEN / med * 1e3:.0f} "
        f"tokens/s; device busy {trace['busy_ms_per_step']:.1f} ms a step in (c)'s trace "
        f"(idle share of the median step {trace['idle_share_of_median_step']:.4f}); heaviest "
        "kernels per step: " + "; ".join(f"{k[:60]} {t:.2f} ms x{c:g}" for k, (t, c) in top))
    per_launch = {}
    for name, kernel in LM_PROFILED_KERNELS:
        hits = [(t, c) for k, (t, c) in trace["kernels"].items() if kernel in k]
        per_launch[name] = sum(t for t, _ in hits) / cfg.n_layers
    log("[lm] device ms per launch in (c)'s trace: "
        + ", ".join(f"{n} {t:.3f}" for n, t in per_launch.items()))
    return {"launches": launches, "launches_per_step": per_step, "losses": losses,
            "step_ms": step_ms, "step_ms_median": med, "tokens_per_s": LM_LEN / med * 1e3,
            "kernel_ms_per_launch": per_launch, "trace": trace,
            "fit_wall_s": wall, "checkpoint_dir": result.checkpoint.path}


# idle gaps on the card's timeline by length in ms: [lo, hi) and a label
GAP_CLASSES = ((0.0, 0.01, "<10 us"), (0.01, 0.1, "10-100 us"), (0.1, 1.0, "0.1-1 ms"),
               (1.0, float("inf"), ">=1 ms"))
# Chrome-trace categories of the card's kernels, of all its work and of the host's
KERNEL_CAT = "kernel"
DEVICE_CATS = (KERNEL_CAT, "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def merged_intervals(spans):
    """The union of [start, end) intervals, sorted, as disjoint intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def trace_account(events: list, gaps: int) -> dict:
    """From a Chrome trace's complete events (``ph == "X"``, microseconds):
    the window from the first host event (the first device event in a
    trace without host events) to the last event, the card's busy time
    (the union of its kernels, copies and memsets), and the ``gaps``
    longest stretches of the window in which the card ran nothing, each
    with the host event that overlaps it most (the shortest such event on
    a tie: the innermost; None without host events)."""
    dev = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat", "").lower() in DEVICE_CATS]
    host = [e for e in events if e.get("cat", "").lower() in HOST_CATS]
    t0 = min([e["ts"] for e in host] or [a for a, _ in dev])
    t1 = max([e["ts"] + e["dur"] for e in host] + [b for _, b in dev])
    busy = merged_intervals(dev)
    idle, last = [], t0
    for a, b in busy:
        if a > last:
            idle.append((last, a))
        last = max(last, b)
    if t1 > last:
        idle.append((last, t1))
    sizes = {}
    for lo, hi, label in GAP_CLASSES:
        within = [b - a for a, b in idle if lo <= (b - a) / 1e3 < hi]
        sizes[label] = (len(within), sum(within) / 1e3)
    out = []
    for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:gaps]:
        gap = {"ms": (b - a) / 1e3, "at_ms": (a - t0) / 1e3, "host_op": None,
               "host_op_ms": None, "overlap_ms": None}
        if host:
            best = max(host, key=lambda e: (min(b, e["ts"] + e["dur"]) - max(a, e["ts"]),
                                            -e["dur"]))
            gap.update(host_op=best["name"], host_op_ms=best["dur"] / 1e3,
                       overlap_ms=max(0.0, min(b, best["ts"] + best["dur"]) - max(a, best["ts"]))
                       / 1e3)
        out.append(gap)
    return {"window_ms": (t1 - t0) / 1e3, "busy_ms": sum(b - a for a, b in busy) / 1e3,
            "idle_ms": sum(b - a for a, b in idle) / 1e3, "gap_sizes": sizes, "gaps": out}


def trace_kernels(events: list, steps: int) -> dict:
    """{name: (device ms, launches) per step} of the card's kernels, copies
    and memsets among a Chrome trace's complete events over ``steps``
    steps."""
    out: dict = {}
    for e in events:
        if e.get("cat", "").lower() in DEVICE_CATS:
            ms, n = out.get(e["name"], (0.0, 0))
            out[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    return {k: (ms / steps, n / steps) for k, (ms, n) in out.items()}


def lm_trace(dev, cfg, trace_root: str, median_step_ms: float) -> dict:
    """``[lm] (c)``: ``LM_TRACE_STEPS`` more steps of the step ``LMTrainer``
    runs (``make_sp_train_step``, each ended by reading its loss, the one
    host sync of a one-step epoch) on a fresh model of the phase's width,
    under ``profile_trace(device=dev)`` and ``step_timer(span_name=
    "lm.step")`` with tracing on, inside one ``lm.trace`` span: once with
    the host's ops recorded (``host_tracer_level`` 1), once with device
    activity only (0), whose step is close to an unprofiled one.  Each
    trace file must parse as JSON and name ``n_layers`` forward, dq and
    dk/dv launches a step, equal to the launch counters around the same
    steps; ``profiler.xplane_trace`` must carry its directory.  A trace
    short of a launch is taken again (the profiler can lose kernel
    records, ``complete_profile``), and after three the phase fails.
    Prints, for each trace, the step's wall from ``step_timer``, the card's
    busy time, the idle share, the idle gaps by length and the longest,
    with the host op over each.  Returns the device-only trace's account
    and the first trace's table of kernels.  These launches are not
    counted in the kernels line."""
    import glob

    from tpu_air_torch.models.lm import CausalLM
    from tpu_air_torch.observability import profile_trace, step_timer, tracing
    from tpu_air_torch.ops.flash_attention import flash_attention, flash_attention_backward
    from tpu_air_torch.parallel.sequence_parallel import make_sp_train_step, shift_targets
    from tpu_air_torch.train.t5_trainer import TrainingArguments, _make_optimizer

    model = CausalLM(cfg, device=dev).init_weights(SEED)
    opt = _make_optimizer(TrainingArguments(learning_rate=3e-4), 4, model.parameters())
    step = make_sp_train_step(model, opt)
    ids = torch.from_numpy(lm_rows(1, LM_LEN, SEED + 22)).to(dev, torch.long)
    tgt = shift_targets(ids, cfg.pad_token_id)
    float(step(ids, tgt))                            # warm-up
    want = cfg.n_layers * LM_TRACE_STEPS

    def take(level: int) -> dict:
        for attempt in range(3):
            log_dir = os.path.join(trace_root, f"level{level}_take{attempt}")
            timer = step_timer(span_name="lm.step")
            flash_attention.launches = 0
            flash_attention_backward.dq_launches = 0
            flash_attention_backward.dkv_launches = 0
            with tracing.span("lm.trace") as root:
                with profile_trace(log_dir, host_tracer_level=level, device=dev):
                    for _ in range(LM_TRACE_STEPS):
                        with timer.step():
                            float(step(ids, tgt))
            counters = {"flash_attention": flash_attention.launches,
                        "flash_attention_bwd_dq": flash_attention_backward.dq_launches,
                        "flash_attention_bwd_dkv": flash_attention_backward.dkv_launches}
            (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
            with open(path) as f:
                events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
            kernels = [e["name"] for e in events if e.get("cat", "").lower() == KERNEL_CAT]
            in_trace = {name: sum(k in n for n in kernels) for name, k in LM_PROFILED_KERNELS}
            if in_trace == counters == dict.fromkeys(counters, want):
                break
            log(f"[lm] (c) level {level} take {attempt + 1}: the trace names {in_trace} of the "
                f"flash kernels, the counters {counters}, {want} each expected")
        else:
            raise AssertionError(f"[lm] (c) three level-{level} traces short of the flash "
                                 f"launches: {in_trace} against counters {counters}")
        spans = tracing.recorder().for_trace(root.trace_id)
        xplane = [s.attrs for s in spans if s.name == "profiler.xplane_trace"]
        n_steps = sum(s.name == "lm.step" for s in spans)
        if xplane != [{"log_dir": log_dir}] or n_steps != LM_TRACE_STEPS:
            raise AssertionError(f"[lm] (c) level {level} spans: xplane {xplane}, "
                                 f"{n_steps} lm.step")
        summ = timer.summary()
        acc = trace_account(events, LM_TRACE_GAPS)
        wall_ms = summ["total_s"] * 1e3 / LM_TRACE_STEPS
        busy_ms = acc["busy_ms"] / LM_TRACE_STEPS
        size_mb = os.path.getsize(path) / 1e6
        tag = f"[lm] (c) host_tracer_level={level}"
        log(f"{tag}: profile_trace(device={str(dev)!r}) over {LM_TRACE_STEPS} steps, take "
            f"{attempt + 1}: {os.path.basename(path)} ({size_mb:.1f} MB, {len(events)} events, "
            f"{len(kernels)} kernels) names {in_trace} of the flash kernels = the counters; "
            f"span profiler.xplane_trace log_dir={log_dir}")
        log(f"{tag}: step wall from step_timer mean {summ['mean_s'] * 1e3:.3f} ms, max "
            f"{summ['max_s'] * 1e3:.3f} ms (the unprofiled [lm] median {median_step_ms:.1f} "
            f"ms); device busy from the trace {busy_ms:.3f} ms a step, idle share "
            f"{1 - busy_ms / wall_ms:.4f} of the step_timer wall and "
            f"{acc['idle_ms'] / acc['window_ms']:.4f} of the traced window "
            f"({acc['window_ms']:.3f} ms), {1 - busy_ms / median_step_ms:.4f} of the unprofiled "
            f"median; card: {card_line()}")
        log(f"{tag}: idle gaps a step by length: " + ", ".join(
            f"{label} {n / LM_TRACE_STEPS:g} gaps {ms / LM_TRACE_STEPS:.3f} ms"
            for label, (n, ms) in acc["gap_sizes"].items()))
        for i, g in enumerate(acc["gaps"]):
            over = ("no host event recorded" if g["host_op"] is None else
                    f"under host event {g['host_op']!r} ({g['host_op_ms']:.3f} ms, "
                    f"{g['overlap_ms']:.3f} ms of the gap)")
            log(f"{tag}: idle gap {i + 1}: {g['ms']:.3f} ms at +{g['at_ms']:.3f} ms, {over}")
        return {"level": level, "takes": attempt + 1, "trace_mb": size_mb,
                "launches_in_trace": in_trace, "counters": counters, "step_timer": summ,
                "step_wall_ms": wall_ms, "busy_ms_per_step": busy_ms,
                "idle_share": 1 - busy_ms / wall_ms,
                "idle_share_of_median_step": 1 - busy_ms / median_step_ms,
                "window_ms": acc["window_ms"], "window_idle_ms": acc["idle_ms"],
                "gap_sizes": acc["gap_sizes"], "gaps": acc["gaps"],
                "kernels": trace_kernels(events, LM_TRACE_STEPS)}

    tracing.enable()
    try:
        host_ops = take(1)
        device_only = take(0)
    finally:
        tracing.disable()
    del model, opt, step
    torch.cuda.empty_cache()
    return {**device_only, "steps": LM_TRACE_STEPS, "kernels": host_ops.pop("kernels"),
            "host_ops": host_ops}


class _PlainFlash(torch.autograd.Function):
    """Causal attention through the plain forward and plain backward, on
    whatever device the tensors are on."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        from tpu_air_torch.ops.flash_attention import flash_attention_reference

        b, h, L, d = q.shape
        flat = [x.reshape(b * h, L, d) for x in (q, k, v)]
        out, lse = flash_attention_reference(*flat, None, None, scale, causal)
        ctx.save_for_backward(*flat, out, lse)
        ctx.scale, ctx.causal, ctx.shape = scale, causal, q.shape
        return out.reshape(b, h, L, d)

    @staticmethod
    def backward(ctx, do):
        from tpu_air_torch.ops.flash_attention import flash_attention_backward_reference

        q, k, v, out, lse = ctx.saved_tensors
        grads = flash_attention_backward_reference(q, k, v, None, out, lse,
                                                   do.reshape(out.shape), None,
                                                   ctx.scale, ctx.causal)
        return (*(g.reshape(ctx.shape) for g in grads), None, None)


@contextlib.contextmanager
def plain_lm_attention():
    """Route the LM's attention through the plain versions, on the card."""
    from tpu_air_torch.models.lm import modeling

    def flash(q, k, v, bias=None, *, kv_mask=None, scale=None, causal=False):
        return _PlainFlash.apply(q, k, v, scale, causal)

    saved = modeling.flash_attention
    modeling.flash_attention = flash
    try:
        yield
    finally:
        modeling.flash_attention = saved


def lm_parity(dev) -> dict:
    """Two f32 train steps through the kernels and through the plain versions
    from the same weights; the losses and the first step's gradients agree."""
    from tpu_air_torch.models.lm import CausalLM
    from tpu_air_torch.ops.flash_attention import flash_attention, flash_attention_backward
    from tpu_air_torch.parallel.sequence_parallel import make_sp_train_step, shift_targets
    from tpu_air_torch.train.t5_trainer import TrainingArguments, _make_optimizer

    cfg = lm_config("float32", LM_PARITY_LAYERS)
    ids = torch.from_numpy(lm_rows(1, LM_PARITY_LEN, SEED + 22)).to(dev, torch.long)
    tgt = shift_targets(ids, cfg.pad_token_id)
    runs = {}
    for path in ("kernel", "plain"):
        model = CausalLM(cfg, device=dev).init_weights(SEED)
        opt = _make_optimizer(TrainingArguments(learning_rate=1e-3), 2, model.parameters())
        grads = []
        adamw_step = opt.step

        def snapshot_then_step():
            grads.append({n: p.grad.detach().clone() for n, p in model.named_parameters()})
            adamw_step()

        opt.step = snapshot_then_step
        step = make_sp_train_step(model, opt)
        ctx = plain_lm_attention() if path == "plain" else contextlib.nullcontext()
        before = (flash_attention.launches, flash_attention_backward.dq_launches,
                  flash_attention_backward.dkv_launches)
        with ctx:
            losses = [float(step(ids, tgt)) for _ in range(2)]
        launched = before != (flash_attention.launches, flash_attention_backward.dq_launches,
                              flash_attention_backward.dkv_launches)
        if launched != (path == "kernel"):
            raise AssertionError(f"[lm parity] the {path} path launched kernels: {launched}")
        runs[path] = losses, grads[0]
        del model, opt, step
        torch.cuda.empty_cache()
    (lk, gk), (lp, gp) = runs["kernel"], runs["plain"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    grad_rel = max((gk[n] - gp[n]).abs().max().item() / gp[n].abs().max().item() for n in gp)
    log(f"[lm parity] f32, {cfg.d_model} wide, depth cut to {cfg.n_layers} layers, L="
        f"{LM_PARITY_LEN}: losses kernel {lk} plain {lp} (max rel diff {loss_rel:.2e}); "
        f"step-1 gradients max |diff| / max |plain| over tensors {grad_rel:.2e}")
    # f32 on both paths, differing in summation order only: the losses to
    # 1e-5 relative; each gradient tensor to 1e-4 of its largest element
    if not (loss_rel < 1e-5 and grad_rel < 1e-4):
        raise AssertionError(f"[lm parity] loss rel {loss_rel}, grad rel {grad_rel}")
    return {"losses_kernel": lk, "losses_plain": lp, "loss_max_rel_diff": loss_rel,
            "grad_max_rel_diff": grad_rel}


# -- phase 9 -----------------------------------------------------------------


def lm_timing(dev, kernels: list, bwd_errs: dict, lm_stats: dict, built: dict) -> list:
    """The three flash kernels at the LM training shape (B*H = 8, L = 8192,
    D = 128, causal, bf16), beside their bounds (flops over 989 TFLOP/s, the
    causal half counted), their plain versions and SDPA.  A kernel's time is
    its device time per launch in the main path's profiled step; the plain
    versions and SDPA, every call of which runs for 0.2 ms or more, are
    timed with CUDA events over back-to-back calls.  The backward kernels'
    rows also carry their host time a call (four tensor maps encoded each)
    and, from ``built`` (phase 1), their bf16 D = 128 instance's registers
    and HGMMA count."""
    from tpu_air_torch.ops.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_reference)

    cfg = lm_config()
    h, L, d = cfg.n_heads, LM_LEN, cfg.head_dim
    scale = d ** -0.5
    rng = np.random.default_rng(SEED + 30)
    q, k, v, do, _, out, lse, _ = backward_inputs(rng, 1, h, L, d, torch.bfloat16, dev,
                                                  mask=False, causal=True)
    flat = [x.reshape(h, L, d) for x in (q, k, v)]
    pairs = h * L * (L + 1) // 2                   # live (query, key) pairs, causal
    elt = h * L * d * 2                            # one bf16 (B*H, L, D) operand
    lse_bytes = h * L * 4
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, scale=scale)

    # CUDA events around separate kernel calls cross-check the profiled step
    per_launch = lm_stats["kernel_ms_per_launch"]
    fwd_ms = per_launch["flash_attention"]
    dq_ms = per_launch["flash_attention_bwd_dq"]
    dkv_ms = per_launch["flash_attention_bwd_dkv"]
    fwd_events_ms = time_ms(lambda: flash_attention(q, k, v, scale=scale, causal=True), 3, 1)
    bwd_events_ms = time_ms(lambda: flash_attention_backward(q, k, v, None, out, lse, do, None,
                                                             scale, True), 3, 1)
    plain_bwd_ms = time_ms(lambda: backward_plain(q, k, v, None, out, lse, do, None,
                                                  scale, True), 2, 1)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), do,
                                                      retain_graph=True), 5, 2)
    lm_errs = bwd_errs[f"bf16 LM shape B1 H{h} L{L} D{d} causal"]
    shape = f"B*H {h} L{L} D{d} causal bf16"
    calls = bwd_kernel_calls(q, k, v, do, out, lse, scale, True)
    host = {name: host_us(call, 20) for name, call in calls.items()}
    events = {name: device_ms(call, 5) for name, call in calls.items()}
    rows = {}
    # forward: reads q, k, v, writes out and lse; 2 products of 2*d flops per
    # live pair.  dq: reads q, k, v, do, lse, delta, writes dq; 3 products.
    # dk/dv: the same inputs, writes dk and dv; 4 products.
    for name, ms, plain_ms, lib_ms, nbytes, flops, err, rel in (
        ("flash_attention", fwd_ms,
         time_ms(lambda: flash_attention_reference(*flat, None, None, scale, True), 2, 1),
         time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                        scale=scale), 5, 2),
         4 * elt + lse_bytes, 4 * d * pairs, bwd_errs["forward bf16 LM shape"],
         bwd_errs["forward bf16 LM shape rel"]),
        ("flash_attention_bwd_dq", dq_ms, plain_bwd_ms, sdpa_bwd_ms,
         5 * elt + 2 * lse_bytes, 6 * d * pairs, lm_errs["dq"], lm_errs["dq_rel"]),
        ("flash_attention_bwd_dkv", dkv_ms, plain_bwd_ms, sdpa_bwd_ms,
         6 * elt + 2 * lse_bytes, 8 * d * pairs, max(lm_errs["dk"], lm_errs["dv"]),
         max(lm_errs["dk_rel"], lm_errs["dv_rel"])),
    ):
        b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16_FLOP_S)
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                      "err_norm_over_plain_norm": rel, "norm_tol": NORM_TOL[torch.bfloat16],
                      "bytes": nbytes, "flops": flops, "shape": shape}
        log(f"[lm timing] {name} ({DESIGN[name]}) {shape}: kernel {ms:.3f} ms device time a "
            f"launch, plain {plain_ms:.3f} ms, SDPA {'forward' if name == 'flash_attention' else 'backward'} "
            f"{lib_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}")
        if name in host:
            kernel = dict(LM_PROFILED_KERNELS)[name]
            inst = built.get(f"{kernel}<bf16,{d}>", {})
            rows[name].update(events_ms=events[name], host_us_per_call=host[name],
                              registers=inst.get("regs"), hgmma=inst.get("HGMMA"),
                              spill_bytes=inst.get("spill"))
            log(f"[lm timing] {name}: {events[name]:.3f} ms a launch by CUDA events "
                f"(device_ms, alone); host {host[name]:.1f} us a call; {kernel}<bf16,{d}> "
                f"{inst.get('regs')} registers at launch, {inst.get('HGMMA')} HGMMA, "
                f"{inst.get('spill')} B spill")
    log(f"[lm timing] by CUDA events: flash_attention {fwd_events_ms:.3f} ms, one "
        f"flash_attention_backward call (delta, dq, dk/dv) {bwd_events_ms:.3f} ms; the plain "
        f"backward computes dq, dk and dv in {plain_bwd_ms:.3f} ms, SDPA's in "
        f"{sdpa_bwd_ms:.3f} ms")
    launches = lm_stats["launches"]

    fwd = next(r for r in kernels if r["name"] == "flash_attention")
    fwd["launches_by_path"] = {"t5_generate": fwd["launches"],
                               "lm_train": launches["flash_attention"]}
    fwd["launches"] += launches["flash_attention"]
    fwd["lm_shape"] = {**rows["flash_attention"], "events_ms": fwd_events_ms}
    for name, line in (("flash_attention_bwd_dq", 368), ("flash_attention_bwd_dkv", 399)):
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "design": DESIGN[name],
            "source": "tpu_air_torch/ops/csrc/flash_attention_bwd.cu",
            "replaces": f"tpu_air/ops/flash_attention.py:{line}",
            "launches": launches[name], "launches_by_path": {"lm_train": launches[name]}, **r,
            "plain": "the plain backward, dq, dk and dv together",
            "library": "SDPA backward, dq, dk and dv in one call",
            "backward_call_events_ms": bwd_events_ms,
            "kernel_ms": r["ms"], "max_err": r["max_abs_err"],
        })
    del q, k, v, do, out, lse, qs, ks, vs, sdpa_out, calls
    torch.cuda.empty_cache()
    return kernels


# -- phases 10-12 ----------------------------------------------------------------


def w1_config(dtype: str = "bfloat16", layers=None, dropout: float = 0.1):
    """FLAN-T5-base as W1 fine-tunes it: its own dropout 0.1, bf16 compute
    on f32 parameters; ``layers`` cuts the depth (both stacks)."""
    from tpu_air_torch.models.t5.config import T5Config

    cfg = T5Config.flan_t5_base()
    cfg.dtype, cfg.dropout_rate = dtype, dropout
    if layers:
        cfg.num_layers = cfg.num_decoder_layers = layers
    return cfg


def w1_rows(n: int, vocab: int, seed: int):
    """Pre-tokenized W1 rows padded to W1_LEN: sources of ragged real length
    (one full), labels of 16-128 tokens ending in EOS, the rest pad."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    pos = np.arange(W1_LEN)[None]
    src = rng.integers(W1_LEN // 4, W1_LEN + 1, n)
    src[0] = W1_LEN
    lab = rng.integers(16, min(128, W1_LEN) + 1, n)
    mask = (pos < src[:, None]).astype(np.int64)
    ids = rng.integers(2, vocab, (n, W1_LEN)) * mask
    labels = np.where(pos < lab[:, None] - 1, rng.integers(2, vocab, (n, W1_LEN)), 0)
    labels[np.arange(n), lab - 1] = 1                            # EOS
    return pd.DataFrame({"input_ids": list(ids), "attention_mask": list(mask),
                         "labels": list(labels)})


def w1_batch(rows, dev) -> dict:
    return {k: torch.from_numpy(np.stack(rows[k].to_list())).to(dev, torch.long)
            for k in ("input_ids", "attention_mask", "labels")}


@contextlib.contextmanager
def recorded_t5_steps():
    """Within the block, every step ``make_t5_train_step`` builds records
    its loss and, on the device clock, its end: yields ``[(None, start),
    (loss, end), ...]``.  The loop itself syncs once, at the epoch's end."""
    from tpu_air_torch.train import t5_trainer

    marks = []
    make_step = t5_trainer.make_t5_train_step

    def recording_step(*a, **kw):
        step = make_step(*a, **kw)

        def rec(batch):
            if not marks:
                marks.append((None, torch.cuda.Event(enable_timing=True)))
                marks[-1][1].record()
            loss = step(batch)
            marks.append((loss, torch.cuda.Event(enable_timing=True)))
            marks[-1][1].record()
            return loss
        return rec

    t5_trainer.make_t5_train_step = recording_step
    try:
        yield marks
    finally:
        t5_trainer.make_t5_train_step = make_step


def w1_main_path(dev) -> dict:
    """``T5Trainer.fit()`` (one epoch of W1_STEPS steps, eval, checkpoint) in
    its trial actor, then generation from the best checkpoint here; each
    step's loss and end on the device clock, recorded in the actor by
    :func:`actor_probe`."""
    import shutil
    import tempfile

    from tpu_air_torch.models.tokenizer import ByteTokenizer
    from tpu_air_torch.ops.decode_attention import decode_attention
    from tpu_air_torch.ops.flash_attention import flash_attention, flash_attention_backward
    from tpu_air_torch.predict.predictors import T5GenerativePredictor
    from tpu_air_torch.train import (CheckpointConfig, RunConfig, T5Trainer,
                                     TrainingArguments)

    def counts():
        return {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches,
                "flash_attention_bwd_dq": flash_attention_backward.dq_launches,
                "flash_attention_bwd_dkv": flash_attention_backward.dkv_launches}

    cfg = w1_config()
    train = w1_rows(W1_BATCH * W1_STEPS, cfg.vocab_size, SEED + 40)
    evaluation = w1_rows(W1_EVAL_ROWS, cfg.vocab_size, SEED + 41)
    storage = tempfile.mkdtemp(prefix="chip_smoke-w1-")
    # W1's own arguments (examples/flan_t5_batch_inference.py): AdamW, lr
    # 2e-5, weight decay 0.01; the per-device batch and the epoch cut to size
    args = TrainingArguments(learning_rate=2e-5, weight_decay=0.01,
                             per_device_train_batch_size=W1_BATCH, num_train_epochs=1,
                             seed=SEED)
    trainer = probed(T5Trainer(
        model_config=cfg, training_args=args, tokenizer=ByteTokenizer(W1_LEN),
        datasets={"train": train, "evaluation": evaluation},
        run_config=RunConfig(storage_path=storage, checkpoint_config=CheckpointConfig(
            num_to_keep=1, checkpoint_score_attribute="eval_loss",
            checkpoint_score_order="min")),
        device=dev), step_maker=T5_STEP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = trainer.fit()
    fit_wall = time.perf_counter() - t0
    try:
        if result.error is not None:
            raise AssertionError(f"[w1] fit failed: {result.error}")
        # the launches, steps and peak memory of the fit's trial actor
        probe, = read_probes(result.path)
        peak_gb, fit_launches = probe["peak_gb"], probe["launches"]
        m = result.metrics
        if m["steps"] != W1_STEPS or len(result.metrics_history) != 1:
            raise AssertionError(f"[w1] expected one epoch of {W1_STEPS} steps: "
                                 f"{result.metrics_history}")
        best = result.checkpoint
        if best.get_metrics()["eval_loss"] != m["eval_loss"]:
            raise AssertionError("[w1] the best checkpoint is not the min eval_loss one")
        losses, step_ms = probe["losses"], probe["step_ms"]
        if len(losses) != W1_STEPS or not all(np.isfinite(losses + [m["loss"], m["eval_loss"]])):
            raise AssertionError(f"[w1] losses {losses}, metrics {m}")
        med = float(np.median(step_ms[1:]))
        tokens = W1_BATCH * W1_LEN
        log(f"[w1] T5Trainer.fit: FLAN-T5-base width and depth ({cfg.d_model} wide, "
            f"{cfg.num_layers}+{cfg.num_decoder_layers} layers, {cfg.num_heads} heads of "
            f"{cfg.d_kv}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), dropout {cfg.dropout_rate}, "
            f"bf16 compute on f32 parameters ({m['params_bytes_total'] / 1e6:.1f} MB), random "
            f"weights from numpy seed {SEED}; batch {W1_BATCH} x {W1_LEN} source / {W1_LEN} "
            f"label tokens, AdamW lr 2e-5, one epoch of {m['steps']} steps and "
            f"{W1_EVAL_ROWS} eval rows in {fit_wall:.1f} s, in its trial actor (pid "
            f"{probe['pid']}, lease {probe['lease']}, {probe['device']}): the training "
            f"function ran {probe['t1'] - probe['t0']:.1f} s of it, its first step began "
            f"{probe['t_first_step'] - probe['t0']:.1f} s in (model build)")
        log("[w1] loss per step: " + ", ".join(f"{x:.4f}" for x in losses)
            + f"; epoch loss {m['loss']:.4f}, eval_loss {m['eval_loss']:.4f}")
        log("[w1] step ms (device clock, first is the warm-up): "
            + ", ".join(f"{x:.1f}" for x in step_ms))
        log(f"[w1] median step after the first {med:.2f} ms = {tokens / med * 1e3:.0f} trained "
            f"tokens/s (global batch x source length); the epoch's train_tokens_per_sec "
            f"{m['train_tokens_per_sec']:.0f} (its first step included); peak memory "
            f"{peak_gb:.2f} GB")
        log(f"[w1] launches in fit (train steps with dropout take the dense path; eval "
            f"runs without dropout): {fit_launches}")
        eval_batches = -(-W1_EVAL_ROWS // W1_BATCH)
        attn_per_forward = cfg.num_layers + 2 * cfg.num_decoder_layers
        if fit_launches["flash_attention"] != eval_batches * attn_per_forward or \
                fit_launches["decode_attention"] or fit_launches["flash_attention_bwd_dq"]:
            raise AssertionError(f"[w1] fit launches {fit_launches}")

        # W3 from the trained checkpoint, cast to bf16 once at load
        t0 = time.perf_counter()
        predictor = T5GenerativePredictor.from_checkpoint(best, dtype="bfloat16", device=dev,
                                                          tokenizer=ByteTokenizer)
        load_s = time.perf_counter() - t0
        dtypes = {p.dtype for p in predictor.model.parameters()}
        if dtypes != {torch.bfloat16}:
            raise AssertionError(f"[w1] from_checkpoint loaded {dtypes}")
        ids, mask = prompts(W1_PROMPTS, W1_LEN, cfg.vocab_size, SEED + 42)
        before = counts()
        t0 = time.perf_counter()
        out = predictor.predict({"input_ids": ids, "attention_mask": mask},
                                max_new_tokens=W1_NEW)
        gen_s = time.perf_counter() - t0
        gen = {k: counts()[k] - before[k] for k in before}
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    steps = gen["decode_attention"] // (2 * cfg.num_decoder_layers)
    log(f"[w1] from_checkpoint(dtype='bfloat16') in {load_s:.1f} s, parameters {dtypes}; "
        f"predict {W1_PROMPTS} prompts x {W1_LEN} -> {W1_NEW} new tokens in {gen_s:.2f} s, "
        f"{steps} decode steps; launches {gen}")
    if len(out) != W1_PROMPTS or gen["flash_attention"] != cfg.num_layers or \
            gen["decode_attention"] <= 0 or \
            gen["decode_attention"] != steps * 2 * cfg.num_decoder_layers:
        raise AssertionError(f"[w1] generation from the checkpoint: {len(out)} rows, {gen}")
    launches = {k: fit_launches[k] + gen[k] for k in gen}
    del predictor, trainer, result
    torch.cuda.empty_cache()
    prof = w1_step_profile(dev, cfg, args, train)
    top = sorted(prof["kernels"].items(), key=lambda kv: -kv[1][0])[:8]
    classes = kernel_classes(prof["kernels"])
    log(f"[w1] a profiled step: {prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms "
        f"(busy share {prof['busy_ms'] / prof['wall_ms']:.4f}; of the median step "
        f"{prof['busy_ms'] / med:.4f}), {prof['launches']:.0f} kernels a step; by class: "
        + "; ".join(f"{k} {t:.2f} ms x{c:g}" for k, (t, c) in
                    sorted(classes.items(), key=lambda kv: -kv[1][0]))
        + "; heaviest kernels per step: "
        + "; ".join(f"{k[:60]} {t:.2f} ms x{c:g}" for k, (t, c) in top))
    return {"launches": launches, "fit_launches": fit_launches, "generate_launches": gen,
            "losses": losses, "epoch_loss": m["loss"], "eval_loss": m["eval_loss"],
            "step_ms": step_ms, "step_ms_median": med, "tokens_per_s": tokens / med * 1e3,
            "epoch_train_tokens_per_sec": m["train_tokens_per_sec"], "peak_memory_gb": peak_gb,
            "fit_wall_s": fit_wall, "profiled_step_ms": prof["wall_ms"],
            "step_device_busy_ms": prof["busy_ms"],
            "busy_share_of_median_step": prof["busy_ms"] / med,
            "kernels_per_step": prof["launches"],
            "step_device_ms_by_class": {k: t for k, (t, _) in classes.items()},
            "generate_s": gen_s, "decode_steps": steps}


def w1_step_profile(dev, cfg, args, rows, steps: int = 2) -> dict:
    """The step ``T5Trainer`` runs (``make_t5_train_step``, dropout on) on a
    fresh model under the profiler; not counted.  Wall and device busy time
    per step, and {kernel name: (device ms, launches)} per step."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_air_torch.models.t5.convert import jax_layouts
    from tpu_air_torch.models.t5.modeling import T5ForConditionalGeneration
    from tpu_air_torch.train.t5_trainer import _make_optimizer, make_t5_train_step

    model = T5ForConditionalGeneration(cfg, device=dev).init_weights(SEED).train()
    layouts = jax_layouts(cfg)
    opt = _make_optimizer(args, 4, [p for _, p in model.named_parameters()],
                          [layouts[n] for n, _ in model.named_parameters()])
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    step = make_t5_train_step(model, opt, gen)
    batch = w1_batch(rows.iloc[:W1_BATCH], dev)
    step(batch)                                      # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = device_kernels(prof, steps)
    del model, opt, step
    torch.cuda.empty_cache()
    return {"wall_ms": wall_ms, "busy_ms": sum(t for t, _ in kernels.values()),
            "launches": sum(c for _, c in kernels.values()), "kernels": kernels}


def w1_parity(dev) -> dict:
    """One f32 training step's loss and gradients, through the kernels (the
    flash forward under ``_FlashPair``: its bias backward recomputes through
    the plain forward, the bias-free cross-attention's runs the dq and dk/dv
    kernels) and through the plain versions, on the card, from the same
    weights."""
    from tpu_air_torch.models.t5.modeling import T5ForConditionalGeneration
    from tpu_air_torch.ops.flash_attention import flash_attention, flash_attention_backward
    from tpu_air_torch.train.t5_trainer import t5_local_sums

    cfg = w1_config("float32", W1_PARITY_LAYERS, dropout=0.0)
    batch = w1_batch(w1_rows(W1_PARITY_BATCH, cfg.vocab_size, SEED + 43), dev)
    runs = {}
    for path in ("kernel", "plain"):
        model = T5ForConditionalGeneration(cfg, device=dev).init_weights(SEED).train()
        ctx = plain_attention() if path == "plain" else contextlib.nullcontext()
        before = (flash_attention.launches, flash_attention_backward.dq_launches,
                  flash_attention_backward.dkv_launches)
        with ctx:
            total, count = t5_local_sums(model, batch)
            loss = total / torch.clamp(count.float(), min=1.0)
            loss.backward()
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip((flash_attention.launches,
                                                flash_attention_backward.dq_launches,
                                                flash_attention_backward.dkv_launches), before))
        if any(launched) != (path == "kernel"):
            raise AssertionError(f"[w1 parity] the {path} path launched {launched}")
        runs[path] = (float(loss.detach()), {n: p.grad.detach().clone()
                                    for n, p in model.named_parameters()}, launched)
        del model, total, count, loss
        torch.cuda.empty_cache()
    (lk, gk, nk), (lp, gp, _) = runs["kernel"], runs["plain"]
    loss_rel = abs(lk - lp) / abs(lp)
    errs = {n: norm_err(gk[n], gp[n]) for n in gp if gp[n].norm() > 0}
    worst = max(errs, key=errs.get)
    biases = {n: errs[n] for n in errs if "rel_bias" in n}
    log(f"[w1 parity] f32, {cfg.d_model} wide, depth cut to {cfg.num_layers}+"
        f"{cfg.num_decoder_layers}, dropout 0, batch {W1_PARITY_BATCH} x {W1_LEN}: loss kernel "
        f"{lk:.7f} plain {lp:.7f} (rel diff {loss_rel:.2e}); gradients ||err|| / ||plain|| "
        f"max {errs[worst]:.2e} ({worst}) over {len(errs)} tensors, relative-position biases "
        + ", ".join(f"{n} {e:.2e}" for n, e in biases.items())
        + f"; kernel-path launches (flash, dq, dk/dv): {nk}")
    # f32 on both paths, differing in summation order only
    if not (loss_rel < 1e-5 and errs[worst] < 1e-4 and len(biases) == 2):
        raise AssertionError(f"[w1 parity] loss rel {loss_rel}, grad {worst} {errs[worst]}, "
                             f"biases {biases}")
    return {"loss_kernel": lk, "loss_plain": lp, "loss_rel_diff": loss_rel,
            "grad_max_norm_err": errs[worst], "grad_worst_tensor": worst,
            "bias_grad_norm_err": biases, "kernel_path_launches": nk}


def w1_timing(dev, kernels: list, errs: dict, w1_stats: dict) -> list:
    """The flash forward at the two W1 training shapes beside its bound, its
    plain version and one SDPA call with the same additive mask (bias, key
    mask and, for the decoder, the causal triangle, built outside the timed
    region).  The work counted is what these inputs need: the live (query,
    key) pairs of each row."""
    from tpu_air_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(SEED + 44)
    cfg = model_config()
    H, D = cfg.num_heads, cfg.d_kv
    B, L = W1_BATCH, W1_LEN
    dt = torch.bfloat16
    rows = {}
    for part, (q, k, v, bias, mask, causal) in w1_flash_inputs(rng, cfg, dev).items():
        nbytes, flops = flash_work(B, H, L, D, needed_keys(mask, L), causal)
        b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16_FLOP_S)
        lib_mask = bias + ((1.0 - mask) * -1e30)[:, None, None, :]
        if causal:
            lib_mask = lib_mask + torch.full((L, L), -1e30, device=dev).triu(1)
        lib_mask = lib_mask.to(dt)
        rows[part] = {
            "ms": device_ms(lambda: flash_attention(q, k, v, bias, kv_mask=mask, scale=1.0,
                                                    causal=causal), 10),
            "plain_ms": device_ms(lambda: flash_plain(q, k, v, bias, mask, causal=causal), 5),
            "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=lib_mask, scale=1.0), 10),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
            "max_abs_err": errs[f"flash bf16 W1 {part}"], "tol": TOL[dt],
            "shape": (f"B{B} H{H} L{L} D{D} bf16, bias [1,H,L,L] f32, "
                      + ("causal, label key mask" if causal else "source key mask")),
        }
        r = rows[part]
        log(f"[w1 timing] flash_attention W1 {part} {r['shape']}: kernel {r['ms']:.4f} ms "
            f"device time, plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}")
        del q, k, v, bias, mask, lib_mask
        torch.cuda.empty_cache()
    fwd = next(r for r in kernels if r["name"] == "flash_attention")
    fwd["launches_by_path"]["w1_fit_generate"] = w1_stats["launches"]["flash_attention"]
    fwd["launches"] += w1_stats["launches"]["flash_attention"]
    fwd["w1_encoder"], fwd["w1_decoder"] = rows["encoder"], rows["decoder"]
    dec = next(r for r in kernels if r["name"] == "decode_attention")
    dec["launches_by_path"] = {"t5_generate": dec["launches"],
                               "w1_fit_generate": w1_stats["launches"]["decode_attention"]}
    dec["launches"] += w1_stats["launches"]["decode_attention"]
    return kernels


# -- phases 13-15 -------------------------------------------------------------


def in_turns(calls: dict, measure) -> dict:
    """``measure`` of each of ``calls`` ({dtype: fn}) in turns, bf16, f16,
    f16, bf16, so that a drift of the card's clock over the phase falls on
    both: {dtype: mean of its two readings}."""
    got = {dt: [] for dt in calls}
    for dt in (torch.bfloat16, torch.float16, torch.float16, torch.bfloat16):
        got[dt].append(measure(calls[dt]))
    return {dt: float(np.mean(v)) for dt, v in got.items()}


def f16_timing(dev, kernels: list, errs: dict, bwd_errs: dict, built: dict) -> list:
    """The four kernels in f16 at the shapes their main paths give them (W3:
    the encoder's flash forward and the decode cross and self steps; the LM
    shape for dq and dk/dv, each launched alone), timed by ``device_ms``,
    beside the same bounds as in bf16 (the same
    bytes, the same 989 TFLOP/s peak), their plain versions and one SDPA
    call; each row goes under its kernel's ``"f16"`` key.  The bf16 kernel
    is timed again here, on the same inputs rounded to bf16, in turns with
    the f16 one (``bf16_same_phase_ms``): the two types compare only so."""
    from tpu_air_torch.ops.decode_attention import decode_attention, decode_attention_reference
    from tpu_air_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(SEED + 50)
    dt = torch.float16
    cfg = model_config()
    B, H, L, D = BATCH, cfg.num_heads, PROMPT_LEN, cfg.d_kv
    by_name = {r["name"]: r for r in kernels}

    def half(x):
        return {t: x.to(t) for t in (torch.bfloat16, torch.float16)}

    q, k, v, bias, mask = flash_inputs(rng, B, H, L, D, torch.float32, dev)
    qh, kh, vh = half(q), half(k), half(v)
    lib_mask = (bias + ((1.0 - mask) * -1e30)[:, None, None, :]).to(dt)
    keys = needed_keys(mask, L)
    nbytes = (2 * B * H * L * D * 2 + 2 * H * D * 2 * int(keys.sum())
              + H * L * int(keys.max()) * 4 + B * L * 4 + B * H * L * 4)
    b_ms, b_by = bound_ms(nbytes, 4 * H * L * D * int(keys.sum()), PEAK_BF16_FLOP_S)
    ms = in_turns({t: partial(flash_attention, qh[t], kh[t], vh[t], bias, kv_mask=mask,
                              scale=1.0) for t in qh}, lambda f: device_ms(f, 10))
    by_name["flash_attention"]["f16"] = {
        "ms": ms[dt], "bf16_same_phase_ms": ms[torch.bfloat16],
        "plain_ms": device_ms(lambda: flash_plain(qh[dt], kh[dt], vh[dt], bias, mask), 5),
        "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
            qh[dt], kh[dt], vh[dt], attn_mask=lib_mask, scale=1.0), 10),
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": errs["flash f16 encoder bias+mask"],
        "tol": TOL[dt], "shape": f"B{B} H{H} L{L} D{D} f16, bias [1,H,L,L] f32, key mask"}
    del q, k, v, bias, mask, qh, kh, vh, lib_mask
    rows = {}
    for key, kind, Lk in (("cross", "cross", L), ("self", "self", NEW_TOKENS + 1)):
        copies = max(2, -(-COLD_BYTES // (2 * B * Lk * H * D * 2)))
        sets = [decode_inputs(rng, B, Lk, H, D, torch.float32, dev, kind) for _ in range(copies)]
        kern = {t: cycled([partial(decode_attention, q_.to(t), k_.to(t), v_.to(t), **kw_)
                           for q_, k_, v_, kw_ in sets]) for t in (torch.bfloat16, dt)}
        q, k, v, kw = sets[0]
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
        q4, k4, v4 = q.transpose(1, 2), k.view(B, Lk, H, D).transpose(1, 2), \
            v.view(B, Lk, H, D).transpose(1, 2)
        if kind == "cross":
            lib_mask = torch.where(kw["kv_mask"] > 0, 0.0, -1e20)[:, None, None, :].to(dt)
            keys, extra = needed_keys(kw["kv_mask"], Lk), B * Lk * 4
        else:
            lib_mask = kw["bias"][None, :, None, :].to(dt)
            keys = torch.full((B,), int((kw["bias"][0] > -1e8).sum()))
            extra = H * int(keys[0]) * 4
        nbytes = 2 * H * D * 2 * int(keys.sum()) + 2 * B * H * D * 2 + extra
        b_ms, b_by = bound_ms(nbytes, 4 * H * D * int(keys.sum()), PEAK_BF16_FLOP_S)
        ms = in_turns(kern, lambda f: device_ms(f, 200))
        rows[key] = {
            "ms": ms[dt], "bf16_same_phase_ms": ms[torch.bfloat16],
            "plain_ms": device_ms(partial(decode_attention_reference, q, k, v, **kw), 20),
            "library_ms": device_ms(partial(F.scaled_dot_product_attention, q4, k4, v4,
                                            attn_mask=lib_mask, scale=1.0), 200),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": errs[f"decode f16 {kind}"],
            "tol": TOL[dt], "shape": f"b{B} L{Lk} h{H} d{D} f16, " + (
                "key mask" if kind == "cross" else "bias [h,L] with causal row")}
        del sets, kern, q, k, v, kw, q4, k4, v4, lib_mask
        torch.cuda.empty_cache()
    by_name["decode_attention"]["f16"] = {**rows["cross"], "self_step": rows["self"]}

    lcfg = lm_config()
    h, Ll, d = lcfg.n_heads, LM_LEN, lcfg.head_dim
    scale = d ** -0.5
    calls, fixed = {}, None
    for t in (torch.bfloat16, dt):
        q, k, v, do, _, out, lse, _ = backward_inputs(np.random.default_rng(SEED + 51), 1, h,
                                                      Ll, d, t, dev, mask=False, causal=True)
        calls[t] = bwd_kernel_calls(q, k, v, do, out, lse, scale, True)
        fixed = (q, k, v, do, out, lse)                  # the f16 set, for plain and SDPA
    q, k, v, do, out, lse = fixed
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, scale=scale)
    plain_ms = time_ms(lambda: backward_plain(q, k, v, None, out, lse, do, None, scale, True),
                       2, 1)
    sdpa_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), do,
                                                  retain_graph=True), 5, 2)
    pairs, elt, lse_bytes = h * Ll * (Ll + 1) // 2, h * Ll * d * 2, h * Ll * 4
    lm_errs = bwd_errs[f"f16 LM shape B1 H{h} L{Ll} D{d} causal"]
    for name, nbytes, flops, err in (
            ("flash_attention_bwd_dq", 5 * elt + 2 * lse_bytes, 6 * d * pairs, lm_errs["dq"]),
            ("flash_attention_bwd_dkv", 6 * elt + 2 * lse_bytes, 8 * d * pairs,
             max(lm_errs["dk"], lm_errs["dv"]))):
        b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16_FLOP_S)
        ms = in_turns({t: c[name] for t, c in calls.items()}, lambda f: device_ms(f, 5))
        inst = built.get(f"{dict(LM_PROFILED_KERNELS)[name]}<f16,{d}>", {})
        by_name[name]["f16"] = {
            "ms": ms[dt], "bf16_same_phase_ms": ms[torch.bfloat16], "plain_ms": plain_ms,
            "library_ms": sdpa_ms, "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "norm_tol": NORM_TOL[dt], "shape": f"B*H {h} L{Ll} D{d} causal f16",
            "host_us_per_call": host_us(calls[dt][name], 20), "registers": inst.get("regs"),
            "hgmma": inst.get("HGMMA"), "spill_bytes": inst.get("spill")}
    del q, k, v, do, out, lse, qs, ks, vs, sdpa_out, calls, fixed
    torch.cuda.empty_cache()
    for name in ("flash_attention", "decode_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        r = by_name[name]["f16"]
        log(f"[f16 timing] {name} {r['shape']}: kernel {r['ms']:.4f} ms device time (bf16 "
            f"in turns with it {r['bf16_same_phase_ms']:.4f} ms), plain {r['plain_ms']:.4f} "
            f"ms, SDPA {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}"
            + (f"; host {r['host_us_per_call']:.1f} us a call, {r['registers']} registers, "
               f"{r['hgmma']} HGMMA" if "host_us_per_call" in r else ""))
    r = by_name["decode_attention"]["f16"]["self_step"]
    log(f"[f16 timing] decode_attention self step {r['shape']}: kernel {r['ms']:.4f} ms (bf16 "
        f"{r['bf16_same_phase_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, SDPA "
        f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
    return kernels


class IdTokenizer:
    """Decodes generated ids to their decimal strings: random weights have
    no vocabulary to decode to, and the strings compare row for row."""

    def batch_decode(self, seqs, skip_special_tokens: bool = True):
        return [" ".join(map(str, row)) for row in np.asarray(seqs).tolist()]


def counting_predictor():
    """``T5GenerativePredictor`` that adds to each scored batch the model's
    device, the launches of both kernels in this process during the batch,
    the seconds the batch took in ``_predict_numpy`` and the seconds its
    ``from_checkpoint`` took: what the scoring actor reports back."""
    from tpu_air_torch.predict.predictors import T5GenerativePredictor

    class CountingT5Predictor(T5GenerativePredictor):
        @classmethod
        def from_checkpoint(cls, checkpoint, **kwargs):
            t0 = time.perf_counter()
            predictor = super().from_checkpoint(checkpoint, **kwargs)
            predictor.load_s = time.perf_counter() - t0
            return predictor

        def _predict_numpy(self, data, **kwargs):
            from tpu_air_torch.ops.decode_attention import decode_attention
            from tpu_air_torch.ops.flash_attention import flash_attention

            t0 = time.perf_counter()
            before = flash_attention.launches, decode_attention.launches
            out = super()._predict_numpy(data, **kwargs)
            if self.model.device.type == "cuda":
                torch.cuda.synchronize(self.model.device)
            return out.assign(device=str(self.model.device),
                              flash_launches=flash_attention.launches - before[0],
                              decode_launches=decode_attention.launches - before[1],
                              actor_predict_s=time.perf_counter() - t0,
                              actor_load_s=self.load_s)

    return CountingT5Predictor


def emitted_tokens(texts, cfg) -> int:
    """Tokens generated up to and with each row's first EOS (all pad for a
    row born finished)."""
    n = 0
    for row in texts:
        toks = np.array(row.split(), dtype=np.int64)
        if (toks == cfg.pad_token_id).all():
            continue
        eos = np.flatnonzero(toks == cfg.eos_token_id)
        n += int(eos[0]) + 1 if eos.size else len(toks)
    return n


def write_w3_checkpoint(dev, path: str) -> float:
    """FLAN-T5-base width and depth, random weights from numpy seed 0,
    written at ``path`` as the JAX package's checkpoint; its
    ``params.msgpack`` MB."""
    from tpu_air_torch.models.t5.modeling import T5ForConditionalGeneration
    from tpu_air_torch.train import Checkpoint

    cfg = model_config()
    model = T5ForConditionalGeneration(cfg, device=dev).init_weights(SEED)
    params = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    Checkpoint.from_model(model_config=cfg, params=params, format="jax", path=path)
    return os.path.getsize(os.path.join(path, "params.msgpack")) / 1e6


@functools.lru_cache(maxsize=None)
def native_toolchain() -> tuple:
    """(the native toolchain found here, why the GCS daemon cannot be built
    and driven here or None): checked once a run, printed by phase 1."""
    from tpu_air_torch import _native

    tools = _native.toolchain()
    return tools, _native.gcs_missing(tools)


def gcs_expected() -> bool:
    """Whether this machine can build and drive the GCS daemon."""
    return native_toolchain()[1] is None


def runtime_native(phase: str) -> dict:
    """The driver runtime's arena stats and GCS membership.  Fails where the
    runtime's store has no arena or, where the daemon is buildable, where
    ``nodes()`` does not list this host alive with the runtime's cards."""
    from tpu_air_torch.core.runtime import get_runtime

    rt = get_runtime()
    if rt.store._arena is None:
        raise AssertionError(f"[{phase}] the runtime's object store has no arena")
    nodes = rt.nodes()
    if gcs_expected():
        host = [n for n in nodes if n["node_id"] == rt.node_id]
        if not (rt.gcs_address and host and host[0]["alive"]
                and host[0]["num_chips"] == rt.num_chips):
            raise AssertionError(f"[{phase}] the GCS at {rt.gcs_address} lists {nodes}, not "
                                 f"{rt.node_id} alive with {rt.num_chips} cards")
    return {"arena": rt.store._arena.stats(), "gcs_address": rt.gcs_address, "nodes": nodes}


def check_native(phase: str, before: dict, after: dict) -> dict:
    """Print the arena's stats at a phase's end against its start and the
    GCS's nodes; fails unless the phase's objects went into the arena (live
    objects and sealed bytes grew) and no block was leaked."""
    a, b = after["arena"], before["arena"]
    log(f"[{phase}] on the arena: live objects {a['live_objects']} "
        f"(+{a['live_objects'] - b['live_objects']}), sealed bytes {a['sealed_bytes']} "
        f"(+{a['sealed_bytes'] - b['sealed_bytes']}), used {a['used']} of {a['capacity']}, "
        f"free-list bytes {a['free_bytes']}, leaked_bytes {a['leaked_bytes']}; GCS "
        f"{after['gcs_address']}: nodes {after['nodes']}")
    if not (a["live_objects"] > b["live_objects"] and a["sealed_bytes"] > b["sealed_bytes"]):
        raise AssertionError(f"[{phase}] nothing went into the arena: {b} -> {a}")
    if a["leaked_bytes"] != 0:
        raise AssertionError(f"[{phase}] the arena leaked {a['leaked_bytes']} bytes")
    return {"arena": a, "arena_at_start": b, "gcs_address": after["gcs_address"],
            "nodes": after["nodes"]}


def batch_path(dev, path: str) -> dict:
    """W3 as the reference runs it: FLAN-T5-base width and depth, random
    weights from numpy seed 0, written as the JAX package's checkpoint
    (``params.msgpack``) at ``path`` (phase 21 serves it again), then
    ``tpu_air_torch.init()`` and ``BatchPredictor.from_checkpoint(...,
    dtype="float16").predict(ds, num_gpus_per_worker=1, batch_size=64,
    max_new_tokens=128)``: one
    scoring actor leases the card and generates for 64 prompts of 512
    tokens (ragged, one all-pad row).  Its outputs must equal, row for row,
    those of the in-process predictor on the same checkpoint."""
    import pandas as pd

    import tpu_air_torch
    from tpu_air_torch.data import from_pandas
    from tpu_air_torch.predict import BatchPredictor, T5GenerativePredictor
    from tpu_air_torch.train import Checkpoint

    cfg = model_config()
    t0 = time.perf_counter()
    mb = write_w3_checkpoint(dev, path)
    log(f"[batch] FLAN-T5-base width, {cfg.num_layers}+{cfg.num_decoder_layers} layers, "
        f"weights from numpy seed {SEED}, written in the JAX package's format "
        f"(params.msgpack {mb:.1f} MB) in {time.perf_counter() - t0:.1f} s")
    n, L, new = BATCH, PROMPT_LEN, NEW_TOKENS
    ids, mask = prompts(n, L, cfg.vocab_size, SEED + 5)
    df = pd.DataFrame({"input_ids": list(ids), "attention_mask": list(mask),
                       "idx": np.arange(n)})
    feats = ["input_ids", "attention_mask"]

    t0 = time.perf_counter()
    tpu_air_torch.init()
    init_s = time.perf_counter() - t0
    try:
        native_start = runtime_native("batch")
        bp = BatchPredictor.from_checkpoint(Checkpoint.from_directory(path),
                                            counting_predictor(), tokenizer=IdTokenizer(),
                                            dtype="float16")
        t0 = time.perf_counter()
        out = bp.predict(from_pandas(df), num_gpus_per_worker=1, batch_size=n,
                         max_new_tokens=new, feature_columns=feats,
                         keep_columns=["idx"]).to_pandas()
        wall = time.perf_counter() - t0
        native = check_native("batch", native_start, runtime_native("batch"))
    finally:
        tpu_air_torch.shutdown()
    out = out.sort_values("idx").reset_index(drop=True)
    actor_s = float(out["actor_predict_s"].unique().sum())
    load_s = float(out["actor_load_s"].unique().sum())
    flash_n = int(out["flash_launches"].unique().sum())
    decode_n = int(out["decode_launches"].unique().sum())
    steps = decode_n // (2 * cfg.num_decoder_layers)
    devices = sorted(set(out["device"]))
    emitted = emitted_tokens(out["generated_output"], cfg)
    log(f"[batch] BatchPredictor.predict: {n} prompts x {L} tokens -> {new} new tokens "
        f"in one leased scoring actor on {devices}, f16: wall {wall:.3f} s (runtime "
        f"init {init_s:.3f} s before it), {emitted / wall:.1f} generated tokens/s; the "
        f"actor's predict {actor_s:.3f} s, share of the wall outside it (pool start-up, "
        f"object store, data path) {1 - actor_s / wall:.3f}; of that, the actor's "
        f"from_checkpoint (1 GB msgpack read and converted, model built, cast to f16) "
        f"{load_s:.3f} s")
    log(f"[batch] the actor's launches: flash {flash_n}, decode {decode_n} ({steps} decode "
        f"steps; expect flash = {cfg.num_layers}, decode = 2 x {cfg.num_decoder_layers} "
        "per step)")
    if devices != ["cuda:0"]:
        raise AssertionError(f"[batch] the scoring actor's model is on {devices}")
    if flash_n != cfg.num_layers or steps <= 0 or \
            decode_n != steps * 2 * cfg.num_decoder_layers or steps > new:
        raise AssertionError(f"[batch] launches flash {flash_n}, decode {decode_n}")
    if out["idx"].tolist() != list(range(n)):
        raise AssertionError("[batch] rows lost or duplicated")

    # the same rows through the in-process predictor of the same checkpoint
    ref = T5GenerativePredictor.from_checkpoint(Checkpoint.from_directory(path),
                                                dtype="float16", device=dev,
                                                tokenizer=IdTokenizer())
    want = ref.predict(df[feats], max_new_tokens=new)["generated_output"].tolist()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = ref.predict(df[feats], max_new_tokens=new)["generated_output"].tolist()
    torch.cuda.synchronize()
    inproc_s = time.perf_counter() - t0
    same = out["generated_output"].tolist() == want
    log(f"[batch] in-process T5GenerativePredictor on the same checkpoint, f16: "
        f"{inproc_s:.3f} s warm ({emitted_tokens(again, cfg) / inproc_s:.1f} generated "
        f"tokens/s); outputs identical to the batch path row for row: {same}")
    if not same or again != want:
        raise AssertionError("[batch] the batch path and the in-process predictor differ")
    toks = np.stack([np.array(r.split(), dtype=np.int64) for r in want])
    if toks.shape != (n, new) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"[batch] generated {toks.shape} ids out of range")
    if (toks[-1] != cfg.pad_token_id).any():
        raise AssertionError("[batch] the all-pad row did not stay finished")

    # f16 at full width with random weights: does it stay finite?
    tids, tmask = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
    with torch.no_grad():
        enc = ref.model.encode(tids, tmask)
        logits = ref.model(tids, tmask, torch.zeros(n, 1, dtype=torch.long, device=dev))
    live = tmask.sum(1) > 0
    finite = {"encoder": bool(torch.isfinite(enc).all()),
              "first_step_logits_live_rows": bool(torch.isfinite(logits[live]).all()),
              "encoder_max_abs": float(enc.float().abs().max())}
    # and the kernel-free plain path in f16 on the card (not asserted: at
    # full width, random weights and f16 a near-tie may flip a token)
    with plain_attention():
        plain = ref.predict(df[feats], max_new_tokens=new)["generated_output"].tolist()
    ptoks = np.stack([np.array(r.split(), dtype=np.int64) for r in plain])
    match = int((ptoks == toks).sum())
    # a greedy row that flips once goes its own way after: where do they first differ
    first = [int(np.flatnonzero(a != b)[0]) for a, b in zip(toks, ptoks) if (a != b).any()]
    log(f"[batch] f16 finite: {finite}; kernel path vs plain path in f16: {match} of "
        f"{toks.size} tokens equal, {int((ptoks == toks).all(1).sum())} of {n} rows; "
        f"first differing step of the others: min {min(first, default=-1)}, median "
        f"{int(np.median(first)) if first else -1}")
    del ref, enc, logits
    torch.cuda.empty_cache()
    return {"wall_s": wall, "init_s": init_s, "tokens_per_s": emitted / wall,
            "actor_predict_s": actor_s, "outside_actor_share": 1 - actor_s / wall,
            "actor_load_s": load_s,
            "launches": {"flash_attention": flash_n, "decode_attention": decode_n},
            "steps": steps, "device": devices[0], "identical_to_in_process": same,
            "in_process_s": inproc_s,
            "in_process_tokens_per_s": emitted_tokens(again, cfg) / inproc_s,
            "params_msgpack_mb": mb, "finite": finite,
            "plain_tokens_equal": match, "tokens": int(toks.size),
            "plain_first_diff_steps": first, "native": native}


# -- phase 16 ----------------------------------------------------------------------


def w2_probe_loop(config):
    """W2's trial function: ``t5_train_loop`` as ``T5Trainer`` runs it, and
    what the trial actor saw, written beside its checkpoints
    (``w2_probe.json``): the device the loop resolved, the card's free
    memory at the trial's start, the kernels' launches in the actor, its
    peak memory and wall seconds."""
    from tpu_air_torch.device import resolve_device
    from tpu_air_torch.ops.decode_attention import decode_attention
    from tpu_air_torch.ops.flash_attention import flash_attention, flash_attention_backward
    from tpu_air_torch.train import session
    from tpu_air_torch.train.t5_trainer import t5_train_loop

    def counts():
        return {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches,
                "flash_attention_bwd_dq": flash_attention_backward.dq_launches,
                "flash_attention_bwd_dkv": flash_attention_backward.dkv_launches}

    t0 = time.perf_counter()
    dev = resolve_device(config.get("_device"))
    free, total = torch.cuda.mem_get_info(dev)
    probe = {"device": str(dev), "pid": os.getpid(), "lease": os.environ.get("TPU_AIR_CHIP_IDS"),
             "free_gb_at_start": free / 1e9, "total_gb": total / 1e9}
    before = counts()
    try:
        t5_train_loop(config)
    finally:
        probe["launches"] = {k: n - before[k] for k, n in counts().items()}
        probe["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        probe["wall_s"] = time.perf_counter() - t0
        with open(os.path.join(session.get_session().run_dir, "w2_probe.json"), "w") as f:
            json.dump(probe, f)


def w2_path(dev) -> dict:
    """W2 as the reference runs it: ``Tuner(T5Trainer(...))`` over
    FLAN-T5-base (full width and depth, dropout 0.1, bf16 compute on f32
    parameters, random weights from numpy seed 0 in every trial, AdamW, W1's
    batch of 8 x 512/512), the reference's search space under
    ``trainer_init_config``, ``ASHAScheduler(max_t=16)`` on eval_loss, seed
    0; each trial leases the card in its own actor
    (``ScalingConfig(num_workers=1, use_gpu=True)``) and keeps its best
    checkpoint.  Cut: 2 of the reference's 4 samples, an epoch is 2 steps
    (16 rows), evaluation 8 rows.
    Then generation from the sweep's best checkpoint in bf16, through the
    kernels and through the plain versions on the card."""
    import shutil
    import tempfile

    import tpu_air_torch
    from tpu_air_torch import tune
    from tpu_air_torch.models.tokenizer import ByteTokenizer
    from tpu_air_torch.ops.decode_attention import decode_attention
    from tpu_air_torch.ops.flash_attention import flash_attention
    from tpu_air_torch.predict.predictors import T5GenerativePredictor
    from tpu_air_torch.train import (CheckpointConfig, RunConfig, ScalingConfig, T5Trainer,
                                     TrainingArguments)

    class ProbingT5Trainer(T5Trainer):
        def _training_fn(self):
            return w2_probe_loop

    cfg = w1_config()
    train = w1_rows(W1_BATCH * W2_STEPS, cfg.vocab_size, SEED + 50)
    evaluation = w1_rows(W2_EVAL_ROWS, cfg.vocab_size, SEED + 51)
    storage = tempfile.mkdtemp(prefix="chip_smoke-w2-")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    try:
        # W1's arguments; the sweep overrides lr, epochs and weight decay
        args = TrainingArguments(learning_rate=2e-5, weight_decay=0.01,
                                 per_device_train_batch_size=W1_BATCH, num_train_epochs=4,
                                 seed=SEED)
        trainer = ProbingT5Trainer(
            model_config=cfg, training_args=args, tokenizer=ByteTokenizer(W1_LEN),
            datasets={"train": train, "evaluation": evaluation},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(storage_path=storage, checkpoint_config=CheckpointConfig(
                num_to_keep=1, checkpoint_score_attribute="eval_loss",
                checkpoint_score_order="min")))
        tuner = tune.Tuner(
            trainer,
            param_space={"trainer_init_config": {k: tune.choice(v) for k, v in W2_SPACE.items()}},
            tune_config=tune.TuneConfig(metric="eval_loss", mode="min", num_samples=W2_SAMPLES,
                                        seed=SEED, scheduler=tune.ASHAScheduler(max_t=W2_MAX_T)))
        t0 = time.perf_counter()
        tpu_air_torch.init()
        init_s = time.perf_counter() - t0
        try:
            t0 = time.perf_counter()
            grid = tuner.fit()
            sweep_s = time.perf_counter() - t0
        finally:
            tpu_air_torch.shutdown()
        log(f"[w2] Tuner(T5Trainer) over FLAN-T5-base ({cfg.d_model} wide, {cfg.num_layers}+"
            f"{cfg.num_decoder_layers} layers, dropout {cfg.dropout_rate}, bf16 on f32, numpy "
            f"seed {SEED} weights), batch {W1_BATCH} x {W1_LEN}/{W1_LEN}, epochs of {W2_STEPS} "
            f"steps and {W2_EVAL_ROWS} eval rows; space {W2_SPACE}, {W2_SAMPLES} samples, "
            f"ASHA(max_t={W2_MAX_T}) on eval_loss, seed {SEED}: {len(grid)} trials, "
            f"{grid.num_errors} errors, sweep wall {sweep_s:.1f} s (runtime init {init_s:.1f} s "
            f"before it); the driver's card memory before it: {free / 1e9:.2f} of "
            f"{total / 1e9:.2f} GB free")
        if grid.num_errors or len(grid) != W2_SAMPLES:
            raise AssertionError(f"[w2] trial errors: {grid.errors}")
        trials, steps, trial_launches = [], 0, {}
        for i, r in enumerate(grid):
            with open(os.path.join(r.path, "w2_probe.json")) as f:
                probe = json.load(f)
            hist = r.metrics_history
            sampled = {k: r.config[k] for k in W2_SPACE}
            evals = [m["eval_loss"] for m in hist]
            steps += sum(m["steps"] for m in hist)
            for k, n in probe["launches"].items():
                trial_launches[k] = trial_launches.get(k, 0) + n
            trials.append({"config": sampled, "epochs_ran": len(hist), "eval_loss": evals,
                           "loss": [m["loss"] for m in hist], **probe})
            log(f"[w2] trial {i}: {sampled}, ran {len(hist)} of {sampled['epochs']} epochs, "
                f"eval_loss " + ", ".join(f"{x:.4f}" for x in evals)
                + f"; in its actor (pid {probe['pid']}, lease {probe['lease']}): device "
                f"{probe['device']}, card memory free at its start {probe['free_gb_at_start']:.2f}"
                f" of {probe['total_gb']:.2f} GB, peak {probe['peak_gb']:.2f} GB, wall "
                f"{probe['wall_s']:.1f} s, launches {probe['launches']}")
            # train steps (dropout 0.1) take the dense path; each epoch's eval
            # is one batch of the encoder's and the decoder's two attentions
            per_epoch = -(-W2_EVAL_ROWS // W1_BATCH) * (cfg.num_layers + 2 * cfg.num_decoder_layers)
            if probe["device"] != "cuda:0" or probe["lease"] != "0":
                raise AssertionError(f"[w2] trial {i} trained on {probe['device']}")
            if probe["launches"]["flash_attention"] <= 0 or \
                    probe["launches"]["flash_attention"] != per_epoch * len(hist) or \
                    probe["launches"]["decode_attention"] or \
                    probe["launches"]["flash_attention_bwd_dq"]:
                raise AssertionError(f"[w2] trial {i} launches {probe['launches']}")
            if len(hist) > min(sampled["epochs"], W2_MAX_T) or \
                    [m["steps"] for m in hist] != [W2_STEPS] * len(hist):
                raise AssertionError(f"[w2] trial {i} history {hist}")
        tokens = steps * W1_BATCH * W1_LEN
        log(f"[w2] {steps} train steps over all trials, {tokens} trained tokens (global batch x "
            f"source length) in the sweep's {sweep_s:.1f} s = {tokens / sweep_s:.1f} trained "
            f"tokens/s of sweep wall; trial actors' launches {trial_launches}")

        best = grid.get_best_result()
        done = [r.metrics["eval_loss"] for r in grid if r.error is None]
        finite = [x for x in done if np.isfinite(x)]
        if best.checkpoint is None or not np.isfinite(best.metrics["eval_loss"]) or \
                best.metrics["eval_loss"] != min(finite):
            raise AssertionError(f"[w2] best {best.metrics.get('eval_loss')} of {done}, "
                                 f"checkpoint {best.checkpoint}")
        t0 = time.perf_counter()
        predictor = T5GenerativePredictor.from_checkpoint(best.checkpoint, dtype="bfloat16",
                                                          device=dev, tokenizer=IdTokenizer())
        load_s = time.perf_counter() - t0
        ids, mask = prompts(W1_PROMPTS, W1_LEN, cfg.vocab_size, SEED + 52)
        batch = {"input_ids": ids, "attention_mask": mask}
        flash_attention.launches = decode_attention.launches = 0
        t0 = time.perf_counter()
        out = predictor.predict(batch, max_new_tokens=W1_NEW)["generated_output"].tolist()
        gen_s = time.perf_counter() - t0
        gen = {"flash_attention": flash_attention.launches,
               "decode_attention": decode_attention.launches}
        with plain_attention():
            plain = predictor.predict(batch, max_new_tokens=W1_NEW)["generated_output"].tolist()
        if (flash_attention.launches, decode_attention.launches) != tuple(gen.values()):
            raise AssertionError("[w2] the plain path launched kernels")
        dsteps = gen["decode_attention"] // (2 * cfg.num_decoder_layers)
        toks = np.stack([np.array(r.split(), dtype=np.int64) for r in out])
        log(f"[w2] best trial {best.config['learning_rate']}/{best.config['epochs']}/"
            f"{best.config['weight_decay']} (lr/epochs/wd): eval_loss "
            f"{best.metrics['eval_loss']:.4f}, checkpoint from_checkpoint(dtype='bfloat16') in "
            f"{load_s:.1f} s; predict {W1_PROMPTS} prompts x {W1_LEN} -> {W1_NEW} new tokens in "
            f"{gen_s:.2f} s, {dsteps} decode steps, {emitted_tokens(out, cfg)} tokens up to each "
            f"row's first EOS, launches {gen}; tokens equal to the plain path's on the card: "
            f"{out == plain}")
        if gen["flash_attention"] != cfg.num_layers or gen["decode_attention"] <= 0 or \
                gen["decode_attention"] != dsteps * 2 * cfg.num_decoder_layers:
            raise AssertionError(f"[w2] generation launches {gen}")
        if toks.shape != (W1_PROMPTS, W1_NEW) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"[w2] generated {toks.shape} ids out of range")
        if out != plain:
            raise AssertionError("[w2] the kernel and plain paths generate different tokens")
        del predictor
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    return {"sweep_wall_s": sweep_s, "runtime_init_s": init_s, "train_steps": steps,
            "trained_tokens": tokens, "trained_tokens_per_s": tokens / sweep_s,
            "trials": trials, "best": {k: best.config[k] for k in W2_SPACE},
            "best_eval_loss": best.metrics["eval_loss"], "generate_s": gen_s,
            "decode_steps": dsteps, "emitted_tokens": emitted_tokens(out, cfg),
            "launches": {"w2_trial_actors": trial_launches, "w2_generate": gen}}


# -- phases 17-19: SegFormer (W7, W6) ------------------------------------------------


def seg_config(depths=None, dropout: bool = True):
    """MiT-b0 at its published width, ADE20K's 150 labels, f32; depth cut to
    ``depths`` and dropout and drop-path off where asked."""
    from tpu_air_torch.models.segformer import SegformerConfig

    cfg = SegformerConfig.mit_b0(num_labels=150)
    if depths is not None:
        cfg.depths = list(depths)
    if not dropout:
        cfg.classifier_dropout_prob = cfg.drop_path_rate = 0.0
    return cfg


def seg_images(n: int, seed: int, labels: bool = False):
    """Synthetic ADE-like uint8 images of ragged sizes (heights 384-683,
    widths 512-683, as ADE20K's validation images run), and with
    ``labels`` their annotations: 0-150 (0 = unlabeled) in blocks of 32
    pixels."""
    rng = np.random.default_rng(seed)
    images, annotations = [], []
    for _ in range(n):
        h, w = int(rng.integers(384, 684)), int(rng.integers(512, 684))
        images.append(rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8))
        if labels:
            blocks = rng.integers(0, 151, size=(h // 32 + 1, w // 32 + 1)).astype(np.uint8)
            annotations.append(np.kron(blocks, np.ones((32, 32), np.uint8))[:h, :w])
    return (images, annotations) if labels else images


def kernel_counts() -> dict:
    from tpu_air_torch.ops.decode_attention import decode_attention
    from tpu_air_torch.ops.flash_attention import flash_attention, flash_attention_backward

    return {"flash_attention": flash_attention.launches,
            "decode_attention": decode_attention.launches,
            "flash_attention_bwd_dq": flash_attention_backward.dq_launches,
            "flash_attention_bwd_dkv": flash_attention_backward.dkv_launches}


def tf32_flags() -> str:
    # backends through getattr: this function travels to the runtime's
    # workers by value (this script is __main__), and cloudpickle takes an
    # attribute chain torch.backends.<name> for a submodule to import and
    # pickles sys.modules' entry for it, which torch.backends.cudnn and
    # torch.backends.cuda replace with objects that do not pickle
    backends = getattr(torch, "backends")
    return f"{backends.cuda.matmul.allow_tf32},{backends.cudnn.allow_tf32}"


def probing_seg_predictor(device=None):
    """``SemanticSegmentationPredictor`` that adds to each scored batch the
    model's device and its process's TF32 flags ("matmul,cuDNN"): what a
    worker reports back.  Masks travel as uint8 (150 labels).  Loaded with
    no device, it lands where the predictor puts it (``device`` names one
    for a rehearsal on the CPU)."""
    from tpu_air_torch.predict.predictors import SemanticSegmentationPredictor

    class ProbingSegPredictor(SemanticSegmentationPredictor):
        @classmethod
        def from_checkpoint(cls, checkpoint, **kwargs):
            kwargs.setdefault("device", device)
            return super().from_checkpoint(checkpoint, **kwargs)

        def _predict_pandas(self, data, **kwargs):
            out = super()._predict_pandas(data, **kwargs)
            return out.assign(predicted_mask=[m.astype(np.uint8) for m in out["predicted_mask"]],
                              device=str(self.model.device), tf32=tf32_flags())

    return ProbingSegPredictor


def profile_once(fn) -> tuple:
    """(wall ms, {kernel: (device ms, launches)}) of one call of ``fn``
    under the profiler.  The profiler can lose kernel records on this
    machine (``complete_profile``), so the device time it sums is a floor."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, device_kernels(prof, 1)


def predict_parts(predictor, batch) -> dict:
    """The steps of ``SemanticSegmentationPredictor._predict_pandas`` on one
    batch, each timed on the host clock and ended by a sync: the host's
    pre-processing, the copy to the card, the forward, and the
    post-processing (resize and argmax on the card, the masks' copies)."""
    from tpu_air_torch.models.segformer.image_processor import _to_numpy_image

    fe, dev = predictor.feature_extractor, predictor.model.device
    marks = [("start", time.perf_counter())]
    images = [_to_numpy_image(im) for im in batch]
    px = fe(images)["pixel_values"]
    marks.append(("pre-processing", time.perf_counter()))
    x = torch.from_numpy(px)
    x = (x.pin_memory() if dev.type == "cuda" else x).to(dev, non_blocking=True)
    torch.cuda.synchronize(dev)
    marks.append(("pin and copy", time.perf_counter()))
    with torch.inference_mode():
        logits = predictor.model(x)
        torch.cuda.synchronize(dev)
        marks.append(("forward", time.perf_counter()))
        fe.post_process_semantic_segmentation(logits, [im.shape[:2] for im in images])
    marks.append(("post-processing", time.perf_counter()))
    return {b[0]: (b[1] - a[1]) * 1e3 for a, b in zip(marks, marks[1:])}


def w7_path(dev) -> dict:
    """W7 as the reference runs it (Scaling_batch_inference.ipynb cc-60, 78,
    91-98, 105-115, 124-129): MiT-b0 width, 150 labels, random weights from
    numpy seed 0 at HF's initializer scales, written in the JAX package's
    checkpoint format (``params.msgpack``, batch-norm stats in
    ``extras.pkl``); 64 ragged ADE-like images, processor size 512, batches
    of 16, through five architectures: sequential in process; tasks that
    reload the predictor from an object-store reference; two actors with a
    ``wait`` loop; ``ActorPool.map_unordered`` over them; and
    ``BatchPredictor.predict(ds, batch_size=16, num_gpus_per_worker=1)``.
    Tasks and actors lease half the card each.  Every mask must have its
    image's size and agree with the sequential run's on 99.99% of pixels.
    The sequential yardstick runs under the TF32 flags the workers report
    (a fresh process's: cuDNN's TF32 on, matmul's off), not this script's."""
    import shutil
    import tempfile

    import pandas as pd

    import tpu_air_torch
    from tpu_air_torch.data import from_items
    from tpu_air_torch.models.segformer.modeling import SegformerForSemanticSegmentation
    from tpu_air_torch.predict import BatchPredictor
    from tpu_air_torch.train import Checkpoint

    cfg = seg_config()
    probe_cls = probing_seg_predictor()
    tmp = tempfile.mkdtemp(prefix="chip_smoke-w7-")
    try:
        model = SegformerForSemanticSegmentation(cfg, device="cpu").init_weights(SEED)
        n_params = sum(p.numel() for p in model.parameters())
        path = os.path.join(tmp, "ckpt")
        Checkpoint.from_model(model_config=cfg, params=model.state_dict(), format="jax",
                              path=path)
        del model
        images = seg_images(SEG_IMAGES, SEED + 60)
        batches = [images[i:i + SEG_BATCH] for i in range(0, len(images), SEG_BATCH)]
        pixels = sum(im.shape[0] * im.shape[1] for im in images)

        def run_batch(predictor, batch):
            out = predictor.predict(pd.DataFrame({"image": list(batch)}))
            return list(out["predicted_mask"]), sorted(set(out["device"])), out["tf32"].iloc[0]

        # 1. sequential, in this process, under a fresh process's flags
        mine = tf32_flags()
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
        fresh = tf32_flags()
        before = kernel_counts()
        try:
            predictor = probe_cls.from_checkpoint(Checkpoint.from_directory(path), device=dev)
            run_batch(predictor, batches[0])                 # warm-up: cuDNN's picks
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            seq = [run_batch(predictor, b) for b in batches]
            seq_s = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
            seq_masks = [m for masks, _, _ in seq for m in masks]
            x = torch.from_numpy(predictor.feature_extractor(batches[0])["pixel_values"]).to(dev)
            # back-to-back forwards on the device clock (``device_ms`` cannot
            # queue them behind a sleep: 5 forwards overflow the launch queue)
            with torch.inference_mode():
                fwd_ms = time_ms(lambda: predictor.model(x), 5, warmup=1)
            df0 = pd.DataFrame({"image": batches[0]})
            predict_ms, kernels = profile_once(lambda: predictor.predict(df0))
            busy_ms = sum(t for t, _ in kernels.values())
            top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
            split = predict_parts(predictor, batches[0])
            del predictor, x
            torch.cuda.empty_cache()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = mine.startswith("True")
            torch.backends.cudnn.allow_tf32 = mine.endswith("True")
        in_process = {k: n - before[k] for k, n in kernel_counts().items()}
        for m, im in zip(seq_masks, images):
            if m.shape != im.shape[:2]:
                raise AssertionError(f"[w7] a {m.shape} mask for a {im.shape[:2]} image")
        log(f"[w7] MiT-b0 ({cfg.hidden_sizes} wide, depths {cfg.depths}, {n_params / 1e6:.2f}M "
            f"parameters), {cfg.num_labels} labels, f32, weights from numpy seed {SEED} at HF's "
            f"initializer scales in the JAX package's checkpoint format; {SEG_IMAGES} ragged "
            f"ADE-like images ({pixels / 1e6:.2f} Mpixel), processor size {SEG_SIZE}, batches "
            f"of {SEG_BATCH}; yardstick TF32 flags (matmul, cuDNN) {fresh}, this script's "
            f"{mine}")
        log(f"[w7] 1 sequential: {seq_s:.3f} s = {SEG_IMAGES / seq_s:.2f} images/s on "
            f"{seq[0][1]}; forward of a batch of {SEG_BATCH} at {SEG_SIZE}^2 {fwd_ms:.2f} ms "
            f"(device clock, back to back); one in-process predict of {SEG_BATCH} images "
            f"{predict_ms:.1f} ms wall, device busy {busy_ms:.1f} ms in "
            f"{sum(c for _, c in kernels.values()):.0f} kernels and copies (profiler: a "
            f"floor), idle share {1 - busy_ms / predict_ms:.4f}; by the forward's device time "
            f"alone {1 - fwd_ms / predict_ms:.4f}; peak memory {peak_gb:.2f} GB; heaviest: "
            + "; ".join(f"{k[:50]} {t:.2f} ms x{c:g}" for k, (t, c) in top))
        log("[w7] one predict's parts, host clock with a sync after each: "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items()))
        if any(in_process.values()):
            raise AssertionError(f"[w7] SegFormer launched the attention kernels: {in_process}")

        results = {"sequential": {"wall_s": seq_s, "devices": seq[0][1], "tf32": fresh,
                                  "differing_pixels": 0}}

        def record(name, wall, masks, devices, flags):
            diff = sum(int((a != b).sum()) for a, b in zip(masks, seq_masks))
            shapes = all(m.shape == im.shape[:2] for m, im in zip(masks, images))
            results[name] = {"wall_s": wall, "devices": devices, "tf32": flags,
                             "differing_pixels": diff}
            log(f"[w7] {name}: {wall:.3f} s = {SEG_IMAGES / wall:.2f} images/s on {devices}, "
                f"TF32 flags {flags}; {diff} of {pixels} pixels differ from the sequential "
                f"masks ({1 - diff / pixels:.6f} agree); every mask its image's size: {shapes}")
            if devices != [str(dev)] or len(masks) != SEG_IMAGES or not shapes or \
                    diff > 1e-4 * pixels or flags != fresh:
                raise AssertionError(f"[w7] {name}: {results[name]}")

        share = 1.0 / SEG_ACTORS
        t0 = time.perf_counter()
        tpu_air_torch.init()
        init_s = time.perf_counter() - t0
        try:
            # 2. stateless tasks: the predictor re-enters from the object store
            ckpt_ref = tpu_air_torch.put(Checkpoint.from_directory(path))

            @tpu_air_torch.remote(num_chips=share)
            def inference_task(ckpt, batch):
                return run_batch(probe_cls.from_checkpoint(ckpt), batch)

            t0 = time.perf_counter()
            outs = tpu_air_torch.get([inference_task.remote(ckpt_ref, b) for b in batches])
            record("tasks", time.perf_counter() - t0, [m for o in outs for m in o[0]],
                   sorted({d for o in outs for d in o[1]}), outs[0][2])

            # 3. two actors and a wait loop (cc-105-115)
            @tpu_air_torch.remote(num_chips=share)
            class PredictionActor:
                def __init__(self, ckpt):
                    self.predictor = probe_cls.from_checkpoint(ckpt)

                def predict(self, i, batch):
                    return i, run_batch(self.predictor, batch)

            actors = [PredictionActor.remote(Checkpoint.from_directory(path))
                      for _ in range(SEG_ACTORS)]
            tpu_air_torch.get([a.predict.remote(0, batches[0]) for a in actors])   # warm
            t0 = time.perf_counter()
            idle, in_flight, done = list(actors), {}, {}
            work = list(enumerate(batches))
            while work or in_flight:
                while idle and work:
                    a = idle.pop()
                    in_flight[a.predict.remote(*work.pop())] = a
                ready, _ = tpu_air_torch.wait(list(in_flight), num_returns=1)
                for r in ready:
                    i, out = tpu_air_torch.get(r)
                    done[i] = out
                    idle.append(in_flight.pop(r))
            outs = [done[i] for i in range(len(batches))]
            record("actors + wait", time.perf_counter() - t0, [m for o in outs for m in o[0]],
                   sorted({d for o in outs for d in o[1]}), outs[0][2])

            # 4. ActorPool.map_unordered over the same actors (cc-124-129)
            t0 = time.perf_counter()
            pool = tpu_air_torch.ActorPool(actors)
            done = dict(pool.map_unordered(lambda a, ib: a.predict.remote(*ib),
                                           list(enumerate(batches))))
            outs = [done[i] for i in range(len(batches))]
            record("ActorPool", time.perf_counter() - t0, [m for o in outs for m in o[0]],
                   sorted({d for o in outs for d in o[1]}), outs[0][2])
            for a in actors:
                tpu_air_torch.kill(a)

            # 5. BatchPredictor (cc-76-78), one scoring actor on the whole card
            t0 = time.perf_counter()
            ds = from_items([{"image": im, "idx": i} for i, im in enumerate(images)],
                            parallelism=len(batches))
            bp = BatchPredictor.from_checkpoint(Checkpoint.from_directory(path), probe_cls)
            out = bp.predict(ds, batch_size=SEG_BATCH, num_gpus_per_worker=1,
                             keep_columns=["idx"]).to_pandas()
            wall = time.perf_counter() - t0
            out = out.sort_values("idx")
            if out["idx"].tolist() != list(range(SEG_IMAGES)):
                raise AssertionError("[w7] BatchPredictor lost or duplicated rows")
            record("BatchPredictor", wall, list(out["predicted_mask"]),
                   sorted(set(out["device"])), out["tf32"].iloc[0])
        finally:
            tpu_air_torch.shutdown()
        log(f"[w7] runtime init {init_s:.1f} s before architectures 2-5")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"architectures": results, "images": SEG_IMAGES, "pixels": pixels,
            "images_per_s": {k: SEG_IMAGES / v["wall_s"] for k, v in results.items()},
            "forward_ms_batch16": fwd_ms, "predict_ms_batch16": predict_ms,
            "predict_device_busy_ms": busy_ms, "predict_idle_share": 1 - busy_ms / predict_ms,
            "predict_idle_share_by_forward": 1 - fwd_ms / predict_ms, "predict_parts_ms": split,
            "peak_memory_gb": peak_gb,
            "runtime_init_s": init_s, "launches": in_process}


def example_module(name: str):
    """``examples/<name>.py`` of this checkout, loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def w6_path(dev) -> dict:
    """W6 on the card: ``SegformerTrainer`` over MiT-b0 (150 labels, dropout
    and drop-path 0.1 as published, f32, random weights from numpy seed 0),
    AdamW lr 1e-4 and weight decay 0, batch 8, one epoch of 6 steps, keep-1
    checkpoint by min loss, on ``ScalingConfig(num_workers=1,
    use_gpu=True)``; the port's ``images_preprocessor`` (size 512,
    ``do_reduce_labels``) over 48 train and 16 eval synthetic images.  Each
    step's loss and device-clock time come from wrapping the step the loop
    builds; then a profiled step, and prediction from the best checkpoint."""
    import shutil
    import tempfile

    import pandas as pd

    from tpu_air_torch.models.segformer import SegformerImageProcessor
    from tpu_air_torch.models.segformer.modeling import SegformerForSemanticSegmentation
    from tpu_air_torch.predict import SemanticSegmentationPredictor
    from tpu_air_torch.train import (CheckpointConfig, RunConfig, ScalingConfig,
                                     SegformerTrainer, TrainingArguments, segformer_trainer)

    images_preprocessor = example_module("torch_segformer_finetune").images_preprocessor
    cfg = seg_config()
    train_imgs, train_ann = seg_images(W6_TRAIN, SEED + 70, labels=True)
    eval_imgs, eval_ann = seg_images(W6_EVAL, SEED + 71, labels=True)
    args = TrainingArguments(learning_rate=1e-4, weight_decay=0.0,
                             per_device_train_batch_size=W6_BATCH, num_train_epochs=1,
                             max_steps_per_epoch=W6_STEPS, seed=SEED)
    storage = tempfile.mkdtemp(prefix="chip_smoke-w6-")
    trainer = SegformerTrainer(
        model_config=cfg, training_args=args,
        feature_extractor=SegformerImageProcessor(size=SEG_SIZE),
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        datasets={"train": pd.DataFrame({"image": train_imgs, "annotation": train_ann}),
                  "evaluation": pd.DataFrame({"image": eval_imgs, "annotation": eval_ann})},
        preprocessor=images_preprocessor(SEG_SIZE),
        run_config=RunConfig(storage_path=storage, checkpoint_config=CheckpointConfig(
            num_to_keep=1, checkpoint_score_attribute="loss", checkpoint_score_order="min")))
    probed(trainer, step_maker="tpu_air_torch.train.segformer_trainer:make_segformer_train_step")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = trainer.fit()
    fit_wall = time.perf_counter() - t0
    try:
        if result.error is not None:
            raise AssertionError(f"[w6] fit failed: {result.error}")
        # recorded in the fit's trial actor
        probe, = read_probes(result.path)
        peak_gb, fit_launches = probe["peak_gb"], probe["launches"]
        m = result.metrics
        losses, step_ms = probe["losses"], probe["step_ms"]
        if m["steps"] != W6_STEPS or len(losses) != W6_STEPS or \
                not all(np.isfinite(losses + [m["loss"], m["eval_loss"]])):
            raise AssertionError(f"[w6] losses {losses}, metrics {m}")
        med = float(np.median(step_ms[1:]))
        best = result.checkpoint
        sd = best.get_params()
        bn_mean = sd["decode_head.batch_norm.running_mean"]
        bn_var = sd["decode_head.batch_norm.running_var"]
        moved = (float(bn_mean.abs().max()), float((bn_var - 1).abs().max()))
        if min(moved) <= 0:
            raise AssertionError(f"[w6] the batch norm's running stats did not move: {moved}")
        log(f"[w6] SegformerTrainer.fit: MiT-b0 ({cfg.hidden_sizes} wide, depths {cfg.depths}), "
            f"{cfg.num_labels} labels, f32, dropout {cfg.classifier_dropout_prob}, drop-path "
            f"{cfg.drop_path_rate}, numpy seed {SEED} weights; images_preprocessor size "
            f"{SEG_SIZE} over {W6_TRAIN} train / {W6_EVAL} eval ragged images; batch "
            f"{W6_BATCH}, AdamW lr 1e-4, wd 0, one epoch of {m['steps']} steps in "
            f"{fit_wall:.1f} s (preprocessing, eval and checkpoint included)")
        log("[w6] loss per step: " + ", ".join(f"{x:.4f}" for x in losses)
            + f"; epoch loss {m['loss']:.4f}, eval_loss {m['eval_loss']:.4f}; batch norm's "
            f"running mean moved up to {moved[0]:.4f}, variance {moved[1]:.4f}")
        log("[w6] step ms (device clock, first is the warm-up): "
            + ", ".join(f"{x:.1f}" for x in step_ms))
        log(f"[w6] median step after the first {med:.2f} ms = {W6_BATCH / med * 1e3:.2f} "
            f"trained images/s; the epoch's train_images_per_sec "
            f"{m['train_images_per_sec']:.2f} (its first step included); peak memory "
            f"{peak_gb:.2f} GB")

        # the best checkpoint predicts the eval images on the card
        before = kernel_counts()
        t0 = time.perf_counter()
        predictor = SemanticSegmentationPredictor.from_checkpoint(best)
        masks = predictor.predict(pd.DataFrame({"image": eval_imgs}))["predicted_mask"]
        pred_s = time.perf_counter() - t0
        shapes = all(np.asarray(k).shape == im.shape[:2] for k, im in zip(masks, eval_imgs))
        classes = sorted({int(c) for k in masks for c in np.unique(k)})
        log(f"[w6] from the best checkpoint (loss {best.get_metrics()['loss']:.4f}): "
            f"SemanticSegmentationPredictor on {predictor.model.device} predicted {len(masks)} "
            f"masks in {pred_s:.2f} s (load included), each its image's size: {shapes}; "
            f"{len(classes)} classes in them")
        if predictor.model.device != dev or len(masks) != W6_EVAL or not shapes or \
                not all(0 <= c < cfg.num_labels for c in classes):
            raise AssertionError("[w6] prediction from the checkpoint")
        del predictor, result, trainer
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    launches = {k: fit_launches[k] + n - before[k] for k, n in kernel_counts().items()}
    if any(launches.values()):
        raise AssertionError(f"[w6] SegFormer launched the attention kernels: {launches}")

    # a profiled step on a fresh model (not counted)
    from tpu_air_torch.train.segformer_trainer import _make_optimizer

    model = SegformerForSemanticSegmentation(cfg, device=dev).init_weights(SEED).train()
    step = segformer_trainer.make_segformer_train_step(
        model, _make_optimizer(args, 4, model.parameters()),
        torch.Generator(device=dev).manual_seed(SEED + 1))
    proc = SegformerImageProcessor(size=SEG_SIZE, do_reduce_labels=True)
    feats = proc(train_imgs[:W6_BATCH], segmentation_maps=train_ann[:W6_BATCH])
    px = torch.from_numpy(feats["pixel_values"]).to(dev)
    lbl = torch.from_numpy(feats["labels"]).to(dev)
    step(px, lbl)
    prof_ms, kernels = profile_once(lambda: step(px, lbl))
    busy = sum(t for t, _ in kernels.values())
    classes = kernel_classes(kernels)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    log(f"[w6] a profiled step: {prof_ms:.1f} ms wall, device busy {busy:.1f} ms (profiler: a "
        f"floor), idle share {1 - busy / prof_ms:.4f} (of the median step: "
        f"{1 - busy / med:.4f}), {sum(c for _, c in kernels.values()):.0f} kernels; by class: "
        + "; ".join(f"{k} {t:.2f} ms x{c:g}" for k, (t, c) in
                    sorted(classes.items(), key=lambda kv: -kv[1][0]))
        + "; heaviest: " + "; ".join(f"{k[:60]} {t:.2f} ms x{c:g}" for k, (t, c) in top))
    del model, step, px, lbl
    torch.cuda.empty_cache()
    return {"losses": losses, "epoch_loss": m["loss"], "eval_loss": m["eval_loss"],
            "step_ms": step_ms, "step_ms_median": med, "images_per_s": W6_BATCH / med * 1e3,
            "epoch_train_images_per_sec": m["train_images_per_sec"], "peak_memory_gb": peak_gb,
            "fit_wall_s": fit_wall, "bn_moved": moved, "profiled_step_ms": prof_ms,
            "step_device_busy_ms": busy, "step_idle_share": 1 - busy / prof_ms,
            "step_device_ms_by_class": {k: t for k, (t, _) in classes.items()},
            "predict_s": pred_s, "launches": launches}


def w6_parity(dev) -> dict:
    """One f32 training step at MiT-b0 width, depths cut to [1, 1, 1, 1],
    dropout and drop-path 0, batch 2 at 128^2, on the card and on the CPU
    from the same weights, TF32 off: the loss, every gradient and the batch
    norm's running stats.  Bounds: loss 1e-5 relative; each gradient
    ||card - cpu|| <= 1e-3 ||cpu|| + 1e-6 of the largest gradient norm
    (cuDNN's and oneDNN's f32 convolution algorithms sum in other orders,
    some through transforms; the linear_c biases' gradients are 0 in exact
    arithmetic, the batch norm's mean cancelling them, so they are rounding
    noise on both); running stats 1e-5."""
    from tpu_air_torch.models.segformer.modeling import (SegformerForSemanticSegmentation,
                                                         segmentation_loss)

    cfg = seg_config(depths=[1, 1, 1, 1], dropout=False)
    rng = np.random.default_rng(SEED + 80)
    px = torch.from_numpy(rng.standard_normal((W6_PARITY_BATCH, W6_PARITY_HW, W6_PARITY_HW, 3),
                                              dtype=np.float32))
    labels = rng.integers(0, cfg.num_labels, (W6_PARITY_BATCH, W6_PARITY_HW, W6_PARITY_HW))
    labels[:, :16] = 255
    labels = torch.from_numpy(labels)
    runs = {}
    for where in ("cpu", str(dev)):
        model = SegformerForSemanticSegmentation(cfg, device=where).init_weights(SEED).train()
        loss = segmentation_loss(model(px.to(where)), labels.to(where))
        loss.backward()
        runs[where] = (float(loss.detach()),
                       {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                       {n: b.detach().cpu() for n, b in model.named_buffers()})
        del model, loss
    (lc, gc, bc), (lg, gg, bg) = runs["cpu"], runs[str(dev)]
    loss_rel = abs(lg - lc) / abs(lc)
    biggest = max(float(g.norm()) for g in gc.values())
    errs = {n: float((gg[n] - gc[n]).norm()) / (float(gc[n].norm()) + 1e-3 * biggest)
            for n in gc}
    worst = max(errs, key=errs.get)
    stats_err = max(float((bg[n] - bc[n]).abs().max()) for n in bc)
    log(f"[w6 parity] f32, MiT-b0 width, depths {cfg.depths}, dropout 0, batch "
        f"{W6_PARITY_BATCH} x {W6_PARITY_HW}^2, TF32 off: loss card {lg:.7f} cpu {lc:.7f} (rel "
        f"diff {loss_rel:.2e}); gradients ||card - cpu|| / (||cpu|| + 1e-3 max) max "
        f"{errs[worst]:.2e} ({worst}) over {len(errs)} tensors; running stats max abs diff "
        f"{stats_err:.2e}")
    if not (loss_rel < 1e-5 and errs[worst] < 1e-3 and stats_err < 1e-5):
        raise AssertionError(f"[w6 parity] loss rel {loss_rel}, grad {worst} {errs[worst]}, "
                             f"stats {stats_err}")
    return {"loss_card": lg, "loss_cpu": lc, "loss_rel_diff": loss_rel,
            "grad_max_err": errs[worst], "grad_worst_tensor": worst, "stats_max_err": stats_err}


# -- phases 20 and 21 ------------------------------------------------------------


def free_port() -> int:
    """A free TCP port on the loopback interface for the serve proxy."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def post_json(port: int, path: str, payload, headers=None, timeout: float = 600.0):
    """(body, headers) of a JSON POST to the serve proxy on this host."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read()), dict(resp.headers)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def w8_path(port: int) -> dict:
    """W8 as the reference runs it, through ``examples/torch_xgboost_e2e.py``:
    seeded taxi-shaped rows, ``GBDTTrainer`` (binary:logistic, 50 rounds)
    over a MinMaxScaler, ``Tuner`` with 3 samples, then ``serve.run(
    PredictorDeployment.options(name="XGBoostService", num_replicas=2,
    route_prefix="/rayair").bind(GBDTPredictor, best_ckpt,
    http_adapter=pandas_read_json))`` on the host; single-row POSTs, then one
    POST of all the rows.  The answers must equal the in-process
    ``GBDTPredictor.predict`` on the same rows, as the adapter parses them."""
    from tpu_air_torch import serve
    from tpu_air_torch.predict import GBDTPredictor
    from tpu_air_torch.serve import pandas_read_json

    ex = example_module("torch_xgboost_e2e")
    t0 = time.perf_counter()
    result, best, valid_ds = ex.train_and_tune(ex.make_taxi_like(W8_ROWS),
                                               num_boost_round=W8_ROUNDS,
                                               num_samples=W8_SAMPLES)
    fit_s = time.perf_counter() - t0
    records = valid_ds.drop_columns(["is_big_tip"]).to_pandas().head(W8_POSTS) \
        .to_dict(orient="records")
    want = GBDTPredictor.from_checkpoint(best.checkpoint).predict(
        pandas_read_json(json.dumps(records).encode()))["predictions"].tolist()
    try:
        t0 = time.perf_counter()
        ex.serve_best(best.checkpoint, port)
        start_s = time.perf_counter() - t0
        single, lat = [], []
        for r in records:
            t0 = time.perf_counter()
            single += [o["predictions"] for o in ex.post_rows(port, [r])]
            lat.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        batch = [o["predictions"] for o in ex.post_rows(port, records)]
        batch_s = time.perf_counter() - t0
    finally:
        serve.shutdown()
    lat_ms = np.array(lat) * 1e3
    log(f"[w8] {W8_ROWS} taxi-shaped rows, GBDTTrainer {W8_ROUNDS} rounds + Tuner "
        f"{W8_SAMPLES} samples in {fit_s:.3f} s (best {best.config['params']}, "
        f"valid-logloss {best.metrics['valid-logloss']:.4f}); serve.run of 2 replicas "
        f"{start_s:.3f} s; {len(records)} single-row POSTs: {len(records) / lat_ms.sum() * 1e3:.1f} "
        f"requests/s, latency p50 {np.percentile(lat_ms, 50):.3f} ms, p99 "
        f"{np.percentile(lat_ms, 99):.3f} ms; one POST of {len(records)} rows "
        f"{batch_s * 1e3:.3f} ms; equal to the in-process predictor: "
        f"{single == want and batch == want}; card: {card_line()}")
    if single != want or batch != want:
        raise AssertionError(f"[w8] HTTP answers differ from the in-process predictor:\n"
                             f"{single}\n{batch}\n{want}")
    return {"fit_s": fit_s, "serve_start_s": start_s,
            "requests_per_s": len(records) / lat_ms.sum() * 1e3,
            "latency_p50_ms": float(np.percentile(lat_ms, 50)),
            "latency_p99_ms": float(np.percentile(lat_ms, 99)),
            "batch_post_ms": batch_s * 1e3, "rows": len(records),
            "best_config": best.config["params"], "equal_to_in_process": True}


def gained(before: dict, after: dict) -> dict:
    """Count and p50/p95/p99 of the samples an ``EngineMetrics`` histogram
    summary gained between two snapshots, interpolated inside the buckets
    as the histogram's own quantiles are."""
    from tpu_air_torch.observability.perf import bucket_upper

    old = before.get("buckets") or {}
    diff = {int(k): int(v) - int(old.get(k, 0)) for k, v in (after.get("buckets") or {}).items()}
    n = sum(diff.values())
    out = {"count": n}
    for name, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
        cum = 0
        for idx in sorted(i for i in diff if diff[i] > 0):
            cum += diff[idx]
            if cum >= q * n:
                lo, hi = bucket_upper(idx - 1), bucket_upper(idx)
                out[name] = lo + (q * n - (cum - diff[idx])) / diff[idx] * (hi - lo)
                break
    return out


def serve_prompts(n: int, vocab: int, seed: int) -> list:
    """``n`` prompts of 64-512 tokens (an eighth of ``max_input_len`` to all
    of it) from a seed."""
    rng = np.random.default_rng(seed)
    li = SERVE_CFG["max_input_len"]
    return [rng.integers(2, vocab, int(n_tok)).tolist()
            for n_tok in rng.integers(li // 8, li + 1, n)]


def window_tokens(model, prompts_: list) -> list:
    """Greedy decoding with ``make_t5_prefill_fn`` / ``make_t5_decode_step_fn``
    over the engine's window batches (``max_batch`` rows of
    ``max_input_len`` tokens, all-pad filler), in process, EOS inclusive:
    what every engine stream must equal."""
    from tpu_air_torch.models.t5.generate import make_t5_decode_step_fn, make_t5_prefill_fn

    cfg = model.config
    b, li, new = SERVE_CFG["max_batch"], SERVE_CFG["max_input_len"], SERVE_CFG["max_new_tokens"]
    prefill, step = make_t5_prefill_fn(model, new + 1), make_t5_decode_step_fn(model)
    out = []
    for w in range(0, len(prompts_), b):
        chunk = prompts_[w:w + b]
        ids = np.full((b, li), cfg.pad_token_id, np.int64)
        mask = np.zeros((b, li), np.int64)
        for r, p in enumerate(chunk):
            ids[r, :len(p)], mask[r, :len(p)] = p, 1
        tok, cache, _ = prefill(torch.from_numpy(ids).to(model.device),
                                torch.from_numpy(mask).to(model.device))
        toks = [tok]
        for _ in range(new - 1):
            cache, tok = step(cache, tok)
            toks.append(tok)
        for row in torch.stack(toks, 1).cpu().tolist()[:len(chunk)]:
            out.append(row[:row.index(cfg.eos_token_id) + 1] if cfg.eos_token_id in row else row)
    return out


def engine_streams(port: int, route: str, prompts_: list, clients: int,
                   max_new: int = SERVE_CFG["max_new_tokens"], finals: list = None) -> list:
    """Each prompt as a submit/poll stream over HTTP from ``clients`` client
    threads: each thread submits its share of the prompts, then polls its
    streams in turn every 10 ms until all are done, each poll pinned to the
    replica that took the submit.  With ``finals``, each stream's last poll
    appends (host clock, its trace id) to it."""
    from concurrent.futures import ThreadPoolExecutor

    def client(share):
        streams = []
        for prompt in share:
            sub, headers = post_json(port, route, {
                "action": "submit", "prompt": prompt, "max_new_tokens": max_new})
            streams.append((sub["request_id"],
                            {"x-tpu-air-replica": headers["x-tpu-air-replica"]}, []))
        done = [False] * len(streams)
        while not all(done):
            for i, (rid, pin, toks) in enumerate(streams):
                if done[i]:
                    continue
                res, got = post_json(port, route, {"action": "poll", "request_id": rid,
                                                   "cursor": len(toks)}, headers=pin)
                toks += res["tokens"]
                done[i] = res["done"]
                if done[i] and finals is not None:
                    finals.append((time.perf_counter(), got["x-tpu-air-trace-id"]))
            time.sleep(0.01)
        return [toks for _, _, toks in streams]

    shares = [list(range(c, len(prompts_), clients)) for c in range(clients)]
    with ThreadPoolExecutor(clients) as pool:
        results = list(pool.map(lambda idx: client([prompts_[i] for i in idx]), shares))
    out = [None] * len(prompts_)
    for idx, toks in zip(shares, results):
        for i, t in zip(idx, toks):
            out[i] = t
    return out


def plain_engine_server():
    """``EngineDeployment``'s replica class with the model's attention routed
    through the plain versions inside the replica, on its leased card."""
    from tpu_air_torch.serve.engine_deployment import _EngineServer

    class PlainEngineServer(_EngineServer):
        def _ensure_engine(self):
            from tpu_air_torch.models.t5 import modeling
            from tpu_air_torch.ops.decode_attention import decode_attention_reference

            def flash(q, k, v, bias=None, *, kv_mask=None, scale=None, causal=False):
                return flash_plain(q, k, v, bias, kv_mask, causal)

            modeling.flash_attention, modeling.decode_attention = flash, decode_attention_reference
            return super()._ensure_engine()

    return PlainEngineServer


def serve_t5_path(dev, ckpt_path: str, port: int) -> dict:
    """FLAN-T5-base (the ``[batch]`` phase's checkpoint, bf16) through the
    serve plane, one replica leasing the card at a time: (a)
    ``PredictorDeployment`` over ``T5GenerativePredictor``, 8 prompts in one
    POST, equal to the in-process predictor; (b) ``EngineDeployment`` with a
    ``T5EngineConfig(max_batch=8, max_input_len=512, max_new_tokens=64)``:
    16 ragged prompts as two blocking POSTs of 8, then as submit/poll streams
    from 4 client threads; every answer equal to in-process greedy decoding
    at the window's shape.  The replicas report their device and launches."""
    from tpu_air_torch import serve
    from tpu_air_torch.engine import T5EngineConfig
    from tpu_air_torch.predict import T5GenerativePredictor
    from tpu_air_torch.serve import EngineDeployment, PredictorDeployment, pandas_read_json
    from tpu_air_torch.train import Checkpoint

    ckpt = Checkpoint.from_directory(ckpt_path)
    t0 = time.perf_counter()
    model = base_model("bfloat16", dev)
    cfg = model.config
    build_s = time.perf_counter() - t0
    out = {}

    # (a) PredictorDeployment
    ids, mask = prompts(SERVE_BATCH, PROMPT_LEN, cfg.vocab_size, SEED + 9)
    rows = [{"input_ids": i.tolist(), "attention_mask": m.tolist()} for i, m in zip(ids, mask)]
    want = T5GenerativePredictor(model, tokenizer=IdTokenizer()).predict(
        {"input_ids": ids, "attention_mask": mask}, max_new_tokens=SERVE_NEW)
    try:
        t0 = time.perf_counter()
        serve.run(PredictorDeployment.options(name="T5Service", route_prefix="/t5",
                                              num_chips=1)
                  .bind(counting_predictor(), ckpt, http_adapter=pandas_read_json,
                        dtype="bfloat16", tokenizer=IdTokenizer(),
                        predict_kwargs={"max_new_tokens": SERVE_NEW}), port=port)
        start_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, _ = post_json(port, "/t5", rows)
        post_s = time.perf_counter() - t0
    finally:
        serve.shutdown()
    same = [r["generated_output"] for r in got] == want["generated_output"].tolist()
    devices = sorted({r["device"] for r in got})
    flash_n, decode_n = got[0]["flash_launches"], got[0]["decode_launches"]
    log(f"[serve t5] (a) PredictorDeployment, 1 replica leasing the card: serve.run "
        f"{start_s:.3f} s (the replica's from_checkpoint {got[0]['actor_load_s']:.3f} s); one "
        f"POST of {SERVE_BATCH} prompts x {PROMPT_LEN} -> {SERVE_NEW} tokens {post_s:.3f} s (the "
        f"replica's predict {got[0]['actor_predict_s']:.3f} s); replica device {devices}, "
        f"launches flash {flash_n}, decode {decode_n}; equal to in process: {same}")
    if not same or devices != [str(dev)] or flash_n <= 0 or decode_n <= 0:
        raise AssertionError(f"[serve t5] (a) same {same}, devices {devices}, "
                             f"launches {flash_n}/{decode_n}")
    out["predictor"] = {"serve_start_s": start_s, "post_s": post_s, "device": devices[0],
                        "replica_load_s": got[0]["actor_load_s"],
                        "replica_predict_s": got[0]["actor_predict_s"],
                        "launches": {"flash_attention": flash_n, "decode_attention": decode_n}}

    # (b) EngineDeployment over the T5 window engine
    ps = serve_prompts(SERVE_PROMPTS, cfg.vocab_size, SEED + 10)
    t0 = time.perf_counter()
    want = window_tokens(model, ps)
    offline_s = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    b = SERVE_CFG["max_batch"]
    try:
        t0 = time.perf_counter()
        h = serve.run(EngineDeployment.options(name="t5-engine", route_prefix="/t5engine",
                                               num_chips=1)
                      .bind(ckpt, T5EngineConfig(**SERVE_CFG), dtype="bfloat16"), port=port)
        post_json(port, "/t5engine", {"prompts": [ps[0][:64]], "max_new_tokens": 2})
        start_s = time.perf_counter() - t0            # replica, model load, first window
        import tpu_air_torch

        snap_w = tpu_air_torch.get(h.method("stats")())
        t0 = time.perf_counter()
        blocking = []
        for w in range(0, len(ps), b):
            res, _ = post_json(port, "/t5engine", {"prompts": ps[w:w + b]})
            blocking += [r["tokens"] for r in res["results"]]
        blocking_s = time.perf_counter() - t0
        snap_b = tpu_air_torch.get(h.method("stats")())
        t0 = time.perf_counter()
        streamed = engine_streams(port, "/t5engine", ps, SERVE_CLIENTS)
        stream_s = time.perf_counter() - t0
        snap = tpu_air_torch.get(h.method("stats")())
    finally:
        serve.shutdown()
    n_tok = sum(map(len, blocking))
    same_b, same_s = blocking == want, streamed == blocking
    launches = snap["kernel_launches"]
    # the blocking POSTs' and the streams' own samples (the warm-up's first
    # window, which loads the kernels and warms cuBLAS, is left out)
    ttft_b, step_b = (gained(snap_w[k], snap_b[k]) for k in ("ttft_s", "step_latency_s"))
    ttft, step = (gained(snap_b[k], snap[k]) for k in ("ttft_s", "step_latency_s"))
    log(f"[serve t5] (b) EngineDeployment, T5EngineConfig({SERVE_CFG}), bf16, 1 replica "
        f"leasing the card: serve.run + model load + a 1-prompt warm-up {start_s:.3f} s; "
        f"{len(ps)} prompts of 64-512 tokens: two blocking POSTs of {b} {blocking_s:.3f} s "
        f"({n_tok} tokens, {n_tok / blocking_s:.1f} generated tokens/s over HTTP); the same as "
        f"streams from {SERVE_CLIENTS} client threads {stream_s:.3f} s "
        f"({n_tok / stream_s:.1f} tokens/s); card: {card_line()}")
    log(f"[serve t5] (b) read inside the replica: device {snap['device']}, launches {launches}; "
        f"the blocking POSTs: TTFT p50 {ttft_b['p50'] * 1e3:.3f} ms, "
        f"p99 {ttft_b['p99'] * 1e3:.3f} ms over {ttft_b['count']} requests, decode step p50 "
        f"{step_b['p50'] * 1e3:.3f} ms, p95 {step_b['p95'] * 1e3:.3f} ms over "
        f"{step_b['count']} steps of {b} rows; the streams: TTFT p50 "
        f"{ttft['p50'] * 1e3:.3f} ms, p99 {ttft['p99'] * 1e3:.3f} ms over {ttft['count']}, "
        f"decode step p50 {step['p50'] * 1e3:.3f} ms, p95 {step['p95'] * 1e3:.3f} ms over "
        f"{step['count']} steps; blocking equal to in-process window decoding "
        f"({offline_s:.3f} s): {same_b}; streams equal to blocking: {same_s}")
    if snap["device"] != str(dev) or launches["flash_attention"] <= 0 or \
            launches["decode_attention"] <= 0:
        raise AssertionError(f"[serve t5] (b) replica device {snap['device']}, launches {launches}")
    if not same_b:
        raise AssertionError(f"[serve t5] (b) blocking answers differ from in-process decoding:"
                             f"\n{blocking}\n{want}")
    if not same_s:
        raise AssertionError(f"[serve t5] (b) streams differ from the blocking answers:"
                             f"\n{streamed}\n{blocking}")
    out["engine"] = {"serve_start_s": start_s, "blocking_s": blocking_s, "stream_s": stream_s,
                     "tokens": n_tok, "blocking_tokens_per_s": n_tok / blocking_s,
                     "stream_tokens_per_s": n_tok / stream_s, "device": snap["device"],
                     "launches": launches, "blocking_ttft_s": ttft_b, "blocking_step_s": step_b,
                     "stream_ttft_s": ttft, "stream_step_s": step,
                     "in_process_build_s": build_s}
    return out


def serve_t5_parity(dev, work: str, port: int) -> dict:
    """f32, full width, depth cut to 2+2, random weights from numpy seed 0:
    the two blocking POSTs of (b) through ``EngineDeployment`` with the
    kernels, then with the plain versions in the replica, on the card; the
    tokens must be equal."""
    import dataclasses

    from tpu_air_torch import get, serve
    from tpu_air_torch.engine import T5EngineConfig
    from tpu_air_torch.models.t5.modeling import T5ForConditionalGeneration
    from tpu_air_torch.serve import EngineDeployment
    from tpu_air_torch.train import Checkpoint

    cfg = model_config()
    cfg.num_layers = cfg.num_decoder_layers = SERVE_PARITY_LAYERS
    model = T5ForConditionalGeneration(cfg, device=dev).init_weights(SEED)
    ckpt = Checkpoint.from_model(model_config=cfg, path=os.path.join(work, "serve_parity"),
                                 params={k: v.cpu() for k, v in model.state_dict().items()})
    del model
    ps = serve_prompts(SERVE_PROMPTS, cfg.vocab_size, SEED + 11)
    b = SERVE_CFG["max_batch"]
    out = {}
    for path, cls in (("kernel", EngineDeployment.func_or_class),
                      ("plain", plain_engine_server())):
        d = dataclasses.replace(EngineDeployment, func_or_class=cls)
        try:
            h = serve.run(d.options(name=f"t5-{path}", route_prefix="/parity", num_chips=1)
                          .bind(ckpt, T5EngineConfig(**SERVE_CFG), dtype="float32"), port=port)
            toks = []
            for w in range(0, len(ps), b):
                res, _ = post_json(port, "/parity", {"prompts": ps[w:w + b]})
                toks += [r["tokens"] for r in res["results"]]
            snap = get(h.method("stats")())
        finally:
            serve.shutdown()
        launched = snap["kernel_launches"]
        if (min(launched.values()) > 0) != (path == "kernel") or \
                (path == "plain" and any(launched.values())):
            raise AssertionError(f"[serve parity] the {path} replica launched {launched}")
        out[path] = toks
    same = out["kernel"] == out["plain"]
    log(f"[serve parity] f32, {cfg.num_layers}+{cfg.num_decoder_layers} layers, {len(ps)} "
        f"prompts through EngineDeployment, kernels against the plain versions in the "
        f"replica on the card: tokens identical = {same}")
    if not same:
        raise AssertionError(f"[serve parity] tokens differ:\n{out['kernel']}\n{out['plain']}")
    return {"tokens_identical": same, "tokens": sum(map(len, out["kernel"]))}


# -- phase 22 --------------------------------------------------------------------


def lm_serve_prompts(n: int, vocab: int, seed: int) -> list:
    """``n`` prompts of 64-512 seeded tokens in [1, vocab) (no pad token).
    Every fourth of the first ``4 * LM_PREFIX_PROMPTS`` starts with one
    shared 256-token prefix, and one of those is the prefix cut 6 tokens
    short, so that it ends inside a shared page (a copy-on-write when it
    finds the page cached)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, LM_PREFIX_LEN).tolist()
    out = []
    for i, n_tok in enumerate(rng.integers(LM_PROMPT_LENS[0], LM_PROMPT_LENS[1] + 1, n)):
        if i % 4 == 0 and i < 4 * LM_PREFIX_PROMPTS:
            if i == 4:
                out.append(prefix[:LM_PREFIX_LEN - 6])
                continue
            n_tok = max(int(n_tok), LM_PREFIX_LEN + 16)
            out.append(prefix + rng.integers(1, vocab, n_tok - LM_PREFIX_LEN).tolist())
        else:
            out.append(rng.integers(1, vocab, int(n_tok)).tolist())
    return out


def lm_engine_run(model, prompts_: list, kv_mode: str, schedule: str,
                  engine_cfg: dict = None) -> dict:
    """One manual-step ``InferenceEngine`` run over ``prompts_``: all at
    once (``burst``) or ``LM_TRICKLE`` in flight, the next submitted as one
    finishes (``trickle``).  Tokens, each request's TTFT on the host clock
    (at step granularity), the wall, steps, the pool's peak pages, and the
    engine's metrics and pool stats."""
    from tpu_air_torch.engine import EngineConfig, InferenceEngine

    engine = InferenceEngine(model, EngineConfig(kv_mode=kv_mode, **(engine_cfg or LM_ENGINE)),
                             auto_start=False, name=f"lm-{kv_mode}-{schedule}")
    n = len(prompts_)
    streams, t_sub, ttft = [None] * n, [0.0] * n, [None] * n
    pending, inflight = list(range(n)), set()
    limit = n if schedule == "burst" else LM_TRICKLE
    peak = steps = 0
    t0 = time.perf_counter()
    while pending or inflight:
        while pending and len(inflight) < limit:
            i = pending.pop(0)
            t_sub[i] = time.perf_counter()
            streams[i] = engine.submit(prompts_[i])
            inflight.add(i)
        engine.step()
        steps += 1
        now = time.perf_counter()
        for i in list(inflight):
            if ttft[i] is None and streams[i].tokens_so_far():
                ttft[i] = now - t_sub[i]
            if streams[i].done:
                inflight.discard(i)
        if engine.paged:
            peak = max(peak, engine.pool.allocator.used_count())
    wall = time.perf_counter() - t0
    out = {"tokens": [s.result(0) for s in streams], "ttft_s": ttft, "wall_s": wall,
           "steps": steps, "peak_pages": peak, "metrics": engine.metrics.snapshot(),
           "pool": engine.pool.stats() if engine.paged else None}
    engine.close()
    return out


def lm_decode_idle_share(model, prompts_: list) -> dict:
    """The paged engine's decode step under the profiler: the shortest
    prompts, one a slot, prefilled (all their chunks in one step, which
    changes no decode step's shape), then 16 engine steps in which every
    slot decodes (the step's ``.cpu()`` included).  The profiler can lose
    kernel records (``complete_profile``), so the busy time it sums is a
    floor and the idle share a ceiling."""
    from tpu_air_torch.engine import EngineConfig, InferenceEngine

    engine = InferenceEngine(model, EngineConfig(**{**LM_ENGINE,
                                                    "prefill_chunks_per_step": 1 << 10}),
                             auto_start=False, name="lm-profiled")
    for p in sorted(prompts_, key=len)[:LM_ENGINE["num_slots"]]:
        engine.submit(p)
    while any(s.prefilling for s in engine.slots.active_slots()) or engine.scheduler.depth():
        engine.step()
    wall_ms, kernels = profile_once(lambda: [engine.step() for _ in range(16)])
    busy = sum(t for t, _ in kernels.values())
    engine.close()
    return {"wall_ms_per_step": wall_ms / 16, "busy_ms_per_step": busy / 16,
            "idle_share": 1 - busy / wall_ms}


def lm_serve_path(dev, ckpt_dir: str, port: int) -> dict:
    """Phase 22 (a)-(e): the ``[lm]`` phase's 136M checkpoint served (see
    the module docstring).  The counts of the decode kernel's launches are
    set to 0 before each of (a), (b), (c) and (e)'s kernel runs and read
    after it; (d)'s are counted in its replica."""
    from tpu_air_torch import get, serve
    from tpu_air_torch.engine import EngineConfig
    from tpu_air_torch.models.lm import generate
    from tpu_air_torch.ops.decode_attention import decode_attention
    from tpu_air_torch.ops.flash_attention import flash_attention
    from tpu_air_torch.predict import LMGenerativePredictor
    from tpu_air_torch.serve import EngineDeployment
    from tpu_air_torch.train import Checkpoint

    t_phase = time.perf_counter()
    ckpt = Checkpoint.from_directory(ckpt_dir)
    out = {"launches": {}, "part_s": {}}

    def part_done(name, t_start):
        out["part_s"][name] = time.perf_counter() - t_start
        return time.perf_counter()

    # (a) offline: LMGenerativePredictor, greedy, no EOS
    t0 = time.perf_counter()
    pred = LMGenerativePredictor.from_checkpoint(ckpt, dtype="bfloat16")
    load_s = time.perf_counter() - t0
    model, cfg = pred.model, pred.model.config
    if model.device != dev or next(model.parameters()).dtype != torch.bfloat16:
        raise AssertionError(f"[lm serve] (a) model on {model.device}, "
                             f"{next(model.parameters()).dtype}")
    n, L, new = LM_GEN_PROMPTS, LM_GEN_LEN, LM_GEN_NEW
    batch = {"input_ids": np.random.default_rng(SEED + 41).integers(1, cfg.vocab_size, (n, L))}
    pred.predict(batch, max_new_tokens=2)               # warm-up at the same shapes
    flash_attention.launches = 0
    decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pred.predict(batch, max_new_tokens=new)
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    toks = np.stack([np.array(s.split(), dtype=np.int64) for s in res["generated_output"]])
    if toks.shape != (n, new) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"[lm serve] (a) generated {toks.shape}, ids "
                             f"{toks.min()}..{toks.max()}")
    want = cfg.n_layers * (new - 1)
    if launches != {"flash_attention": 0, "decode_attention": want}:
        raise AssertionError(f"[lm serve] (a) launches {launches}, expect decode "
                             f"{cfg.n_layers} x {new - 1} = {want} and no flash")
    from tpu_air_torch.models.lm import head_weight, init_cache

    with torch.inference_mode():
        cache = init_cache(model, n, L + new + 8)
        ids = torch.from_numpy(batch["input_ids"]).to(dev)
        model(ids, return_hidden=True, decode=True, cache=cache)
        head_w = head_weight(model).float()
        tok = ids[:, -1:]
        pos = torch.full((n, 1), L, device=dev)

        def one_step():
            h = model(tok, pos, return_hidden=True, decode=True, cache=cache)
            return torch.argmax(h[:, -1].float() @ head_w, dim=-1)

        one_step()
        steps_ms = step_times_ms(one_step, new - 1)
    step_ms, step_p90 = float(np.median(steps_ms)), float(np.percentile(steps_ms, 90))
    log(f"[lm serve] (a) LMGenerativePredictor.from_checkpoint(dtype=\"bfloat16\") of the "
        f"[lm] checkpoint ({cfg.d_model} wide, {cfg.n_layers} layers, {cfg.n_heads} heads of "
        f"{cfg.head_dim}, vocab {cfg.vocab_size}) {load_s:.3f} s; predict: {n} prompts x {L} "
        f"tokens -> {new} new, greedy, no EOS: {wall:.3f} s, {n * new / wall:.1f} generated "
        f"tokens/s; launches {launches} (decode = {cfg.n_layers} x {new - 1}); decode step "
        f"median {step_ms:.3f} ms, p90 {step_p90:.3f} ms over {new - 1} steps (b={n}, "
        f"cache L={L + new + 8}); card: {card_line()}")
    out["offline"] = {"load_s": load_s, "wall_s": wall, "tokens_per_s": n * new / wall,
                      "launches": launches, "decode_step_ms": step_ms,
                      "decode_step_p90_ms": step_p90}
    out["launches"]["lm_generate"] = launches["decode_attention"]
    del pred, cache
    torch.cuda.empty_cache()
    t_part = part_done("a", t_phase)

    # (b) the paged engine in process, burst then trickle
    ps = lm_serve_prompts(LM_ENGINE_PROMPTS, cfg.vocab_size, SEED + 42)
    decode_attention.launches = 0
    runs = {"burst": lm_engine_run(model, ps, "paged", "burst"),
            "trickle": lm_engine_run(model, ps[:LM_TRICKLE_PROMPTS], "paged", "trickle")}
    paged_launches = decode_attention.launches
    same = runs["burst"]["tokens"][:LM_TRICKLE_PROMPTS] == runs["trickle"]["tokens"]
    idle = lm_decode_idle_share(model, ps)
    for sched, r in runs.items():
        ttft = np.array(r["ttft_s"]) * 1e3
        step = r["metrics"]["step_latency_s"]
        n_tok = sum(map(len, r["tokens"]))
        log(f"[lm serve] (b) paged InferenceEngine({LM_ENGINE}), {sched}: "
            f"{len(r['tokens'])} prompts "
            f"of {LM_PROMPT_LENS[0]}-{LM_PROMPT_LENS[1]} tokens ({LM_PREFIX_PROMPTS} behind a "
            f"{LM_PREFIX_LEN}-token prefix) in "
            f"{r['wall_s']:.3f} s over {r['steps']} steps, {n_tok / r['wall_s']:.1f} generated "
            f"tokens/s; TTFT p50 {np.percentile(ttft, 50):.3f} ms, p99 "
            f"{np.percentile(ttft, 99):.3f} ms (host clock at step ends); decode step p50 "
            f"{step['p50'] * 1e3:.3f} ms, p95 {step['p95'] * 1e3:.3f} ms over {step['count']} "
            f"steps (the engine's histogram); prefix hits {r['pool']['prefix_hits']}, "
            f"copy-on-write copies {r['pool']['cow_copies']}, peak pool pages "
            f"{r['peak_pages']} of {r['pool']['pages_total']}")
    log(f"[lm serve] (b) burst and trickle tokens identical per prompt (the trickle's "
        f"{LM_TRICKLE_PROMPTS}): {same}; decode "
        f"launches over both runs {paged_launches} ({cfg.n_layers} a step); the decode step "
        f"under the profiler ({LM_ENGINE['num_slots']} slots decoding): "
        f"{idle['wall_ms_per_step']:.3f} ms a step, "
        f"device busy {idle['busy_ms_per_step']:.3f} ms, idle share {idle['idle_share']:.4f}")
    if not same:
        bad = [i for i, (a, b) in enumerate(zip(runs["burst"]["tokens"], runs["trickle"]["tokens"]))
               if a != b]
        raise AssertionError(f"[lm serve] (b) burst and trickle differ at prompts {bad}")
    if paged_launches != cfg.n_layers * (runs["burst"]["metrics"]["step_latency_s"]["count"]
                                         + runs["trickle"]["metrics"]["step_latency_s"]["count"]):
        raise AssertionError(f"[lm serve] (b) decode launches {paged_launches}")
    out["paged"] = {sched: {k: v for k, v in r.items() if k != "tokens"}
                    for sched, r in runs.items()}
    out["paged"]["identical"] = same
    out["paged"]["profiled_step"] = idle
    out["burst_tokens"] = runs["burst"]["tokens"]       # phase 23's yardstick
    out["launches"]["lm_engine_paged"] = paged_launches
    t_part = part_done("b", t_part)

    # (c) the slab engine, burst; agreement with (b) and offline generate
    decode_attention.launches = 0
    slab = lm_engine_run(model, ps, "slab", "burst")
    out["launches"]["lm_engine_slab"] = decode_attention.launches
    offline = [generate(model, [p], max_new_tokens=LM_ENGINE["max_new_tokens"])[0].tolist()
               for p in ps[:LM_OFFLINE_PROMPTS]]

    def agree(a, b):
        return sum(x == y for ra, rb in zip(a, b) for x, y in zip(ra, rb))

    total = sum(map(len, slab["tokens"]))
    n_off = sum(map(len, offline))
    agree_b, agree_off = agree(slab["tokens"], runs["burst"]["tokens"]), agree(slab["tokens"], offline)
    agree_b_off = agree(runs["burst"]["tokens"], offline)
    log(f"[lm serve] (c) slab InferenceEngine, burst: {slab['wall_s']:.3f} s over "
        f"{slab['steps']} steps, {total / slab['wall_s']:.1f} generated tokens/s, decode "
        f"launches {out['launches']['lm_engine_slab']}; tokens agreeing with (b) "
        f"{agree_b}/{total}, with per-prompt offline generate (the first "
        f"{LM_OFFLINE_PROMPTS} prompts) {agree_off}/{n_off}, (b) with offline "
        f"{agree_b_off}/{n_off} (bf16: the prefill shapes differ, so this is printed, "
        "not asserted)")
    out["slab"] = {"wall_s": slab["wall_s"], "steps": slab["steps"], "tokens": total,
                   "agree_with_paged": agree_b, "agree_with_offline": agree_off,
                   "paged_agree_with_offline": agree_b_off}
    want = runs["burst"]["tokens"][:LM_SERVED]
    del model
    torch.cuda.empty_cache()
    t_part = part_done("c", t_part)

    # (d) served: EngineDeployment over the checkpoint, one replica on the card
    served = ps[:LM_SERVED]
    b = LM_SERVED // 2
    try:
        t0 = time.perf_counter()
        h = serve.run(EngineDeployment.options(name="lm-engine", route_prefix="/lmengine",
                                               num_chips=1)
                      .bind(ckpt, EngineConfig(**LM_ENGINE), dtype="bfloat16"), port=port)
        post_json(port, "/lmengine", {"prompts": [served[0][:64]], "max_new_tokens": 2})
        start_s = time.perf_counter() - t0
        snap_w = get(h.method("stats")())
        t0 = time.perf_counter()
        blocking = []
        for w in range(0, len(served), b):
            res, _ = post_json(port, "/lmengine", {"prompts": served[w:w + b]})
            blocking += [r["tokens"] for r in res["results"]]
        blocking_s = time.perf_counter() - t0
        snap_b = get(h.method("stats")())
        t0 = time.perf_counter()
        streamed = engine_streams(port, "/lmengine", served, SERVE_CLIENTS,
                                  LM_ENGINE["max_new_tokens"])
        stream_s = time.perf_counter() - t0
        snap = get(h.method("stats")())
    finally:
        serve.shutdown()
    n_tok = sum(map(len, blocking))
    rl = snap["kernel_launches"]
    ttft_b, step_b = (gained(snap_w[k], snap_b[k]) for k in ("ttft_s", "step_latency_s"))
    ttft_s, step_s = (gained(snap_b[k], snap[k]) for k in ("ttft_s", "step_latency_s"))
    log(f"[lm serve] (d) EngineDeployment(EngineConfig({LM_ENGINE}), dtype=\"bfloat16\"), one "
        f"replica leasing the card: serve.run + load + a 1-prompt warm-up {start_s:.3f} s; "
        f"{len(served)} prompts as two blocking POSTs of {b} {blocking_s:.3f} s "
        f"({n_tok / blocking_s:.1f} tokens/s), as streams from {SERVE_CLIENTS} client threads "
        f"{stream_s:.3f} s ({n_tok / stream_s:.1f} tokens/s); replica device {snap['device']}, "
        f"launches {rl}; blocking: TTFT p50 {ttft_b['p50'] * 1e3:.3f} ms, p99 "
        f"{ttft_b['p99'] * 1e3:.3f} ms, decode step p50 {step_b['p50'] * 1e3:.3f} ms, p95 "
        f"{step_b['p95'] * 1e3:.3f} ms; streams: TTFT p50 {ttft_s['p50'] * 1e3:.3f} ms, p99 "
        f"{ttft_s['p99'] * 1e3:.3f} ms, decode step p50 {step_s['p50'] * 1e3:.3f} ms, p95 "
        f"{step_s['p95'] * 1e3:.3f} ms; equal to (b): blocking {blocking == want}, streams "
        f"{streamed == want}")
    if snap["device"] != str(dev) or rl["decode_attention"] <= 0 or rl["flash_attention"]:
        raise AssertionError(f"[lm serve] (d) replica device {snap['device']}, launches {rl}")
    if blocking != want or streamed != want:
        raise AssertionError(f"[lm serve] (d) served tokens differ from (b):\n{blocking}\n"
                             f"{streamed}\n{want}")
    out["served"] = {"serve_start_s": start_s, "blocking_s": blocking_s, "stream_s": stream_s,
                     "tokens": n_tok, "device": snap["device"], "launches": rl,
                     "blocking_ttft_s": ttft_b, "blocking_step_s": step_b,
                     "stream_ttft_s": ttft_s, "stream_step_s": step_s}
    out["launches"]["lm_serve_replica"] = rl["decode_attention"]
    t_part = part_done("d", t_part)

    # (e) f32 parity, depth cut to 2: the kernel against the plain version
    out["parity"] = lm_serve_parity(dev)
    out["launches"]["lm_serve_parity"] = out["parity"]["kernel_launches"]
    part_done("e", t_part)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[lm serve] phase 22 (a)-(e) {out['phase_s']:.1f} s: "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in out["part_s"].items()))
    return out


def lm_serve_parity(dev) -> dict:
    """Phase 22 (e): f32, full width, depth cut to 2, weights from numpy
    seed 0, TF32 off: offline ``generate``, the slab engine and the paged
    engine, each through the decode kernel and through
    ``decode_attention_reference`` on the card; all six token streams
    equal."""
    from tpu_air_torch.models.lm import CausalLM, generate, modeling
    from tpu_air_torch.ops.decode_attention import decode_attention, decode_attention_reference

    model = CausalLM(lm_config("float32", LM_SERVE_PARITY_LAYERS), device=dev).init_weights(SEED)
    ps = lm_serve_prompts(LM_SERVE_PARITY_PROMPTS, model.config.vocab_size, SEED + 43)
    new = LM_SERVE_PARITY_NEW
    ecfg = {**LM_ENGINE, "max_new_tokens": new}
    streams, launched = {}, {}
    saved = modeling.decode_attention
    for path in ("kernel", "plain"):
        modeling.decode_attention = saved if path == "kernel" else decode_attention_reference
        try:
            decode_attention.launches = 0
            streams[f"{path} offline"] = [generate(model, [p], max_new_tokens=new)[0].tolist()
                                          for p in ps]
            for mode in ("slab", "paged"):
                streams[f"{path} {mode}"] = lm_engine_run(model, ps, mode, "burst",
                                                          ecfg)["tokens"]
            launched[path] = decode_attention.launches
        finally:
            modeling.decode_attention = saved
    ref = streams["kernel offline"]
    same = {k: v == ref for k, v in streams.items()}
    log(f"[lm serve] (e) f32, {LM_SERVE_PARITY_LAYERS} layers at full width, "
        f"{len(ps)} prompts -> {new} tokens: offline, slab and paged, through the kernel "
        f"({launched['kernel']} launches) and the plain version ({launched['plain']}): equal "
        f"to the kernel's offline streams: {same}")
    if launched["plain"] or not launched["kernel"]:
        raise AssertionError(f"[lm serve] (e) launches {launched}")
    if not all(same.values()):
        raise AssertionError(f"[lm serve] (e) token streams differ: {same}")
    del model
    torch.cuda.empty_cache()
    return {"identical": True, "streams": list(streams), "kernel_launches": launched["kernel"]}


def decode_shape_timing(dev, b: int, h: int, seed: int, tag: str) -> dict:
    """The decode kernel at an LM engine shape (b rows, L ``slot_len``, h
    heads of 128, bf16, a per-row mask with rows at varied positions, one
    at 0) beside its bound (the live K/V bytes, q, the output and the mask
    over 3.35 TB/s), its plain version and SDPA on the same inputs; the
    slabs are cycled through ``COLD_BYTES`` as the L2 would find them cold.
    The comparison's launches are not counted."""
    from tpu_air_torch.ops.decode_attention import decode_attention, decode_attention_reference

    L, d = LM_ENGINE["slot_len"], 128
    dt = torch.bfloat16
    rng = np.random.default_rng(seed)
    pos = rng.integers(L // 16, L, b)
    pos[0] = 0
    mask_np = (np.arange(L)[None] <= pos[:, None]).astype(np.float32)
    mask = torch.from_numpy(mask_np).to(dev)
    lib_mask = mask.bool()[:, None, None, :]
    copies = max(2, -(-COLD_BYTES // (2 * b * L * h * d * 2)))
    sets = []
    for _ in range(copies):
        q, k, v, _ = decode_inputs(rng, b, L, h, d, dt, dev, "plain")
        q = q * float(torch.tensor(d ** -0.5, dtype=dt))
        sets.append((q, k, v))
    q, k, v = sets[0]
    before = decode_attention.launches
    got = decode_attention(q, k, v, kv_mask=mask)
    want = decode_attention_reference(q, k, v, kv_mask=mask)
    err = scaled_err(got, want)
    k4, v4 = (x.view(b, L, h, d).transpose(1, 2) for x in (k, v))
    lib = F.scaled_dot_product_attention(q.transpose(1, 2), k4, v4, attn_mask=lib_mask,
                                         scale=1.0).transpose(1, 2)
    lib_err = scaled_err(lib, want)
    ms = device_ms(cycled([partial(decode_attention, *s, kv_mask=mask) for s in sets]), 50)
    plain_ms = device_ms(cycled([partial(decode_attention_reference, *s, kv_mask=mask)
                                 for s in sets]), 10)
    lib_ms = device_ms(cycled([
        partial(F.scaled_dot_product_attention, s[0].transpose(1, 2),
                s[1].view(b, L, h, d).transpose(1, 2), s[2].view(b, L, h, d).transpose(1, 2),
                attn_mask=lib_mask, scale=1.0) for s in sets]), 20)
    decode_attention.launches = before           # the comparison's launches are not counted
    keys = int(mask_np.sum())
    nbytes = 2 * keys * h * d * 2 + 2 * b * h * d * 2 + b * L * 4
    flops = 4 * keys * h * d
    b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16_FLOP_S)
    if not err < TOL[dt]:
        raise AssertionError(f"{tag} kernel against plain {err} >= {TOL[dt]}")
    log(f"{tag} decode_attention at b {b}, L {L}, h {h}, d {d}, bf16, per-row mask "
        f"({keys} live keys of {b * L}): kernel {ms:.4f} ms device time, plain "
        f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
        f"({nbytes / 1e6:.2f} MB); kernel against plain {err:.3e} (tolerance {TOL[dt]}), SDPA "
        f"against plain {lib_err:.3e}; card: {card_line()}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err, "bytes": nbytes, "flops": flops,
            "live_keys": keys, "shape": f"b {b} L {L} h {h} d {d} bf16 per-row mask"}


def lm_serve_timing(dev, kernels: list, stats: dict) -> list:
    """Phase 22 (f): the decode kernel at the LM engine's shape (b 16 slots,
    8 heads of 128; :func:`decode_shape_timing`).  The launches the phase
    counted are added to the decode kernel's row."""
    timed = decode_shape_timing(dev, LM_ENGINE["num_slots"], 8, SEED + 44, "[lm serve] (f)")
    row = next(r for r in kernels if r["name"] == "decode_attention")
    row.setdefault("launches_by_path", {})
    row["lm_engine_shape"] = timed
    for where, n in stats["launches"].items():
        row["launches_by_path"][where] = n
        row["launches"] += n
    return kernels


def lm_tenants(cfg, seed: int = SEED + 45) -> dict:
    """``LM_LIVE_TENANTS`` seeded LoRA head deltas ``(a [d, r], b [r, V])``
    of rank ``LM_LIVE_RANK``, scaled (``LM_LIVE_SCALE``) so that the delta's
    logits, about 64 * std(a) * std(b) for a final-norm hidden state of RMS 1,
    are as large as the base model's."""
    rng = np.random.default_rng(seed)
    sa, sb = LM_LIVE_SCALE
    return {f"tenant-{i}": (
        (rng.standard_normal((cfg.d_model, LM_LIVE_RANK)) * sa).astype(np.float32),
        (rng.standard_normal((LM_LIVE_RANK, cfg.vocab_size)) * sb).astype(np.float32))
        for i in range(LM_LIVE_TENANTS)}


def lm_v2(state: dict) -> dict:
    """Perturbed weights: the embedding (the tied head) E turned into 1 - E,
    the ``weights.publish`` corrupt fault's flip on one tensor.  The logits
    become sum(h) - h.E, so greedy picks what the base model scores lowest.
    (A negated embedding is no perturbation: the model is nearly odd in
    it, and the negated head turns the logits back.)"""
    return {k: 1 - v if k == "embedding" else v for k, v in state.items()}


def tenant_rows(n: int, names: list) -> list:
    """Prompt i's tenant: the base model for every fourth, else tenant
    ``i % 4 - 1`` (a quarter of the prompts each)."""
    return [None if i % 4 == 0 else names[i % 4 - 1] for i in range(n)]


def drain(engine) -> int:
    """Step a manual engine until it is idle; the steps it took."""
    steps = 0
    while not engine.idle():
        engine.step()
        steps += 1
    return steps


def decode_steps(engine) -> int:
    return engine.metrics.snapshot()["step_latency_s"]["count"]


def migrate_mid_burst(src, dst, prompts_: list, after: int) -> dict:
    """Every prompt on ``src`` (whose prefill runs in its first step), then
    ``after`` decode steps, then ``migrate_out`` and ``submit_migrated`` of
    every stream onto ``dst``, which decodes them to the end.  The streams'
    tokens, the pages and bytes moved, and the host ms of ``migrate_out``,
    of the ``submit_migrated`` checks and of ``dst``'s first step (the 16
    landings' page writes and one decode step)."""
    from tpu_air_torch.engine.dist import payload_nbytes, payload_pages

    for p in prompts_:
        src.submit(p)
    for _ in range(after):
        src.step()
    sync = torch.cuda.synchronize if src.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    payloads = src.migrate_out()
    out_ms = (time.perf_counter() - t0) * 1e3
    if len(payloads) != len(prompts_):
        raise AssertionError(f"migrate_out shipped {len(payloads)} of {len(prompts_)} streams")
    t0 = time.perf_counter()
    landed = [dst.submit_migrated(p) for p in payloads]
    check_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    dst.step()
    sync()
    land_ms = (time.perf_counter() - t0) * 1e3
    drain(dst)
    return {"tokens": [s.result(0) for s in landed],
            "pages": sum(payload_pages(p["pages"]) for p in payloads),
            "bytes": sum(payload_nbytes(p["pages"]) for p in payloads),
            "migrate_out_ms": out_ms, "submit_migrated_ms": check_ms,
            "first_step_ms": land_ms, "migrations": dst.metrics.snapshot()["migrations"],
            "dst_chunks": dst._chunks_run}


def adapter_step_cost(model, prompts_: list, tenants: dict, who: list) -> dict:
    """The paged decode step at the engine's shape, every slot decoding (the
    shortest prompts under their tenants of (a)), with the LoRA banks and
    without, from the same state and in turns: the wall of a step with its
    ``.cpu()`` (median of ``step_times_ms``; the step syncs with the host
    inside, so ``device_ms`` cannot queue it behind a sleep); and the banks'
    gather and two einsums alone (``device_ms``).  The launches these calls
    make are not counted."""
    from tpu_air_torch.engine import EngineConfig, InferenceEngine
    from tpu_air_torch.models.lm import make_lm_paged_decode_step_fn
    from tpu_air_torch.ops.decode_attention import decode_attention

    before = decode_attention.launches
    engine = InferenceEngine(model, EngineConfig(**{**LM_ENGINE, "prefill_chunks_per_step": 1 << 10},
                                                 adapter_slots=4, adapter_rank=LM_LIVE_RANK),
                             auto_start=False, name="lm-live-step-cost")
    for name, (a, b) in tenants.items():
        engine.load_adapter(name, a, b)
    for i in sorted(range(len(prompts_)), key=lambda i: len(prompts_[i]))[:LM_ENGINE["num_slots"]]:
        engine.submit(prompts_[i], adapter_id=who[i])
    engine.step()                     # admits and prefills every slot, then one decode step
    t = engine._tensor
    args = (engine.cache, t(engine._cur_tok), t(engine._pos), t(engine.pool.block_table))
    bank_a, bank_b, ids = engine._adapter_a, engine._adapter_b, t(engine._adapter_ids_host)
    base_fn = make_lm_paged_decode_step_fn(model, LM_ENGINE["slot_len"])
    calls = {"base": lambda: base_fn(*args)[1],
             "banks": lambda: engine._decode_step(*args, bank_a, bank_b, ids)[1]}
    host_ms = {k: [] for k in calls}
    for k in ("base", "banks", "banks", "base"):
        host_ms[k].append(float(np.median(step_times_ms(lambda: calls[k]().cpu(), 20))))
    h = torch.randn(LM_ENGINE["num_slots"], model.config.d_model, device=model.device)
    bank_ms = device_ms(lambda: torch.einsum("sr,srv->sv", torch.einsum(
        "sd,sdr->sr", h, bank_a[ids]), bank_b[ids]), 50)
    engine.close()
    decode_attention.launches = before
    return {"step_ms": {k: float(np.mean(v)) for k, v in host_ms.items()}, "bank_ms": bank_ms}


def lm_live_path(dev, ckpt_dir: str, port: int, work: str, served: dict) -> dict:
    """Phase 23 (a)-(e): live weights, LoRA adapters and migration on the
    ``[lm]`` checkpoint's engine (see the module docstring).  ``served`` is
    phase 22's result: its burst tokens and decode-step times are the
    yardstick.  The counts of the decode kernel's launches are set to 0
    before each of (a), (b), (c) and (e)'s kernel runs and read after it;
    (d)'s are counted in its replica."""
    from tpu_air_torch import get, serve
    from tpu_air_torch.engine import EngineConfig, InferenceEngine
    from tpu_air_torch.faults import plan as faults
    from tpu_air_torch.ops.decode_attention import decode_attention
    from tpu_air_torch.serve import EngineDeployment, WeightStore, attach_weights, compute_probe
    from tpu_air_torch.serve.weights import offline_greedy, uninstall_controller
    from tpu_air_torch.train import Checkpoint

    t_phase = time.perf_counter()
    ckpt = Checkpoint.from_directory(ckpt_dir)
    model = ckpt.get_model(dtype="bfloat16", device=dev)
    cfg = model.config
    ps = lm_serve_prompts(LM_ENGINE_PROMPTS, cfg.vocab_size, SEED + 42)
    base, base_step = served["burst_tokens"], served["paged"]["burst"]["metrics"]["step_latency_s"]
    tenants = lm_tenants(cfg)
    names = list(tenants)
    who = tenant_rows(len(ps), names)
    new = LM_ENGINE["max_new_tokens"]
    out = {"launches": {}, "part_s": {}}

    def part_done(name, t_start):
        out["part_s"][name] = time.perf_counter() - t_start
        return time.perf_counter()

    # (a) adapters: the mixed-tenant burst in process
    engine = InferenceEngine(model, EngineConfig(**LM_ENGINE, adapter_slots=4,
                                                 adapter_rank=LM_LIVE_RANK),
                             auto_start=False, name="lm-live-adapters")
    for name, (a, b) in tenants.items():
        engine.load_adapter(name, a, b)
    decode_attention.launches = 0
    t0 = time.perf_counter()
    burst = who[:LM_LIVE_ADAPTER_PROMPTS]
    streams = [engine.submit(p, adapter_id=t) for p, t in zip(ps, burst)]
    drain(engine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, n_steps = decode_attention.launches, decode_steps(engine)
    step = engine.metrics.snapshot()["step_latency_s"]
    engine.close()
    toks = [s.result(0) for s in streams]
    bad = [i for i, t in enumerate(burst) if t is None and toks[i] != base[i]]
    changed, agree, total = {}, {}, {}
    for name in names:
        rows = [i for i, t in enumerate(burst) if t == name]
        total[name] = len(rows) * new
        changed[name] = sum(x != y for i in rows for x, y in zip(toks[i], base[i]))
        agree[name] = sum(x == y for i in rows[:LM_LIVE_OFFLINE_ROWS] for x, y in zip(
            toks[i], offline_greedy(model, ps[i], new, *tenants[name])))
    log(f"[lm live] (a) paged InferenceEngine({LM_ENGINE}, adapter_slots=4, adapter_rank="
        f"{LM_LIVE_RANK}), bf16: {len(names)} tenants of rank {LM_LIVE_RANK} (a ~ N(0, "
        f"{LM_LIVE_SCALE[0]:.4f}), b ~ N(0, {LM_LIVE_SCALE[1]})), the first {len(burst)} "
        f"prompts as one burst, "
        f"a quarter on each tenant and on the base: {wall:.3f} s over {n_steps} decode steps; "
        f"base rows equal to phase 22 (b)'s burst: {not bad}; tokens each tenant changed "
        f"against the base model's {changed} of {total}; adapter rows agreeing with per-tenant "
        f"offline_greedy (bf16: prefill shapes differ, printed, not asserted) {agree} of "
        f"{LM_LIVE_OFFLINE_ROWS * new} a tenant (its first {LM_LIVE_OFFLINE_ROWS} rows); "
        f"decode step p50 {step['p50'] * 1e3:.3f} ms, p95 {step['p95'] * 1e3:.3f} ms "
        f"(phase 22 (b) burst: p50 {base_step['p50'] * 1e3:.3f} ms, p95 "
        f"{base_step['p95'] * 1e3:.3f} ms); decode launches {launches}; card: {card_line()}")
    if bad:
        raise AssertionError(f"[lm live] (a) base rows {bad} differ from phase 22's burst")
    if min(changed.values()) == 0:
        raise AssertionError(f"[lm live] (a) a tenant changed no token: {changed}")
    if launches != cfg.n_layers * n_steps:
        raise AssertionError(f"[lm live] (a) decode launches {launches}, steps {n_steps}")
    cost = adapter_step_cost(model, ps, tenants, who)
    log(f"[lm live] (a) the decode step at 16 slots, all decoding, with the banks and without, "
        f"in turns from one state: {cost['step_ms']['banks']:.3f} / {cost['step_ms']['base']:.3f} "
        f"ms a step with its .cpu() (median of 20, twice each); the banks' gather "
        f"([16, {LM_LIVE_RANK}, {cfg.vocab_size}] f32) and two einsums alone "
        f"{cost['bank_ms']:.4f} ms of device time")
    out["adapters"] = {"wall_s": wall, "steps": n_steps, "changed": changed, "total": total,
                       "agree_offline": agree, "step_latency_s": step,
                       "phase22_step_latency_s": base_step, "step_cost": cost}
    out["launches"]["lm_live_adapters"] = launches
    adapter_tokens = toks
    t_part = part_done("a", t_phase)

    # (b) live weights: a byte-identical swap mid-burst, then v2 and rollback
    state = ckpt.get_params()                    # f32: the served bf16 after the cast
    engine = InferenceEngine(model, EngineConfig(**LM_ENGINE), auto_start=False,
                             name="lm-live-swap")
    decode_attention.launches = 0
    swap_ps, swap_base = ps[:LM_LIVE_SWAP_PROMPTS], base[:LM_LIVE_SWAP_PROMPTS]
    streams = [engine.submit(p) for p in swap_ps]
    for _ in range(LM_LIVE_SWAP_AT):
        engine.step()
    same_ms = engine.swap_params(state, version=1)
    drain(engine)
    toks = [s.result(0) for s in streams]
    v2_ms = engine.swap_params(lm_v2(state),
                               version=2)
    fresh = ps[1]
    under_v2 = engine.generate([fresh])[0]
    back_ms = engine.rollback_params()
    restored = engine.generate([fresh])[0]
    try:
        engine.rollback_params()
        second = "no error"
    except RuntimeError as e:
        second = f"RuntimeError: {e}"
    launches, n_steps = decode_attention.launches, decode_steps(engine)
    engine.close()
    log(f"[lm live] (b) swap_params to byte-identical weights after {LM_LIVE_SWAP_AT} steps of "
        f"a {len(swap_ps)}-prompt burst: stall {same_ms:.3f} ms, tokens identical to phase 22 "
        f"(b)'s burst: {toks == swap_base}; swap to v2 (embedding E -> 1 - E) stall {v2_ms:.3f} ms, a fresh "
        f"prompt's tokens under v2 differ: {under_v2 != base[1]}; rollback stall {back_ms:.3f} "
        f"ms, the prompt's tokens then equal phase 22's: {restored == base[1]}; a second "
        f"rollback: {second}; decode launches {launches}")
    if toks != swap_base:
        raise AssertionError("[lm live] (b) the same-weights swap changed tokens")
    if under_v2 == base[1] or restored != base[1] or second == "no error":
        raise AssertionError(f"[lm live] (b) v2 {under_v2 != base[1]}, restored "
                             f"{restored == base[1]}, second rollback {second}")
    if launches != cfg.n_layers * n_steps:
        raise AssertionError(f"[lm live] (b) decode launches {launches}, steps {n_steps}")
    out["swap"] = {"same_stall_ms": same_ms, "v2_stall_ms": v2_ms, "rollback_stall_ms": back_ms}
    out["launches"]["lm_live_swap"] = launches
    t_part = part_done("b", t_part)

    # (c) migration between two engines on the card, each on its own copy
    # of the checkpoint
    model_b = ckpt.get_model(dtype="bfloat16", device=dev)
    src = InferenceEngine(model, EngineConfig(**{**LM_ENGINE, "prefill_chunks_per_step": 1 << 10}),
                          auto_start=False, name="lm-live-a")
    dst = InferenceEngine(model_b, EngineConfig(**LM_ENGINE), auto_start=False, name="lm-live-b")
    decode_attention.launches = 0
    mig = migrate_mid_burst(src, dst, ps[:LM_LIVE_MIGRATED], LM_LIVE_MIGRATE_AFTER)
    launches, n_steps = decode_attention.launches, decode_steps(src) + decode_steps(dst)
    src.close()
    dst.close()
    del model_b
    same = mig["tokens"] == base[:LM_LIVE_MIGRATED]
    log(f"[lm live] (c) {LM_LIVE_MIGRATED} prompts on engine A, migrate_out after "
        f"{LM_LIVE_MIGRATE_AFTER} decode steps, submit_migrated on engine B: {mig['pages']} "
        f"pages, {mig['bytes'] / 1e6:.2f} MB moved through the host; migrate_out "
        f"{mig['migrate_out_ms']:.3f} ms, submit_migrated checks {mig['submit_migrated_ms']:.3f} "
        f"ms, B's first step (the landings and one decode step) {mig['first_step_ms']:.3f} ms, "
        f"{mig['migrate_out_ms'] / mig['pages'] * 1e3:.1f} us a page out; tokens identical to "
        f"the unmigrated run (phase 22 (b)): {same}; B's migrations {mig['migrations']}, prefill "
        f"chunks {mig['dst_chunks']}; decode launches {launches}")
    if not same or mig["migrations"]["in_reprefill_chunks"] or mig["dst_chunks"]:
        raise AssertionError(f"[lm live] (c) identical {same}, {mig['migrations']}, chunks "
                             f"{mig['dst_chunks']}")
    if launches != cfg.n_layers * n_steps:
        raise AssertionError(f"[lm live] (c) decode launches {launches}, steps {n_steps}")
    out["migration"] = {k: v for k, v in mig.items() if k != "tokens"}
    out["launches"]["lm_live_migrate"] = launches
    torch.cuda.empty_cache()
    t_part = part_done("c", t_part)

    # (d) served: the canary controller over EngineDeployment
    root = os.path.join(work, "lm_live_weights")
    probes = [p[:64] for p in ps[1:1 + LM_LIVE_PROBES]]
    probe = compute_probe(model, probes, LM_LIVE_PROBE_NEW, with_logits=True,
                          logit_tolerance=0.0)
    a, b = tenants[names[0]]
    tprobe = compute_probe(model, probes, LM_LIVE_PROBE_NEW, adapter_a=a, adapter_b=b,
                           with_logits=True, logit_tolerance=0.0)
    rows = [i for i, t in enumerate(burst) if t == names[0]]
    try:
        t0 = time.perf_counter()
        h = serve.run(EngineDeployment.options(name="lm-live", route_prefix="/lmlive",
                                               num_chips=1)
                      .bind(ckpt, EngineConfig(**LM_ENGINE, adapter_slots=4,
                                               adapter_rank=LM_LIVE_RANK), dtype="bfloat16"),
                      port=port)
        post_json(port, "/lmlive", {"prompts": [ps[0][:64]], "max_new_tokens": 2})
        start_s = time.perf_counter() - t0
        store = WeightStore(root)
        t0 = time.perf_counter()
        v1 = store.publish(state, metadata={"iteration": 1}, probe=probe)
        publish_s = time.perf_counter() - t0
        ctl = attach_weights("/lmlive", root, soak_s=0.2)
        t0 = time.perf_counter()
        r1 = ctl.promote(v1)
        promote_s = time.perf_counter() - t0
        faults.install(faults.FaultPlan(specs=[faults.FaultSpec("weights.publish", "corrupt")]))
        try:
            v2 = store.publish(state, metadata={"iteration": 2}, probe=probe)
        finally:
            faults.clear()
        r2 = ctl.promote(v2)
        r3 = ctl.promote(store.publish_adapter(names[0], a, b, probe=tprobe))
        res, _ = post_json(port, "/lmlive", {"prompts": [ps[i] for i in rows],
                                             "adapter_id": names[0]})
        tenant_toks = [r["tokens"] for r in res["results"]]
        stats, _ = post_json(port, "/-/stats", {})
        snap = get(h.method("stats")())
    finally:
        uninstall_controller("/lmlive")
        serve.shutdown()
    wst = stats["weights"]["/lmlive"]
    rl = snap["kernel_launches"]
    same = tenant_toks == [adapter_tokens[i] for i in rows]
    log(f"[lm live] (d) EngineDeployment(EngineConfig({LM_ENGINE}, adapter_slots=4), "
        f"dtype=\"bfloat16\") with attach_weights on a WeightStore: serve.run + load + warm-up "
        f"{start_s:.3f} s; publish of v1 ({len(store.manifest(v1)['tensors'])} tensors, f32) "
        f"{publish_s:.3f} s; promote v1 (swap from the store, probe with exact logits, a "
        f"{ctl.soak_s} s soak) {promote_s:.3f} s: {r1}; promote of v2, published under a "
        f"weights.publish corrupt fault: {r2}; the tenant adapter through the gate: {r3}; "
        f"/-/stats weights {wst}; {len(rows)} prompts of {names[0]} in one POST equal to (a)'s "
        f"in-process tokens: {same}; replica device {snap['device']}, launches {rl}, weights "
        f"{snap.get('weights')}")
    if not r1["promoted"] or r2["promoted"] or not r3["promoted"]:
        raise AssertionError(f"[lm live] (d) promotions {r1}, {r2}, {r3}")
    if wst["rollbacks"] != 1 or wst["current_version"] != v1 or not same:
        raise AssertionError(f"[lm live] (d) weights {wst}, tenant tokens equal {same}")
    if snap["device"] != str(dev) or rl["decode_attention"] <= 0 or rl["flash_attention"]:
        raise AssertionError(f"[lm live] (d) replica device {snap['device']}, launches {rl}")
    out["served"] = {"serve_start_s": start_s, "publish_s": publish_s, "promote_s": promote_s,
                     "promote_v1": r1, "promote_v2": r2, "promote_adapter": r3,
                     "weights": wst, "replica_weights": snap.get("weights"), "launches": rl}
    out["launches"]["lm_live_replica"] = rl["decode_attention"]
    del model
    torch.cuda.empty_cache()
    t_part = part_done("d", t_part)

    # (e) f32 parity at full width, depth cut to 2
    out["parity"] = lm_live_parity(dev)
    out["launches"]["lm_live_parity"] = out["parity"]["kernel_launches"]
    part_done("e", t_part)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[lm live] phase 23 (a)-(e) {out['phase_s']:.1f} s: "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in out["part_s"].items()))
    return out


PROM_SAMPLE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [-+0-9.eEinfINFaN]+$")


def prometheus_families(text: str) -> set:
    """The metric names of a Prometheus text exposition, checked line by
    line: a ``#`` comment, or ``name{labels} value`` (an OpenMetrics
    exemplar after `` # `` allowed); anything else fails."""
    names = set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        sample = line.split(" # ", 1)[0]
        if not PROM_SAMPLE.match(sample):
            raise AssertionError(f"[obs serve] /metrics: not Prometheus text: {line!r}")
        float(sample.rsplit(" ", 1)[1])
        names.add(re.split(r"[{ ]", sample, maxsplit=1)[0])
    return names


def get_url(url: str):
    """(status, body bytes) of a GET."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def obs_serve_path(dev, ckpt_dir: str, work: str, served: dict) -> dict:
    """``[obs serve]``: the observability plane over the served paged LM
    engine, in a runtime of its own (``init(include_dashboard=True,
    dashboard_port=0)``, ``TPU_AIR_TRACE=1`` and ``TPU_AIR_POSTMORTEM_DIR``
    set before it starts), on phase 22's checkpoint, engine configuration
    and prompts in bf16 (``served`` is phase 22's result).  (a) the default
    SLO monitor over ``dashboard.slo_source`` and airwatch (seed 0, a scrape
    every ``OBS_WATCH_S``) installed, ``EngineDeployment`` served; (b) the
    32 prompts as streams, then phase 22 (d)'s ``LM_SERVED`` again as
    streams, then ``OBS_POST`` of them in one traced blocking POST, at 64
    new tokens, equal to phase 22's burst; (c) every dashboard route
    scraped and checked, and the last streams' traces listed whole; (d)
    the autoscaler's default
    sources, a same-weights canary promotion, and the same promotion under
    an SLO every request breaks, which must fail on the burn; (e) the
    decode step of the ``LM_SERVED`` streams with the plane on against
    phase 22's over the same streams, the difference reported; then a
    postmortem: an actor on a leased card exits with status 17, and its
    dump must load naming the crash, the actor and its card.  The decode
    launches are counted in the replica."""
    import tpu_air_torch
    from tpu_air_torch import get, serve
    from tpu_air_torch.engine import EngineConfig
    from tpu_air_torch.observability import dashboard, postmortem, slo, tracing, watch
    from tpu_air_torch.serve import EngineDeployment, WeightStore, attach_weights
    from tpu_air_torch.serve.autoscaler import (_installed_monitor_burning,
                                                _installed_watch_anomalies)
    from tpu_air_torch.serve.weights import uninstall_controller
    from tpu_air_torch.train import Checkpoint

    t_phase = time.perf_counter()
    ckpt = Checkpoint.from_directory(ckpt_dir)
    pm_dir = os.path.join(work, "postmortem")
    os.environ["TPU_AIR_TRACE"] = "1"              # the replica inherits it
    os.environ["TPU_AIR_POSTMORTEM_DIR"] = pm_dir
    tracing.enable()
    out = {}
    try:
        tpu_air_torch.init(include_dashboard=True, dashboard_port=0)
        url = dashboard.start_dashboard(port=0)   # the running server's URL
        mon = slo.ensure_default(dashboard.slo_source)
        w = watch.install(watch.WatchConfig(seed=0, interval_s=OBS_WATCH_S))
        port = free_port()
        t0 = time.perf_counter()
        h = serve.run(EngineDeployment.options(name="lm-obs", route_prefix="/lmobs",
                                               num_chips=1)
                      .bind(ckpt, EngineConfig(**LM_ENGINE), dtype="bfloat16"), port=port)
        post_json(port, "/lmobs", {"prompts": [[5, 6, 7, 8]], "max_new_tokens": 2})
        start_s = time.perf_counter() - t0
        if not (w._scraper is not None and w._scraper.running):
            raise AssertionError("[obs serve] (a) serve.run did not start the fleet scraper")
        log(f"[obs serve] (a) init(include_dashboard=True) at {url}; default SLO monitor "
            f"({', '.join(s.name for s in mon.slos)}); airwatch seed 0 every {OBS_WATCH_S} s; "
            f"EngineDeployment(EngineConfig({LM_ENGINE}), dtype=\"bfloat16\") on the card, "
            f"serve.run + load + warm-up {start_s:.3f} s")

        # (b) phase 22's prompts over HTTP
        ps = lm_serve_prompts(LM_ENGINE_PROMPTS, ckpt.get_model_config().vocab_size, SEED + 42)
        burst = served["burst_tokens"]
        # streams keep the replica's actor free between short calls, so the
        # scraper's stats RPCs land while the engine decodes
        t0 = time.perf_counter()
        tokens = engine_streams(port, "/lmobs", ps, SERVE_CLIENTS, LM_ENGINE["max_new_tokens"])
        traffic_s = time.perf_counter() - t0
        # phase 22 (d)'s streams again, the same load with the plane on: (e)
        # reads their decode steps, (c) their last polls' traces
        finals = []
        snap_s = get(h.method("stats")())
        again = engine_streams(port, "/lmobs", ps[:LM_SERVED], SERVE_CLIENTS,
                               LM_ENGINE["max_new_tokens"], finals)
        snap_e = get(h.method("stats")())
        # then one blocking POST, whose trace (a few dozen spans) the
        # dashboard must list
        res, headers = post_json(port, "/lmobs", {"prompts": ps[:OBS_POST]})
        posted = [r["tokens"] for r in res["results"]]
        trace_id = headers["x-tpu-air-trace-id"]
        same = (tokens == burst, again == burst[:LM_SERVED], posted == burst[:OBS_POST])
        n_tok = sum(map(len, tokens))
        log(f"[obs serve] (b) {len(ps)} prompts as submit/poll streams from {SERVE_CLIENTS} "
            f"client threads: {traffic_s:.3f} s, {n_tok / traffic_s:.1f} generated tokens/s; "
            f"then phase 22 (d)'s {LM_SERVED} as streams again, then {OBS_POST} in one "
            f"blocking POST; tokens equal phase 22's burst: streams {same[0]}, the "
            f"{LM_SERVED} again {same[1]}, POST {same[2]}")
        if not all(same):
            bad = [i for i, (a, b) in enumerate(zip(tokens, burst)) if a != b]
            raise AssertionError(f"[obs serve] (b) tokens differ from phase 22's: streams at "
                                 f"{bad}, the {LM_SERVED} again equal {same[1]}, POST equal "
                                 f"{same[2]}")

        # (c) every route, once the scraper has seen the end of the traffic
        seen = w.scrapes
        deadline = time.time() + 30
        while w.scrapes < seen + 2:
            if time.time() > deadline:
                raise AssertionError(f"[obs serve] (c) the scraper stopped at {w.scrapes}")
            time.sleep(0.05)
        stats = get(h.method("stats")())
        bodies = {}
        for route in ("/", "/api/cluster", "/api/objects", "/api/engines", "/api/serve",
                      "/api/traces", "/api/traces/export", "/api/slo", "/api/tenants",
                      "/api/watch", "/api/batch", "/api/version", "/metrics"):
            status, body = get_url(url + route)
            if status != 200:
                raise AssertionError(f"[obs serve] (c) {route}: {status} {body[:300]!r}")
            bodies[route] = body
        data = {r: json.loads(b) for r, b in bodies.items() if r.startswith("/api/")}
        # the replica's engines; /api/engines also lists this process's own
        # (the earlier phases' in-process engines stay registered)
        engines = {k: v for k, v in data["/api/engines"].items() if k.startswith("lm-obs/")}
        totals = {k: sum(v[k] for v in engines.values())
                  for k in ("requests_completed", "tokens_emitted")}
        want = {k: stats[k] for k in totals}
        fams = prometheus_families(bodies["/metrics"].decode())
        _, body = get_url(f"{url}/api/traces?limit={1 << 20}")   # the polls' traces too
        listing = json.loads(body)
        listed = {t["trace_id"] for t in listing["traces"]}

        def spans_and_events(tid):
            _, one = get_url(f"{url}/api/traces?trace_id={tid}")
            _, exp = get_url(f"{url}/api/traces/export?trace_id={tid}")
            return (len(json.loads(one)["spans"]),
                    sum(e["ph"] == "X" for e in json.loads(exp)["traceEvents"]))

        n_spans, n_events = spans_and_events(trace_id)
        # the ring keeps the newest spans: the last streams' polls are in it
        last = {tid: spans_and_events(tid) for _, tid in sorted(finals)[-OBS_LAST_STREAMS:]}
        slos = {s["name"]: s for s in data["/api/slo"]["slos"]}
        headline = data["/api/tenants"]["headline"]
        log(f"[obs serve] (c) /api/engines {sorted(data['/api/engines'])}: the replica's "
            f"{sorted(engines)} totals {totals}, its stats() {want}; /metrics {len(fams)} families "
            f"({sum(f.startswith('tpu_air_engine_') for f in fams)} tpu_air_engine_*, "
            f"{sum(f.startswith('tpu_air_slo_') for f in fams)} tpu_air_slo_*); /api/traces "
            f"recorder {listing['recorder']}, {len(listed)} traces listed; the POST's trace "
            f"listed {trace_id in listed}, its {n_spans} spans and {n_events} exported events; "
            f"the last {OBS_LAST_STREAMS} streams' final polls listed "
            f"{[tid in listed for tid in last]}, (spans, exported events) "
            f"{list(last.values())}; /api/slo "
            + ", ".join(f"{n} total {s['total']:g} burn {[round(x['burn_rate'], 3) for x in s['windows']]}"
                        for n, s in slos.items())
            + f"; /api/watch scrapes {data['/api/watch']['scrapes']}, anomalies "
            f"{data['/api/watch']['anomalies']}; /api/tenants chip-seconds per 1k tokens "
            f"{headline['chip_seconds_per_1k_tokens']:.6f} over {headline['tokens_total']:g} "
            f"tokens; /api/cluster gcs {data['/api/cluster']['gcs']}, /api/batch "
            f"{data['/api/batch']}")
        checks = {
            "engines": totals == want and len(engines) == 1,
            "metrics": any(f.startswith("tpu_air_engine_") for f in fams)
            and any(f.startswith("tpu_air_slo_") for f in fams),
            "traces": trace_id in listed and n_spans > 0 and n_spans == n_events,
            "stream traces": len(last) == OBS_LAST_STREAMS
            and all(tid in listed and 0 < n == m for tid, (n, m) in last.items()),
            "slo": sorted(slos) == sorted(s.name for s in slo.default_slos())
            and all(len(s["windows"]) == 2 for s in slos.values())
            and slos["ttft"]["total"] > 0,
            "watch": data["/api/watch"]["scrapes"] > 0,
            "tenants": headline["chip_seconds_per_1k_tokens"] > 0,
            "cluster": data["/api/cluster"]["initialized"]
            and data["/api/cluster"]["gcs"] == {"address": None, "nodes": []},
            "batch": data["/api/batch"] == {"jobs": {}},
        }
        if not all(checks.values()):
            raise AssertionError(f"[obs serve] (c) failed checks: "
                                 f"{[k for k, ok in checks.items() if not ok]}")

        # (d) the controls read the plane
        burning, anomalies = _installed_monitor_burning(), _installed_watch_anomalies()
        if burning != tuple(mon.burning()) or anomalies != tuple(w.anomalous()):
            raise AssertionError(f"[obs serve] (d) autoscaler sources {burning}, {anomalies}")
        store = WeightStore(os.path.join(work, "obs_weights"))
        v1 = store.publish(ckpt.get_params(), metadata={"iteration": 1})
        ctl = attach_weights("/lmobs", store.root, soak_s=1.0)
        try:
            r1 = ctl.promote(v1)
            slo.install(slo.SLOMonitor(
                [slo.SLO(name="obs-every-request", metric="ttft_s", threshold_s=1e-6,
                         windows=((600.0, 1.0),))], source=dashboard.slo_source))
            slo.monitor().observe()
            post_json(port, "/lmobs", {"prompts": ps[:4], "max_new_tokens": 4})
            time.sleep(2 * OBS_WATCH_S)
            slo.monitor().observe()
            burn = slo.monitor().burning()
            r2 = ctl.promote(v1)
        finally:
            uninstall_controller("/lmobs")
            slo.install(mon)
        log(f"[obs serve] (d) autoscaler default sources: burning {burning}, anomalies "
            f"{anomalies} (= the monitor's and the detector's); same-weights promote with a "
            f"{ctl.soak_s} s soak: {r1}; under an SLO every request breaks (burning {burn}): "
            f"{r2}")
        if not r1["promoted"] or r2["promoted"] or "SLO burning" not in r2["reason"] \
                or "obs-every-request" not in r2["reason"]:
            raise AssertionError(f"[obs serve] (d) promotions {r1}, {r2}")

        # (e) the decode step of phase 22 (d)'s streams, plane on against off
        step = gained(snap_s["step_latency_s"], snap_e["step_latency_s"])
        base = served["served"]["stream_step_s"]
        cost = {q: (step[q] - base[q]) * 1e3 for q in ("p50", "p95")}
        rl = stats["kernel_launches"]
        log(f"[obs serve] (e) phase 22 (d)'s {LM_SERVED} streams with the plane on: decode "
            f"step p50 {step['p50'] * 1e3:.3f} ms, p95 {step['p95'] * 1e3:.3f} ms over "
            f"{step['count']} steps; in phase 22 (plane off): p50 {base['p50'] * 1e3:.3f} ms, "
            f"p95 {base['p95'] * 1e3:.3f} ms over {base['count']} steps; on - off: p50 "
            f"{cost['p50']:+.3f} ms, p95 {cost['p95']:+.3f} ms (reported, not asserted); "
            f"replica device {stats['device']}, launches {rl}; card: {card_line()}")
        if stats["device"] != str(dev) or rl["decode_attention"] <= 0 or rl["flash_attention"]:
            raise AssertionError(f"[obs serve] replica device {stats['device']}, launches {rl}")
        serve.shutdown()
        if w._scraper is not None:
            raise AssertionError("[obs serve] serve.shutdown left the fleet scraper running")
        out.update({"serve_start_s": start_s, "traffic_s": traffic_s, "tokens": n_tok,
                    "totals": totals, "metric_families": len(fams), "trace_spans": n_spans,
                    "tenants_headline": headline, "scrapes": w.scrapes, "promote_same": r1,
                    "promote_burning": r2, "decode_step_s": step, "phase22_step_s": base,
                    "plane_cost_ms": cost, "last_stream_traces": last,
                    "recorder": listing["recorder"],
                    "launches": rl})

        # postmortem: an actor on a leased card dies
        @tpu_air_torch.remote(num_chips=1)
        class Doomed:
            def where(self):
                from tpu_air_torch.device import resolve_device

                return (str(torch.ones(1, device=resolve_device()).device),
                        os.environ.get("TPU_AIR_CHIP_IDS"))

            def die(self):
                os._exit(17)

        actor = Doomed.remote()
        where = get(actor.where.remote(), timeout=300)
        try:
            get(actor.die.remote(), timeout=300)
            raise AssertionError("[obs serve] the actor's exit raised nothing")
        except tpu_air_torch.RemoteError as e:
            crash = str(e)
        # every worker death dumps (the replica that serve.shutdown killed
        # too): the actor's dump is the one that names it
        deadline = time.time() + 60
        while True:
            dumps = {f: postmortem.load(os.path.join(pm_dir, f))
                     for f in sorted(os.listdir(pm_dir)) if f.endswith(".json")}
            mine = [f for f, d in dumps.items() if d["context"]["actor_id"] == actor._actor_id]
            if mine:
                break
            if time.time() > deadline:
                raise AssertionError(f"[obs serve] no postmortem of {actor._actor_id} in "
                                     f"{pm_dir} after {crash!r}: {sorted(dumps)}")
            time.sleep(0.1)
        name = mine[0]
        dump = dumps[name]
        ctx = dump["context"]
        log(f"[obs serve] postmortem: the actor on {where[0]} (lease {where[1]}) exited with "
            f"17; {crash.splitlines()[0][:120]}; dump {name} (of {len(dumps)} in the directory: "
            f"every worker death writes one): reason {dump['reason']}, actor {ctx['actor_id']}, card ids "
            f"{ctx['chip_ids']}, sections {sorted(dump)}")
        if (not dump["reason"].startswith("WorkerCrashed(") or ctx["actor_id"] != actor._actor_id
                or ctx["chip_ids"] != [dev.index or 0] or where[0] != str(dev)):
            raise AssertionError(f"[obs serve] postmortem {dump['reason']}, {ctx}, {where}")
        out["postmortem"] = {"reason": dump["reason"], "context": ctx, "sections": sorted(dump)}
    finally:
        serve.shutdown()
        watch.clear()
        slo.install(None)
        tpu_air_torch.shutdown()
        tracing.disable()
        os.environ.pop("TPU_AIR_TRACE", None)
        os.environ.pop("TPU_AIR_POSTMORTEM_DIR", None)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[obs serve] phase {out['phase_s']:.1f} s (runtime start and stop included)")
    return out


def lane_streams(port: int, route: str, prompts_: list, progress: dict):
    """Each prompt as a submit/poll stream over HTTP, all submitted first
    from this thread, then polled in turn every 10 ms (each poll pinned to
    the replica that took the submit) until all are done; ``progress[i]``
    is ``[pin, tokens]`` of stream ``i`` as it goes, for the caller to read
    while the streams decode."""
    streams = []
    for i, prompt in enumerate(prompts_):
        sub, headers = post_json(port, route, {"action": "submit", "prompt": prompt,
                                               "max_new_tokens": LM_ENGINE["max_new_tokens"]})
        progress[i] = [headers["x-tpu-air-replica"], []]
        streams.append(sub["request_id"])
    done = [False] * len(streams)
    while not all(done):
        for i, rid in enumerate(streams):
            if done[i]:
                continue
            pin, toks = progress[i]
            res, _ = post_json(port, route, {"action": "poll", "request_id": rid,
                                             "cursor": len(toks)},
                               headers={"x-tpu-air-replica": pin})
            toks += res["tokens"]
            done[i] = res["done"]
        time.sleep(0.01)


def batch_lane_path(dev, ckpt_dir: str, served: dict) -> dict:
    """``[batch lane]`` (phase 25): revocable leases and the batch lane over
    the served paged LM engine, in a runtime of its own, on phase 22's
    checkpoint, engine configuration and prompts in bf16 (``served`` is
    phase 22's result; its burst tokens are the yardstick).  (a) ``init``
    with the dashboard on port 0 and airwatch; ``EngineDeployment`` with 2
    replicas of ``num_chips=0.5`` sharing the card, each printing its
    device; (b) ``BatchJob`` over a ``Dataset`` of the 32 prompts (4
    blocks), killed by the ``batch.runner`` fault site at its 3rd chunk
    commit, then resumed by a fresh job of the same id: every row exactly
    once across the committed chunk objects, at least one chunk resumed,
    each row's tokens equal to phase 22 (b)'s, billed to tenant
    ``batch:chip-batch``, and the ``batch.job`` span with ``batch.chunk``
    children; (c) 16 of the prompts as streams; once the first of A's has
    ``LANE_RETURN_AFTER`` tokens, replica A goes back through the lane's own
    return path
    (``shrink_target``, ``mark_borrowed``, the ``borrow_return`` RPC with a
    ``LANE_NOTICE_S`` notice), and the preemption watcher migrates A's live
    streams into B's process (the journal replays those still queued or
    prefilling on B from their prompts): every stream equal to phase 22's,
    one borrow return, at least one migration, no replay failure, no
    replica spawned in A's place, no prefill chunk re-run on B for a
    migrated stream; the pages and bytes moved and the ms a page; (d) ``/api/batch``, ``/metrics`` and ``/-/stats`` report the job.
    Borrowing on a trough (``BatchJob._maybe_borrow``) waits for a whole
    free card (``avail["chip"] >= 1.0``): with one card shared by the two
    replicas it never borrows here, and tests/test_torch_batch.py checks it
    on the CPU with two device slots.  The decode launches are counted in
    the replicas: A's read just after its notice (the few steps between
    that read and its ``migrate_out`` are not counted; the watcher ends
    A's process after the migration), B's at the end."""
    import threading

    import tpu_air_torch
    from tpu_air_torch import data as tdata
    from tpu_air_torch import get, serve
    from tpu_air_torch.batch import BatchJob, BatchJobConfig, BatchJobKilled
    from tpu_air_torch.core.runtime import get_runtime
    from tpu_air_torch.engine import EngineConfig
    from tpu_air_torch.engine.metrics import merge_snapshots
    from tpu_air_torch.faults import plan as faults
    from tpu_air_torch.observability import dashboard, tracing, watch
    from tpu_air_torch.serve import EngineDeployment
    from tpu_air_torch.serve.proxy import replica_engine_stats, route_control
    from tpu_air_torch.train import Checkpoint

    t_phase = time.perf_counter()
    ckpt = Checkpoint.from_directory(ckpt_dir)
    cfg = ckpt.get_model_config()
    ps = lm_serve_prompts(LM_ENGINE_PROMPTS, cfg.vocab_size, SEED + 42)
    burst = served["burst_tokens"]
    route = "/lmlane"
    out = {}
    try:
        # (a) two replicas sharing the card
        tpu_air_torch.init(include_dashboard=True, dashboard_port=0)
        native_start = runtime_native("batch lane")
        url = dashboard.start_dashboard(port=0)
        w = watch.install(watch.WatchConfig(seed=0, interval_s=OBS_WATCH_S))
        port = free_port()
        t0 = time.perf_counter()
        h = serve.run(EngineDeployment.options(name="lm-lane", route_prefix=route,
                                               num_replicas=2, num_chips=LANE_REPLICA_CHIPS)
                      .bind(ckpt, EngineConfig(**LM_ENGINE), dtype="bfloat16"), port=port)
        replicas = list(h._replicas)
        get([r.handle.remote("weights_probe", ([[5, 6, 7, 8]], 2), {}) for r in replicas],
            timeout=600)
        devices = [get(r.handle.remote("stats", (), {}))["device"] for r in replicas]
        start_s = time.perf_counter() - t0
        log(f"[batch lane] (a) init(include_dashboard=True) at {url}, airwatch seed 0; "
            f"EngineDeployment(EngineConfig({LM_ENGINE}), dtype=\"bfloat16\"), 2 replicas of "
            f"num_chips={LANE_REPLICA_CHIPS}: devices {devices}; serve.run + load + warm-up "
            f"{start_s:.3f} s")
        if devices != [str(dev)] * 2:
            raise AssertionError(f"[batch lane] (a) replica devices {devices}")

        # (b) the batch lane, killed at a chunk commit, then resumed
        ds = tdata.from_items([{"prompt": p} for p in ps], parallelism=LANE_BLOCKS)
        jcfg = BatchJobConfig(route_prefix=route, max_new_tokens=LM_ENGINE["max_new_tokens"],
                              num_shards=LANE_SHARDS, chunk_rows=LANE_CHUNK_ROWS,
                              window=LANE_WINDOW)
        tracing.enable()
        t0 = time.perf_counter()
        faults.install(faults.FaultPlan(seed=0, specs=[
            faults.FaultSpec("batch.runner", "kill", at=LANE_KILL_AT)]))
        killed = BatchJob(ds, job_id="chip-batch", config=jcfg)
        try:
            killed.run()
            raise AssertionError("[batch lane] (b) the batch.runner kill raised nothing")
        except BatchJobKilled as e:
            kill_msg = str(e)
        finally:
            faults.clear()
        kill_s = time.perf_counter() - t0
        first = killed.stats()
        t0 = time.perf_counter()
        job = BatchJob(ds, job_id="chip-batch", config=jcfg)
        stats = job.run()
        resume_s = time.perf_counter() - t0
        tracing.disable()
        store = get_runtime().store
        occ = {}
        for s in range(LANE_SHARDS):
            c = 0
            while store.contains(job._chunk_id(s, c)):
                for gi in store.get(job._chunk_id(s, c))["rows"]:
                    occ[int(gi)] = occ.get(int(gi), 0) + 1
                c += 1
        results = job.results()
        bad = [gi for gi in range(len(ps)) if results.get(gi) != burst[gi]]
        spans = [sp for sp in tracing.recorder().recent(0) if sp.name.startswith("batch.")]
        roots = [sp for sp in spans if sp.name == "batch.job"
                 and sp.attrs.get("job_id") == "chip-batch" and sp.attrs.get("resumed") == 1]
        children = [sp for sp in spans if sp.name == "batch.chunk" and roots
                    and sp.parent_id == roots[-1].span_id]
        adm = route_control(route)["admission"].tenants.get("batch:chip-batch", {})
        tenants = merge_snapshots(replica_engine_stats()).get("tenants") or {}
        billed = tenants.get("batch:chip-batch", {})
        snaps = [get(r.handle.remote("stats", (), {})) for r in replicas]
        steps = [sn["step_latency_s"]["p50"] for sn in snaps]
        lane_launches = sum(sn["kernel_launches"]["decode_attention"] for sn in snaps)
        resumed_notes = w.events(kind="batch.resume")
        log(f"[batch lane] (b) BatchJob(job_id=\"chip-batch\", {LANE_SHARDS} shards, "
            f"{LANE_CHUNK_ROWS}-row chunks, window {LANE_WINDOW}, best_effort) over "
            f"{len(ps)} rows in {LANE_BLOCKS} blocks under FaultSpec(\"batch.runner\", \"kill\", "
            f"at={LANE_KILL_AT}): {kill_msg!r} after {kill_s:.3f} s with {first['rows_done']} "
            f"rows committed; the resumed job: {resume_s:.3f} s, rows processed "
            f"{stats['rows_processed']}, resumed {stats['rows_resumed']}, chunks resumed "
            f"{stats['chunks_resumed']}, {stats['rows_per_s']:.3f} rows/s "
            f"({len(ps) / (kill_s + resume_s):.3f} rows/s over both runs), shed retries "
            f"{first['shed_retries']} + {stats['shed_retries']}, submit retries "
            f"{first['submit_retries']} + {stats['submit_retries']}; rows in the committed "
            f"chunks {len(occ)}, each once {set(occ.values()) == {1}}; rows equal to phase "
            f"22's burst: {len(ps) - len(bad)} of {len(ps)}; tenant batch:chip-batch admitted "
            f"{adm.get('admitted')}, engine requests completed "
            f"{billed.get('requests_completed')}; span batch.job (resumed) with "
            f"{len(children)} batch.chunk children; airwatch batch.resume notes "
            f"{len(resumed_notes)}; decode launches in the replicas {lane_launches}, decode "
            f"step p50 {[round(x * 1e3, 3) for x in steps]} ms; card: {card_line()}")
        checks = {
            "exactly once": sorted(occ) == list(range(len(ps)))
            and set(occ.values()) == {1},
            "resumed": stats["state"] == "done" and stats["resumes"] == 1
            and stats["chunks_resumed"] >= 1
            and stats["rows_resumed"] == first["rows_done"]
            and 0 < first["rows_done"] < len(ps),
            "tokens": not bad,
            "billing": adm.get("admitted") == len(ps)
            and billed.get("requests_completed") == len(ps),
            "spans": len(roots) == 1 and len(children) == stats["chunks_done"] > 0,
            "airwatch": len(resumed_notes) == 1,
            "launches": lane_launches > 0,
        }
        if not all(checks.values()):
            raise AssertionError(f"[batch lane] (b) failed checks "
                                 f"{[k for k, ok in checks.items() if not ok]}; rows off "
                                 f"phase 22's burst {bad}")
        out.update({"job": stats, "killed": first, "kill_s": kill_s, "resume_s": resume_s,
                    "step_p50_s": steps, "job_launches": lane_launches})

        # (c) replica A returned through the lane's path, its streams migrate
        progress = {}
        streams = threading.Thread(target=lane_streams,
                                   args=(port, route, ps[:LANE_STREAMS], progress),
                                   daemon=True)
        streams.start()
        a, b = replicas
        deadline = time.time() + 300
        # the first of A's streams to reach LANE_RETURN_AFTER tokens: A's
        # other streams are decoding (shipped) or still prefilling or queued
        # (replayed from their prompts on B), none near its end
        while not (len(progress) == LANE_STREAMS
                   and any(len(t) >= LANE_RETURN_AFTER for pin, t in progress.values()
                           if pin == a._actor_id)):
            if time.time() > deadline or not streams.is_alive():
                raise AssertionError(f"[batch lane] (c) the streams stopped: "
                                     f"{[len(t) for _, t in progress.values()]}")
            time.sleep(0.005)
        seen = sorted(len(t) for pin, t in progress.values() if pin == a._actor_id)
        watcher = route_control(route)["watcher"]
        target = h.shrink_target()
        watcher.mark_borrowed(a._actor_id)
        returned = get(a.handle.remote("borrow_return", (LANE_NOTICE_S,), {}))
        a_launches = get(a.handle.remote("stats", (), {}))["kernel_launches"]
        streams.join(timeout=300)
        if streams.is_alive():
            raise AssertionError("[batch lane] (c) the streams did not finish")
        deadline = time.time() + 60
        while h.live_replicas() != 1 and time.time() < deadline:
            time.sleep(0.05)
        tokens = [progress[i][1] for i in range(LANE_STREAMS)]
        ws = watcher.stats()
        replays = route_control(route)["journal"].stats()
        snap_b = get(b.handle.remote("stats", (), {}))
        mg = snap_b.get("migrations") or {}
        page_bytes = (cfg.n_layers * 2 * LM_ENGINE["page_len"] * cfg.n_heads * cfg.head_dim
                      * torch.tensor([], dtype=torch.bfloat16).element_size())
        pages = ws["migrated_pages"]
        ms_page = ws["preemption_recovery_ms"] / pages if pages else float("nan")
        recovered = w.events(kind="preemption.recovered")
        on_a = len(seen)
        log(f"[batch lane] (c) {LANE_STREAMS} prompts as streams, {on_a} on replica A; once "
            f"one of A's showed {LANE_RETURN_AFTER} tokens to its client ({seen}): "
            f"shrink_target() -> {target}, "
            f"mark_borrowed(A), borrow_return({LANE_NOTICE_S}) -> {returned}; watcher "
            f"{ws}; journal {replays}; replicas live {h.live_replicas()}, left {[r._actor_id for r in h._replicas]}"
            f" (B {b._actor_id}); B's migrations {mg}; moved {pages} pages, "
            f"{pages * page_bytes} bytes ({page_bytes} a page over {cfg.n_layers} layers, k "
            f"and v), notice seen to A out of rotation {ws['preemption_recovery_ms']:.3f} ms, "
            f"{ms_page:.3f} ms a page through the arena (13.063 ms a page through the file "
            f"store in an earlier run, PERF.md §5); tokens equal to phase 22's burst "
            f"{tokens == burst[:LANE_STREAMS]}; A's launches just after its notice {a_launches}, "
            f"B's {snap_b['kernel_launches']}; airwatch preemption.recovered "
            f"{recovered[-1] if recovered else None}")
        checks = {
            "returned": returned is True and target == 1 and on_a >= 1,
            "tokens": tokens == burst[:LANE_STREAMS],
            "watcher": ws["borrow_returns"] == 1 and ws["preemptions"] == 1
            and ws["migrations"] >= 1 and ws["migration_fallbacks"] == 0
            and replays["replay_failures"] == 0,
            "no backfill": route_control(route)["autoscaler"] is None
            and [r._actor_id for r in h._replicas] == [b._actor_id],
            "no re-prefill": mg.get("in") == ws["migrations"]
            and mg.get("in_reprefill_chunks") == 0,
            "airwatch": bool(recovered) and recovered[-1].get("borrowed") is True,
        }
        if not all(checks.values()):
            raise AssertionError(f"[batch lane] (c) failed checks "
                                 f"{[k for k, ok in checks.items() if not ok]}")
        launches = a_launches["decode_attention"] + snap_b["kernel_launches"]["decode_attention"]
        if a_launches["flash_attention"] or snap_b["kernel_launches"]["flash_attention"]:
            raise AssertionError(f"[batch lane] flash launches in the replicas: {a_launches}, "
                                 f"{snap_b['kernel_launches']}")
        out.update({"migration": ws, "journal": replays, "pages": pages, "bytes": pages * page_bytes,
                    "ms_per_page": ms_page, "b_migrations": mg,
                    "launches": {"decode_attention": launches},
                    "launches_a_before_notice": a_launches,
                    "launches_b": snap_b["kernel_launches"]})

        # (d) the job on the dashboard and the serve plane's stats
        _, body = get_url(url + "/api/batch")
        api = json.loads(body)["jobs"].get("chip-batch", {})
        _, body = get_url(url + "/metrics")
        text = body.decode()
        fams = prometheus_families(text)
        sample = [ln for ln in text.splitlines()
                  if ln.startswith('tpu_air_batch_rows_done{job="chip-batch"}')]
        _, body = get_url(f"http://127.0.0.1:{port}/-/stats")
        section = json.loads(body).get("batch", {}).get("chip-batch", {})
        _, body = get_url(url + "/api/objects")
        objects = json.loads(body)
        _, body = get_url(url + "/api/cluster")
        gcs = json.loads(body)["gcs"]
        log(f"[batch lane] (d) /api/batch chip-batch rows_done {api.get('rows_done')} of "
            f"{api.get('rows_total')}, state {api.get('state')}; /metrics "
            f"{sorted(f for f in fams if f.startswith('tpu_air_batch_'))}, {sample}; /-/stats "
            f"batch chip-batch rows_done {section.get('rows_done')}; /api/objects arena "
            f"{objects.get('arena')}, file objects {objects.get('file_objects')}; /api/cluster "
            f"gcs {gcs}; /metrics arena families "
            f"{sorted(f for f in fams if f.startswith('tpu_air_arena_'))}")
        if not (api.get("rows_done") == api.get("rows_total") == len(ps)
                and sample and float(sample[0].rsplit(" ", 1)[1]) == len(ps)
                and section.get("rows_done") == len(ps)):
            raise AssertionError(f"[batch lane] (d) /api/batch {api}, /metrics {sample}, "
                                 f"/-/stats {section}")
        listed = [n for n in gcs["nodes"] if n["node_id"] == "host-0" and n["alive"]]
        if "arena" not in objects or "tpu_air_arena_live_objects" not in fams or (
                gcs_expected() and not listed):
            raise AssertionError(f"[batch lane] (d) /api/objects {objects}, /api/cluster gcs "
                                 f"{gcs}")
        out["native"] = check_native("batch lane", native_start, runtime_native("batch lane"))
    finally:
        faults.clear()
        tracing.disable()
        serve.shutdown()
        watch.clear()
        tpu_air_torch.shutdown()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[batch lane] phase {out['phase_s']:.1f} s (runtime start and stop included)")
    return out


# -- phase 26 ----------------------------------------------------------------------


def kv_payload(pages: int, seed: int, dev, form: str = "tensors"):
    """Phase 25's migration payload shape on ``dev``: ``pages`` K/V pages of
    the 136M LM in bf16 (0.5 MiB a page over its 8 layers), from a seeded
    generator on the card, so the same seed gives the same bits in any
    process.  ``tensors``: ``migrate_out``'s form, ``{layer path: {"k", "v":
    [pages, page_len, h*d]}}``; ``bytes``: the same pages as one flat uint8
    tensor (what the store carries out of band, read zero-copy)."""
    cfg = lm_config()
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (pages, LM_ENGINE["page_len"], cfg.n_heads * cfg.head_dim)
    payload = {f"layer_{i}/attn": {kv: torch.randn(shape, generator=g, device=dev,
                                                   dtype=torch.bfloat16)
                                   for kv in ("k", "v")}
               for i in range(cfg.n_layers)}
    if form == "tensors":
        return payload
    return torch.cat([t.reshape(-1) for d in payload.values() for t in d.values()]).view(
        torch.uint8)


class PagePutter:
    """Phase 26's actor on its leased card: makes a payload there from a
    seed, copies it to the host and puts it into the object store; the ms
    of the copy and of the put on its own clock."""

    def __init__(self):
        from tpu_air_torch.device import resolve_device

        self.dev = resolve_device(None)
        torch.zeros(1, device=self.dev)          # the CUDA context, before any timing

    def device(self) -> str:
        return str(self.dev)

    def put(self, pages: int, seed: int, form: str) -> dict:
        import tpu_air_torch

        payload = kv_payload(pages, seed, self.dev, form)
        torch.cuda.synchronize(self.dev)
        t0 = time.perf_counter()
        if form == "tensors":
            host = {p: {kv: t.cpu() for kv, t in d.items()} for p, d in payload.items()}
        else:
            host = payload.cpu().numpy()
        t1 = time.perf_counter()
        ref = tpu_air_torch.put(host)
        return {"ref": [ref], "copy_ms": (t1 - t0) * 1e3,
                "put_ms": (time.perf_counter() - t1) * 1e3}


def native_round_trips(dev, actor, where: str) -> dict:
    """``NATIVE_REPS`` round trips of each payload form and size: the actor
    puts, the driver gets, moves the value back to the card and checks it
    bitwise against the same seed's payload made there; then the value dies
    (its pins must be 0) and the object is deleted.  ``where`` is where the
    objects must lie: ``arena`` or ``files``.  Medians of the ms."""
    import gc
    import warnings

    from tpu_air_torch import get
    from tpu_air_torch.core.runtime import get_runtime

    store = get_runtime().store
    out = {}
    for form in ("tensors", "bytes"):
        for pages in NATIVE_PAGES:
            reps = []
            for r in range(NATIVE_REPS):
                seed = SEED + 60 + r
                res = get(actor.put.remote(pages, seed, form), timeout=600)
                oid = res["ref"][0].id
                in_arena = store._arena is not None and store._arena.contains(oid)
                as_file = os.path.exists(os.path.join(store.root, oid))
                t0 = time.perf_counter()
                val = get(res["ref"][0], timeout=600)
                t1 = time.perf_counter()
                if form == "tensors":
                    on_card = {p: {kv: t.to(dev) for kv, t in d.items()} for p, d in val.items()}
                else:
                    with warnings.catch_warnings():  # a read-only view of the store
                        warnings.simplefilter("ignore", UserWarning)
                        on_card = torch.from_numpy(val).to(dev)
                torch.cuda.synchronize(dev)
                t2 = time.perf_counter()
                want = kv_payload(pages, seed, dev, form)
                if form == "tensors":
                    equal = val.keys() == want.keys() and all(
                        torch.equal(on_card[p][kv].view(torch.int16),
                                    want[p][kv].view(torch.int16))
                        for p in want for kv in ("k", "v"))
                else:
                    equal = torch.equal(on_card, want)
                pins_alive = store._arena.pins(oid) if in_arena else None
                del val, on_card, want
                gc.collect()
                pins_dead = store._arena.pins(oid) if in_arena else None
                store.delete(oid)
                reps.append({"put_ms": res["copy_ms"] + res["put_ms"], "copy_ms": res["copy_ms"],
                             "get_ms": (t1 - t0) * 1e3, "to_card_ms": (t2 - t1) * 1e3,
                             "equal": equal, "in_arena": in_arena, "as_file": as_file,
                             "pins_alive": pins_alive, "pins_dead": pins_dead})
            med = {k: float(np.median([x[k] for x in reps]))
                   for k in ("put_ms", "copy_ms", "get_ms", "to_card_ms")}
            med["ms"] = med["put_ms"] + med["get_ms"] + med["to_card_ms"]
            med["ms_per_page"] = med["ms"] / pages
            placed = all(x["in_arena"] and not x["as_file"] if where == "arena"
                         else x["as_file"] and not x["in_arena"] for x in reps)
            pins = [(x["pins_alive"], x["pins_dead"]) for x in reps]
            log(f"[native] (b) through the {where}: {form}, {pages} page(s) "
                f"({pages * (1 << 19)} bytes), median of {NATIVE_REPS}: the actor's copy to the "
                f"host {med['copy_ms']:.3f} ms + put {med['put_ms'] - med['copy_ms']:.3f} ms, the "
                f"driver's get {med['get_ms']:.3f} ms, back to {dev} {med['to_card_ms']:.3f} ms: "
                f"{med['ms']:.3f} ms an object, {med['ms_per_page']:.3f} ms a page; bitwise equal "
                f"{all(x['equal'] for x in reps)}; in the {where} {placed}; pins (value alive, "
                f"dead) {pins if where == 'arena' else 'n/a'}")
            if not all(x["equal"] for x in reps) or not placed:
                raise AssertionError(f"[native] (b) {where}, {form}, {pages} pages: {reps}")
            if where == "arena" and any(dead != 0 for _, dead in pins):
                raise AssertionError(f"[native] (b) pins held after the values died: {pins}")
            if where == "arena" and form == "bytes" and any(alive != 1 for alive, _ in pins):
                raise AssertionError(f"[native] (b) a zero-copy value holds no pin: {pins}")
            out[f"{form}_{pages}"] = {**med, "pins": pins}
    return out


def native_path(dev) -> dict:
    """Phase 26 (a)-(c): the native object arena and the GCS daemon on the
    card's path, in runtimes of their own.  (a) the toolchain; (b) a leased
    actor on the card puts phase 25's payload shape (1 page and 135 pages,
    as ``migrate_out``'s tensors and as one zero-copy byte array) and the
    driver gets it back onto the card, bitwise equal: through the arena
    (the default runtime), then through the file store (a second runtime
    whose arena, ``TPU_AIR_ARENA_BYTES`` = ``NATIVE_SMALL_ARENA``, holds
    neither), the same ``put``/``get``; (c) with the GCS (where it builds):
    ``nodes()`` lists host-0 alive with the card, the leased actor is in
    the actor directory on card 0, marked dead after ``kill``, and the KV
    round-trips."""
    import tpu_air_torch
    from tpu_air_torch import get
    from tpu_air_torch.core.runtime import get_runtime

    t_phase = time.perf_counter()
    tools, missing = native_toolchain()
    log(f"[native] (a) toolchain: g++ {tools['g++']!r}, protoc {tools['protoc']!r}, protobuf "
        f"headers {tools['protobuf_headers']!r}, Python protobuf {tools['python_protobuf']!r}; "
        + ("the GCS daemon builds and runs here" if missing is None
           else f"gcs: not buildable here ({missing}), (c) not run"))
    out = {"toolchain": tools, "gcs_missing": missing}
    Putter = tpu_air_torch.remote(num_chips=1)(PagePutter)

    # (b) through the arena, and (c), in the default runtime
    tpu_air_torch.init()
    try:
        start = runtime_native("native")
        actor = Putter.remote()
        device = get(actor.device.remote(), timeout=600)
        if device != str(dev):
            raise AssertionError(f"[native] the leased actor is on {device}")
        out["arena"] = native_round_trips(dev, actor, "arena")
        end = runtime_native("native")
        a = end["arena"]
        log(f"[native] (b) the arena after the round trips, every payload deleted (the "
            f"actor's small replies stay): {a}")
        # no payload left (the least is half a MiB) and no block leaked
        if a["leaked_bytes"] != 0 or \
                a["sealed_bytes"] - start["arena"]["sealed_bytes"] >= NATIVE_PAGES[0] << 19:
            raise AssertionError(f"[native] (b) the arena kept or leaked blocks: "
                                 f"{start['arena']} -> {a}")
        out["arena_stats"] = a
        if missing is None:
            from tpu_air_torch.control import GcsClient

            rt = get_runtime()
            client = GcsClient(rt.gcs_address)
            try:
                nodes = tpu_air_torch.nodes()
                info = client.lookup_actor(actor._actor_id)
                tpu_air_torch.kill(actor)
                dead = client.lookup_actor(actor._actor_id)
                client.kv_put("chip_smoke/native", b"\x00card\xff")
                kv = client.kv_get("chip_smoke/native")
                client.kv_del("chip_smoke/native")
            finally:
                client.close()
            log(f"[native] (c) GCS {rt.gcs_address}: nodes {nodes}; the leased actor in the "
                f"directory {info}; after kill {dead}; KV round trip {kv!r}")
            host = [n for n in nodes if n["node_id"] == "host-0"]
            if not (host and host[0]["alive"] and host[0]["num_chips"] == 1
                    and info and info["chip_ids"] == [0] and info["node_id"] == "host-0"
                    and not info["dead"] and dead and dead["dead"] and kv == b"\x00card\xff"):
                raise AssertionError(f"[native] (c) nodes {nodes}, actor {info}, dead {dead}, "
                                     f"kv {kv!r}")
            out["gcs"] = {"address": rt.gcs_address, "nodes": nodes, "actor": info,
                          "after_kill": dead}
        else:
            tpu_air_torch.kill(actor)
    finally:
        tpu_air_torch.shutdown()

    # (b) through the file store: an arena too small for either size
    saved = os.environ.get("TPU_AIR_ARENA_BYTES")
    os.environ["TPU_AIR_ARENA_BYTES"] = str(NATIVE_SMALL_ARENA)
    try:
        tpu_air_torch.init()
        try:
            cap = get_runtime().store._arena.stats()["capacity"]
            actor = Putter.remote()
            out["files"] = native_round_trips(dev, actor, "files")
            tpu_air_torch.kill(actor)
        finally:
            tpu_air_torch.shutdown()
    finally:
        if saved is None:
            os.environ.pop("TPU_AIR_ARENA_BYTES", None)
        else:
            os.environ["TPU_AIR_ARENA_BYTES"] = saved
    big = f"tensors_{NATIVE_PAGES[-1]}"
    log(f"[native] (b) {NATIVE_PAGES[-1]} pages as tensors (phase 25's migration payload): "
        f"{out['arena'][big]['ms_per_page']:.3f} ms a page through the arena, "
        f"{out['files'][big]['ms_per_page']:.3f} through the file store (its arena "
        f"{cap} bytes); as bytes: {out['arena'][f'bytes_{NATIVE_PAGES[-1]}']['ms_per_page']:.3f} "
        f"and {out['files'][f'bytes_{NATIVE_PAGES[-1]}']['ms_per_page']:.3f}; card: "
        f"{card_line()}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[native] phase {out['phase_s']:.1f} s (two runtimes' start and stop included)")
    return out


def lm_live_parity(dev) -> dict:
    """Phase 23 (e): f32, full width, depth cut to 2, weights from numpy
    seed 0, TF32 off, through the decode kernel and through
    ``decode_attention_reference`` on the card: the mixed-tenant burst
    equals per-tenant ``offline_greedy``; a same-weights swap mid-burst and
    a migration equal the unswapped, unmigrated tokens; after v2 and a
    rollback a prompt gives the base tokens again; and the exact-fingerprint
    canary gate (``compute_probe`` without logits) passes on an in-process
    replica's ``weights_probe``."""
    from tpu_air_torch.engine import EngineConfig, InferenceEngine
    from tpu_air_torch.models.lm import CausalLM, modeling
    from tpu_air_torch.ops.decode_attention import decode_attention, decode_attention_reference
    from tpu_air_torch.serve import EngineDeployment, compute_probe
    from tpu_air_torch.serve.weights import offline_greedy, probe_fingerprint
    from tpu_air_torch.train import Checkpoint

    model = CausalLM(lm_config("float32", LM_SERVE_PARITY_LAYERS), device=dev).init_weights(SEED)
    cfg = model.config
    ps = lm_serve_prompts(LM_SERVE_PARITY_PROMPTS, cfg.vocab_size, SEED + 46)
    new = LM_SERVE_PARITY_NEW
    ecfg = {**LM_ENGINE, "max_new_tokens": new}
    tenants = lm_tenants(cfg)
    who = tenant_rows(len(ps), list(tenants))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    checks, launched = {}, {}
    saved = modeling.decode_attention
    for path in ("kernel", "plain"):
        modeling.decode_attention = saved if path == "kernel" else decode_attention_reference
        try:
            decode_attention.launches = 0
            want = [offline_greedy(model, p, new, *(tenants[t] if t else (None, None)))
                    for p, t in zip(ps, who)]
            base = [offline_greedy(model, p, new) for p in ps]
            engine = InferenceEngine(model, EngineConfig(**ecfg, adapter_slots=4,
                                                         adapter_rank=LM_LIVE_RANK),
                                     auto_start=False, name=f"lm-live-parity-{path}")
            for name, (a, b) in tenants.items():
                engine.load_adapter(name, a, b)
            streams = [engine.submit(p, adapter_id=t) for p, t in zip(ps, who)]
            drain(engine)
            engine.close()
            checks[f"{path} adapters"] = [s.result(0) for s in streams] == want
            engine = InferenceEngine(model, EngineConfig(**ecfg), auto_start=False,
                                     name=f"lm-live-parity-swap-{path}")
            streams = [engine.submit(p) for p in ps]
            for _ in range(LM_LIVE_SWAP_AT):
                engine.step()
            engine.swap_params(state, version=1)
            drain(engine)
            checks[f"{path} swap"] = [s.result(0) for s in streams] == base
            engine.swap_params(lm_v2(state))
            under_v2 = engine.generate([ps[1]])[0]
            engine.rollback_params()
            checks[f"{path} rollback"] = (under_v2 != base[1]
                                          and engine.generate([ps[1]])[0] == base[1])
            engine.close()
            mig = migrate_mid_burst(
                InferenceEngine(model, EngineConfig(**{**ecfg, "prefill_chunks_per_step": 1 << 10}),
                                auto_start=False, name=f"lm-live-parity-a-{path}"),
                InferenceEngine(model, EngineConfig(**ecfg), auto_start=False,
                                name=f"lm-live-parity-b-{path}"),
                ps, min(LM_LIVE_MIGRATE_AFTER, new // 2))
            checks[f"{path} migration"] = (mig["tokens"] == base
                                           and mig["migrations"]["in_reprefill_chunks"] == 0)
            server = EngineDeployment.func_or_class(Checkpoint.from_dict({"model": model}),
                                                    EngineConfig(**ecfg))
            try:
                got = server.weights_probe(ps[:LM_LIVE_PROBES], LM_LIVE_PROBE_NEW)
            finally:
                server.close()
            pinned = compute_probe(model, ps[:LM_LIVE_PROBES], LM_LIVE_PROBE_NEW)
            checks[f"{path} fingerprint gate"] = probe_fingerprint(got) == pinned["fingerprint"]
            launched[path] = decode_attention.launches
        finally:
            modeling.decode_attention = saved
    log(f"[lm live] (e) f32, {LM_SERVE_PARITY_LAYERS} layers at full width, {len(ps)} prompts "
        f"-> {new} tokens, through the kernel ({launched['kernel']} launches) and the plain "
        f"version ({launched['plain']}): {checks}")
    if launched["plain"] or not launched["kernel"]:
        raise AssertionError(f"[lm live] (e) launches {launched}")
    if not all(checks.values()):
        raise AssertionError(f"[lm live] (e) {checks}")
    del model
    torch.cuda.empty_cache()
    return {"checks": checks, "kernel_launches": launched["kernel"]}


# -- phase 27 ----------------------------------------------------------------------

# ring dials: the [lm] phase's attention (B 1, H 8, D 128, L 8192) split over sp
# ranks held in this process; (d) LMTrainer with Adafactor, sp 1, 3 one-step epochs
RING_SPS, RING_DTYPES, RING_ADAFACTOR_STEPS = (2, 4), (torch.bfloat16, torch.float32), 3
FLASH_KERNELS = ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def zero_flash_counts() -> None:
    from tpu_air_torch.ops.flash_attention import flash_attention, flash_attention_backward

    flash_attention.launches = 0
    flash_attention_backward.dq_launches = 0
    flash_attention_backward.dkv_launches = 0


def ring_inputs(rng, dtype, dev):
    """q, k, v, do of the LM's attention, (1, H, L, D) views of [1, L, H, D]
    tensors as the model lays them out."""
    cfg = lm_config()

    def t():
        x = rng.standard_normal((1, LM_LEN, cfg.n_heads, cfg.head_dim), dtype=np.float32)
        return torch.from_numpy(x).to(dev, dtype).transpose(1, 2)

    return t(), t(), t(), t()


def ring_run(q, k, v, do, sp: int, causal: bool):
    """The in-memory ring over sp ranks, forward then backward of ``do``:
    (out, dq, dk, dv) put together in rank order, and the flash kernels'
    launches over the two."""
    from tpu_air_torch.ops.ring_attention import ring_attention_in_memory

    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    shards = [list(x.chunk(sp, dim=2)) for x in leaves]
    if any(s.shape[2] != LM_LEN // sp for s in shards[0]):
        raise AssertionError(f"[ring] shards of {[s.shape for s in shards[0]]}")
    zero_flash_counts()
    outs = ring_attention_in_memory(*shards, causal=causal)
    torch.autograd.backward(outs, list(do.chunk(sp, dim=2)))
    torch.cuda.synchronize()
    counts = {n: kernel_counts()[n] for n in FLASH_KERNELS}
    return (torch.cat([o.detach() for o in outs], dim=2), *(x.grad for x in leaves)), counts


def ring_compare(dev) -> dict:
    """27 (a) and (b): the ring against one whole-sequence call of the kernels
    and against the plain versions, and its launches against its live hops."""
    from tpu_air_torch.ops.flash_attention import (flash_attention_backward,
                                                   flash_attention_backward_reference,
                                                   flash_attention_reference,
                                                   flash_attention_with_lse)
    from tpu_air_torch.ops.ring_attention import live_hops

    cfg = lm_config()
    h, d, L = cfg.n_heads, cfg.head_dim, LM_LEN
    scale = d ** -0.5
    rng = np.random.default_rng(SEED + 50)
    launches = dict.fromkeys(FLASH_KERNELS, 0)
    errs = {}
    for dtype in RING_DTYPES:
        tag = TAG[dtype]
        q, k, v, do = ring_inputs(rng, dtype, dev)

        def flat(x):
            return x.reshape(h, L, d)

        for causal in (True, False):
            with torch.no_grad():
                out_w, lse_w = flash_attention_with_lse(q, k, v, causal=causal)
            whole = (out_w, *flash_attention_backward(q, k, v, None, out_w, lse_w, do, None,
                                                      scale, causal))
            out_p, lse_p = flash_attention_reference(flat(q), flat(k), flat(v), None, None,
                                                     scale, causal)
            plain = (out_p, *flash_attention_backward_reference(
                flat(q), flat(k), flat(v), None, out_p, lse_p, flat(do), None, scale, causal))
            del out_w, lse_w, out_p, lse_p
            for sp in RING_SPS:
                name = f"{tag} sp{sp} {'causal' if causal else 'non-causal'}"
                got, counts = ring_run(q, k, v, do, sp, causal)
                live = live_hops(sp, causal)
                log(f"[ring] {name}: launches {counts} (live hops {live}; "
                    f"{sp * sp - live} masked)")
                if any(n != live for n in counts.values()):
                    raise AssertionError(f"[ring] {name}: launches {counts} != {live} live hops")
                for n in FLASH_KERNELS:
                    launches[n] += counts[n]
                row = {}
                for t_name, g, w_k, w_p in zip(("out", "dq", "dk", "dv"), got, whole, plain):
                    g = flat(g)
                    if not torch.isfinite(g.float()).all():
                        raise AssertionError(f"[ring] {name} {t_name}: non-finite")
                    for ref_name, w in (("kernels", flat(w_k)), ("plain", w_p)):
                        rel, sc = norm_err(g, w), scaled_err(g, w)
                        row[f"{t_name} vs {ref_name}"] = {"max_abs_err": max_err(g, w),
                                                          "scaled": sc, "norm": rel}
                        if not (rel < NORM_TOL[dtype] and sc < TOL[dtype]):
                            raise AssertionError(
                                f"[ring] {name} {t_name} against the whole-sequence "
                                f"{ref_name}: ||err|| / ||ref|| {rel:.2e} (tol "
                                f"{NORM_TOL[dtype]:.0e}), scaled max err {sc:.2e} (tol "
                                f"{TOL[dtype]:.0e})")
                log(f"[ring] {name}: " + "; ".join(
                    f"{k} max abs {e['max_abs_err']:.2e} norm {e['norm']:.2e}"
                    for k, e in row.items()) + f" (tol norm {NORM_TOL[dtype]:.0e}, "
                    f"scaled {TOL[dtype]:.0e})")
                errs[name] = row
                del got
            del whole, plain
            torch.cuda.empty_cache()
        del q, k, v, do
    return {"launches": launches, "errors": errs}


def ring_timing(dev) -> dict:
    """27 (c), bf16: each hop type alone at L/sp (the diagonal causal, the
    visible hop non-causal) through the forward, dq and dk/dv kernels beside
    their bounds, their plain versions and SDPA; then the whole causal ring,
    forward and forward + backward, beside the whole-sequence kernels."""
    from tpu_air_torch.ops.flash_attention import (flash_attention_backward,
                                                   flash_attention_reference,
                                                   flash_attention_with_lse)
    from tpu_air_torch.ops.ring_attention import ring_attention_in_memory

    cfg = lm_config()
    h, d, L = cfg.n_heads, cfg.head_dim, LM_LEN
    scale = d ** -0.5
    q, k, v, do = ring_inputs(np.random.default_rng(SEED + 51), torch.bfloat16, dev)
    hops = []
    for sp in RING_SPS:
        n = L // sp
        qh, kh, vh, doh = (x[:, :, :n] for x in (q, k, v, do))
        elt, lse_bytes = h * n * d * 2, h * n * 4
        for kind, causal in (("diagonal", True), ("visible", False)):
            pairs = h * (n * (n + 1) // 2 if causal else n * n)
            with torch.no_grad():
                out_h, lse_h = flash_attention_with_lse(qh, kh, vh, causal=causal)
            calls = bwd_kernel_calls(qh, kh, vh, doh, out_h, lse_h, scale, causal)
            kernel_ms = {
                "flash_attention": device_ms(
                    lambda: flash_attention_with_lse(qh, kh, vh, causal=causal), 10),
                **{name: device_ms(call, 10) for name, call in calls.items()}}
            flat = [x.reshape(h, n, d) for x in (qh, kh, vh)]
            plain_fwd = time_ms(lambda: flash_attention_reference(*flat, None, None, scale,
                                                                  causal), 2, 1)
            plain_bwd = time_ms(lambda: backward_plain(qh, kh, vh, None, out_h, lse_h, doh,
                                                       None, scale, causal), 2, 1)
            leaves = [x.detach().requires_grad_() for x in (qh, kh, vh)]
            sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal, scale=scale)
            # queued behind the sleep kernel as the kernels are: at these
            # shapes one call's host dispatch outlasts its device time
            sdpa_fwd = device_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=causal, scale=scale), 10)
            sdpa_bwd = device_ms(lambda: torch.autograd.grad(sdpa_out, leaves, doh,
                                                             retain_graph=True), 10)
            # forward: reads q, k, v, writes out and lse; 2 products of 2*d
            # flops a live pair.  dq: reads q, k, v, do, lse, delta, writes dq;
            # 3 products.  dk/dv: the same inputs, writes dk and dv; 4 products.
            for name, nbytes, flops, plain_ms, lib_ms in (
                    ("flash_attention", 4 * elt + lse_bytes, 4 * d * pairs, plain_fwd, sdpa_fwd),
                    ("flash_attention_bwd_dq", 5 * elt + 2 * lse_bytes, 6 * d * pairs,
                     plain_bwd, sdpa_bwd),
                    ("flash_attention_bwd_dkv", 6 * elt + 2 * lse_bytes, 8 * d * pairs,
                     plain_bwd, sdpa_bwd)):
                b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16_FLOP_S)
                hops.append({"name": name, "sp": sp, "hop": kind,
                             "shape": f"B1 H{h} L{n} D{d} {'causal' if causal else 'non-causal'} bf16",
                             "ms": kernel_ms[name], "bound_ms": b_ms, "bound_by": b_by,
                             "plain_ms": plain_ms, "library_ms": lib_ms, "bytes": nbytes,
                             "flops": flops})
                log(f"[ring timing] sp{sp} {kind} hop, {name} at L/sp = {n}: kernel "
                    f"{kernel_ms[name]:.4f} ms (device_ms), bound {b_ms:.4f} ms by {b_by}, "
                    f"plain {plain_ms:.3f} ms, SDPA {'forward' if name == 'flash_attention' else 'backward'} "
                    f"{lib_ms:.4f} ms")
            del out_h, lse_h, calls, leaves, sdpa_out
    torch.cuda.empty_cache()
    whole = {}
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def whole_fwd():
        with torch.no_grad():
            return flash_attention_with_lse(q, k, v, causal=True)

    def whole_fwd_bwd():
        out, lse = whole_fwd()
        return flash_attention_backward(q, k, v, None, out, lse, do, None, scale, True)

    whole["whole-sequence kernels"] = (time_ms(whole_fwd, 3, 1), time_ms(whole_fwd_bwd, 3, 1))
    for sp in RING_SPS:
        shards = [list(x.chunk(sp, dim=2)) for x in leaves]
        dos = list(do.chunk(sp, dim=2))

        def ring_fwd():
            with torch.no_grad():
                return ring_attention_in_memory(*shards, causal=True)

        def ring_fwd_bwd():
            torch.autograd.backward(ring_attention_in_memory(*shards, causal=True), dos)

        whole[f"ring sp{sp}"] = (time_ms(ring_fwd, 3, 1), time_ms(ring_fwd_bwd, 3, 1))
    for name, (f_ms, fb_ms) in whole.items():
        log(f"[ring timing] causal L{L}, {name}: forward {f_ms:.3f} ms, forward + backward "
            f"{fb_ms:.3f} ms (CUDA events over back-to-back calls, host included)")
    del q, k, v, do, leaves
    torch.cuda.empty_cache()
    return {"hops": hops, "whole_ms": {k: {"forward": f, "forward_backward": fb}
                                       for k, (f, fb) in whole.items()}}


def ring_adafactor(dev, storage: str) -> dict:
    """27 (d): ``LMTrainer.fit()`` with ``optimizer="adafactor"`` at the 136M
    width, sp 1, 3 one-step epochs of 8192 tokens, through the kernels."""
    import pandas as pd

    from tpu_air_torch.train import LMTrainer, RunConfig, TrainingArguments

    cfg = lm_config()
    steps = RING_ADAFACTOR_STEPS
    rows = pd.DataFrame({"input_ids": list(lm_rows(1, LM_LEN, SEED + 52))})
    args = TrainingArguments(learning_rate=1e-2, per_device_train_batch_size=1,
                             num_train_epochs=steps, seed=SEED, optimizer="adafactor",
                             evaluation_strategy="no", save_strategy="no")
    trainer = probed(LMTrainer(model_config=cfg, training_args=args, datasets={"train": rows},
                               run_config=RunConfig(storage_path=storage), device=dev))
    result = trainer.fit()
    if result.error is not None:
        raise AssertionError(f"[ring] (d) Adafactor fit failed: {result.error}")
    probe, = read_probes(result.path)           # counted in the fit's trial actor
    counts = {n: probe["launches"][n] for n in FLASH_KERNELS}
    hist = result.metrics_history
    losses = [m["loss"] for m in hist]
    step_ms = [LM_LEN / m["train_tokens_per_sec"] * 1e3 for m in hist]
    log(f"[ring] (d) LMTrainer.fit, optimizer='adafactor', {cfg.d_model} wide, "
        f"{cfg.n_layers} layers, bf16, L={LM_LEN}, sp 1: losses "
        + ", ".join(f"{x:.4f}" for x in losses) + "; step ms (first is the warm-up) "
        + ", ".join(f"{x:.1f}" for x in step_ms) + f"; launches {counts}")
    if len(hist) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"[ring] (d) {hist}")
    if any(n != cfg.n_layers * steps for n in counts.values()):
        raise AssertionError(f"[ring] (d) launches {counts}, expected {cfg.n_layers} a step")
    return {"losses": losses, "step_ms": step_ms, "launches": counts}


def ring_refusal(dev, storage: str) -> dict:
    """27 (e): ``sequence_parallel=2`` in a runtime of the card's one slot
    raises before any rank starts (its 2 ranks need a lease of 2 slots);
    nothing runs on the CPU instead."""
    import pandas as pd

    from tpu_air_torch.train import LMTrainer, RunConfig, ScalingConfig, TrainingArguments

    rows = pd.DataFrame({"input_ids": list(lm_rows(1, LM_LEN, SEED + 53))})
    trainer = LMTrainer(model_config=lm_config(), datasets={"train": rows},
                        training_args=TrainingArguments(num_train_epochs=1),
                        scaling_config=ScalingConfig(num_workers=1, sequence_parallel=2),
                        run_config=RunConfig(storage_path=storage))
    zero_flash_counts()
    t0 = time.perf_counter()
    try:
        result = trainer.fit()
    except ValueError as e:
        msg = str(e)
    else:
        raise AssertionError(f"[ring] (e) sp=2 on {torch.cuda.device_count()} card(s) ran: "
                             f"{result.metrics}, error {result.error}")
    counts = {n: kernel_counts()[n] for n in FLASH_KERNELS}
    want = f"needs 2 cards (chip slots of the runtime, wrapped onto its cards); the runtime " \
           f"has {torch.cuda.device_count()}"
    log(f"[ring] (e) LMTrainer(ScalingConfig(num_workers=1, sequence_parallel=2)).fit() on "
        f"the card: ValueError in {time.perf_counter() - t0:.2f} s: {msg}")
    if want not in msg or any(counts.values()):
        raise AssertionError(f"[ring] (e) {msg!r} (want {want!r}); launches {counts}")
    return {"error": msg}


def ring_path(dev, work: str) -> dict:
    """Phase 27."""
    t0 = time.perf_counter()
    stats = ring_compare(dev)
    stats["timing"] = ring_timing(dev)
    stats["adafactor"] = ring_adafactor(dev, os.path.join(work, "ring_adafactor"))
    stats["refusal"] = ring_refusal(dev, os.path.join(work, "ring_refusal"))
    stats["wall_s"] = time.perf_counter() - t0
    log(f"[ring] phase 27 in {stats['wall_s']:.1f} s")
    return stats


def add_ring_rows(kernels: list, ring: dict) -> None:
    """Phase 27's launches (the ring's (a) runs and (d)'s fit) and hop times
    into the flash kernels' rows."""
    for r in kernels:
        if r["name"] not in FLASH_KERNELS:
            continue
        for where, n in (("ring", ring["launches"][r["name"]]),
                         ("lm_adafactor", ring["adafactor"]["launches"][r["name"]])):
            r["launches_by_path"][where] = n
            r["launches"] += n
        r["ring_hops"] = [h for h in ring["timing"]["hops"] if h["name"] == r["name"]]


def token_agreement(got: list, want: list) -> tuple:
    """(prompts whose tokens are equal, the first differing position of each
    other prompt)."""
    same = sum(a == b for a, b in zip(got, want))
    first = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
             for a, b in zip(got, want) if a != b]
    return same, first


def manual_burst(engine, prompts_: list) -> dict:
    """Every prompt submitted at once to a manual-step engine, then steps
    until it is idle: tokens, steps, decode steps, wall and the engine's
    step p50.  The engine is closed after."""
    try:
        streams = [engine.submit(p) for p in prompts_]
        t0 = time.perf_counter()
        steps = 0
        while not engine.idle():
            engine.step()
            steps += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        snap = engine.metrics.snapshot()
        return {"tokens": [s.result(0) for s in streams], "steps": steps, "wall_s": wall,
                "decode_steps": snap["step_latency_s"]["count"],
                "step_p50_ms": snap["step_latency_s"]["p50"] * 1e3}
    finally:
        engine.close()


def capture_first_decode(engine) -> dict:
    """Wrap an engine's decode step: at its first call, record the f32
    logits of the rows decoding by their prompts, computed from the same
    cache as the step (which then writes the same K/V again): through
    ``paged_decode_logits`` on a MeshEngine, through the model as the
    single-card paged step runs it otherwise.  The capture's own kernel
    launches are not counted."""
    from tpu_air_torch.engine import MeshEngine
    from tpu_air_torch.engine.dist.sharded import paged_decode_logits
    from tpu_air_torch.models.lm import head_weight
    from tpu_air_torch.ops.decode_attention import decode_attention

    seen = {}
    step = engine._decode_step

    def logits_of(cache, tok, pos, table):
        if isinstance(engine, MeshEngine):
            return paged_decode_logits(engine.sharded, cache, tok, pos, table)
        with torch.inference_mode():
            for c in cache:
                c.cache_index, c.block_table = pos, table
            h = engine.model(tok[:, None], pos[:, None], return_hidden=True, decode=True,
                             cache=cache)
            return h[:, -1].float() @ head_weight(engine.model).float()

    def wrapped(cache, tok, pos, table, *banks):
        if not seen:
            before = decode_attention.launches
            logits = logits_of(cache, tok, pos, table).cpu()
            decode_attention.launches = before
            for s in engine.slots.active_slots():
                if not s.prefilling:
                    seen[tuple(s.request.prompt)] = (s.request.stream.tokens_so_far()[0],
                                                     logits[s.index])
        return step(cache, tok, pos, table, *banks)

    engine._decode_step = wrapped
    return seen


def first_decode_logits(engine, prompts_: list) -> dict:
    """An engine's first decode step over a burst of ``prompts_``, every one
    prefilled in the step before (:func:`capture_first_decode`; the engine
    takes all its chunks in one step); the engine is closed once it has
    stepped."""
    seen = capture_first_decode(engine)
    try:
        for p in prompts_:
            engine.submit(p)
        while not seen:
            engine.step()
    finally:
        engine.close()
    if len(seen) != len(prompts_):
        raise AssertionError(f"[dist] {len(seen)} of {len(prompts_)} rows at the first step")
    return seen


def logits_err(got: dict, want: dict) -> float:
    """The largest scaled error of one engine's first-step logits against
    another's, over the prompts whose first token the two agree on (a row
    whose first token differs decodes another input)."""
    errs = [scaled_err(got[p][1], want[p][1]) for p in want if got[p][0] == want[p][0]]
    if len(errs) * 2 < len(want):
        raise AssertionError(f"[dist] first tokens agree on {len(errs)} of {len(want)} rows")
    return max(errs)


def dist_meshes(dev, model, ps: list, burst: list, ckpt) -> dict:
    """Phase 28 (a): ``MeshEngine`` with every shard on the one card (see
    the module docstring)."""
    from tpu_air_torch.engine import EngineConfig, InferenceEngine, MeshEngine
    from tpu_air_torch.engine.dist import sharded
    from tpu_air_torch.models.lm import CausalLM
    from tpu_air_torch.ops.decode_attention import decode_attention, decode_attention_reference

    cfg = model.config
    out = {"bf16": {}, "f32": {}, "f32_first_step_err": {}, "launches": 0}
    mesh_ps = ps[:DIST_MESH_PROMPTS]
    decode_attention.launches = 0
    yard8 = manual_burst(InferenceEngine(model, EngineConfig(**{**DIST_ENGINE, "num_slots": 8}),
                                         auto_start=False, name="dist-single-8"), mesh_ps)
    yard_launches = decode_attention.launches
    if yard_launches != cfg.n_layers * yard8["decode_steps"]:
        raise AssertionError(f"[dist] (a) single-card 8-slot launches {yard_launches}")
    same8, first8 = token_agreement(yard8["tokens"], burst[:len(mesh_ps)])
    log(f"[dist] (a) single-card paged engine at 8 slots (a dp 2 replica's rows), the first "
        f"{len(mesh_ps)} prompts: {yard8['wall_s']:.3f} s over {yard8['steps']} steps; prompts "
        f"equal to phase 22 (b)'s 16-slot burst {same8}/{len(mesh_ps)}, first differing "
        f"positions {first8}")
    out["single_8_slots"] = {k: v for k, v in yard8.items() if k != "tokens"}
    # the first decode step over DIST_FIRST prompts: the single-card engine
    # at 16 slots in bf16 (the yardstick) and at 8 slots (how far the batch
    # shape alone moves bf16), and the same weights in f32 at full depth
    first_cfg = {**LM_ENGINE, "prefill_chunks_per_step": 1 << 10}
    first_ps = ps[:DIST_FIRST]
    single_first = first_decode_logits(
        InferenceEngine(model, EngineConfig(**first_cfg), auto_start=False), first_ps)
    noise = logits_err(first_decode_logits(
        InferenceEngine(model, EngineConfig(**{**first_cfg, "num_slots": 8}), auto_start=False),
        first_ps), single_first)
    full32 = ckpt.get_model(dtype="float32")
    f32_first = first_decode_logits(
        InferenceEngine(full32, EngineConfig(**first_cfg), auto_start=False), first_ps)
    del full32
    torch.cuda.empty_cache()
    single_vs_f32 = logits_err(single_first, f32_first)
    out["first_step"] = {"shape_noise": noise, "single_bf16_vs_f32": single_vs_f32}
    log(f"[dist] (a) the single-card engine's first decode step over {len(first_ps)} prompts, "
        f"f32 logits: at 8 slots against 16, scaled {noise:.3e} apart (what the batch shape "
        f"alone moves in bf16); bf16 against the same weights in f32, {single_vs_f32:.3e}")
    for dp, tp in DIST_BF16_MESHES:
        engine = MeshEngine(model, EngineConfig(**DIST_ENGINE), dp=dp, tp=tp,
                            devices=[dev] * (dp * tp), auto_start=False, name=f"dist-{dp}x{tp}")
        admits = [0] * dp
        admit = engine.pool.admit

        def counting_admit(slot, *a, _admit=admit, _pool=engine.pool, **kw):
            admits[_pool.replica_of(slot)] += 1
            return _admit(slot, *a, **kw)

        engine.pool.admit = counting_admit
        n_attn = engine.sharded.n_attn
        decode_attention.launches = 0
        run = manual_burst(engine, mesh_ps)
        launches = decode_attention.launches
        want_launches = cfg.n_layers * n_attn * dp * run["decode_steps"]
        same, firsts = token_agreement(run["tokens"], burst[:len(mesh_ps)])
        rec = {k: v for k, v in run.items() if k != "tokens"}
        rec.update(admits_per_replica=admits, launches=launches, equal_to_22b=same,
                   first_differing=firsts, heads_per_shard=cfg.n_heads // n_attn)
        log(f"[dist] (a) MeshEngine dp {dp} x tp {tp} on {dev} ({dp * tp} shards, "
            f"{cfg.n_heads // n_attn} heads of {cfg.head_dim} a shard), bf16, {len(mesh_ps)} "
            f"prompts as a burst: {run['wall_s']:.3f} s over {run['steps']} steps, step p50 "
            f"{run['step_p50_ms']:.3f} ms; admissions per replica {admits}; decode launches "
            f"{launches} ({cfg.n_layers} layers x {n_attn} shards x {dp} replicas x "
            f"{run['decode_steps']} steps); prompts equal to phase 22 (b)'s burst "
            f"{same}/{len(mesh_ps)}, first differing positions {firsts}")
        if launches != want_launches or not launches:
            raise AssertionError(f"[dist] (a) {dp}x{tp} decode launches {launches}, "
                                 f"expect {want_launches}")
        if dp > 1 and sum(a > 0 for a in admits) != dp:
            raise AssertionError(f"[dist] (a) {dp}x{tp} admissions per replica {admits}")
        if tp == 1 and run["tokens"] != yard8["tokens"]:
            raise AssertionError(f"[dist] (a) dp {dp} tokens differ from the single-card "
                                 f"engine at the replica's 8 slots: "
                                 f"{token_agreement(run['tokens'], yard8['tokens'])}")
        if tp > 1:
            first = first_decode_logits(MeshEngine(model, EngineConfig(**first_cfg), dp=dp, tp=tp,
                                                   devices=[dev] * (dp * tp), auto_start=False),
                                        first_ps)
            err, err32 = logits_err(first, single_first), logits_err(first, f32_first)
            rec.update(first_step_vs_single=err, first_step_vs_f32=err32)
            # the mesh's bf16 rounds other products than the single card's:
            # it is held to be as close to the f32 model as the single
            # card's bf16 is, within a factor of two
            bound = 2 * single_vs_f32
            log(f"[dist] (a) {dp}x{tp} first decode step over the {len(first_ps)} prompts, f32 "
                f"logits: against the single-card bf16 engine's, scaled {err:.3e} (the scaled "
                f"{TOL[torch.bfloat16]} of one kernel's rounding: {err < TOL[torch.bfloat16]}); "
                f"against the f32 model's, {err32:.3e} (bound {bound:.3e}, twice the single "
                f"card's {single_vs_f32:.3e})")
            if not err32 <= bound:
                raise AssertionError(f"[dist] (a) {dp}x{tp} first-step logits {err32} from f32, "
                                     f"bound {bound}")
        out["bf16"][f"{dp}x{tp}"] = rec
        out["launches"] += launches
        if (dp, tp) == (2, 2):
            out["tokens_2x2"] = run["tokens"]
    # f32, depth cut: the kernel and its plain version in the shards
    m32 = CausalLM(lm_config("float32", LM_SERVE_PARITY_LAYERS), device=dev).init_weights(SEED)
    ps32 = lm_serve_prompts(LM_SERVE_PARITY_PROMPTS, cfg.vocab_size, SEED + 43)
    e32 = {**DIST_ENGINE, "max_new_tokens": LM_SERVE_PARITY_NEW}
    ref = manual_burst(InferenceEngine(m32, EngineConfig(**e32), auto_start=False), ps32)["tokens"]
    first32 = first_decode_logits(InferenceEngine(m32, EngineConfig(**first_cfg),
                                                  auto_start=False), ps32)
    saved = sharded.decode_attention
    launched = {}
    for path in ("kernel", "plain"):
        sharded.decode_attention = saved if path == "kernel" else decode_attention_reference
        try:
            decode_attention.launches = 0
            for dp, tp in DIST_F32_MESHES:
                got = manual_burst(MeshEngine(m32, EngineConfig(**e32), dp=dp, tp=tp,
                                              devices=[dev] * (dp * tp), auto_start=False),
                                   ps32)["tokens"]
                out["f32"][f"{path} {dp}x{tp}"] = got == ref
                if path == "kernel":
                    out["f32_first_step_err"][f"{dp}x{tp}"] = logits_err(first_decode_logits(
                        MeshEngine(m32, EngineConfig(**first_cfg), dp=dp, tp=tp,
                                   devices=[dev] * (dp * tp), auto_start=False), ps32), first32)
            launched[path] = decode_attention.launches
        finally:
            sharded.decode_attention = saved
    out["launches"] += launched["kernel"]
    log(f"[dist] (a) f32, {LM_SERVE_PARITY_LAYERS} layers at full width, {len(ps32)} prompts -> "
        f"{LM_SERVE_PARITY_NEW} tokens, MeshEngine {DIST_F32_MESHES} through the kernel "
        f"({launched['kernel']} launches) and the plain version ({launched['plain']}): equal to "
        f"the single-card engine's streams: {out['f32']}; first decode step's logits against "
        f"the single-card engine's, scaled {out['f32_first_step_err']} (tolerance "
        f"{TOL[torch.float32]})")
    if launched["plain"] or not launched["kernel"] or not all(out["f32"].values()) or \
            not max(out["f32_first_step_err"].values()) < TOL[torch.float32]:
        raise AssertionError(f"[dist] (a) f32: {out['f32']}, launches {launched}")
    del m32
    torch.cuda.empty_cache()
    return out


def dist_router(dev, ckpt, ps: list, burst: list, ttft_22b: list) -> dict:
    """Phase 28 (b): ``DisaggRouter`` with 2 ``PrefillWorker`` replicas on
    the card, in the runtime ``dist_path`` started (see the module
    docstring)."""
    from tpu_air_torch.engine import DisaggRouter, EngineConfig
    from tpu_air_torch.faults import plan as faults
    from tpu_air_torch.observability import tracing
    from tpu_air_torch.ops.decode_attention import decode_attention

    out = {}
    n_layers = ckpt.get_model_config().n_layers
    router = DisaggRouter(ckpt, EngineConfig(**LM_ENGINE), prefill_replicas=2,
                          dtype="bfloat16", name="chip-disagg")
    try:
        t0 = time.perf_counter()
        warm = [router.submit(p[:64], 2) for p in ps[:2]]     # one a worker: each builds
        [s.result(600) for s in warm]
        start_s = time.perf_counter() - t0
        st0 = router.stats()
        devices = [w.get("device") for w in st0["workers"]]
        log(f"[dist] (b) DisaggRouter(EngineConfig({LM_ENGINE}), prefill_replicas=2, "
            f"dtype=\"bfloat16\"): 2 PrefillWorker actors and the decode engine in this "
            f"process; workers' devices {devices}; start + 2 warm-up requests {start_s:.3f} s")
        if not all(str(d).startswith("cuda") for d in devices):
            raise AssertionError(f"[dist] (b) prefill workers on {devices}")
        h0 = (router.handoffs, router.reroutes, router.fallbacks)
        tracing.recorder().clear()
        decode_attention.launches = 0
        n = len(ps)
        streams, roots, t_sub, ttft = [], [], [], [None] * n
        t0 = time.perf_counter()
        for p in ps:
            with tracing.span("client.request") as root:
                roots.append(root.trace_id)
                t_sub.append(time.perf_counter())
                streams.append(router.submit(p))
        while not all(s.done for s in streams):
            now = time.perf_counter()
            for i, s in enumerate(streams):
                if ttft[i] is None and s.tokens_so_far():
                    ttft[i] = now - t_sub[i]
            time.sleep(0.001)
        tokens = [s.result(0) for s in streams]
        wall = time.perf_counter() - t0
        launches = decode_attention.launches
        st = router.stats()
        counts = (router.handoffs - h0[0], router.reroutes - h0[1], router.fallbacks - h0[2])
        pages = sum(w["pages_shipped"] for w in st["workers"]) - \
            sum(w["pages_shipped"] for w in st0["workers"])
        nbytes = sum(w["bytes_shipped"] for w in st["workers"]) - \
            sum(w["bytes_shipped"] for w in st0["workers"])
        decode_steps = st["engine"]["step_latency_s"]["count"] - \
            st0["engine"]["step_latency_s"]["count"]
        spans, deadline = {}, time.monotonic() + 30
        while time.monotonic() < deadline:
            spans = {}
            for sp in tracing.recorder().recent(limit=0):
                spans.setdefault(sp.trace_id, []).append(sp)
            if all({"engine.prefill", "engine.kv_transfer", "engine.decode"}
                   <= {x.name for x in spans.get(t, [])} for t in roots):
                break
            time.sleep(0.2)
        one_trace = all(
            {x.pid for x in spans.get(t, []) if x.name == "engine.prefill"} - {os.getpid()}
            and {x.pid for x in spans.get(t, []) if x.name in ("engine.kv_transfer",
                                                                  "engine.decode")}
            == {os.getpid()} for t in roots)
        xfer = sorted((x.end_ns - x.start_ns) / 1e6 for t in roots for x in spans.get(t, [])
                      if x.name == "engine.kv_transfer")
        ttft_ms = np.array([t for t in ttft if t is not None]) * 1e3
        same, firsts = token_agreement(tokens, burst)
        out["clean"] = {"wall_s": wall, "handoffs": counts[0], "reroutes": counts[1],
                        "fallbacks": counts[2], "pages": pages, "bytes": nbytes,
                        "kv_transfer_ms_p50": float(np.median(xfer)) if xfer else None,
                        "ttft_p50_ms": float(np.percentile(ttft_ms, 50)),
                        "ttft_p50_ms_22b": float(np.percentile(np.array(ttft_22b) * 1e3, 50)),
                        "launches": launches, "decode_steps": decode_steps,
                        "one_trace": bool(one_trace), "devices": devices, "start_s": start_s}
        log(f"[dist] (b) burst of {n} prompts through the router: {wall:.3f} s, "
            f"{sum(map(len, tokens)) / wall:.1f} generated tokens/s; handoffs {counts[0]}, "
            f"re-routes {counts[1]}, fallbacks {counts[2]}; {pages} pages, "
            f"{nbytes / 1e6:.1f} MB shipped through the object store, engine.kv_transfer "
            f"p50 {out['clean']['kv_transfer_ms_p50']} ms a handoff over {len(xfer)} spans; "
            f"TTFT p50 {out['clean']['ttft_p50_ms']:.3f} ms (client clock; phase 22 (b)'s "
            f"{out['clean']['ttft_p50_ms_22b']:.3f}); decode launches {launches} "
            f"({decode_steps} decode steps); one trace id a request with its prefill in a "
            f"worker's process and its transfer and decode in this one: {one_trace}; prompts "
            f"equal to phase 22 (b)'s {same}/{n}, first differing positions {firsts}")
        if tokens != burst or counts != (n, 0, 0) or not one_trace:
            raise AssertionError(f"[dist] (b) tokens equal {same}/{n}, counts {counts}, "
                                 f"one trace {one_trace}")
        if launches != decode_steps * n_layers or not launches:
            raise AssertionError(f"[dist] (b) decode launches {launches}, steps {decode_steps}")
    finally:
        router.close()
    # the prefill.worker fault: replica 0 dies at its first prefill, replica
    # 1 at its second; a request re-routes, then every later one falls back
    name = "chip-disagg-fault"
    faults.install(faults.FaultPlan(seed=0, specs=[
        faults.FaultSpec("prefill.worker", "kill", at=1, match=f"{name}-prefill-0"),
        faults.FaultSpec("prefill.worker", "kill", at=2, match=f"{name}-prefill-1")]))
    router = DisaggRouter(ckpt, EngineConfig(**LM_ENGINE), prefill_replicas=2,
                          dtype="bfloat16", name=name)
    try:
        sub = ps[:DIST_FAULT_PROMPTS]
        t0 = time.perf_counter()
        got = [router.submit(sub[0]).result(600)]
        rerouted = (router.reroutes, router.fallbacks, router.live_prefill_replicas())
        got += [s.result(600) for s in [router.submit(p) for p in sub[1:]]]
        out["faults"] = {"after_first": rerouted, "reroutes": router.reroutes,
                         "fallbacks": router.fallbacks, "handoffs": router.handoffs,
                         "live": router.live_prefill_replicas(),
                         "equal": got == burst[:len(sub)], "wall_s": time.perf_counter() - t0}
        log(f"[dist] (b) prefill.worker kill faults: after the first request (re-routes, "
            f"fallbacks, live replicas) {rerouted}; after {len(sub)} requests re-routes "
            f"{router.reroutes}, fallbacks {router.fallbacks}, handoffs {router.handoffs}, live "
            f"replicas {router.live_prefill_replicas()}; every stream equal to phase 22 (b)'s: "
            f"{out['faults']['equal']}")
        if rerouted[0] < 1 or rerouted[1] or router.fallbacks < 1 or not out["faults"]["equal"]:
            raise AssertionError(f"[dist] (b) faults: {out['faults']}")
    finally:
        router.close()
        faults.clear()
    return out


def dist_serve(ckpt, ps: list, kind: str, want: list) -> dict:
    """Phase 28 (c): ``EngineDeployment`` through ``serve.run`` with
    ``disagg=`` or ``mesh=(2, 2)`` in the running runtime: one blocking POST
    of ``DIST_POST`` prompts equal to ``want``'s, the replica's stats lazy
    before it and carrying the topology (and the router's counts) after."""
    from tpu_air_torch import get, serve
    from tpu_air_torch.engine import EngineConfig
    from tpu_air_torch.serve import EngineDeployment

    port = free_port()
    chips, extra = ((1, {"disagg": {"prefill_replicas": 2}}) if kind == "disagg"
                    else (4, {"mesh": (2, 2)}))
    try:
        t0 = time.perf_counter()
        h = serve.run(EngineDeployment.options(name=f"lm-{kind}", route_prefix=f"/lm{kind}",
                                               num_chips=chips)
                      .bind(ckpt, EngineConfig(**LM_ENGINE), dtype="bfloat16", **extra),
                      port=port)
        before = get(h.method("stats")())
        res, _ = post_json(port, f"/lm{kind}", {"prompts": ps[:DIST_POST]})
        wall = time.perf_counter() - t0
        toks = [r["tokens"] for r in res["results"]]
        snap = get(h.method("stats")())
    finally:
        serve.shutdown()
    rec = {"before_build": before, "topology": snap.get("topology"),
           "disagg": snap.get("disagg"), "device": snap["device"],
           "launches": snap["kernel_launches"]["decode_attention"],
           "equal": toks == want[:DIST_POST], "wall_s": wall}
    log(f"[dist] (c) EngineDeployment({kind}={extra[kind]}), num_chips={chips}: replica stats "
        f"before the first request {before}; one blocking POST of {DIST_POST} prompts equal "
        f"to ({'b' if kind == 'disagg' else 'a'})'s: {rec['equal']}; replica stats topology "
        f"{rec['topology']}, disagg {rec['disagg']}, device {rec['device']}, decode launches "
        f"{rec['launches']}; serve.run + POST {wall:.3f} s")
    ok = before == {} and rec["equal"] and rec["launches"] > 0 and bool(rec["topology"])
    if kind == "disagg":
        ok = ok and rec["topology"].get("disagg") == "on" and \
            rec["disagg"]["handoffs"] >= DIST_POST and rec["disagg"]["fallbacks"] == 0
    else:
        ok = ok and rec["topology"].get("mesh") == "2x2" and rec["disagg"] is None
    if not ok:
        raise AssertionError(f"[dist] (c) {kind}: {rec}")
    return rec


def dist_path(dev, ckpt_dir: str, served: dict) -> dict:
    """Phase 28 (``[dist]``): sharded and disaggregated LM serving over
    phase 22's checkpoint, engine configuration and prompts (``served`` is
    phase 22's result; its burst tokens are the yardstick).  See the module
    docstring."""
    import tpu_air_torch
    from tpu_air_torch import serve
    from tpu_air_torch.observability import tracing
    from tpu_air_torch.train import Checkpoint

    t_phase = time.perf_counter()
    ckpt = Checkpoint.from_directory(ckpt_dir)
    model = ckpt.get_model(dtype="bfloat16")
    ps = lm_serve_prompts(LM_ENGINE_PROMPTS, model.config.vocab_size, SEED + 42)
    burst = served["burst_tokens"]
    out = {"a": dist_meshes(dev, model, ps, burst, ckpt)}
    tokens_2x2 = out["a"].pop("tokens_2x2")
    del model
    torch.cuda.empty_cache()
    t_a = time.perf_counter()
    os.environ["TPU_AIR_TRACE"] = "1"          # workers and replicas inherit it
    tpu_air_torch.init()
    try:
        native = runtime_native("dist")
        tracing.enable()
        out["b"] = dist_router(dev, ckpt, ps, burst, served["paged"]["burst"]["ttft_s"])
        out["c"] = {"disagg": dist_serve(ckpt, ps, "disagg", burst)}
        arena = runtime_native("dist")["arena"]
        log(f"[dist] (b)-(c) the runtime's arena at the start {native['arena']}, at the end "
            f"{arena}")
        if arena["leaked_bytes"]:
            raise AssertionError(f"[dist] the arena leaked {arena['leaked_bytes']} bytes")
        out["arena"] = arena
    finally:
        tracing.disable()
        os.environ.pop("TPU_AIR_TRACE", None)
        serve.shutdown()
        tpu_air_torch.shutdown()
    tpu_air_torch.init(num_chips=4)            # 4 chip slots, every one on the card
    try:
        out["c"]["mesh"] = dist_serve(ckpt, ps, "mesh", tokens_2x2)
    finally:
        serve.shutdown()
        tpu_air_torch.shutdown()
    t_bc = time.perf_counter()
    out["d"] = [dict(decode_shape_timing(dev, b, h, SEED + 46 + i, f"[dist] (d) {label}:"),
                     label=label) for i, (label, b, h) in enumerate(DIST_TIMING)]
    out["launches"] = {"dist_mesh_engine": out["a"]["launches"],
                       "dist_router_decode": out["b"]["clean"]["launches"],
                       "dist_serve_replicas": sum(out["c"][k]["launches"] for k in out["c"])}
    out["part_s"] = {"a": t_a - t_phase, "b+c": t_bc - t_a, "d": time.perf_counter() - t_bc}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[dist] phase 28 {out['phase_s']:.1f} s: "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in out["part_s"].items()))
    return out


def add_dist_rows(kernels: list, dist: dict) -> None:
    """Phase 28's decode launches and its timed shapes into the decode
    kernel's row."""
    row = next(r for r in kernels if r["name"] == "decode_attention")
    for where, n in dist["launches"].items():
        row["launches_by_path"][where] = n
        row["launches"] += n
    row["dist_shapes"] = dist["d"]


# -- phase 29 ------------------------------------------------------------------


def tp_lm_fit(dev, work: str, lm_stats: dict) -> dict:
    """Phase 29 (a): ``LMTrainer`` at tp 2 over lease ids 0 and 1, both on
    the card, at the ``[lm]`` phase's width and rows."""
    import pandas as pd

    from tpu_air_torch.train import (CheckpointConfig, LMTrainer, RunConfig, ScalingConfig,
                                     TrainingArguments)

    cfg = lm_config()
    rows = pd.DataFrame({"input_ids": list(lm_rows(1, LM_LEN, SEED + 20))})
    args = TrainingArguments(learning_rate=3e-4, per_device_train_batch_size=1,
                             num_train_epochs=TP_LM_STEPS, seed=SEED, evaluation_strategy="no")
    trainer = probed(LMTrainer(model_config=cfg, training_args=args, datasets={"train": rows},
                               scaling_config=ScalingConfig(num_workers=1, model_parallel=2),
                               run_config=RunConfig(storage_path=os.path.join(work, "tp_lm"),
                                                    checkpoint_config=CheckpointConfig(
                                                        num_to_keep=1))))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with runtime_of(2):     # the trial actor's lease of 2 slots: cuda:0 twice
        result = trainer.fit()
    wall = time.perf_counter() - t0
    if result.error is not None:
        raise AssertionError(f"[tp] (a) fit failed: {result.error}")
    probe, = read_probes(result.path)           # counted in the fit's trial actor
    launches = {k: probe["launches"][k] for k in FLASH_KERNELS}
    hist = result.metrics_history
    m = hist[-1]
    losses = [h["loss"] for h in hist]
    step_ms = [LM_LEN / h["train_tokens_per_sec"] * 1e3 for h in hist]
    want = cfg.n_layers * 2 * TP_LM_STEPS
    med = float(np.median(step_ms[1:]))
    log(f"[tp] (a) LMTrainer(ScalingConfig(num_workers=1, model_parallel=2)).fit: the [lm] "
        f"phase's LM ({cfg.d_model} wide, {cfg.n_layers} layers, {cfg.n_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}), bf16 on f32, L={LM_LEN}, {len(hist)} one-step "
        f"epochs in {wall:.1f} s; mesh data {m['mesh_data']} x model {m['mesh_model']} on "
        f"{probe['device']} twice (lease {probe['lease']}); params {m['params_bytes_total'] / 1e6:.1f} MB logical, "
        f"{m['params_bytes_per_device'] / 1e6:.1f} MB on the first device")
    log("[tp] (a) loss per step: " + ", ".join(f"{x:.4f}" for x in losses)
        + "; tp 1 ([lm]): " + ", ".join(f"{x:.4f}" for x in lm_stats["losses"][:len(hist)]))
    log(f"[tp] (a) step ms (first is the warm-up): " + ", ".join(f"{x:.1f}" for x in step_ms)
        + f"; median after the first {med:.1f} ms against the tp 1 step's "
        f"{lm_stats['step_ms_median']:.1f} ms ([lm]): both shards run on the one card, in "
        f"turn, so tp 2 here is no speedup")
    log(f"[tp] (a) launches {launches} (expect layers x shards x steps = {want} each)")
    if len(hist) != TP_LM_STEPS or any(h["steps"] != 1 for h in hist) or \
            not all(np.isfinite(losses)):
        raise AssertionError(f"[tp] (a) history {hist}")
    if m["mesh_model"] != 2 or not m["params_bytes_per_device"] < m["params_bytes_total"]:
        raise AssertionError(f"[tp] (a) metrics {m}")
    if any(n != want for n in launches.values()):
        raise AssertionError(f"[tp] (a) launches {launches}, want {want} each")
    params = result.checkpoint.get_params()
    if "layers.0.attn.q.weight" not in params or \
            tuple(params["layers.0.attn.q.weight"].shape) != (cfg.n_heads * cfg.head_dim,
                                                              cfg.d_model):
        raise AssertionError("[tp] (a) the checkpoint does not hold the logical parameters")
    del trainer, result, params
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": losses, "step_ms": step_ms, "step_ms_median": med,
            "tp1_step_ms_median": lm_stats["step_ms_median"], "fit_wall_s": wall,
            "params_bytes_total": m["params_bytes_total"],
            "params_bytes_per_device": m["params_bytes_per_device"]}


def flash_counts() -> dict:
    from tpu_air_torch.ops.flash_attention import flash_attention, flash_attention_backward

    return {"flash_attention": flash_attention.launches,
            "flash_attention_bwd_dq": flash_attention_backward.dq_launches,
            "flash_attention_bwd_dkv": flash_attention_backward.dkv_launches}


def tp_lm_parity(dev) -> dict:
    """Phase 29 (a): two f32 steps at ``[lm parity]``'s cut depth and
    length through the single-card step and through the tensor-parallel
    step at tp 2 and 4 (every shard on the card), from the same weights:
    the losses to 1e-5 relative and each step-1 gradient, put back
    together, to 1e-5 of its norm (the CPU tests' tolerances,
    tests/test_torch_tp_train.py)."""
    from tpu_air_torch.models.lm import CausalLM
    from tpu_air_torch.models.lm.convert import tp_split_dims
    from tpu_air_torch.parallel.mesh import worker_mesh
    from tpu_air_torch.parallel.sequence_parallel import make_sp_train_step, shift_targets
    from tpu_air_torch.parallel.sharding import logical_parameters, shard_module
    from tpu_air_torch.train.lm_trainer import make_lm_tp_train_step
    from tpu_air_torch.train.t5_trainer import TrainingArguments, _make_optimizer

    cfg = lm_config("float32", LM_PARITY_LAYERS)
    ids = torch.from_numpy(lm_rows(1, LM_PARITY_LEN, SEED + 22)).to(dev, torch.long)
    tgt = shift_targets(ids, cfg.pad_token_id)
    runs = {}
    for tp in (1,) + TP_PARITY:
        model = CausalLM(cfg, device=dev).init_weights(SEED)
        mesh = worker_mesh([dev] * tp, tp)
        shard_module(model, list(mesh.devices[0]), tp_split_dims(cfg, tp))
        logical = logical_parameters(model)
        opt = _make_optimizer(TrainingArguments(learning_rate=1e-3), 2,
                              [(shards, dim) for _, shards, dim in logical])
        grads = []
        adamw_step = opt.step

        def snapshot_then_step():
            grads.append({n: (s[0].grad if d is None else torch.cat([p.grad for p in s], d))
                          .detach().clone() for n, s, d in logical})
            adamw_step()

        opt.step = snapshot_then_step
        step = make_sp_train_step(model, opt) if tp == 1 else \
            make_lm_tp_train_step(model, opt, mesh)
        zero_flash_counts()
        losses = [float(step(ids, tgt)) for _ in range(2)]
        runs[tp] = (losses, grads[0], flash_counts())
        del model, opt, step, logical
        torch.cuda.empty_cache()
    base_losses, base_grads, _ = runs[1]
    out = {}
    for tp in TP_PARITY:
        losses, grads, launches = runs[tp]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, base_losses))
        grad_rel = max(norm_err(grads[n], base_grads[n]) for n in base_grads)
        want = cfg.n_layers * tp * 2
        log(f"[tp] (a) f32 parity, {cfg.d_model} wide, depth cut to {cfg.n_layers} layers, "
            f"L={LM_PARITY_LEN}, tp {tp} (every shard on {dev}): losses {losses} against the "
            f"single-card step's {base_losses} (max rel diff {loss_rel:.2e}); step-1 gradients "
            f"max |diff| / |single-card| over tensors {grad_rel:.2e}; launches {launches}")
        if not (loss_rel < 1e-5 and grad_rel < 1e-5):
            raise AssertionError(f"[tp] (a) tp {tp}: loss rel {loss_rel}, grad rel {grad_rel}")
        if any(n != want for n in launches.values()):
            raise AssertionError(f"[tp] (a) tp {tp} launches {launches}, want {want} each")
        out[f"tp{tp}"] = {"losses": losses, "loss_max_rel_diff": loss_rel,
                          "grad_max_norm_rel_diff": grad_rel, "launches": launches}
    out["single_card_losses"] = base_losses
    return out


def tp_w1(dev, work: str, w1_stats: dict) -> dict:
    """Phase 29 (b): W1 at tp 2: ``T5Trainer(scaling_config=ScalingConfig(
    model_parallel=2))`` over lease ids 0 and 1 at FLAN-T5-base width for
    TP_W1_STEPS steps of W1_BATCH x W1_LEN rows (the ``[w1]`` phase's first
    ones), its eval (the flash forward per shard: dropout keeps the train
    steps on the dense path), then generation from its checkpoint."""
    from tpu_air_torch.models.tokenizer import ByteTokenizer
    from tpu_air_torch.ops.decode_attention import decode_attention
    from tpu_air_torch.predict.predictors import T5GenerativePredictor
    from tpu_air_torch.train import RunConfig, ScalingConfig, T5Trainer, TrainingArguments

    def counts():
        return {**flash_counts(), "decode_attention": decode_attention.launches}

    cfg = w1_config()
    train = w1_rows(W1_BATCH * W1_STEPS, cfg.vocab_size, SEED + 40)
    evaluation = w1_rows(W1_BATCH, cfg.vocab_size, SEED + 41)
    args = TrainingArguments(learning_rate=2e-5, weight_decay=0.01,
                             per_device_train_batch_size=W1_BATCH, num_train_epochs=1,
                             max_steps_per_epoch=TP_W1_STEPS, seed=SEED)
    trainer = probed(T5Trainer(
        model_config=cfg, training_args=args, tokenizer=ByteTokenizer(W1_LEN),
        scaling_config=ScalingConfig(model_parallel=2),
        datasets={"train": train, "evaluation": evaluation},
        run_config=RunConfig(storage_path=os.path.join(work, "tp_w1"))),
        step_maker=T5_STEP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with runtime_of(2):     # the trial actor's lease of 2 slots: cuda:0 twice
        result = trainer.fit()
    wall = time.perf_counter() - t0
    if result.error is not None:
        raise AssertionError(f"[tp] (b) fit failed: {result.error}")
    probe, = read_probes(result.path)           # recorded in the fit's trial actor
    step_ms = probe["step_ms"]
    fit_launches = {k: probe["launches"][k] for k in counts()}
    m = result.metrics
    attn = cfg.num_layers + 2 * cfg.num_decoder_layers
    log(f"[tp] (b) T5Trainer at tp 2: FLAN-T5-base width and depth, dropout "
        f"{cfg.dropout_rate}, bf16 on f32, {m['steps']} steps of {W1_BATCH} x {W1_LEN}, eval "
        f"of {W1_BATCH} rows, in {wall:.1f} s; loss {m['loss']:.4f} (tp 1's first "
        f"{TP_W1_STEPS} steps, [w1]: {w1_stats['losses'][:TP_W1_STEPS]}), eval_loss "
        f"{m['eval_loss']:.4f}; mesh data {m['mesh_data']} x model {m['mesh_model']}; params "
        f"{m['params_bytes_total'] / 1e6:.1f} MB logical, {m['params_bytes_per_device'] / 1e6:.1f}"
        f" MB on the first device; step ms (device clock, the first a warm-up) "
        + ", ".join(f"{x:.1f}" for x in step_ms)
        + f" against the tp 1 step's median {w1_stats['step_ms_median']:.1f} ([w1]); launches "
        f"{fit_launches} (eval: {attn} attention calls x 2 shards)")
    if m["steps"] != TP_W1_STEPS or m["mesh_model"] != 2 or \
            not np.isfinite([m["loss"], m["eval_loss"]]).all() or \
            not m["params_bytes_per_device"] < m["params_bytes_total"]:
        raise AssertionError(f"[tp] (b) metrics {m}")
    if fit_launches["flash_attention"] != attn * 2 or fit_launches["decode_attention"] or \
            fit_launches["flash_attention_bwd_dq"]:
        raise AssertionError(f"[tp] (b) fit launches {fit_launches}")
    predictor = T5GenerativePredictor.from_checkpoint(result.checkpoint, dtype="bfloat16",
                                                      device=dev, tokenizer=ByteTokenizer)
    ids, mask = prompts(W1_PROMPTS, W1_LEN, cfg.vocab_size, SEED + 42)
    before = counts()
    out = predictor.predict({"input_ids": ids, "attention_mask": mask}, max_new_tokens=W1_NEW)
    gen = {k: counts()[k] - before[k] for k in before}
    log(f"[tp] (b) generate from the tp 2 checkpoint (logical parameters, loaded at tp 1 in "
        f"bf16): {len(out)} rows x {W1_NEW} new tokens; launches {gen}")
    if len(out) != W1_PROMPTS or gen["flash_attention"] != cfg.num_layers or \
            gen["decode_attention"] <= 0:
        raise AssertionError(f"[tp] (b) generation: {len(out)} rows, {gen}")
    del predictor, trainer, result
    torch.cuda.empty_cache()
    return {"fit_launches": fit_launches, "generate_launches": gen,
            "launches": {k: fit_launches[k] + gen[k] for k in gen}, "loss": m["loss"],
            "eval_loss": m["eval_loss"], "fit_wall_s": wall, "step_ms": step_ms,
            "tp1_step_ms_median": w1_stats["step_ms_median"],
            "params_bytes_total": m["params_bytes_total"],
            "params_bytes_per_device": m["params_bytes_per_device"]}


def tp_timing(dev) -> dict:
    """Phase 29 (c): the kernels at the tp 2 shard shapes beside their
    bounds, plain versions and SDPA: the flash forward, dq and dk/dv at the
    LM's B1 H4 L8192 D128 causal (bf16), the flash forward at W1's encoder
    shard B8 H6 L512 D64 (bias, key mask), and the decode kernel at the
    2 x 2 mesh's shard (b 8, 4 heads).  These calls are not counted."""
    from tpu_air_torch.ops.flash_attention import (flash_attention, flash_attention_backward,
                                                   flash_attention_reference)

    counted = flash_counts()
    rng = np.random.default_rng(SEED + 47)
    h, L, d = lm_config().n_heads // 2, LM_LEN, lm_config().head_dim
    scale = d ** -0.5
    q, k, v, do, _, out, lse, _ = backward_inputs(rng, 1, h, L, d, torch.bfloat16, dev,
                                                  mask=False, causal=True)
    flat = [x.reshape(h, L, d) for x in (q, k, v)]
    want_out = flash_attention_reference(*flat, None, None, scale, True)[0].reshape(q.shape)
    got = flash_attention_backward(q, k, v, None, out, lse, do, None, scale, True)
    want = backward_plain(q, k, v, None, out, lse, do, None, scale, True)
    errs = {"flash_attention": (max_err(out, want_out), norm_err(out, want_out)),
            "flash_attention_bwd_dq": (max_err(got[0], want[0].reshape(got[0].shape)),
                                       norm_err(got[0], want[0].reshape(got[0].shape))),
            "flash_attention_bwd_dkv": tuple(
                max(f(got[i], want[i].reshape(got[i].shape)) for i in (1, 2))
                for f in (max_err, norm_err))}
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, scale=scale)
    calls = bwd_kernel_calls(q, k, v, do, out, lse, scale, True)
    pairs = h * L * (L + 1) // 2
    elt = h * L * d * 2
    lse_bytes = h * L * 4
    plain_bwd_ms = time_ms(lambda: backward_plain(q, k, v, None, out, lse, do, None, scale,
                                                  True), 2, 1)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), do,
                                                      retain_graph=True), 5, 2)
    shape = f"B1 H{h} L{L} D{d} causal bf16 (the tp 2 shard of the [lm] shape)"
    rows = {}
    for name, call, plain_ms, lib_ms, nbytes, flops in (
        ("flash_attention", lambda: flash_attention(q, k, v, scale=scale, causal=True),
         time_ms(lambda: flash_attention_reference(*flat, None, None, scale, True), 2, 1),
         time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale),
                 5, 2), 4 * elt + lse_bytes, 4 * d * pairs),
        ("flash_attention_bwd_dq", calls["flash_attention_bwd_dq"], plain_bwd_ms, sdpa_bwd_ms,
         5 * elt + 2 * lse_bytes, 6 * d * pairs),
        ("flash_attention_bwd_dkv", calls["flash_attention_bwd_dkv"], plain_bwd_ms,
         sdpa_bwd_ms, 6 * elt + 2 * lse_bytes, 8 * d * pairs),
    ):
        b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16_FLOP_S)
        err, rel = errs[name]
        rows[name] = {"ms": device_ms(call, 5), "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                      "err_norm_over_plain_norm": rel, "norm_tol": NORM_TOL[torch.bfloat16],
                      "bytes": nbytes, "flops": flops, "shape": shape}
        r = rows[name]
        log(f"[tp] (c) {name} {shape}: kernel {r['ms']:.4f} ms device time, plain "
            f"{plain_ms:.3f} ms, SDPA {lib_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}; kernel "
            f"against plain {err:.3e} (norm {rel:.2e}, tolerance {NORM_TOL[torch.bfloat16]})")
        if not rel < NORM_TOL[torch.bfloat16]:
            raise AssertionError(f"[tp] (c) {name} against plain: {rel}")
    del q, k, v, do, out, lse, qs, ks, vs, sdpa_out, calls, got, want, want_out, flat
    torch.cuda.empty_cache()

    cfg = w1_config()
    H, D, B, Lw = cfg.num_heads // 2, cfg.d_kv, W1_BATCH, W1_LEN
    q, k, v, bias, mask = flash_inputs(rng, B, H, Lw, D, torch.bfloat16, dev)
    got = flash_attention(q, k, v, bias, kv_mask=mask, scale=1.0)
    want = flash_plain(q, k, v, bias, mask)
    nbytes, flops = flash_work(B, H, Lw, D, needed_keys(mask, Lw), False)
    b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16_FLOP_S)
    lib_mask = (bias + ((1.0 - mask) * -1e30)[:, None, None, :]).to(torch.bfloat16)
    enc = {"ms": device_ms(lambda: flash_attention(q, k, v, bias, kv_mask=mask, scale=1.0), 10),
           "plain_ms": device_ms(lambda: flash_plain(q, k, v, bias, mask), 5),
           "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=lib_mask, scale=1.0), 10),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
           "max_abs_err": max_err(got, want), "tol": TOL[torch.bfloat16],
           "shape": f"B{B} H{H} L{Lw} D{D} bf16, bias [1,H,L,L] f32, source key mask "
                    "(the tp 2 shard of W1's encoder)"}
    log(f"[tp] (c) flash_attention {enc['shape']}: kernel {enc['ms']:.4f} ms device time, "
        f"plain {enc['plain_ms']:.4f} ms, SDPA {enc['library_ms']:.4f} ms, bound "
        f"{b_ms:.4f} ms by {b_by}; kernel against plain {enc['max_abs_err']:.3e}")
    if not enc["max_abs_err"] < TOL[torch.bfloat16]:
        raise AssertionError(f"[tp] (c) W1 encoder shard: {enc['max_abs_err']}")
    del q, k, v, bias, mask, lib_mask, got, want
    torch.cuda.empty_cache()
    decode = decode_shape_timing(dev, 8, 4, SEED + 48, "[tp] (c) 2 x 2 mesh shard:")
    # the comparisons' and timings' launches are not counted
    flash_attention.launches = counted["flash_attention"]
    flash_attention_backward.dq_launches = counted["flash_attention_bwd_dq"]
    flash_attention_backward.dkv_launches = counted["flash_attention_bwd_dkv"]
    return {"lm_shard": rows, "w1_encoder_shard": enc, "decode_2x2": decode}


def tp_path(dev, work: str, lm_stats: dict, w1_stats: dict) -> dict:
    """Phase 29 (``[tp]``): tensor-parallel training on the card.  See the
    module docstring."""
    t_phase = time.perf_counter()
    out = {"a": tp_lm_fit(dev, work, lm_stats)}
    out["a"]["parity"] = tp_lm_parity(dev)
    t_a = time.perf_counter()
    out["b"] = tp_w1(dev, work, w1_stats)
    t_b = time.perf_counter()
    out["c"] = tp_timing(dev)
    out["part_s"] = {"a": t_a - t_phase, "b": t_b - t_a, "c": time.perf_counter() - t_b}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[tp] phase 29 {out['phase_s']:.1f} s: "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in out["part_s"].items()))
    return out


def add_tp_rows(kernels: list, tp: dict) -> None:
    """Phase 29's launches (the tp fit, its f32 steps and W1 at tp 2) and
    its timed shard shapes into the kernels' rows."""
    parity = tp["a"]["parity"]
    for r in kernels:
        name = r["name"]
        by = r.setdefault("launches_by_path", {})
        new = {"tp_lm_fit": tp["a"]["launches"].get(name, 0),
               "tp_lm_f32_steps": sum(parity[f"tp{n}"]["launches"].get(name, 0)
                                      for n in TP_PARITY),
               "tp_w1_fit_generate": tp["b"]["launches"].get(name, 0)}
        for where, n in new.items():
            by[where] = n
            r["launches"] += n
        if name in tp["c"]["lm_shard"]:
            r["tp_lm_shard_shape"] = tp["c"]["lm_shard"][name]
    fwd = next(r for r in kernels if r["name"] == "flash_attention")
    fwd["tp_w1_encoder_shard_shape"] = tp["c"]["w1_encoder_shard"]
    dec = next(r for r in kernels if r["name"] == "decode_attention")
    dec["tp_2x2_shard_shape"] = tp["c"]["decode_2x2"]


# -- phase 30: multi-host ------------------------------------------------------------
# These functions run on every host of the emulated cluster: they travel by
# value (this script is __main__) and import what they use.


def mh_zero_counts() -> None:
    """Set this host's kernel launch counts and cross-host all-reduce
    record to 0."""
    from tpu_air_torch.ops.decode_attention import decode_attention
    from tpu_air_torch.ops.flash_attention import flash_attention, flash_attention_backward
    from tpu_air_torch.parallel.distributed import HOST_ALLREDUCE

    flash_attention.launches = 0
    flash_attention_backward.dq_launches = 0
    flash_attention_backward.dkv_launches = 0
    decode_attention.launches = 0
    HOST_ALLREDUCE.update(calls=0, ms=[], bytes=0, backend=None)


def mh_host_counts() -> dict:
    """This host's launch counts and cross-host all-reduce record."""
    from tpu_air_torch.ops.decode_attention import decode_attention
    from tpu_air_torch.ops.flash_attention import flash_attention, flash_attention_backward
    from tpu_air_torch.parallel.distributed import HOST_ALLREDUCE, process_index

    return {"host": process_index(), "pid": os.getpid(),
            "launches": {"flash_attention": flash_attention.launches,
                         "flash_attention_bwd_dq": flash_attention_backward.dq_launches,
                         "flash_attention_bwd_dkv": flash_attention_backward.dkv_launches,
                         "decode_attention": decode_attention.launches},
            "allreduce": dict(HOST_ALLREDUCE, ms=list(HOST_ALLREDUCE["ms"]))}


def mh_t5_loop(config):
    """``t5_train_loop``, then the sha256 of this host's final logical
    parameters (names and f32 bytes, in name order) written to
    ``config["mh_dir"]/host-<process index>``."""
    import hashlib

    from tpu_air_torch.parallel import distributed as D
    from tpu_air_torch.parallel import sharding
    from tpu_air_torch.train.t5_trainer import t5_train_loop

    models = []
    shard_module = sharding.shard_module

    def keep(model, *args, **kwargs):
        models.append(model)
        return shard_module(model, *args, **kwargs)

    sharding.shard_module = keep
    try:
        t5_train_loop(config)
    finally:
        sharding.shard_module = shard_module
    state = sharding.gather_state_dict(models[-1])
    h = hashlib.sha256()
    for name in sorted(state):
        h.update(name.encode())
        h.update(state[name].detach().float().cpu().contiguous().numpy().tobytes())
    with open(os.path.join(config["mh_dir"], f"host-{D.process_index()}"), "w") as f:
        f.write(h.hexdigest())


def mh_elastic_loop(config):
    """Six paced reports with a checkpoint each, resuming from one; each
    report sums a ones tensor on the card over the hosts (the hosts' count)
    and appends (iteration, hosts) to ``config["trace_dir"]/host-<index>``."""
    from tpu_air_torch.parallel import distributed as D
    from tpu_air_torch.train import Checkpoint, session

    start = 0
    if config.get("resume_from_checkpoint"):
        start = Checkpoint.from_directory(config["resume_from_checkpoint"]).get_metrics()["i"]
    path = os.path.join(config["trace_dir"], f"host-{D.process_index()}")
    dev = torch.device(config["_device"])
    for i in range(start, 6):
        hosts = int(D.all_reduce_sum(torch.ones(1, device=dev)).item())
        ckpt = (Checkpoint.from_model(metrics={"i": i + 1}) if session.get_world_rank() == 0
                else None)
        session.report({"i": i + 1, "hosts": hosts, "world": list(D.world())}, checkpoint=ckpt)
        with open(path, "a") as f:
            f.write(f"{i + 1} {hosts}\n")
        time.sleep(0.3)  # paced so the notice lands between reports


def mh_trainer(cfg, args, rows: dict, work: str, scaling: dict, name: str, dev):
    """A T5Trainer whose training function is :func:`mh_t5_loop`."""
    from tpu_air_torch.models.tokenizer import ByteTokenizer
    from tpu_air_torch.train import RunConfig, ScalingConfig, T5Trainer

    class DigestT5Trainer(T5Trainer):
        def _training_fn(self):
            return mh_t5_loop

    mh_dir = os.path.join(work, name + "_digests")
    os.makedirs(mh_dir, exist_ok=True)
    return DigestT5Trainer(model_config=cfg, training_args=args, tokenizer=ByteTokenizer(W1_LEN),
                           scaling_config=ScalingConfig(**scaling), datasets=rows,
                           trainer_init_config={"mh_dir": mh_dir},
                           run_config=RunConfig(storage_path=os.path.join(work, name)),
                           device=dev), mh_dir


def mh_parity_args():
    from tpu_air_torch.train import TrainingArguments

    return TrainingArguments(learning_rate=2e-5, weight_decay=0.01,
                             per_device_train_batch_size=W1_BATCH // 4, num_train_epochs=1,
                             max_steps_per_epoch=MH_PARITY_STEPS, seed=SEED)


def mh_parity_rows(cfg) -> dict:
    return {"train": w1_rows(W1_BATCH * MH_PARITY_STEPS, cfg.vocab_size, SEED + 60),
            "evaluation": w1_rows(W1_BATCH, cfg.vocab_size, SEED + 61)}


def mh_one_host(dev, work: str) -> dict:
    """Phase 30 (b)'s yardstick, before the cluster starts: the f32 fit at
    W1 width, depth cut to MH_PARITY_LAYERS + MH_PARITY_LAYERS, dropout 0, on
    one host running dp 4 x tp 2 in its trial actor (lease ids 0-7 wrap onto
    the card; TF32 off there as here)."""
    cfg = w1_config("float32", MH_PARITY_LAYERS, dropout=0.0)
    trainer, _ = mh_trainer(cfg, mh_parity_args(), mh_parity_rows(cfg), work, dict(
        num_workers=1, num_chips_per_worker=8, model_parallel=2), "mh_one_host", None)
    with runtime_of(8):     # the trial actor's lease of 8 slots, all on the card
        result = probed(trainer).fit()
    if result.error is not None:
        raise AssertionError(f"[multihost] (b) one-host fit failed: {result.error}")
    params = result.checkpoint.get_params()
    torch.cuda.empty_cache()
    return {"metrics": result.metrics_history, "params": params}


def mh_w1(dev, work: str, cluster, w1_stats: dict) -> dict:
    """Phase 30 (a): W1 across the 2 hosts (see the module docstring)."""
    from tpu_air_torch.models.tokenizer import ByteTokenizer
    from tpu_air_torch.ops.decode_attention import decode_attention
    from tpu_air_torch.predict.predictors import T5GenerativePredictor
    from tpu_air_torch.train import TrainingArguments

    cfg = w1_config()
    rows = {"train": w1_rows(W1_BATCH * W1_STEPS, cfg.vocab_size, SEED + 40),
            "evaluation": w1_rows(W1_BATCH, cfg.vocab_size, SEED + 41)}
    args = TrainingArguments(learning_rate=2e-5, weight_decay=0.01,
                             per_device_train_batch_size=W1_BATCH // 4, num_train_epochs=1,
                             max_steps_per_epoch=TP_W1_STEPS, seed=SEED)
    trainer, mh_dir = mh_trainer(cfg, args, rows, work, dict(num_workers=4, model_parallel=2),
                                 "mh_w1", dev)
    cluster.run(mh_zero_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded_t5_steps() as marks:
        result = trainer.fit()
    wall = time.perf_counter() - t0
    hosts = cluster.run(mh_host_counts)
    step_ms = [a.elapsed_time(b) for (_, a), (_, b) in zip(marks, marks[1:])]
    if result.error is not None:
        raise AssertionError(f"[multihost] (a) fit failed: {result.error}")
    m = result.metrics
    digests = [open(os.path.join(mh_dir, f"host-{h}")).read() for h in range(2)]
    attn = cfg.num_layers + 2 * cfg.num_decoder_layers
    want_eval = attn * 2 * 2            # attention calls x 2 shards x 2 replicas a host
    backends = sorted({h["allreduce"]["backend"] for h in hosts})
    log(f"[multihost] (a) T5Trainer(ScalingConfig(num_workers=4, model_parallel=2)) over 2 "
        f"hosts x 4 slots, every slot on {dev}: FLAN-T5-base width and depth, dropout "
        f"{cfg.dropout_rate}, bf16 on f32, {m['steps']} steps of {W1_BATCH} x {W1_LEN}, eval of "
        f"{W1_BATCH} rows, in {wall:.1f} s; mesh_num_hosts {m['mesh_num_hosts']}, mesh_data "
        f"{m['mesh_data']}, mesh_model {m['mesh_model']}; cross-host group backend "
        f"{backends}; loss {m['loss']:.4f} (one card's first {TP_W1_STEPS} steps, [w1]: "
        f"{w1_stats['losses'][:TP_W1_STEPS]}), eval_loss {m['eval_loss']:.4f}; host 0's step ms "
        f"(device clock, the first a warm-up) " + ", ".join(f"{x:.1f}" for x in step_ms)
        + f" against one card's median {w1_stats['step_ms_median']:.1f} ([w1])")
    for h in hosts:
        ar = h["allreduce"]
        log(f"[multihost] (a) host {h['host']} (pid {h['pid']}): launches {h['launches']}; "
            f"gradient all-reduce over the hosts {ar['calls']} calls of "
            f"{ar['bytes'] / 1e6:.1f} MB, ms " + ", ".join(f"{x:.1f}" for x in ar["ms"]))
    log(f"[multihost] (a) parameter digests after the fit: host 0 {digests[0][:16]}..., "
        f"host 1 {digests[1][:16]}...")
    if (m["mesh_num_hosts"], m["mesh_data"], m["mesh_model"], m["steps"]) != \
            (2, 4, 2, TP_W1_STEPS) or not np.isfinite([m["loss"], m["eval_loss"]]).all():
        raise AssertionError(f"[multihost] (a) metrics {m}")
    if digests[0] != digests[1]:
        raise AssertionError(f"[multihost] (a) the hosts' parameters differ: {digests}")
    for h in hosts:
        if h["launches"]["flash_attention"] != want_eval or h["launches"]["decode_attention"] \
                or h["launches"]["flash_attention_bwd_dq"] or \
                h["allreduce"]["calls"] != TP_W1_STEPS or h["allreduce"]["backend"] != "gloo":
            raise AssertionError(f"[multihost] (a) host {h['host']}: {h}")
    predictor = T5GenerativePredictor.from_checkpoint(result.checkpoint, dtype="bfloat16",
                                                      device=dev, tokenizer=ByteTokenizer)
    ids, mask = prompts(W1_PROMPTS, W1_LEN, cfg.vocab_size, SEED + 62)
    before = {**flash_counts(), "decode_attention": decode_attention.launches}
    out = predictor.predict({"input_ids": ids, "attention_mask": mask}, max_new_tokens=W1_NEW)
    gen = {k: v - before[k] for k, v in {**flash_counts(),
                                         "decode_attention": decode_attention.launches}.items()}
    texts = [str(t) for t in out["generated_output"]]
    log(f"[multihost] (a) generate from the 2-host checkpoint on {dev} (bf16): {len(out)} rows "
        f"x {W1_NEW} new tokens; launches {gen}; rows: "
        + " | ".join(repr(t[:40]) for t in texts))
    if len(out) != W1_PROMPTS or gen["flash_attention"] != cfg.num_layers or \
            gen["decode_attention"] <= 0:
        raise AssertionError(f"[multihost] (a) generation: {len(out)} rows, {gen}")
    launches = {k: sum(h["launches"][k] for h in hosts) + gen.get(k, 0)
                for k in hosts[0]["launches"]}
    del predictor, trainer, result
    torch.cuda.empty_cache()
    return {"hosts": hosts, "launches": launches, "generate_launches": gen,
            "loss": m["loss"], "eval_loss": m["eval_loss"], "fit_wall_s": wall,
            "step_ms": step_ms, "one_card_step_ms_median": w1_stats["step_ms_median"],
            "allreduce_ms": [h["allreduce"]["ms"] for h in hosts],
            "allreduce_bytes": hosts[0]["allreduce"]["bytes"], "backend": backends[0],
            "digest": digests[0], "generated": texts}


def mh_parity(dev, work: str, cluster, one: dict) -> dict:
    """Phase 30 (b): :func:`mh_one_host`'s fit across the 2 hosts, against
    it: losses to 1e-5 relative, each final parameter to 1e-5 of its norm
    (the CPU tests' bounds, tests/test_torch_multihost.py)."""
    cfg = w1_config("float32", MH_PARITY_LAYERS, dropout=0.0)
    trainer, mh_dir = mh_trainer(cfg, mh_parity_args(), mh_parity_rows(cfg), work, dict(
        num_workers=4, model_parallel=2), "mh_parity", dev)
    cluster.run(mh_zero_counts)
    result = trainer.fit()
    hosts = cluster.run(mh_host_counts)
    if result.error is not None:
        raise AssertionError(f"[multihost] (b) fit failed: {result.error}")
    got, want = result.metrics_history, one["metrics"]
    loss_rel = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(got, want)
                   for k in ("loss", "eval_loss"))
    params = result.checkpoint.get_params()
    errs = {n: norm_err(params[n], one["params"][n]) for n in one["params"]}
    worst = max(errs, key=errs.get)
    digests = [open(os.path.join(mh_dir, f"host-{h}")).read() for h in range(2)]
    log(f"[multihost] (b) f32 parity, {cfg.d_model} wide, depth cut to {cfg.num_layers}+"
        f"{cfg.num_decoder_layers}, dropout 0, {MH_PARITY_STEPS} steps of {W1_BATCH} x {W1_LEN}: "
        f"2 hosts (dp 2 x tp 2 each) loss {[g['loss'] for g in got]} eval_loss "
        f"{[g['eval_loss'] for g in got]} against one host's dp 4 x tp 2 "
        f"{[w['loss'] for w in want]} / {[w['eval_loss'] for w in want]} (max rel diff "
        f"{loss_rel:.2e}); final parameters ||diff|| / ||one host|| max {errs[worst]:.2e} "
        f"({worst}); hosts' digests equal: {digests[0] == digests[1]}; launches "
        + "; ".join(f"host {h['host']} {h['launches']}" for h in hosts))
    if not (loss_rel < 1e-5 and errs[worst] < 1e-5 and digests[0] == digests[1]
            and len(got) == len(want) and got[-1]["mesh_num_hosts"] == 2):
        raise AssertionError(f"[multihost] (b) loss rel {loss_rel}, {worst} {errs[worst]}, "
                             f"digests {digests}")
    del trainer, result, params
    torch.cuda.empty_cache()
    return {"loss_max_rel_diff": loss_rel, "param_max_norm_rel_diff": errs[worst],
            "param_worst_tensor": worst, "losses": [g["loss"] for g in got],
            "one_host_losses": [w["loss"] for w in want],
            "launches": {k: sum(h["launches"][k] for h in hosts) for k in hosts[0]["launches"]}}


def mh_elastic(dev, work: str) -> dict:
    """Phase 30 (c): a ``runtime.lease`` notice revokes the 8-slot lease of
    a ``TorchTrainer`` 0.8 s after its grant: both hosts stop at the same
    report, the run shrinks to 4 slots on one host (this process) and
    resumes from the retained checkpoint, with ``max_failures=0``."""
    from tpu_air_torch.faults import plan as faults
    from tpu_air_torch.train import FailureConfig, RunConfig, ScalingConfig, TorchTrainer

    trace = os.path.join(work, "mh_elastic_trace")
    os.makedirs(trace)
    faults.install(faults.FaultPlan(seed=15, specs=[
        faults.FaultSpec("runtime.lease", "notice", at=1, delay_s=0.8, notice_s=10.0)]))
    t0 = time.perf_counter()
    try:
        r = TorchTrainer(mh_elastic_loop, train_loop_config={"trace_dir": trace},
                         scaling_config=ScalingConfig(num_workers=2, num_chips_per_worker=4),
                         run_config=RunConfig(storage_path=os.path.join(work, "mh_elastic"),
                                              failure_config=FailureConfig(max_failures=0)),
                         device=dev).fit()
    finally:
        faults.clear()
    wall = time.perf_counter() - t0
    lines = {}
    for h in range(2):
        with open(os.path.join(trace, f"host-{h}")) as f:
            lines[h] = [tuple(int(x) for x in ln.split()) for ln in f.read().split("\n") if ln]
    spanned = {h: [i for i, n in v if n == 2] for h, v in lines.items()}
    hist = [m["i"] for m in r.metrics_history]
    log(f"[multihost] (c) elastic shrink in {wall:.1f} s: each host's reports over 2 hosts "
        f"{spanned}, then {[m['i'] for m in r.metrics_history]} on one host (world "
        f"{r.metrics.get('world')}, hosts {r.metrics.get('hosts')}); error {r.error}")
    first = hist[0] if hist else None
    if r.error is not None or r.metrics.get("i") != 6 or r.metrics.get("hosts") != 1 or \
            r.metrics.get("world") != [0, 1] or hist != list(range(first, 7)) or \
            spanned[0] != spanned[1] or not spanned[0] or spanned[0][-1] != first - 2:
        raise AssertionError(f"[multihost] (c) {r.error}, {r.metrics}, {hist}, {spanned}")
    return {"wall_s": wall, "reports_over_2_hosts": spanned[0], "resumed_at": first,
            "history": hist}


def flash_shape_timing(dev, B: int, H: int, seed: int, tag: str, where: str) -> dict:
    """The bf16 flash forward at W1's length and head dim, B rows and H
    heads, as W1's encoder (bias, a ragged source key mask) and decoder
    (causal, bias, a label key mask), against its plain version, beside
    its bound (:func:`flash_work`), its plain version's time and one SDPA
    call with the same additive mask.  These calls are not counted."""
    from tpu_air_torch.ops.flash_attention import flash_attention, flash_attention_backward

    counted = flash_counts()
    rng = np.random.default_rng(seed)
    cfg = w1_config()
    L, D, dt = W1_LEN, cfg.d_kv, torch.bfloat16
    rows = {}
    for part, causal in (("encoder", False), ("decoder", True)):
        q, k, v, bias, mask = flash_inputs(rng, B, H, L, D, dt, dev, mask=not causal)
        if causal:      # label key masks that always admit the start position
            lens = rng.integers(16, 129, B)
            lens[0] = L
            mask = torch.from_numpy((np.arange(L)[None] < lens[:, None]).astype(np.float32)
                                    ).to(dev)
        got = flash_attention(q, k, v, bias, kv_mask=mask, scale=1.0, causal=causal)
        want = flash_plain(q, k, v, bias, mask, causal=causal)
        nbytes, flops = flash_work(B, H, L, D, needed_keys(mask, L), causal)
        b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16_FLOP_S)
        lib_mask = bias + ((1.0 - mask) * -1e30)[:, None, None, :]
        if causal:
            lib_mask = lib_mask + torch.full((L, L), -1e30, device=dev).triu(1)
        lib_mask = lib_mask.to(dt)
        rows[part] = {
            "ms": device_ms(lambda: flash_attention(q, k, v, bias, kv_mask=mask, scale=1.0,
                                                    causal=causal), 10),
            "plain_ms": device_ms(lambda: flash_plain(q, k, v, bias, mask, causal=causal), 5),
            "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=lib_mask, scale=1.0), 10),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
            "max_abs_err": max_err(got, want), "tol": TOL[dt],
            "shape": (f"B{B} H{H} L{L} D{D} bf16, bias [1,H,L,L] f32, "
                      + ("causal, label key mask" if causal else "source key mask")
                      + f" ({where})")}
        r = rows[part]
        log(f"{tag} flash_attention {part} {r['shape']}: kernel {r['ms']:.4f} ms device time, "
            f"plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
            f"by {b_by}; kernel against plain {r['max_abs_err']:.3e}")
        if not r["max_abs_err"] < TOL[dt]:
            raise AssertionError(f"{tag} {part} against plain: {r['max_abs_err']}")
        del q, k, v, bias, mask, lib_mask, got, want
        torch.cuda.empty_cache()
    # the comparisons' and timings' launches are not counted
    flash_attention.launches = counted["flash_attention"]
    flash_attention_backward.dq_launches = counted["flash_attention_bwd_dq"]
    flash_attention_backward.dkv_launches = counted["flash_attention_bwd_dkv"]
    return rows


def mh_shard_timing(dev) -> dict:
    """Phase 30 (d): the flash forward at (a)'s replica shard, the shape
    each host launches in its eval (B 2, H 6: a dp 4 x tp 2 replica's 2
    rows and half of T5's 12 heads)."""
    return flash_shape_timing(dev, W1_BATCH // 4, w1_config().num_heads // 2, SEED + 62,
                              "[multihost] (d)", "a dp 4 x tp 2 replica's shard of W1")


def mh_path(dev, work: str, w1_stats: dict) -> dict:
    """Phase 30 (``[multihost]``): two emulated hosts on the one card.  See
    the module docstring."""
    import tpu_air_torch
    from tpu_air_torch import _native
    from tpu_air_torch.core.runtime import get_runtime
    from tpu_air_torch.parallel.distributed import spawn_local_cluster

    t_phase = time.perf_counter()
    one = mh_one_host(dev, work)
    t_one = time.perf_counter()
    cluster = spawn_local_cluster(2, devices_per_process=4)
    try:
        log(f"[multihost] 2 hosts x 4 chip slots on {dev} (host 1: agent pid "
            f"{cluster.procs[0].pid}) in {time.perf_counter() - t_one:.1f} s; the GCS, and with "
            f"it the cross-host object plane, "
            + (f"does not run here: {cluster.gcs_missing} (toolchain: "
               f"{_native.gcs_missing()})" if cluster.gcs_address is None else
               f"runs at {cluster.gcs_address}: nodes {cluster.nodes()}"))
        tpu_air_torch.init(num_cpus=1)
        runtime = get_runtime()
        if (runtime.num_chips, runtime.chips_per_host) != (8, 4):
            raise AssertionError(f"[multihost] runtime slots {runtime.num_chips}, "
                                 f"{runtime.chips_per_host} a host")
        parts = {}
        t = time.perf_counter()
        out = {"a": mh_w1(dev, work, cluster, w1_stats)}
        parts["a"] = time.perf_counter() - t
        t = time.perf_counter()
        out["b"] = mh_parity(dev, work, cluster, one)
        parts["b"] = time.perf_counter() - t + (t_one - t_phase)
        t = time.perf_counter()
        out["c"] = mh_elastic(dev, work)
        parts["c"] = time.perf_counter() - t
    finally:
        tpu_air_torch.shutdown()
        cluster.shutdown()
    t = time.perf_counter()
    out["d"] = mh_shard_timing(dev)
    parts["d"] = time.perf_counter() - t
    out["part_s"] = parts
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[multihost] phase 30 {out['phase_s']:.1f} s: "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in parts.items()))
    return out


# -- training in runtime actors: the probe fit()'s actors run -------------------


def zero_kernel_counts() -> None:
    from tpu_air_torch.ops.decode_attention import decode_attention

    zero_flash_counts()
    decode_attention.launches = 0


def param_digest(model) -> str:
    """sha256 of a model's parameters, each folded exactly on the card: the
    int64 sums (mod 2**64) of its f32 bits as int32 and of those bits times
    their index mod 65521 plus 1, so two ranks' digests are equal only
    where their parameters are, bit for bit, with no copy of ~1 GB to the
    host."""
    import hashlib

    sums = []
    names = []
    for name, p in sorted(model.named_parameters()):
        x = p.detach().float().reshape(-1).view(torch.int32).to(torch.int64)
        w = torch.arange(x.numel(), device=x.device, dtype=torch.int64) % 65521 + 1
        sums.append(torch.stack([x.sum(), (x * w).sum()]))
        names.append(name)
    h = hashlib.sha256()
    for name, (a, b) in zip(names, torch.stack(sums).tolist()):
        h.update(name.encode() + a.to_bytes(8, "little", signed=True)
                 + b.to_bytes(8, "little", signed=True))
    return h.hexdigest()


def actor_probe(inner, step_maker=None, digests: bool = False, die=None):
    """A training function for ``fit()``'s trial actor, or for each rank of
    its worker group: ``inner`` under this run's TF32 settings, with the
    kernels' launch counters set to 0 in that process.  ``step_maker``
    (``"module:function"``) records every step the function builds, its
    loss and its end on the device clock; ``digests`` folds the rank's
    parameters (:func:`param_digest`) at every report; ``die`` =
    ``(rank, report, marker)`` ends that rank's process outright at that
    report once (the marker file says it did).  What the process saw goes
    to ``probe-<rank>-<pid>.json`` in the run's directory: the launches,
    peak memory, steps, digests, its device, lease, group backend, the
    checkpoint it resumed from, and the host clock at the function's start,
    its first step's start and its end."""
    flags = tf32_flags()

    def probe(config):
        import importlib

        import torch.distributed as dist

        from tpu_air_torch.train import session

        backends = getattr(torch, "backends")
        matmul, cudnn = (f == "True" for f in flags.split(","))
        backends.cuda.matmul.allow_tf32 = matmul
        backends.cudnn.allow_tf32 = cudnn
        zero_kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        sess = session.get_session()
        rank = sess.world_rank
        marks, digest_list, patches, first_step = [], [], [], []
        if step_maker:
            mod_name, attr = step_maker.split(":")
            mod = importlib.import_module(mod_name)
            make = getattr(mod, attr)

            def recording(*a, **kw):
                step = make(*a, **kw)

                def rec(*b, **k):
                    if not marks:
                        first_step.append(time.time())
                        marks.append((None, torch.cuda.Event(enable_timing=True)))
                        marks[-1][1].record()
                    loss = step(*b, **k)
                    marks.append((loss, torch.cuda.Event(enable_timing=True)))
                    marks[-1][1].record()
                    return loss
                return rec

            patches.append((mod, attr, make))
            setattr(mod, attr, recording)
        if digests or die:
            from tpu_air_torch.parallel import sharding

            models = []
            shard = sharding.shard_module
            report = session.report

            def keep(model, *a, **kw):
                models.append(model)
                return shard(model, *a, **kw)

            def probed_report(metrics, checkpoint=None):
                n = len(digest_list) + 1
                if die and rank == die[0] and n == die[1] and not os.path.exists(die[2]):
                    open(die[2], "w").close()
                    os._exit(7)
                if digests:
                    digest_list.append(param_digest(models[-1]))
                else:
                    digest_list.append(None)
                return report(metrics, checkpoint)

            patches += [(sharding, "shard_module", shard), (session, "report", report)]
            sharding.shard_module = keep
            session.report = probed_report
        t0 = time.time()
        try:
            return inner(config)
        finally:
            for mod, attr, orig in patches:
                setattr(mod, attr, orig)
            torch.cuda.synchronize()
            out = {"pid": os.getpid(), "rank": rank, "t0": t0, "t1": time.time(),
                   "t_first_step": first_step[0] if first_step else None,
                   "threads": torch.get_num_threads(),
                   "cpus": len(os.sched_getaffinity(0)), "loadavg": os.getloadavg(),
                   "lease": os.environ.get("TPU_AIR_CHIP_IDS"),
                   "device": f"cuda:{torch.cuda.current_device()}",
                   "backend": dist.get_backend() if dist.is_initialized() else None,
                   "resume": config.get("resume_from_checkpoint"),
                   "launches": kernel_counts(),
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "losses": [float(loss) for loss, _ in marks[1:]],
                   "step_ms": [a.elapsed_time(b) for (_, a), (_, b) in zip(marks, marks[1:])],
                   "digests": digest_list}
            with open(os.path.join(sess.run_dir, f"probe-{rank}-{os.getpid()}.json"), "w") as f:
                json.dump(out, f)

    return probe


def probed(trainer, **kw):
    """``trainer`` with its training function run under :func:`actor_probe`."""
    inner = trainer._training_fn()
    trainer._training_fn = lambda: actor_probe(inner, **kw)
    return trainer


@contextlib.contextmanager
def runtime_of(slots: int):
    """A runtime of ``slots`` chip slots for the block: a fit's lease of
    several slots wraps onto the one card."""
    import tpu_air_torch

    tpu_air_torch.init(num_chips=slots)
    try:
        yield
    finally:
        tpu_air_torch.shutdown()


def read_probes(run_dir: str) -> list:
    """The probes a run's processes wrote, oldest first."""
    out = []
    for name in os.listdir(run_dir):
        if name.startswith("probe-") and name.endswith(".json"):
            with open(os.path.join(run_dir, name)) as f:
                out.append(json.load(f))
    return sorted(out, key=lambda p: (p["t0"], p["rank"]))


def summed_launches(probes: list) -> dict:
    out = {}
    for p in probes:
        for k, n in p["launches"].items():
            out[k] = out.get(k, 0) + n
    return out


def pid_alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except OSError:
        return False


def lease_back(runtime, phase: str) -> None:
    if runtime.avail["chip"] != float(runtime.num_chips) or \
            sorted(runtime.free_chips) != list(range(runtime.num_chips)):
        raise AssertionError(f"[{phase}] the lease is not back: avail {runtime.avail}, free "
                             f"{runtime.free_chips}")


# -- phase 31 ---------------------------------------------------------------------


def actors_sweep(dev, work: str, runtime) -> dict:
    """31 (a): ``Tuner(T5Trainer)`` with ``ScalingConfig(num_workers=2,
    use_gpu=True)``: each trial's runner leases 2 slots at once and runs
    its attempt on 2 rank actors placed on them (gloo: both on the card);
    the two ranks' parameters are equal at every report; then generation
    from the best checkpoint through the kernels, equal to the plain path's."""
    from tpu_air_torch import tune
    from tpu_air_torch.models.tokenizer import ByteTokenizer
    from tpu_air_torch.ops.decode_attention import decode_attention
    from tpu_air_torch.ops.flash_attention import flash_attention
    from tpu_air_torch.predict.predictors import T5GenerativePredictor
    from tpu_air_torch.train import (CheckpointConfig, RunConfig, ScalingConfig, T5Trainer,
                                     TrainingArguments)

    class DigestingT5Trainer(T5Trainer):
        def _training_fn(self):
            return actor_probe(super()._training_fn(), digests=True,
                               step_maker=T5_STEP)

    cfg = w1_config()
    storage = os.path.join(work, "actors_sweep")
    args = TrainingArguments(learning_rate=2e-5, weight_decay=0.01,
                             per_device_train_batch_size=W1_BATCH // 2,
                             per_device_eval_batch_size=W1_BATCH // 2,
                             num_train_epochs=ACT_EPOCHS, seed=SEED)
    trainer = DigestingT5Trainer(
        model_config=cfg, training_args=args, tokenizer=ByteTokenizer(W1_LEN),
        datasets={"train": w1_rows(W1_BATCH * W2_STEPS, cfg.vocab_size, SEED + 80),
                  "evaluation": w1_rows(W2_EVAL_ROWS, cfg.vocab_size, SEED + 81)},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=True),
        run_config=RunConfig(storage_path=storage, checkpoint_config=CheckpointConfig(
            num_to_keep=1, checkpoint_score_attribute="eval_loss", checkpoint_score_order="min")))
    space = {"trainer_init_config": {"learning_rate": tune.choice(W2_SPACE["learning_rate"]),
                                     "weight_decay": tune.choice(W2_SPACE["weight_decay"])}}
    t0 = time.perf_counter()
    grid = tune.Tuner(trainer, param_space=space, tune_config=tune.TuneConfig(
        metric="eval_loss", mode="min", num_samples=ACT_SAMPLES, seed=SEED,
        scheduler=tune.ASHAScheduler(max_t=ACT_EPOCHS))).fit()
    sweep_s = time.perf_counter() - t0
    if grid.num_errors or len(grid) != ACT_SAMPLES:
        raise AssertionError(f"[actors] (a) trial errors: {grid.errors}")
    per_epoch = -(-W2_EVAL_ROWS // W1_BATCH) * (cfg.num_layers + 2 * cfg.num_decoder_layers)
    trials, spans, pids = [], [], []
    for i, r in enumerate(grid):
        probes = read_probes(r.path)
        hist = r.metrics_history
        by_rank = {p["rank"]: p for p in probes}
        pids += [p["pid"] for p in probes]
        spans.append((min(p["t0"] for p in probes), max(p["t1"] for p in probes)))
        log(f"[actors] (a) trial {i}: lr {r.config['learning_rate']}, weight decay "
            f"{r.config['weight_decay']}: {len(hist)} of {ACT_EPOCHS} epochs, eval_loss "
            + ", ".join(f"{m['eval_loss']:.4f}" for m in hist) + "; ranks "
            + "; ".join(f"{p['rank']}: pid {p['pid']}, lease {p['lease']}, {p['device']}, "
                        f"{p['backend']}, peak {p['peak_gb']:.2f} GB, launches {p['launches']}, "
                        f"first step {p['t_first_step'] - p['t0']:.1f} s in, step ms (device "
                        "clock, the all-reduce in each) "
                        + ", ".join(f"{x:.0f}" for x in p["step_ms"])
                        + f", function {p['t1'] - p['t0']:.1f} s" for p in probes)
            + f"; digests at each report equal: {by_rank[0]['digests'] == by_rank[1]['digests']}")
        if len(probes) != 2 or set(by_rank) != {0, 1}:
            raise AssertionError(f"[actors] (a) trial {i} probes {probes}")
        if by_rank[0]["digests"] != by_rank[1]["digests"] or \
                len(by_rank[0]["digests"]) != len(hist) or not hist:
            raise AssertionError(f"[actors] (a) trial {i}: the ranks' parameters differ: "
                                 f"{by_rank[0]['digests']} vs {by_rank[1]['digests']}")
        for p in probes:
            if p["device"] != "cuda:0" or p["backend"] != "gloo" or \
                    p["launches"]["flash_attention"] != per_epoch * len(hist) or \
                    p["launches"]["decode_attention"] or p["launches"]["flash_attention_bwd_dq"]:
                raise AssertionError(f"[actors] (a) trial {i} rank {p['rank']}: {p}")
        if [m["steps"] for m in hist] != [W2_STEPS] * len(hist) or \
                any(m["mesh_data"] != 2 for m in hist):
            raise AssertionError(f"[actors] (a) trial {i} history {hist}")
        trials.append({"config": {k: r.config[k] for k in ("learning_rate", "weight_decay")},
                       "epochs_ran": len(hist), "eval_loss": [m["eval_loss"] for m in hist],
                       "digests_equal": True, "ranks": probes})
    overlap = min(e for _, e in spans) - max(s for s, _ in spans)
    launches = summed_launches([p for t in trials for p in t["ranks"]])
    log(f"[actors] (a) Tuner(T5Trainer(ScalingConfig(num_workers=2))) over FLAN-T5-base "
        f"({cfg.d_model} wide, {cfg.num_layers}+{cfg.num_decoder_layers} layers, dropout "
        f"{cfg.dropout_rate}, bf16 on f32), global batch {W1_BATCH} x {W1_LEN}/{W1_LEN} as 2 x "
        f"{W1_BATCH // 2}, {ACT_SAMPLES} trials of up to {ACT_EPOCHS} epochs of {W2_STEPS} "
        f"steps, ASHA(max_t={ACT_EPOCHS}): sweep wall {sweep_s:.1f} s, the trials' ranks ran "
        f"together for {overlap:.1f} s; ranks' launches {launches}")
    if overlap <= 0:
        raise AssertionError(f"[actors] (a) the trials did not run at once: {spans}")
    lease_back(runtime, "actors")
    if [p for p in pids if pid_alive(p)]:
        raise AssertionError(f"[actors] (a) rank processes left: {pids}")
    best = grid.get_best_result()
    predictor = T5GenerativePredictor.from_checkpoint(best.checkpoint, dtype="bfloat16",
                                                      device=dev, tokenizer=IdTokenizer())
    ids, mask = prompts(W1_PROMPTS, W1_LEN, cfg.vocab_size, SEED + 82)
    batch = {"input_ids": ids, "attention_mask": mask}
    flash_attention.launches = decode_attention.launches = 0
    t0 = time.perf_counter()
    out = predictor.predict(batch, max_new_tokens=W1_NEW)["generated_output"].tolist()
    gen_s = time.perf_counter() - t0
    gen = {"flash_attention": flash_attention.launches,
           "decode_attention": decode_attention.launches}
    with plain_attention():
        plain = predictor.predict(batch, max_new_tokens=W1_NEW)["generated_output"].tolist()
    if (flash_attention.launches, decode_attention.launches) != tuple(gen.values()):
        raise AssertionError("[actors] (a) the plain path launched kernels")
    dsteps = gen["decode_attention"] // (2 * cfg.num_decoder_layers)
    log(f"[actors] (a) best trial (lr {best.config['learning_rate']}, weight decay "
        f"{best.config['weight_decay']}, eval_loss {best.metrics['eval_loss']:.4f}): "
        f"{W1_PROMPTS} prompts x {W1_LEN} -> {W1_NEW} new tokens in {gen_s:.2f} s, {dsteps} "
        f"decode steps, launches {gen}; tokens equal to the plain path's: {out == plain}")
    if gen["flash_attention"] != cfg.num_layers or gen["decode_attention"] <= 0 or \
            gen["decode_attention"] != dsteps * 2 * cfg.num_decoder_layers or out != plain:
        raise AssertionError(f"[actors] (a) generation: launches {gen}, tokens equal "
                             f"{out == plain}")
    del predictor
    torch.cuda.empty_cache()
    return {"sweep_wall_s": sweep_s, "trials_overlap_s": overlap, "trials": trials,
            "generate_s": gen_s, "decode_steps": dsteps,
            "launches": {"ranks": launches, "generate": gen}}


def actors_fit_crash(dev, work: str, runtime) -> dict:
    """31 (b): ``T5Trainer.fit()`` over 2 rank actors at W1's width; rank 1
    dies outright at its report ACT_DIE_AT; the retry resumes from that
    report's checkpoint and ends; the lease is back and no rank's process
    is left."""
    from tpu_air_torch.models.tokenizer import ByteTokenizer
    from tpu_air_torch.train import (CheckpointConfig, FailureConfig, RunConfig, ScalingConfig,
                                     T5Trainer, TrainingArguments)

    cfg = w1_config()
    storage = os.path.join(work, "actors_fit")
    marker = os.path.join(work, "actors_fit_died")
    args = TrainingArguments(learning_rate=2e-5, weight_decay=0.01,
                             per_device_train_batch_size=W1_BATCH // 2,
                             per_device_eval_batch_size=W1_BATCH // 2,
                             num_train_epochs=ACT_FIT_EPOCHS, max_steps_per_epoch=1, seed=SEED)
    trainer = probed(T5Trainer(
        model_config=cfg, training_args=args, tokenizer=ByteTokenizer(W1_LEN),
        datasets={"train": w1_rows(W1_BATCH, cfg.vocab_size, SEED + 83),
                  "evaluation": w1_rows(W1_BATCH, cfg.vocab_size, SEED + 84)},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=True),
        run_config=RunConfig(storage_path=storage, name="fit",
                             checkpoint_config=CheckpointConfig(num_to_keep=1),
                             failure_config=FailureConfig(max_failures=1))),
        die=(1, ACT_DIE_AT, marker), step_maker=T5_STEP)
    t0 = time.perf_counter()
    result = trainer.fit()
    wall = time.perf_counter() - t0
    probes = read_probes(result.path)
    first = [p for p in probes if p["resume"] is None]
    retry = [p for p in probes if p["resume"] is not None]
    hist = result.metrics_history
    log(f"[actors] (b) T5Trainer(ScalingConfig(num_workers=2)).fit() at FLAN-T5-base width, "
        f"{ACT_FIT_EPOCHS} one-step epochs of {W1_BATCH} x {W1_LEN}, rank 1 dying outright at "
        f"its report {ACT_DIE_AT}, FailureConfig(max_failures=1): error {result.error}, "
        f"{wall:.1f} s; the first attempt's ranks {[(p['rank'], p['pid']) for p in first]} "
        f"(rank 1 left no probe: it died), the retry's {[(p['rank'], p['pid']) for p in retry]} "
        f"resumed from {os.path.basename(retry[0]['resume']) if retry else None}; rank 0's "
        f"functions ran " + ", ".join(f"{p['t1'] - p['t0']:.1f} s (first step "
                                      f"{p['t_first_step'] - p['t0']:.1f} s in)"
                                      for p in probes if p["rank"] == 0) + "; history "
        + ", ".join(f"{m['epoch']}: loss {m['loss']:.4f} eval_loss {m['eval_loss']:.4f}"
                    for m in hist))
    if result.error is not None or not os.path.exists(marker):
        raise AssertionError(f"[actors] (b) {result.error}, died {os.path.exists(marker)}")
    if len(first) != 1 or first[0]["rank"] != 0 or len(retry) != 2 or \
            any(not p["resume"].endswith(f"checkpoint_{ACT_DIE_AT:06d}") for p in retry) or \
            len(hist) != ACT_FIT_EPOCHS:
        raise AssertionError(f"[actors] (b) probes {probes}, history {hist}")
    lease_back(runtime, "actors")
    left = [p["pid"] for p in probes if pid_alive(p["pid"])]
    if left:
        raise AssertionError(f"[actors] (b) rank processes left: {left}")
    log("[actors] (b) afterwards the runtime's 4 slots are free and no rank's process is left")
    return {"wall_s": wall, "resumed_from": os.path.basename(retry[0]["resume"]),
            "history": [{k: m[k] for k in ("epoch", "loss", "eval_loss")} for m in hist],
            "launches": summed_launches(probes)}


def actors_parity(dev, work: str) -> dict:
    """31 (c): one f32 step of W1's model at [w1 parity]'s cut depth,
    dropout 0, over 2 rank actors (each half the batch, the gradients
    all-reduced over gloo) against 1 rank at the whole batch: the losses
    within 1e-6 relative, the parameters within 1e-6 in norm."""
    from tpu_air_torch.train import RunConfig, ScalingConfig, T5Trainer, TrainingArguments

    import threading

    cfg = w1_config("float32", W1_PARITY_LAYERS, dropout=0.0)
    rows = w1_rows(W1_BATCH, cfg.vocab_size, SEED + 85)
    results = {}

    def fit(workers):
        args = TrainingArguments(learning_rate=2e-5, weight_decay=0.01,
                                 per_device_train_batch_size=W1_BATCH // workers,
                                 num_train_epochs=1, evaluation_strategy="no", seed=SEED)
        results[workers] = probed(T5Trainer(
            model_config=cfg, training_args=args, datasets={"train": rows},
            scaling_config=ScalingConfig(num_workers=workers, use_gpu=True),
            run_config=RunConfig(storage_path=os.path.join(work, f"actors_parity{workers}"))),
            step_maker=T5_STEP).fit()

    # both fits at once: 3 of the runtime's 4 slots
    threads = [threading.Thread(target=fit, args=(w,)) for w in (2, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    runs = {}
    for workers in (2, 1):
        result = results.get(workers)
        if result is None or result.error is not None:
            raise AssertionError(f"[actors] (c) {workers} ranks: "
                                 f"{None if result is None else result.error}")
        runs[workers] = (result.metrics["loss"], result.checkpoint.get_params(),
                         summed_launches(read_probes(result.path)))
    (l2, p2, n2), (l1, p1, n1) = runs[2], runs[1]
    loss_rel = abs(l2 - l1) / abs(l1)
    flat2 = torch.cat([p2[k].reshape(-1).double() for k in sorted(p1)])
    flat1 = torch.cat([p1[k].reshape(-1).double() for k in sorted(p1)])
    param_rel = float((flat2 - flat1).norm() / flat1.norm())
    errs = {k: norm_err(p2[k], p1[k]) for k in p1}
    worst = max(errs, key=errs.get)
    log(f"[actors] (c) f32, {cfg.d_model} wide, depth cut to {cfg.num_layers}+"
        f"{cfg.num_decoder_layers}, dropout 0, one step of {W1_BATCH} x {W1_LEN}: 2 ranks loss "
        f"{l2:.7f}, 1 rank {l1:.7f} (rel diff {loss_rel:.2e}); parameters ||2 - 1|| / ||1|| "
        f"{param_rel:.2e} (worst tensor {worst} {errs[worst]:.2e}); launches 2 ranks {n2}, 1 "
        f"rank {n1}")
    if not (loss_rel < 1e-6 and param_rel < 1e-6):
        raise AssertionError(f"[actors] (c) loss rel {loss_rel}, parameters {param_rel}")
    del p1, p2, flat1, flat2
    torch.cuda.empty_cache()
    return {"loss_rel_diff": loss_rel, "param_norm_rel_diff": param_rel,
            "param_worst_tensor": worst, "param_worst_tensor_rel": errs[worst],
            "launches": summed_launches([{"launches": n2}, {"launches": n1}])}


def actors_shard_timing(dev) -> dict:
    """31 (d): the flash forward at the shape each rank of (a) and (b)
    launches in its eval (B 4, H 12: half of W1's batch, every head)."""
    return flash_shape_timing(dev, W1_BATCH // 2, w1_config().num_heads, SEED + 86,
                              "[actors] (d)", "a rank's half of W1's eval batch")


def actors_path(dev, work: str) -> dict:
    """Phase 31 (``[actors]``): training in runtime actors, in a runtime of 4
    chip slots on the one card.  See the module docstring."""
    import tpu_air_torch
    from tpu_air_torch.core.runtime import get_runtime

    t_phase = time.perf_counter()
    tpu_air_torch.init(num_chips=4)
    parts, out = {}, {}
    try:
        runtime = get_runtime()
        for key, fn in (("a", lambda: actors_sweep(dev, work, runtime)),
                        ("b", lambda: actors_fit_crash(dev, work, runtime)),
                        ("c", lambda: actors_parity(dev, work))):
            t = time.perf_counter()
            out[key] = fn()
            parts[key] = time.perf_counter() - t
    finally:
        tpu_air_torch.shutdown()
    t = time.perf_counter()
    out["d"] = actors_shard_timing(dev)
    parts["d"] = time.perf_counter() - t
    out["part_s"] = parts
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[actors] phase 31 {out['phase_s']:.1f} s: "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in parts.items()))
    return out


def add_actor_rows(kernels: list, actors: dict) -> None:
    """Phase 31's launches (the sweep's ranks and its generation, and the
    fits' ranks of (b) and (c)) into the kernels' rows, and (d)'s rank
    shape timings into the flash forward's."""
    next(r for r in kernels if r["name"] == "flash_attention")["actors_rank_eval"] = actors["d"]
    for r in kernels:
        by = r.setdefault("launches_by_path", {})
        sweep = actors["a"]["launches"]
        by["actors_sweep"] = (sweep["ranks"].get(r["name"], 0)
                              + sweep["generate"].get(r["name"], 0))
        by["actors_fit"] = (actors["b"]["launches"].get(r["name"], 0)
                            + actors["c"]["launches"].get(r["name"], 0))
        r["launches"] += by["actors_sweep"] + by["actors_fit"]


def add_mh_rows(kernels: list, mh: dict) -> None:
    """Phase 30's launches (both hosts' fits and the generation after (a))
    into the kernels' rows, and (d)'s replica-shard timings into the flash
    forward's."""
    fwd = next(r for r in kernels if r["name"] == "flash_attention")
    fwd["multihost_replica_shard"] = mh["d"]
    for r in kernels:
        by = r.setdefault("launches_by_path", {})
        for where, n in (("multihost_w1_hosts_generate", mh["a"]["launches"]),
                         ("multihost_f32_hosts", mh["b"]["launches"])):
            by[where] = n.get(r["name"], 0)
            r["launches"] += by[where]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on the card",
              file=sys.stderr)
        return 2
    import tpu_air_torch  # noqa: F401  (fails outside a checkout of the repo)

    if not adopt_orphans():
        log("[processes] prctl(PR_SET_CHILD_SUBREAPER) refused: only the processes "
            "still under this one are stopped at the end")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        return run_phases(dev, work, t_start)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_phases(dev, work: str, t_start: float) -> int:
    import tpu_air_torch
    from tpu_air_torch import serve

    smi = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    built = build()
    errs = compare(dev)
    main_stats = main_path(dev)
    main_stats["parity"] = parity(dev)
    kernels = timing(dev, errs, main_stats["launches"])
    bwd_errs = compare_backward(dev)
    lm_stats = lm_main_path(dev, os.path.join(work, "lm_run"))
    lm_stats["parity"] = lm_parity(dev)
    kernels = lm_timing(dev, kernels, bwd_errs, lm_stats, built)
    w1_stats = w1_main_path(dev)
    w1_stats["parity"] = w1_parity(dev)
    kernels = w1_timing(dev, kernels, errs, w1_stats)
    errs16 = compare(dev, (torch.float16,), "f16 compare")
    errs16.update(compare_backward(dev, (torch.float16,), "f16 compare"))
    kernels = f16_timing(dev, kernels, errs16, errs16, built)
    # last: once its scoring actor has used the card, this process's
    # profiler lost kernel records (complete_profile)
    batch_stats = batch_path(dev, os.path.join(work, "w3_ckpt"))
    for r in kernels:       # the W3 batch path's launches, counted in its scoring actor
        n = batch_stats["launches"].get(r["name"], 0)
        r.setdefault("launches_by_path", {})["w3_batch_actor"] = n
        r["launches"] += n
    w2_stats = w2_path(dev)
    for r in kernels:       # W2: its trials' launches (in their actors) and its generation's
        for where in ("w2_trial_actors", "w2_generate"):
            n = w2_stats["launches"][where].get(r["name"], 0)
            r["launches_by_path"][where] = n
            r["launches"] += n
    w7_stats = w7_path(dev)
    w6_stats = w6_path(dev)
    w6_stats["parity"] = w6_parity(dev)
    for r in kernels:       # SegFormer runs no attention kernel (both phases check it)
        r["launches_by_path"]["w7_in_process"] = w7_stats["launches"][r["name"]]
        r["launches_by_path"]["w6_fit"] = w6_stats["launches"][r["name"]]
    t_serve = time.perf_counter()
    tpu_air_torch.init()
    try:
        port = free_port()
        w8_stats = w8_path(port)
        serve_stats = serve_t5_path(dev, os.path.join(work, "w3_ckpt"), port)
        serve_stats["parity"] = serve_t5_parity(dev, work, port)
        lm_serve_stats = lm_serve_path(dev, lm_stats["checkpoint_dir"], port)
        lm_live_stats = lm_live_path(dev, lm_stats["checkpoint_dir"], free_port(), work,
                                     lm_serve_stats)
    finally:
        serve.shutdown()
        tpu_air_torch.shutdown()
    log(f"[serve] phases 20-23 (runtime start and stop included) "
        f"{time.perf_counter() - t_serve:.1f} s")
    obs_stats = obs_serve_path(dev, lm_stats["checkpoint_dir"], work, lm_serve_stats)
    lane_stats = batch_lane_path(dev, lm_stats["checkpoint_dir"], lm_serve_stats)
    native_stats = native_path(dev)
    ring_stats = ring_path(dev, work)
    add_ring_rows(kernels, ring_stats)
    dist_stats = dist_path(dev, lm_stats["checkpoint_dir"], lm_serve_stats)
    tp_stats = tp_path(dev, work, lm_stats, w1_stats)
    mh_stats = mh_path(dev, work, w1_stats)
    actor_stats = actors_path(dev, work)
    del lm_serve_stats["burst_tokens"]
    kernels = lm_serve_timing(dev, kernels, lm_serve_stats)
    row = next(r for r in kernels if r["name"] == "decode_attention")
    for where, n in lm_live_stats["launches"].items():   # phase 23's, in process and replica
        row["launches_by_path"][where] = n
        row["launches"] += n
    row["launches_by_path"]["obs_serve_replica"] = obs_stats["launches"]["decode_attention"]
    row["launches"] += obs_stats["launches"]["decode_attention"]
    row["launches_by_path"]["batch_lane_replicas"] = lane_stats["launches"]["decode_attention"]
    row["launches"] += lane_stats["launches"]["decode_attention"]
    add_dist_rows(kernels, dist_stats)
    add_tp_rows(kernels, tp_stats)
    add_mh_rows(kernels, mh_stats)
    add_actor_rows(kernels, actor_stats)
    for r in kernels:       # the serve path's launches, counted in its replicas
        for where in ("predictor", "engine"):
            n = serve_stats[where]["launches"].get(r["name"], 0)
            r["launches_by_path"][f"serve_t5_{where}_replica"] = n
            r["launches"] += n
    stop_processes()
    log("[processes] every process this run started has exited")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels, "main": main_stats, "lm": lm_stats, "w1": w1_stats,
                      "batch": batch_stats, "w2": w2_stats, "w7": w7_stats, "w6": w6_stats,
                      "w8": w8_stats, "serve_t5": serve_stats, "lm_serve": lm_serve_stats,
                      "lm_live": lm_live_stats, "obs_serve": obs_stats,
                      "batch_lane": lane_stats, "native": native_stats,
                      "ring": ring_stats, "dist": dist_stats, "tp": tp_stats,
                      "multihost": mh_stats, "actors": actor_stats}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:  # a failed phase too leaves no process behind
        stop_processes()
    sys.exit(rc)
