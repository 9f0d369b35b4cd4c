#!/usr/bin/env python3
"""Drive the PyTorch port (`ray_lightning_tpu_torch`) on one CUDA card.

Phases, each of which raises (and so exits nonzero) on failure:

  1. device  — a CUDA card is required; prints ``nvidia-smi``'s name and
               power limit.
  2. build   — compiles the six CUDA sources of ``ops/csrc`` (one nvcc
               per source, all at once), timed.
  3. kernels — each kernel's wrapper on card tensors at the serving and
               training shapes of Llama-3-8B, in bf16, against its plain
               PyTorch version on the same inputs, plus the masking edge
               cases (for the decode: pads, a slot that sees nothing, a
               poisoned scratch block, two calls that must be bitwise
               equal, one CUDA launch a call; for the prefill: two-row
               chunks whose pad covers whole ranges of its split walk or
               falls inside one, pad columns, a poisoned scratch block);
               the flash forward (O, lse) and both backward passes (dQ;
               dK, dV) at the training shape causal and full, a query
               shard at an offset, MHA, a short sequence, head dim 64,
               and queries that see no key (held to exact zeros);
               RMSNorm at N 4, 128 and 4096, with f32 and bf16 gains and
               at a D with a scalar tail; the RMSNorm gradient. One JSON
               line per timed shape with the kernel's, the plain
               version's and one library call's time (and, for flash,
               the two backward kernels' together), the least time the
               card could take, the max error and the worst share of the
               tolerance used; for the decode and RMSNorm also the host
               microseconds of one wrapper call. Then, untimed, every
               other shape the kernels' gates admit that the serving and
               training shapes do not cover (decode and prefill: hd 64,
               other GQA ratios, block sizes 5 / 24 / 32, lengths 0 and
               1, a ragged chunk; flash: ragged lengths 1000 / 65 / 1
               causal, full and at an offset, B 1, n_rep 2).
  4. serve   — Llama-3-8B at full width, 16 of its 32 layers
               (``--layers``; random weights from a seeded
               generator), served by `Scheduler` + `DecodeEngine` through
               the kernel lanes: 8 requests, prompts of 200-1500 tokens,
               32 new tokens each, half greedy and half sampled. Every
               kernel's launch counter is zeroed just before and read
               just after, and must match the count the run implies. The
               greedy half is then served again through the reference
               lanes on the same weights, teacher-forced along the kernel
               lanes' tokens, and the logits of every step are compared.
  5. train   — Llama-3-8B at full width, 4 layers, seq 2048, batch 2
               (random f32 master weights from a seed): 8 AdamW steps
               through `Trainer.fit` with `SingleDevice`, fused CE, block
               remat, and the trainer's defaults: batches prefetched two
               ahead on a side stream and a warm start (one forward and
               backward before the loop). The launch counters are zeroed
               before and read after, and must match the counts the run
               implies, the warm-up's forward and backward counted; the
               loss must fall. The same 8 steps are then run from the same
               weights through the reference lanes
               (`dispatch.force_reference`), which must launch no kernel,
               and loss and grad_norm are compared at every step.
               Last, the kernel-lanes fit runs once more with its last
               steps under `torch.profiler`.
  6. dist    — training across processes on the card (one rank: NCCL
               refuses two ranks on one card): (a) phase 5's fit through
               `fit_distributed(num_processes=1)` under
               ``FSDP(overlap="on")`` in a worker process that a
               `LoopbackTransport` starts (10 (b)); (b) the same fit
               under `DataParallel` in this process (a one-rank NCCL
               group the strategy starts); (c) a
               `fit_distributed` run that saves at step 4
               (`ModelCheckpoint`, 23 GB of f32 weights and AdamW moments,
               the script's one save of this size: the card's machine may
               write 45 GiB a run; `checkpoint.io` writes it from
               eight threads, one a GiB of a rank's share, at most eight),
               with the bytes and the save and verify seconds; 14 (a)
               and 8 (a) resume it; (d) the
               reference's MNIST matrix: fit with
               `EarlyStopping` and `ModelCheckpoint` under `RayXlaPlugin`,
               predict from the best checkpoint in a worker, load it here
               and predict again. Every fit's per-step loss and grad_norm
               must equal phase 5's single-device kernel lane exactly (the
               same kernels at world size 1), and every fit's kernel
               launches (counted in the worker, sent back over the side
               channel) must match the counts its steps imply.
  7. sweep   — `sweep.run` on the card's pool (the probe finds one card,
               so one trial at a time, each in its own process pinned by
               ``CUDA_VISIBLE_DEVICES``): (a) two Llama trials of phase
               5's fit at lr 3e-4 and 0, each validating one
               held-out batch every 2 steps and reporting its loss under
               ASHA (max_t 4, grace 1, factor 2). The lr-3e-4 trial's
               rows must equal phase 5's kernel lane exactly; ASHA must
               stop the lr-0 arm, and every status must equal a replay of
               the recorded reports through a fresh scheduler; each
               trial's launches (counted in its process) must match its
               steps and validation passes; each must see card 0 only,
               and the card as free as the first did. (b) the reference's
               Tune example at one card: three MNIST trials (lr 3e-5, 0,
               1e-4), each a `fit_distributed` worker under
               `RayXlaPlugin(use_gpu=True)` reporting through the trial
               with `TuneReportCheckpointCallback`, under ASHA over the
               epochs: the lr-0 arm must be stopped (the verdict raises
               in its trial's pump), no trial's worker may still run as
               the trial returns, the same checks of card, order, free
               memory and replay as (a); the best checkpoint must
               verify, load on the card with no device given, and give
               the accuracy and validation loss its trial reported,
               where no other report lies within the loss tolerance. One
               JSON line per trial (status, iterations, wall, the start
               split, step time, peak memory, free memory at its start)
               and one per sweep (wall, the report round trip).
  8. resilience — (a) phase 5's fit under `FSDP` through
               `fit_distributed(resilience=ResilienceConfig(...))` in one
               supervised worker whose checkpoint directory holds phase 6
               (c)'s step-4 checkpoint (hard links), resumed from it,
               SIGKILL'd by the fault injector at step 6 and resumed from
               it again (no save): two attempts, steps 5-6 and 5-8 equal
               to phase 5's kernel lane bitwise,
               the card as free at the second start as at the first, each
               attempt's launches (sent per step from the worker) as its
               steps imply, with the save, restore and relaunch seconds;
               (b) the trainguard in this process: phase 5's fit guard
               off and on under ``set_sync_debug_mode("warn")`` (rows
               equal to phase 5's, no more synchronising calls guarded),
               then 8 masked batches against 9 whose extra batch is
               poisoned with a NaN at step 3 (one skipped update; every
               kept update and the final weights bitwise the clean
               run's); (c) one supervised MNIST run (`RayXlaPlugin(
               use_gpu=True)`) through a preemption at step 3, a hang at
               6 caught by the stall watchdog and a corrupted newest
               checkpoint plus a kill at 9, whose resumes start at steps
               4, 6 and 6 and whose final weights equal an uninterrupted
               supervised run's bitwise; a ``raise`` that fails as FATAL
               after one attempt; no worker left running; (d) the
               parameter digest of the trained weights on the card, timed,
               against numpy's digest of the same bytes on the host.
  9. telemetry — (a) right after phase 5, its fit three times more in
               this process: telemetry off and on, both under
               ``set_sync_debug_mode("warn")`` (the same synchronising
               calls), then with telemetry and a `ProfileConfig` window
               of steps 5-6. Every fit's rows equal phase 5's bitwise and
               its launches phase 5's; a span file with 8 dispatch and 8
               step spans and a goodput ledger whose buckets sum to its
               wall; one capture, not disarmed, whose session and
               exported Chrome trace hold the flash forward, dK/dV, dQ
               and RMSNorm kernels as often as two steps launch them.
               (b) inside phase 4, its model and requests again with a
               live `MetricsRegistry` and `FlightRecorder`: greedy
               streams equal to phase 4's, the same launches a tick,
               counters equal to ground truth, TTFT and TPOT p50 within a
               bucket of the host medians, the flight ring's last tick,
               the directory's aggregate; the host ms a tick with and
               without. (c) phase 8's supervised runs with telemetry on
               (the default; (a)'s ledger every step): the goodput of
               each, its buckets summing to the supervised wall, in (a)
               the replayed steps 5-6 in ``rollback_replay_s`` and both
               workers' setup in ``launch_s``; ``python -m
               ray_lightning_tpu_torch timeline`` over (c)'s faulted run
               with events from every ledger and a valid Chrome trace.
               (d) after the card's name, the bf16 matmul probe beside
               the spec-sheet peak.
 10. hot loop and remote — (a) in phase 5's process, its fit as the
               default (prefetched, warm-started) lane and as the
               synchronous one (``prefetch_to_device=0, warm_start=
               False``): rows bitwise equal to phase 5's, each lane's
               step time, first step's wall, ``compile_time_s``,
               prefetch occupancy and wait, and peak (the prefetched
               lane's may exceed the other's only by its buffers); (b)
               inside phase 6, as its (a): phase 5's fit through
               ``fit_distributed(FSDP(overlap="on"), hosts=["localhost"],
               transport=LoopbackTransport())`` in one worker: rows
               bitwise phase 5's, launches phase 5's, the worker on
               ``cuda:0`` of the visible set with no driver-only variable
               in its environment, the call's wall;
               (c) ``python -m ray_lightning_tpu_torch perf --smoke`` on
               the card through the CLI's entry point in this process,
               its JSON line. Phase 8 also prints each
               supervised attempt's ``compile_s`` beside its first step's
               wall, and every attempt of (a) must book one.
 11. serving front end — (a) inside phase 4, its model and requests
               through ``ServeDriver(n_replicas=2, backend="inline")``:
               every stream bitwise phase 4's, the launches phase 4's
               formula over both replicas' ticks and chunks, every
               request's spans and a merged completion histogram of 8;
               (a') the live session on the same model (start with one
               replica, submit half, `add_replica`, submit the rest,
               remove replica 0 gracefully while it holds work, stop):
               streams bitwise (a)'s; (b) phase 4's greedy prompts
               through `generate` (the flash forward: L launches a
               prefill), the kernel lane against `force_reference()`
               lanes teacher-forced along its tokens, logits within
               ``LOGIT_TOL``, and how many tokens agree with phase 4's
               streams (not gated: the attention paths round
               differently in bf16); (c) after phase 4, 4 layers: two
               process replicas on the card loading a params file,
               replica 1 SIGKILL'd mid-stream: ``restarts == {0: 0, 1:
               1}``, a ``flight.json`` with the classification, every
               stream bitwise an inline driver's at the same weights in
               this process; each replica start's import, load, warm-up
               and kernel-library seconds.
 12. planner and tensor axis — (a) phase 5's fit against its plan
               (`plan_train_memory`, the card's kind): parameter and
               optimizer bytes equal the fitted trainer's storage to the
               byte, the plan's total at least the fit's peak, the
               table's memory at most the card's ``total_memory``; (b)
               after phase 10 (a), `find_max_local_batch`'s batch at S
               2048 trained 2 steps in this process: no OOM, its peak
               within the plan, tokens/s; (c) two processes on the card,
               each a rank of ``ShardedMesh(tensor=2)`` joined over gloo
               with CUDA tensors, phase 5's fit (8 steps): per-step loss
               and grad_norm within the train limits of phase 5's rows,
               each rank's flash and RMSNorm launches by phase 5's
               formula at H 16 / Hkv 4, its parameter and optimizer bytes
               equal to the plan's; then, on the same ranks, 16 (b)'s
               BERT-base fit under ``ShardedMesh(tensor=2)`` for
               ``TP_BERT_STEPS`` steps (6 heads a rank; each rank's
               flash launches by 16 (b)'s formula, its bytes the plan's;
               16 (b) holds its rows against its own kernel lane); a
               correctness lane, not a speed (every all-reduce crosses
               the host); (d) phases 6-8 and
               10 (b) build their FSDP models on the meta device and
               stay bitwise phase 5's; 6 (a)'s worker prints its init
               path and the init's peak. ``FLASH_OWED`` holds the
               tensor-parallel heads (tp 2, tp 8) and the check adds
               (b)'s batch, held on two of its rows, and the RMSNorm
               at every row of (b)'s batch (B_max x 2048 at D 4096,
               f32 gain). ``phase12_s`` in
               the ``timing`` line.
 13. the rest of serving — (a) inside phase 4, its greedy requests
               through an inline ``ServeDriver`` session whose replica
               drafts with an independent 4-layer Llama-3-8B (bf16,
               another seed) at ``DraftConfig(k=4)``: each stream phase
               4's token for token but where the plain lane's top-2
               margin at the first parting is under ``LOGIT_TOL`` (printed
               with its step), the launches by the speculative formula
               (no paged kernel; RMSNorm 2L+1 a target call, 2L'+1 a
               draft call), the draft's live weight and pool bytes equal
               to `speculative_plan`'s, ``accepted_tokens_per_step``,
               tokens/s, TPOT and the peak; (b) a 2-layer full-width
               f32 model drafting for itself on 2 greedy requests:
               ``accepted_tokens_per_step == 4`` (a rejection only where
               the f32 plain lane's margin is under 1e-4 of its largest
               logit, printed) and the streams those of the base engine's
               f32 reference lanes; the RMSNorm kernel on f32 rows first
               held at the lane's row counts; (c) inside phase 11 (c),
               its params file and requests through a live session on a
               ``tp=2`` process replica (two ranks sharing the card over
               gloo, H 16 / Hkv 4 a rank): streams 11 (c)'s one-card ones
               under (a)'s margin rule (a sampled request's margin taken
               on its Gumbel-perturbed scores, the bound over its
               temperature), each rank's launches by phase 4's formula
               and its weight, pool and logits bytes equal to
               `serve_memory_summary(tp=2)`'s; a correctness lane, not a
               speed; (d) phase 4's serve plan against its engine: the
               weights, the pool and ``last_logits`` to the byte, the
               gathered view the kernels retire above the kernel lanes'
               peak increment, the verdict lines; (e) ``serve llama3-8b
               --autotune`` at phase 4's geometry (block sizes 8-256 at
               span 4096), every candidate's kernels held against their
               plain versions here as well as by the sweep, each
               candidate's times, and the winner's engine serving one of
               phase 4's greedy requests as phase 4 did (the margin
               rule). ``DECODE_OWED``/``PREFILL_OWED`` hold the tp 2
               heads and block sizes 8, 64, 128 and 256. ``phase13_s``
               in the ``timing`` line.
 14. elastic, autoscale and trace load — (a) inside phase 6 (c),
               its step-4 checkpoint (FSDP, world 1) resumed by two
               processes on the card, each a rank of
               ``ShardedMesh(tensor=2)`` over gloo, through steps 5-8:
               before step 5 each rank's live state, gathered into
               canonical rows, equal to the checkpoint's bytes piece by
               piece (the pieces its restore read, position-weighted
               digests: parameters, both AdamW moments and their step
               counts; the scheduler and the step), the move summary
               ``["tensor"]`` world 1 -> 2, a ``reshard`` span and
               goodput ``reshard_s`` on each rank, rows within the train
               limits of phase 6 (a)'s rows (phase 5's bitwise), launches
               by phase 5's formula at H 16 / Hkv 4 (the way back, a
               tensor-rank checkpoint restored on one FSDP rank, is held
               on the CPU only: a second 23 GB save would pass the 45
               GiB the card's machine may write a run); (c)
               inside phase 4, its model: a seeded MMPP trace
               (``AUTOSCALE_TRACE``, 24 requests, prompts 128-1536)
               through `loadgen.run_trace` and an inline
               ``ServeDriver(n_replicas=1)`` with traffic classes under
               an `AutoscaleController` (the CLI's ramp policy, cooldowns
               in ticks): exactly one scale-up 1 -> 2 and one scale-down
               2 -> 1 in ``autoscale.jsonl``, each acted with its signal
               snapshot; every rid completed or shed with a typed record,
               no latency-critical shed; every completed stream the same
               trace's through a fixed one-replica driver (phase 13's
               margin rule); launches by phase 4's formula over both
               replicas' ticks and chunks; the ``report`` CLI's autoscale
               section and the ``timeline`` CLI's merge of the ledger;
               per-class TTFT, the shed fraction, tokens/s; (d) after 11
               (c), on its params file and requests: a live session of
               one process replica that an `AutoscaleController` grows
               to two under a scripted burst, ``scale_up_s`` and the new
               replica's start split, both replicas serving, every
               stream 11 (c)'s inline one (phase 13's margin rule). Phase 8 (a) runs with
               ``elastic=ElasticBudget(max_world=2)`` over a capacity
               oracle whose probe file says 1: its rows still phase 5's,
               exactly one ``grow_refused`` entry (source ``file``) in
               its result, its ``reshards.jsonl`` and the report.
               ``phase14_s`` in the ``timing`` line.
 15. the Llama path's knobs — after phase 12: (a) the AdamW kernel
               (``ops/csrc/adamw.cu``, a bf16 first moment) on phase 5's
               27 parameters (1.92 G elements, seeded) against its plain
               version on copies, at steps 1 and 100: a step with
               ``found_inf`` 1 leaves both lanes bitwise as they were,
               a real one gives the moments bitwise and the parameters
               within 1 ulp; timed beside its bound (24 bytes an element)
               and ``torch._fused_adamw_`` (f32 moments) on the same
               tensors; (b) phase 5's fit with ``LlamaModule(mu_dtype=
               torch.bfloat16)``, ``remat_policy="attn_out"`` and
               ``ce_inline_bwd=True``, kernel lane against reference lane
               within ``TRAIN_LOSS_TOL`` / ``TRAIN_GNORM_RTOL``, 4 flash
               forward launches a step (8 under "nothing") and one AdamW
               launch, ``exp_avg`` bf16, the optimizer's live bytes and
               the parameters' equal to the plan's to the byte, the peak
               under the plan's total; (c) one forward and backward of
               the model under "dots" against no remat (the same
               projection GEMMs in the backward; "nothing" runs more),
               then 2-step fits under "dots" (within the train limits of
               phase 5's rows) and, under ``FSDP`` with the bf16 first
               moment, with tied embeddings (no ``lm_head``, every
               parameter and moment a DTensor whose local shard the
               AdamW kernel steps, the parameters' and the optimizer's
               bytes the plan's); (d) the Llama example, the slice's
               entry point, through its ``main``: the 1B model at B 2,
               S 2048 for 2 steps with ``--mu-bf16 --remat-policy
               attn_out --ce-inline-bwd`` (its launches, a finite loss
               near ln V, a bf16 ``exp_avg``, its checkpoint written
               under the git-ignored ``rlt_logs/chip_smoke_example/``
               and removed). ``phase15_s`` in the
               ``timing`` line; the AdamW kernel in the kernels' summary
               (``"replaces": null``, with a note).
 16. the BASELINE's ResNet and BERT and the examples — after phase
               15: (a) the flash forward, dK/dV and dQ at BERT-base's
               attention (B 32, S 128, H = Hkv = 12, hd 64, full) and
               at a tensor=2 rank's (H = Hkv = 6), timed as phase 3's
               rows against SDPA and the bound
               (``BERT_FLASH_CASES``; S 512 at B 8 untimed in
               ``FLASH_OWED``); (b) BERT-base at full width (12 layers,
               dim 768, vocab 30522; seeded f32 masters, bf16 compute,
               no dropout) through `Trainer.fit` with `SingleDevice`: 8
               AdamW steps at B 32, S 128 on `synthetic_sst` rows fed
               without ``attention_mask`` (12 flash forwards, 12 dK/dV
               and 12 dQ a step and a warm-up), the same 8 steps under
               `dispatch.force_reference` (no kernel), loss and
               grad_norm within ``BERT_LOSS_TOL`` / ``BERT_GNORM_RTOL``
               a step and, over the first ``BERT_EARLY`` steps (both
               lanes at the seed's weights), within
               ``BERT_EARLY_LOSS_TOL`` / ``BERT_EARLY_GNORM_RTOL``;
               then one batch's logits on the trained weights
               without a mask (the flash kernels) and with an all-ones
               mask (the dense path: no flash launch) within
               ``BERT_LOGIT_TOL``; step ms, tokens/s, peak; and 12
               (c)'s ``tensor=2`` rows against this kernel lane's first
               ``TP_BERT_STEPS`` within the same limits; (c)
               ResNet-50 with the CIFAR stem, 8 steps at B 128 on
               seeded 32x32x3 images: a finite, falling loss, none of
               the seven kernels launched; step ms, images/s, peak; (d)
               ``mnist_dp_example``, ``cifar_resnet_example --prefetch``
               and ``bert_finetune_example`` through their ``main`` at
               their smoke sizes on the card, each ending with its JAX
               twin's line (their files under the git-ignored
               ``rlt_logs/chip_smoke_examples/``, removed after); (e)
               the doctor's ``--json`` naming the card and its memory,
               and the CIFAR example's batches made by the native
               batcher. ``phase16_s`` and each part's seconds in the
               ``timing`` line.
 17. the sequence, pipeline and expert axes — after phase 16, whose
               time its two-rank gloo group and a two-rank probe spend
               importing (they wait for the phase's gate), the group's
               ranks also paying a fresh process's first flash call
               there (`warm_process`, ``warm_s``): (a) the probe
               prints which of gloo's c10d calls carry CUDA tensors
               between two processes on the card (`all_to_all_single`,
               even and to a neighbour only, which the shifts of
               `parallel.comm` use under gloo with CUDA tensors, and
               `batch_isend_irecv`, last, since it may kill its
               processes); (b) ring and Ulysses attention over the
               two-rank ``seq`` axis at B 1, S 8192, H 32, Hkv 8, hd
               128, causal, bf16: O, dQ, dK, dV of the ring's kernel lane
               against its plain-version lane (`truth_ratio`, an f64
               reference) and both against the one-device flash kernels
               on the whole sequence, the flash launches a rank by its
               visible blocks, forward and backward ms by CUDA events and
               the host ms waited for rotations; ``FLASH_OWED_17`` holds
               the ring's blocks and Ulysses' heads untimed in phase 3;
               (c) phase 5's fit under ``ShardedMesh(seq=2)`` (ring) and
               (d) under ``ShardedMesh(pipe=2)`` (2 microbatches), 2
               steps each, within the train limits of phase 5's rows,
               with each step's gradient reduction timed; (e)
               `MoEClassifierModule` at its JAX defaults under
               ``ShardedMesh(expert=2)`` and under
               ``ShardedMesh(tensor=2)`` (half of every expert's columns
               a rank), each within ``MOE_RTOL`` of its one-rank fit. ``phase17_s`` in the ``timing`` line;
               ``--axes-only`` runs phase 3's ``FLASH_OWED_17`` rows,
               phase 5 and phase 17 alone.
 18. analysis — (a) the lock-order watcher, armed from the
               script's first lines (``RLT_LOCKWATCH=1``,
               ``RLT_LOCKWATCH_MAX_HOLD_S=2.0``, both inherited by every
               child process), so that every `san_lock` of phases 1-17 in
               this process was the watcher's: no lock-order cycle
               (RLT702) or the run fails; the order graph's locks and
               edges, and every lock held past 2 s with its seconds and
               site (RLT705, a reading); (b) after that verdict, two fresh
               lock names nested both ways on one thread must be reported
               as a cycle naming both (the arming held); (c) the host
               microseconds of an armed acquire/release pair against a
               plain ``threading.Lock``'s, 100k pairs each; (d)
               ``python -m ray_lightning_tpu_torch lint`` through its
               ``main`` in this process over the port package (threadcheck
               on, the default gate) on a machine with no JAX: exit 0, its
               seconds and counts by severity. ``phase18_s`` in the
               ``timing`` line. 12 (c)'s and 14 (a)'s ranks start ahead of
               their legs (with phase 12, and before 6 (c)'s save): they
               import while the legs before them run (`warm_imports`:
               the port's trainer and strategies, torch.distributed's
               FSDP, DTensor and checkpoint modules, ``torch._dynamo``)
               and wait for a gate file (``warm_s`` in their lines), as
               phase 17's do.
 19. graph walks — last: (a) each ``rltt`` operator (flash forward,
               dK/dV, dQ, RMSNorm, paged decode, paged prefill, AdamW) at
               phase 3's shapes against its wrapper on the same inputs:
               bitwise, its launch counter up by one a call, both calls'
               host microseconds (AdamW's untimed); (b)
               `analysis.tracecheck.audit_step` of phase 5's step on fake
               CUDA tensors: the flash and RMSNorm operators in its kernel
               list, its traced peak within ``TRACE_PEAK_RTOL`` of phase
               5's ``max_memory_allocated``, its modelled step beside
               phase 5's measured step (the drift, a reading); (c)
               `serve.audit.audit_decode_step` at phase 4's engine, both
               lanes: the kernel lane runs the paged decode, paged prefill
               and RMSNorm operators and is clean of RLT307/RLT308, the
               reference lane flags both; (d) ``python -m
               ray_lightning_tpu_torch trace llama3-8b --topo h100-8
               --json`` in a process of its own with JAX blocked and no
               card visible, started with phase 17's ranks (before phase
               16): exit 0 and a report (its collectives counted). ``phase19_s`` in the
               ``timing`` line.
  4b. serve profile — before 18, phase 4's model serves four of its requests
               again under `torch.profiler`, the device traced alone:
               the device's busy share and the kernels with the most
               device time. It runs after every other profiled phase
               because after a profiled serving run at this depth every
               later profiler session of the process loses its first
               kernel records (``--profile-sessions`` shows it).

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Run from the repository root:
``python3 chip_smoke.py`` (``--layers N`` sets the serve phase's depth,
16 by default, 32 the whole model). Three other modes build the kernels
and then only measure: ``--train-spread N`` runs phase 5's lane comparison
at seeds 0..N-1 (the spread the train limits are set from), ``--bert-spread
N`` phase 16 (b)'s (the BERT limits'), and ``--ab-old
CSRC`` times the decode and RMSNorm (and, as a control on the turns,
the dQ and prefill) in turns with a build of older sources.
``--profile-sessions N`` counts, in N fresh processes, the device events
each of four `torch.profiler` sessions records, then builds the kernels
and captures two-step windows of phase 5's fit, each after one other
profiled session (`DISTURBANCES`: none, 2000 decode calls, phase 4's
serving window at 2 and at 16 layers) and with 0, 16 or 64 primer
kernels in the capture's warm-up, with each window's kernel launches,
lost kernel events and kernel lead (the most a kernel's start precedes
its own launch call in the trace).
``chip_faults.py`` plants known faults in the kernels and runs these same
checks on them; ``chip_variants.py`` times variants of the decode and
RMSNorm sources.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import gc
import glob
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

# Phase 18: the lock-order watcher is armed for the whole run, before
# anything of the port is imported (`san_lock` decides at creation, and
# module-level locks are created at import); child processes inherit it.
# A lock held past 2 s is reported (a reading, not a failure).
os.environ.setdefault("RLT_LOCKWATCH", "1")
os.environ.setdefault("RLT_LOCKWATCH_MAX_HOLD_S", "2.0")

import torch  # noqa: E402

from ray_lightning_tpu_torch.core.callbacks import (  # noqa: E402
    Callback,
    ModelCheckpoint,
)
from ray_lightning_tpu_torch.models.llama import LlamaModule  # noqa: E402

#: wall clock when this module's imports (torch and the port's training
#: modules) ended: the second mark of a sweep trial's start split
IMPORTED_AT = time.time()

#: H100 SXM peaks (NVIDIA data sheet) for the least-time bound
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
#: kernel vs plain version, both bf16 out, held elementwise to
#:   |a - b| <= ATOL_RMS * rms(b's row) + RTOL * |b|
#: where a row is one output vector (hd or D values). The absolute term
#: scales with what is compared: at a 4096-token cache the attention
#: outputs are about 0.026 in size (a softmax over ~n/e keys averages
#: unit-variance values), where a fixed 2e-2 would pass a kernel that
#: adds or drops keys. A sound kernel differs from the plain version by
#: the bf16 rounding of its unnormalised probabilities (taken against a
#: running max, not the row's) and of its output: at 1e-2 * rms its
#: worst element used 0.86 of the allowance, and the faults that
#: chip_faults.py plants use 7 or more of it (PERF.md).
RTOL = 2e-2
ATOL_RMS = 2e-2
#: kernel lanes vs reference lanes (set at the full 32 layers; the serve
#: phase runs SERVE_LAYERS, where less compounds), on the f32 logits of
#: every greedy step (the reference lanes are teacher-forced along the
#: kernel lanes' tokens, so every step is compared). The reference rounds
#: the normalised softmax probabilities to bf16 before the PV product and
#: the kernels round the unnormalised ones; that difference compounds
#: over 32 layers. Bound on max |delta logit| per step, and on the
#: reference's margin for its own argmax over the kernel lanes' token
#: where the two differ. About 1.5x the largest reading of a sound run,
#: 0.105 (PERF.md).
LOGIT_TOL = 0.16
#: flash lse (f32 from identical f32 scores in both versions) is also
#: held to this absolute bound; the two differ by summation order only
LSE_ATOL = 1e-3
#: kernel lanes vs reference lanes in training: per-step bound on
#: |delta loss| and on |delta grad_norm| / grad_norm. The lanes differ in
#: attention (the kernels round unnormalised probabilities and dS to bf16
#: inside tiled sums, the reference its normalised probabilities) and in
#: RMSNorm (kernel vs plain forward). About 1.5x the largest reading of
#: sound kernels over eight weight-and-data seeds (``--train-spread 8``),
#: 1.36e-3 and 8.0e-3 (PERF.md); the planted faults read 9e-3 and 2.7% or
#: more.
TRAIN_LOSS_TOL = 2.1e-3
TRAIN_GNORM_RTOL = 1.2e-2
#: seeds every random input: weights, prompts, tokens, kernel-check tensors
SEED = 0
#: the serve phase's depth: Llama-3-8B's full width, half its 32 layers,
#: so the whole script keeps a margin under its time limit (on an H100 80GB
#: HBM3 at 32 layers the phase took 118 s of a 944 s run)
SERVE_LAYERS = 16

#: Llama-3-8B's serving shapes: slots, heads, KV heads, head dim, block
#: size, blocks per slot, model width, prefill chunk
C, H, HKV, HD, P, M, D, CH = 4, 32, 8, 128, 16, 256, 4096, 128
#: ragged decode lengths (slot 0 fills its whole table) and the prefill
#: chunk offsets the kernels are checked at
DECODE_LENGTHS = (4096, 1537, 700, 33)
PREFILL_POS = (0, 1024, 3968)
#: two-row prefill chunks (pos, pads): at 3968 row 1's pad covers the
#: first ranges of the split walk whole (they merge as empty partials);
#: at 1024 it falls inside a range
PREFILL_PADS = ((3968, (0, 2100)), (1024, (0, 700)))
#: decode shapes the gate admits beyond the serving one, checked untimed:
#: name -> (H, Hkv, hd, P, M, lengths, pads); each table holds 4096
#: positions or, at P 5, 4100
DECODE_OWED = {
    "hd 64": (H, HKV, 64, P, M, DECODE_LENGTHS, (0, 100, 17, 3)),
    "n_rep 1": (HKV, HKV, HD, P, M, DECODE_LENGTHS, (0, 0, 0, 0)),
    "n_rep 2": (2 * HKV, HKV, HD, P, M, DECODE_LENGTHS, (0, 0, 0, 0)),
    "n_rep 8": (8 * HKV, HKV, HD, P, M, DECODE_LENGTHS, (0, 0, 0, 0)),
    "n_rep 16": (H, 2, HD, P, M, DECODE_LENGTHS, (0, 0, 0, 0)),
    "P 5": (H, HKV, HD, 5, 820, (4100, 1537, 700, 33), (0, 0, 9, 0)),
    "P 32": (H, HKV, HD, 32, 128, DECODE_LENGTHS, (0, 0, 0, 0)),
    "length 1": (H, HKV, HD, P, M, (1, 4096, 2, 1), (0, 4095, 1, 0)),
    "length 0": (H, HKV, HD, P, M, (0, 1537, 0, 33), (0, 0, 0, 0)),
    # phase 13 (c): a tensor-parallel replica's rank, H 16 / Hkv 4
    "tp 2": (H // 2, HKV // 2, HD, P, M, DECODE_LENGTHS, (0, 0, 0, 0)),
    # phase 13 (e): the autotune's block sizes no row above holds
    "P 8": (H, HKV, HD, 8, 512, DECODE_LENGTHS, (0, 0, 0, 0)),
    "P 64": (H, HKV, HD, 64, 64, DECODE_LENGTHS, (0, 100, 0, 0)),
    "P 128": (H, HKV, HD, 128, 32, DECODE_LENGTHS, (0, 0, 0, 0)),
    "P 256": (H, HKV, HD, 256, 16, DECODE_LENGTHS, (0, 0, 300, 0)),
}
#: prefill shapes beyond the serving one, checked untimed: name -> (CH,
#: H, Hkv, hd, P, M, pos, one pad per row)
PREFILL_OWED = {
    "hd 64": (CH, H, HKV, 64, P, M, 1000, (0,)),
    "n_rep 1": (CH, HKV, HKV, HD, P, M, 1000, (0,)),
    "H 24 / Hkv 8": (CH, 24, HKV, HD, P, M, 1000, (0, 300)),
    "P 5": (CH, H, HKV, HD, 5, 820, 3900, (0,)),
    "P 24": (CH, H, HKV, HD, 24, 171, 1000, (0, 50)),
    "P 32": (CH, H, HKV, HD, 32, 128, 3968, (0,)),
    "CH 100": (100, H, HKV, HD, P, M, 1000, (0, 7)),
    "tp 2": (CH, H // 2, HKV // 2, HD, P, M, 1000, (0, 300)),
    "P 8": (CH, H, HKV, HD, 8, 512, 3968, (0,)),
    "P 64": (CH, H, HKV, HD, 64, 64, 1000, (0, 50)),
    "P 128": (CH, H, HKV, HD, 128, 32, 3968, (0,)),
    "P 256": (CH, H, HKV, HD, 256, 16, 1000, (0, 700)),
}
#: a massive activation, as Llama residual streams carry in a few channels:
#: each RMSNorm check row holds it in three columns, so a kernel that drops
#: any vector or scalar holding one from the sum of squares moves the whole
#: row far past the tolerance (a dropped vector of unit-scale values moves
#: the row by ~0.1%, below bf16's rounding)
RMS_SPIKE = 50.0
#: RMSNorm cases (N, D, gain dtype): the serving and training models keep
#: their gains in f32; at D + 1 rows start at every 2-byte offset, so the
#: kernel peels a scalar head and tail
RMS_CASES = ((4, D, torch.float32), (4, D, torch.bfloat16),
             (128, D, torch.float32), (4096, D, torch.float32),
             (4, D + 1, torch.bfloat16), (4096, D + 1, torch.float32))


def prefill_splits(b: int, pos: int) -> int:
    """The ranges the prefill kernel splits a chunk's walk into."""
    from ray_lightning_tpu_torch.ops.kernels import paged_prefill as pp
    from ray_lightning_tpu_torch.ops.kernels.paged_attention import sm_count

    return pp.launch_plan(b, CH, H, HKV, M * P, pos, sm_count(0))[1]


def rms_inputs(gen: torch.Generator, n: int, d: int, wdt):
    """Seeded RMSNorm inputs: x [n, d] bf16 of unit scale with RMS_SPIKE
    in the first, middle and last column, a gain [d] of ``wdt`` near one."""
    x = torch.randn(n, d, generator=gen, device="cuda")
    x[:, [0, d // 2, d - 1]] = RMS_SPIKE
    w = 1 + 0.5 * torch.randn(d, generator=gen, device="cuda")
    return x.to(torch.bfloat16), w.to(wdt)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---- the processes the script starts ----------------------------------------


def descendants() -> dict:
    """Every living process below this one, pid -> command line, from
    /proc: the workers, ranks and replicas the phases start, which none
    may outlive (zombies are dead and left out)."""
    parent, cmd = {}, {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{name}/cmdline", "rb") as f:
                line = f.read().replace(b"\0", b" ").decode(errors="replace")
        except (OSError, ValueError):
            continue  # gone while read
        if state != "Z":
            parent[int(name)], cmd[int(name)] = int(ppid), line.strip()
    found, todo = {}, [os.getpid()]
    while todo:
        pid = todo.pop()
        for child, pp in parent.items():
            if pp == pid and child not in found:
                found[child] = cmd[child][:200]
                todo.append(child)
    return found


def stop_descendants(where: str) -> dict:
    """End every process still below this one: SIGTERM, then SIGKILL
    after 5 s. Returns what was found (empty when nothing was left)."""
    import signal

    left = descendants()
    if not left:
        return left
    log(f"chip_smoke: processes still running {where}: {left}")
    for sig, wait_s in ((signal.SIGTERM, 5.0), (signal.SIGKILL, 5.0)):
        for pid in descendants():
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + wait_s
        while descendants() and time.monotonic() < deadline:
            time.sleep(0.1)
    return left


# ---- timing ----------------------------------------------------------------


def time_ms(fn, reps: int = 15) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each call.
    The card is first held busy with a sleep kernel so the host enqueues
    the call before it starts (the time is the device's, not Python's),
    and a 64 MiB buffer is rewritten between calls so L2 starts cold,
    as it does for the serving loop's per-layer pools."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn`` (a kernel wrapper): the card is
    held busy by a sleep kernel, so the calls only enqueue and the time is
    the host's own (checks, allocation, the launch call)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


#: profiler sessions the decode's launch count may take (see decode_case)
PROFILE_SESSIONS = 3


def kernel_profile(fn, calls: int = 1):
    """{kernel name: {"launches", "ms"}} per call of ``fn`` over ``calls``
    back-to-back calls after a warm-up, from torch.profiler's device
    events: what ``fn`` launches and the kernels' own device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: dict(launches=e.count / calls,
                             ms=e.self_device_time_total / 1e3 / calls)
            for e in device_kernels(prof)}


def bound(nbytes: float, flops: float):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / BF16_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---- phase 3: kernels against their plain versions -------------------------


def tolerance_ratio(got: torch.Tensor, want: torch.Tensor, rms_dims=(-1,)):
    """(max |got - want|, the largest share of its allowance any element
    uses) under the RTOL / ATOL_RMS rule; a share above 1 fails. The rms
    is taken over ``rms_dims`` (a row by default). A non-finite output
    uses an infinite share, and so does any error where the plain
    version's rms is zero."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rms = want.pow(2).mean(dim=rms_dims, keepdim=True).sqrt()
    share = torch.where(err == 0, torch.zeros_like(err),
                        err / (ATOL_RMS * rms + RTOL * want.abs()))
    if not bool(torch.isfinite(got).all()):
        return float("inf"), float("inf")
    return err.max().item(), share.max().item()


def hold(got: torch.Tensor, want: torch.Tensor, what: str, rms_dims=(-1,)):
    """`tolerance_ratio`, raising when the kernel is out of tolerance."""
    err, share = tolerance_ratio(got, want, rms_dims)
    if not share <= 1.0:
        raise AssertionError(f"{what}: max |err| {err:.4g} uses {share:.3g}x "
                             f"the tolerance")
    return err, share


def i32(x):
    return torch.tensor(x, dtype=torch.int32, device="cuda")


class KernelInputs:
    """Seeded bf16 inputs, by default at the serving shapes: one pool of K
    and V whose C slots own distinct blocks in shuffled order (block 0,
    the scratch block, is in no table)."""

    def __init__(self, gen: torch.Generator, h=H, hkv=HKV, hd=HD, p=P, m=M):
        self.gen, self.h, self.hd = gen, h, hd
        nb = 1 + C * m
        self.pool_k = self.randn(nb, p, hkv, hd)
        self.pool_v = self.randn(nb, p, hkv, hd)
        perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
        self.tables = perm[:C * m].reshape(C, m).to(torch.int32).contiguous()

    def randn(self, *shape):
        return torch.randn(shape, generator=self.gen,
                           device="cuda").to(torch.bfloat16)

    def decode(self, lengths, pad):
        """Arguments of one decode call over all C slots."""
        return ((self.randn(C, self.h, self.hd), self.pool_k, self.pool_v,
                 self.tables, i32(list(lengths))), dict(pad=i32(list(pad))))

    def prefill(self, pos, pad, ch=CH):
        """Arguments of one prefill chunk over the first len(pad) rows."""
        tab = self.tables[:len(pad)].contiguous()
        return ((self.randn(len(pad), ch, self.h, self.hd), self.pool_k,
                 self.pool_v, tab, pos), dict(pad=i32(list(pad))))


def decode_bytes(lengths, pad, hkv, hd, q_heads, m):
    """Bytes the decode must move: q in and out once, each visible K and
    V row once, the tables, lengths and pads."""
    vis = sum(max(0, l - p) for l, p in zip(lengths, pad))
    return (2 * len(lengths) * q_heads * hd * 2 + vis * hkv * hd * 2 * 2
            + len(lengths) * m * 4 + 2 * len(lengths) * 4), vis


def check_kernels(gen: torch.Generator):
    from ray_lightning_tpu_torch.ops.attention import gather_pages
    from ray_lightning_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_kernel, paged_attention_plain)
    from ray_lightning_tpu_torch.ops.kernels.paged_prefill import (
        paged_prefill_kernel, paged_prefill_plain)
    from ray_lightning_tpu_torch.ops.kernels.rmsnorm import (
        rms_norm_kernel, rms_norm_plain)
    import torch.nn.functional as F

    inp = KernelInputs(gen)
    rows = []

    def record(kernel, shape, err, share, ms, plain_ms, lib_ms, nbytes,
               flops, **extra):
        b_ms, b_by = bound(nbytes, flops)
        row = dict(kernel=kernel, shape=shape, max_abs_err=err,
                   tolerance_share=share, kernel_ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, **extra)
        print(json.dumps(row), flush=True)
        rows.append(row)

    # -- paged decode: ragged lengths up to 4096 --------------------------
    def decode_case(name, lengths, pad, time_it=True):
        args, kw = inp.decode(lengths, pad)
        got = paged_attention_kernel(*args, **kw)
        err, share = hold(got, paged_attention_plain(*args, **kw),
                          f"paged_decode {name}")
        if not time_it:
            return got
        if not torch.equal(got, paged_attention_kernel(*args, **kw)):
            raise AssertionError("paged_decode: two calls differ")
        # a profiler session that records no device event at all has
        # lost its events (two of this script's runs on the card did, at
        # this first session of the process; the cause is not known), so
        # it is taken again, and the row says how often; a wrapper that
        # launches nothing still reads {} after the last
        for retakes in range(PROFILE_SESSIONS):
            launched = kernel_profile(
                lambda: paged_attention_kernel(*args, **kw))
            if launched:
                break
        if sum(k["launches"] for k in launched.values()) != 1:
            raise AssertionError(f"paged_decode: launches {launched}, not one")
        ms = time_ms(lambda: paged_attention_kernel(*args, **kw))
        plain_ms = time_ms(lambda: paged_attention_plain(*args, **kw),
                           reps=5)
        q, pool_k, pool_v, tables, ln = args
        gk = gather_pages(pool_k, tables).transpose(1, 2)  # [C, Hkv, G, hd]
        gv = gather_pages(pool_v, tables).transpose(1, 2)
        kv_pos = torch.arange(M * P, device="cuda")
        mask = ((kv_pos[None] < ln[:, None])
                & (kv_pos[None] >= kw["pad"][:, None]))[:, None, None, :]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], gk, gv, attn_mask=mask, enable_gqa=True))
        nbytes, vis = decode_bytes(lengths, pad, HKV, HD, H, M)
        record("paged_decode", dict(C=C, H=H, Hkv=HKV, hd=HD, P=P, M=M,
                                    lengths=list(lengths), pad=list(pad)),
               err, share, ms, plain_ms, lib_ms, nbytes,
               4 * H * HD * vis,
               launches_per_call={k: v["launches"] for k, v in launched.items()},
               profile_retakes=retakes,
               host_us=host_us(lambda: paged_attention_kernel(*args, **kw)))
        return got

    decode_case("ragged", DECODE_LENGTHS, [0, 0, 0, 0])
    decode_case("pad", DECODE_LENGTHS, [0, 100, 17, 3], time_it=False)
    # fully masked slot 0 (pad beyond length) writes zeros
    out = decode_case("masked", [5, 64, 64, 64], [9, 0, 0, 0],
                      time_it=False)
    if bool((out[0] != 0).any()):
        raise AssertionError("paged_decode: fully masked slot not zero")
    # scratch block 0 at the table tail, poisoned: no visible change
    tab0 = inp.tables.clone()
    tab0[0, 2:] = 0
    q = inp.randn(C, H, HD)
    ln = i32([20, 64, 64, 64])
    outs = []
    for fill in (0.0, 1e4):
        inp.pool_k[0], inp.pool_v[0] = fill, fill
        outs.append(paged_attention_kernel(q, inp.pool_k, inp.pool_v, tab0,
                                           ln))
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError("paged_decode: scratch poison leaked")

    # -- paged prefill: B = 1, CH = 128 at three depths; two rows with a
    # pad that covers whole ranges of the split walk or falls inside one
    def prefill_case(pos, pad, time_it=True):
        args, kw = inp.prefill(pos, pad)
        got = paged_prefill_kernel(*args, **kw)
        err, share = hold(got, paged_prefill_plain(*args, **kw),
                          f"paged_prefill pos={pos} pad={pad}")
        if not time_it:
            return got
        ms = time_ms(lambda: paged_prefill_kernel(*args, **kw))
        plain_ms = time_ms(lambda: paged_prefill_plain(*args, **kw),
                           reps=5)
        q, pool_k, pool_v, tab, _ = args
        b, pd = len(pad), kw["pad"]
        gk = gather_pages(pool_k, tab).transpose(1, 2)
        gv = gather_pages(pool_v, tab).transpose(1, 2)
        kv_pos = torch.arange(M * P, device="cuda")
        q_pos = pos + torch.arange(CH, device="cuda")
        mask = ((kv_pos[None, :] <= q_pos[:, None])[None]
                & (kv_pos[None, None, :] >= pd[:, None, None]))[:, None]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), gk, gv, attn_mask=mask, enable_gqa=True))
        seen = sum(max(0, pos + j + 1 - p) for p in pad for j in range(CH))
        vis_kv = sum(max(0, pos + CH - p) for p in pad)
        nbytes = 2 * b * CH * H * HD * 2 + vis_kv * HKV * HD * 4 + b * M * 4
        record("paged_prefill", dict(B=b, CH=CH, H=H, Hkv=HKV, hd=HD, P=P,
                                     M=M, pos=pos, pad=list(pad),
                                     n_split=prefill_splits(b, pos)),
               err, share, ms, plain_ms, lib_ms, nbytes, 4 * H * HD * seen)
        return got

    if prefill_splits(1, 0) != 1:
        raise AssertionError("paged_prefill: pos 0 should walk one range")
    for pos in PREFILL_POS:
        prefill_case(pos, [0])
    for pos, pad in PREFILL_PADS:
        prefill_case(pos, pad)
    out = prefill_case(0, [0, 40], time_it=False)
    if bool((out[1, :40] != 0).any()) or not bool((out[1, 40:] != 0).any()):
        raise AssertionError("paged_prefill: pad-column queries not zero")
    # scratch block 0 named by the table from the block after the chunk's
    # last position, poisoned: its tile is walked but masked, so no
    # visible change
    pos = 1000
    tab0 = inp.tables[:1].clone()
    tab0[0, -(-(pos + CH) // P):] = 0
    q = inp.randn(1, CH, H, HD)
    outs = []
    for fill in (0.0, 1e4):
        inp.pool_k[0], inp.pool_v[0] = fill, fill
        outs.append(paged_prefill_kernel(q, inp.pool_k, inp.pool_v, tab0,
                                         pos))
    hold(outs[0], paged_prefill_plain(q, inp.pool_k, inp.pool_v, tab0, pos),
         "paged_prefill poison")
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError("paged_prefill: scratch poison leaked")
    del inp, outs

    # -- RMSNorm: the serving shapes, the train shape, a scalar tail ------
    for n, d, wdt in RMS_CASES:
        x, w = rms_inputs(gen, n, d, wdt)
        got = rms_norm_kernel(x, w)
        err, share = hold(got, rms_norm_plain(x, w),
                          f"rms_norm N={n} D={d} w {wdt}")
        ms = time_ms(lambda: rms_norm_kernel(x, w))
        plain_ms = time_ms(lambda: rms_norm_plain(x, w))
        wx = w.to(x.dtype)
        lib_ms = time_ms(lambda: F.rms_norm(x, (d,), wx, 1e-5))
        record("rms_norm", dict(N=n, D=d, w=str(wdt).split(".")[-1]), err,
               share, ms, plain_ms, lib_ms,
               2 * n * d * 2 + d * w.element_size(), 4 * n * d,
               host_us=host_us(lambda: rms_norm_kernel(x, w)))
    return rows


def check_owed(gen: torch.Generator):
    """The decode and prefill at every shape of DECODE_OWED and
    PREFILL_OWED against their plain versions, untimed; a slot of
    length 0 must give exact zeros. One JSON line per shape."""
    from ray_lightning_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_kernel, paged_attention_plain)
    from ray_lightning_tpu_torch.ops.kernels.paged_prefill import (
        paged_prefill_kernel, paged_prefill_plain)

    for name, (h, hkv, hd, p, m, lengths, pad) in DECODE_OWED.items():
        args, kw = KernelInputs(gen, h, hkv, hd, p, m).decode(lengths, pad)
        got = paged_attention_kernel(*args, **kw)
        err, share = hold(got, paged_attention_plain(*args, **kw),
                          f"paged_decode {name}")
        empty = [c for c, (l, pd) in enumerate(zip(lengths, pad)) if l <= pd]
        if any(bool((got[c] != 0).any()) for c in empty):
            raise AssertionError(f"paged_decode {name}: empty slot not zero")
        print(json.dumps(dict(check="paged_decode", case=name, H=h, Hkv=hkv,
                              hd=hd, P=p, M=m, lengths=list(lengths),
                              pad=list(pad), max_abs_err=err,
                              tolerance_share=share)), flush=True)
    for name, (ch, h, hkv, hd, p, m, pos, pad) in PREFILL_OWED.items():
        args, kw = KernelInputs(gen, h, hkv, hd, p, m).prefill(pos, pad, ch)
        got = paged_prefill_kernel(*args, **kw)
        err, share = hold(got, paged_prefill_plain(*args, **kw),
                          f"paged_prefill {name}")
        print(json.dumps(dict(check="paged_prefill", case=name, CH=ch,
                              H=h, Hkv=hkv, hd=hd, P=p, M=m, pos=pos,
                              pad=list(pad), max_abs_err=err,
                              tolerance_share=share)), flush=True)
    torch.cuda.empty_cache()


# ---- phase 3b: flash attention and the RMSNorm gradient --------------------

#: Llama-3-8B's training attention: batch, sequence, heads, KV heads, hd
TB, TS, TH, THKV = 2, 2048, 32, 8
#: name -> (B, Sq, Sk, H, Hkv, hd, causal, q_offset); the first is the
#: training step's shape, the summary's. "hd 64" is the other head size
#: the shape gate admits; in "empty rows" the first 64 queries see no key
#: (q_offset -64) and must give O = 0, lse = -1e30 and zero gradients.
FLASH_CASES = {
    "train causal": (TB, TS, TS, TH, THKV, HD, True, 0),
    "train full": (TB, TS, TS, TH, THKV, HD, False, 0),
    "q_offset": (TB, TS // 2, TS, TH, THKV, HD, True, TS // 2),
    "mha": (TB, TS, TS, TH, TH, HD, True, 0),
    "short": (TB, 128, 128, TH, THKV, HD, True, 0),
    "hd 64": (TB, TS, TS, TH, THKV, 64, True, 0),
    "empty rows": (TB, 256, 256, TH, THKV, HD, True, -64),
}
#: flash shapes the gate admits beyond FLASH_CASES, checked untimed (same
#: fields): ragged lengths in the three modes (at an offset: the last
#: half of the sequence's queries), B 1, n_rep 2
FLASH_OWED = {
    **{f"{mode} {n}": (1, sq, n, TH, THKV, HD, mode != "full", n - sq)
       for n in (1000, 65, 1)
       for mode, sq in (("causal", n), ("full", n), ("q_offset", -(-n // 2)))},
    "n_rep 2": (TB, 512, 512, 16, 8, HD, True, 0),
    # phase 12's tensor-parallel heads a rank: tensor 2 and tensor 8
    "tp 2": (TB, TS, TS, TH // 2, THKV // 2, HD, True, 0),
    "tp 8": (TB, TS, TS, TH // 8, THKV // 8, HD, True, 0),
    # phase 16: BERT-base at its max_seq_len, bidirectional, hd 64
    "bert S 512": (8, 512, 512, 12, 12, 64, False, 0),
}
#: phase 17's flash shapes (same fields), checked after FLASH_OWED and
#: the B_max row, so the seeded draws of those stay what they were: a
#: ring block of Llama-3-8B's max_seq_len over two ranks (causal on the
#: diagonal, whole below it) and Ulysses' heads a rank over the whole
#: sequence
FLASH_OWED_17 = {
    "ring block causal": (1, 4096, 4096, TH, THKV, HD, True, 0),
    "ring block full": (1, 4096, 4096, TH, THKV, HD, False, 0),
    "ulysses 2": (1, 8192, 8192, TH // 2, THKV // 2, HD, True, 0),
}
#: the batch rows of the B_max flash row (phase 12 (b)'s batch, planned)
#: held against the plain version: the kernels run at the full batch,
#: whose plain [B, H, S, S] scores would not fit beside it
BMAX_ROWS = (0, -1)
#: at Sk = 1 every softmax has one key: P = 1 and dS = P (dP - delta) = 0,
#: so dQ and dK are zero in exact arithmetic and both versions hold only
#: the rounding of dP - delta (two f32 sums of the same products, ~1e-6);
#: there they are held to this absolute bound, not to a share of a zero rms
ZERO_GRAD_ATOL = 1e-4
#: gradients are held with the rms of each head's [S, hd] slab: a
#: gradient row can cancel to zero (dQ of the first query is exactly 0)
#: while its rounding noise does not
SLAB = (1, 3)
#: phase 17's flash rows, sequences of 4096 and 8192: there the plain
#: version's own bf16 rounding of dS and of its output puts it, at a few
#: elements a draw, as far from an f64 reference as the tolerance allows
#: (`scripts/flash_truth.py`, 16 draws at S 4096: where the kernel uses
#: most of the tolerance, it is the nearer of the two about as often as
#: the plain version is). An element of these rows' gradients beyond the
#: tolerance of the plain version passes only where the kernel is no
#: further from the f64 reference than the plain version, plus the same
#: tolerance around it. 17 (b) holds the ring's O, dQ, dK and dV so too:
#: there its two lanes' largest errors against f64 are equal. Under this
#: rule the rows and the ring still reject every planted flash fault
#: (`chip_faults.py --axes`)
TRUTH_HELD = tuple(FLASH_OWED_17)


def visible_pairs(sq: int, sk: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs one head attends over."""
    if not causal:
        return sq * sk
    return sum(max(0, min(sk, q_offset + i + 1)) for i in range(sq))


class FlashCase:
    """Seeded bf16 q, k, v, dO for one shape, the kernels' outputs and
    the plain versions' on the same inputs (the backward on the kernel
    forward's lse and delta, so each pass is held on its own)."""

    def __init__(self, gen, B, Sq, Sk, H, Hkv, hd, causal, q_offset):
        from ray_lightning_tpu_torch.ops.kernels import flash as F

        self.F, self.args = F, (causal, q_offset)
        self.shape = (B, Sq, Sk, H, Hkv, hd)
        rn = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                    device="cuda").to(torch.bfloat16)
        self.q, self.k, self.v = rn(B, Sq, H, hd), rn(B, Sk, Hkv, hd), \
            rn(B, Sk, Hkv, hd)
        self.do = rn(B, Sq, H, hd)
        self.o, self.lse = F.flash_fwd_kernel(self.q, self.k, self.v,
                                              *self.args)
        self.delta = F.flash_delta(self.o, self.do)

    def rows(self, idx):
        """This case held on batch rows ``idx`` only: the kernels' outputs
        at the full batch, sliced, against the plain versions on those
        rows' inputs (rows are independent)."""
        idx = torch.tensor(idx, device="cuda")
        out = FlashCase.__new__(FlashCase)
        out.F, out.args = self.F, self.args
        out.shape = (len(idx),) + self.shape[1:]
        dk, dv = self.dkv()
        dq = self.dq()
        for name in ("q", "k", "v", "do", "o", "lse", "delta"):
            setattr(out, name, getattr(self, name)[idx])
        sliced = (dk[idx], dv[idx]), dq[idx]
        out.dkv = lambda: sliced[0]
        out.dq = lambda: sliced[1]
        return out

    def fwd(self):
        return self.F.flash_fwd_kernel(self.q, self.k, self.v, *self.args)

    def fwd_plain(self):
        return self.F.flash_fwd_plain(self.q, self.k, self.v, *self.args)

    def bwd_in(self):
        return (self.q, self.k, self.v, self.do, self.lse, self.delta,
                *self.args)

    def dkv(self):
        return self.F.flash_bwd_dkv_kernel(*self.bwd_in())

    def dq(self):
        return self.F.flash_bwd_dq_kernel(*self.bwd_in())

    def dkv_plain(self):
        return self.F.flash_bwd_dkv_plain(*self.bwd_in())

    def dq_plain(self):
        return self.F.flash_bwd_dq_plain(*self.bwd_in())

    def shares(self, truth: bool = False):
        """{output: (max |err|, share of the tolerance)} of every kernel
        output against its plain version (the caller judges them); with
        ``truth``, the gradients' shares by `truth_ratio`."""
        po, plse = self.fwd_plain()
        out = {"o": tolerance_ratio(self.o, po),
               "lse": tolerance_ratio(self.lse, plse)}
        lse_err = (self.lse - plse).abs().max().item()
        out["lse_abs"] = (lse_err, lse_err / LSE_ATOL)
        del po, plse
        ref = (f64_attention(self.q, self.k, self.v, self.do, *self.args)
               if truth else None)
        dk, dv = self.dkv()
        pdk, pdv = self.dkv_plain()
        pdq = self.dq_plain()

        def ratio(name, got, want):
            if ref is None:
                return tolerance_ratio(got, want, SLAB)
            return truth_ratio(got, want, ref[name])

        out["dk"] = ratio("dk", dk, pdk)
        out["dv"] = ratio("dv", dv, pdv)
        del pdk, pdv
        out["dq"] = ratio("dq", self.dq(), pdq)
        torch.cuda.synchronize()
        return out


def f64_attention(q, k, v, do, causal: bool, off: int = 0) -> dict:
    """O, dQ, dK and dV of the attention of q, k, v [B, S, heads, hd]
    with the cotangent ``do``, in f64 from the given (bf16) values, one KV
    head's group at a time."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    r, scale = h // hkv, hd ** -0.5
    rows = off + torch.arange(sq, device=q.device)[:, None]
    vis = (rows >= torch.arange(sk, device=q.device)[None, :] if causal
           else torch.ones(sq, sk, dtype=torch.bool, device=q.device))
    out = {"o": torch.zeros_like(q), "dq": torch.zeros_like(q),
           "dk": torch.zeros_like(k), "dv": torch.zeros_like(v)}
    for g in range(hkv):
        heads = slice(g * r, (g + 1) * r)
        qg, dog, kg, vg = q[:, :, heads], do[:, :, heads], k[:, :, g], \
            v[:, :, g]
        s = torch.einsum("bird,bjd->brij", qg, kg) * scale
        p = torch.softmax(s.masked_fill(~vis, float("-inf")), dim=-1)
        og = torch.einsum("brij,bjd->bird", p, vg)
        out["o"][:, :, heads] = og
        dp = torch.einsum("bird,bjd->brij", dog, vg)
        delta = (dog * og).sum(-1).permute(0, 2, 1)[..., None]
        ds = p * (dp - delta) * scale
        out["dq"][:, :, heads] = torch.einsum("brij,bjd->bird", ds, kg)
        out["dk"][:, :, g] = torch.einsum("brij,bird->bjd", ds, qg)
        out["dv"][:, :, g] = torch.einsum("brij,bird->bjd", p, dog)
        del s, p, og, dp, ds
    return out


def truth_ratio(got: torch.Tensor, plain: torch.Tensor,
                truth: torch.Tensor, rms_dims=SLAB):
    """(max |got - plain|, largest share): an element's share is the
    lesser of its share of the tolerance against the plain version
    (`tolerance_ratio`'s, the rms over ``rms_dims``) and of |got - truth|
    against |plain - truth| plus the tolerance around the f64
    ``truth``."""
    got, plain = got.double(), plain.double()
    err = (got - plain).abs()

    def tol(ref):
        rms = ref.pow(2).mean(dim=rms_dims, keepdim=True).sqrt()
        return ATOL_RMS * rms + RTOL * ref.abs()

    vs_plain = torch.where(err == 0, torch.zeros_like(err), err / tol(plain))
    vs_truth = (got - truth).abs() / ((plain - truth).abs() + tol(truth))
    if not bool(torch.isfinite(got).all()):
        return float("inf"), float("inf")
    return err.max().item(), torch.minimum(vs_plain, vs_truth).max().item()


def sdpa_args(c: FlashCase):
    """The same attention as one `F.scaled_dot_product_attention` call."""
    B, Sq, Sk, H, Hkv, _ = c.shape
    causal, off = c.args
    kw = dict(enable_gqa=Hkv != H)
    if causal and off == 0 and Sq == Sk:
        kw["is_causal"] = True
    elif causal:
        q_pos = off + torch.arange(Sq, device="cuda")[:, None]
        kw["attn_mask"] = q_pos >= torch.arange(Sk, device="cuda")[None]
    return (c.q.transpose(1, 2), c.k.transpose(1, 2),
            c.v.transpose(1, 2)), kw


def check_empty_rows(c: FlashCase):
    """A causal case at a negative q_offset: the first -q_offset queries
    see no key and give O = 0 and lse = -1e30, and their dQ is zero, as
    are dK and dV of the keys no query sees (SDPA gives NaN on such rows,
    so the kernels are held to exact values here)."""
    Sq, off = c.shape[1], c.args[1]
    dk, dv = c.dkv()
    dq = c.dq()
    n = -off
    unseen = max(0, off + Sq)  # keys from here on are seen by no query
    bad = [what for what, ok in (
        ("O", bool((c.o[:, :n] == 0).all())),
        ("lse", bool((c.lse[:, :, :n] == c.F.NEG_INF).all())),
        ("dQ", bool((dq[:, :n] == 0).all())),
        ("dK", bool((dk[:, unseen:] == 0).all())),
        ("dV", bool((dv[:, unseen:] == 0).all()))) if not ok]
    if bad:
        raise AssertionError(f"flash empty rows: {bad} not exact")


def check_flash(gen: torch.Generator, cases=None):
    """The three flash kernels against their plain versions at every
    shape of ``cases`` (FLASH_CASES); one JSON row per (kernel, shape),
    timed, each with its shape's seconds (``case_s``)."""
    import torch.nn.functional as F

    rows = []
    for name, (B, Sq, Sk, H, Hkv, hd, causal, off) in (
            cases or FLASH_CASES).items():
        t0 = time.perf_counter()
        case_rows = []
        c = FlashCase(gen, B, Sq, Sk, H, Hkv, hd, causal, off)
        shares = c.shares()
        bad = {k: v for k, v in shares.items() if not v[1] <= 1.0}
        if bad:
            raise AssertionError(f"flash {name}: out of tolerance {bad}")
        bwd_pair = time_ms(lambda: (c.dkv(), c.dq()))
        if causal and off < 0:
            check_empty_rows(c)
            lib_fwd = lib_bwd = lib_fb = None  # SDPA: NaN on empty rows
        else:
            (sq, sk, sv), kw = sdpa_args(c)
            lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, **kw))
            leaves = [t.detach().requires_grad_(True) for t in (sq, sk, sv)]
            lib_out = F.scaled_dot_product_attention(*leaves, **kw)
            do_t = c.do.transpose(1, 2)
            lib_bwd = time_ms(lambda: torch.autograd.grad(
                lib_out, leaves, do_t, retain_graph=True))

            def lib_both():
                o = F.scaled_dot_product_attention(*leaves, **kw)
                torch.autograd.grad(o, leaves, do_t)

            lib_fb = time_ms(lib_both)
            del lib_out, leaves
        vis = B * H * visible_pairs(Sq, Sk, causal, off)
        q_bytes, kv_bytes, vec = B * Sq * H * hd * 2, B * Sk * Hkv * hd * 2, \
            B * H * Sq * 4
        shape = dict(case=name, B=B, Sq=Sq, Sk=Sk, H=H, Hkv=Hkv, hd=hd,
                     causal=causal, q_offset=off)
        for kernel, fn, plain, lib, nbytes, flops, outs in (
                ("flash_fwd", c.fwd, c.fwd_plain, lib_fwd,
                 2 * q_bytes + 2 * kv_bytes + vec, 4 * vis * hd,
                 ("o", "lse", "lse_abs")),
                ("flash_bwd_dkv", c.dkv, c.dkv_plain, lib_bwd,
                 2 * q_bytes + 4 * kv_bytes + 2 * vec, 8 * vis * hd,
                 ("dk", "dv")),
                ("flash_bwd_dq", c.dq, c.dq_plain, lib_bwd,
                 3 * q_bytes + 2 * kv_bytes + 2 * vec, 6 * vis * hd,
                 ("dq",))):
            b_ms, b_by = bound(nbytes, flops)
            row = dict(kernel=kernel, shape=shape,
                       max_abs_err=max(shares[o][0] for o in outs
                                       if o != "lse_abs"),
                       tolerance_share={o: shares[o][1] for o in outs},
                       kernel_ms=time_ms(fn),
                       plain_ms=time_ms(plain, reps=3),
                       library_ms=lib, bwd_pair_ms=bwd_pair,
                       bound_ms=b_ms, bound_by=b_by)
            if kernel != "flash_fwd":
                row["library_fwd_bwd_ms"] = lib_fb
            case_rows.append(row)
        case_s = time.perf_counter() - t0
        for row in case_rows:
            row["case_s"] = case_s
            print(json.dumps(row), flush=True)
        rows += case_rows
        del c
        torch.cuda.empty_cache()
    return rows


def check_flash_owed(gen: torch.Generator, only=None):
    """The three flash kernels against their plain versions at every
    shape of FLASH_OWED, at phase 12 (b)'s planned batch (its BMAX_ROWS
    held) and of FLASH_OWED_17, and the RMSNorm at that batch's every
    row, untimed; one JSON line per shape. ``only``: those FLASH_OWED_17
    rows alone."""
    from ray_lightning_tpu_torch.ops.kernels.rmsnorm import (
        rms_norm_kernel, rms_norm_plain)

    if only is not None:
        owed = {k: FLASH_OWED_17[k] for k in only}
    else:
        b_max = planned_max_batch()[0]
        owed = {**FLASH_OWED,
                f"B_max {b_max}": (b_max, TS, TS, TH, THKV, HD, True, 0),
                **FLASH_OWED_17}
    for name, dims in owed.items():
        case = FlashCase(gen, *dims)
        if name.startswith("B_max"):
            case = case.rows([r % dims[0] for r in BMAX_ROWS])
        shares = case.shares(truth=name in TRUTH_HELD)
        zero = ("dq", "dk") if dims[2] == 1 else ()
        bad = {k: v for k, v in shares.items()
               if not (v[0] <= ZERO_GRAD_ATOL if k in zero else v[1] <= 1.0)}
        if bad:
            raise AssertionError(f"flash {name}: out of tolerance {bad}")
        print(json.dumps(dict(check="flash", case=name, shape=dims,
                              max_abs_err={k: v[0] for k, v in shares.items()},
                              tolerance_share={k: v[1] for k, v in
                                               shares.items()})), flush=True)
    del case
    if only is not None:
        torch.cuda.empty_cache()
        return
    # phase 12 (b)'s RMSNorm: B_max x TS rows at D with the f32 gain
    n = b_max * TS
    x, w = rms_inputs(gen, n, D, torch.float32)
    err, share = hold(rms_norm_kernel(x, w), rms_norm_plain(x, w),
                      f"rms_norm B_max {b_max}")
    print(json.dumps(dict(check="rms_norm", case=f"B_max {b_max}", N=n, D=D,
                          w="float32", max_abs_err=err,
                          tolerance_share=share)), flush=True)
    del x, w
    torch.cuda.empty_cache()


def check_rms_norm_grad(gen: torch.Generator):
    """On a CUDA tensor `rms_norm` (the CUDA forward) carries a grad_fn,
    and its dx and dw (the ported backward rule) match autograd through
    the plain version on the same inputs."""
    from ray_lightning_tpu_torch.ops.kernels.rmsnorm import (
        rms_norm_kernel, rms_norm_plain)
    from ray_lightning_tpu_torch.ops.norms import rms_norm

    x = torch.randn(TB * TS, D, generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_(True)
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")
         ).requires_grad_(True)
    g = torch.randn(TB * TS, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    before = rms_norm_kernel.launches
    y = rms_norm(x, w)
    if y.grad_fn is None or rms_norm_kernel.launches != before + 1:
        raise AssertionError("rms_norm on CUDA: no grad_fn or no launch")
    dx, dw = torch.autograd.grad(y, (x, w), g)
    pdx, pdw = torch.autograd.grad(rms_norm_plain(x, w), (x, w), g)
    err_x, share_x = hold(dx, pdx, "rms_norm dx")
    err_w, share_w = hold(dw, pdw, "rms_norm dw")
    row = dict(check="rms_norm_grad", N=TB * TS, D=D,
               max_abs_err={"dx": err_x, "dw": err_w},
               tolerance_share={"dx": share_x, "dw": share_w})
    print(json.dumps(row), flush=True)


# ---- phase 4: serving at full width ----------------------------------------


class TickProbe:
    """Wraps `DecodeEngine.tick` to count ticks and prefill chunks and
    time each tick (host clock; a tick ends by copying its tokens to the
    host). On the kernel lanes (``forced=None``) it keeps the f32 logits
    every greedy token is taken from, by (rid, step). On the reference
    lanes ``forced`` is the kernel lanes' (logits, tokens): before each
    tick it compares each greedy slot's logits with the kernel lanes' at
    the same step, then sets them to pick the kernel lanes' token, so the
    reference follows the kernel lanes' stream."""

    def __init__(self, engine, sched, forced=None):
        self.engine, self.sched = engine, sched
        self.ticks = self.chunks = 0
        self.tick_s = {"decode": [], "decode+prefill": []}
        self.logits = {}
        self.forced = forced
        self.steps = []  # (rid, step, max |delta|, ref margin, max |ref|)
        self._tick = engine.tick
        engine.tick = self

    def _greedy_decoding(self, decoding):
        for s in map(int, decoding.nonzero()[0]):
            slot = self.sched.slots[s]
            if slot.req.temperature == 0.0:
                yield s, slot.req.rid, len(slot.emitted)

    def __call__(self, tables, pos, decoding, temp, top_k, rngs, prefill,
                 pad=None):
        last = self.engine.last_logits
        for s, rid, t in self._greedy_decoding(decoding):
            if self.forced is None:
                self.logits[(rid, t)] = last[s].clone()
                continue
            k_logits, k_tokens = self.forced
            tok = k_tokens[rid][t]
            ref = last[s]
            self.steps.append((rid, t, (k_logits[(rid, t)] - ref).abs().max(),
                               ref.max() - ref[tok], ref.abs().max()))
            last[s].zero_()
            last[s, tok] = 1.0
        t0 = time.perf_counter()
        out = self._tick(tables, pos, decoding, temp, top_k, rngs,
                         prefill, pad=pad)
        dt = time.perf_counter() - t0
        self.ticks += 1
        chunk = int(prefill[0]) >= 0  # the single-slot prefill lane
        self.tick_s["decode+prefill" if chunk else "decode"].append(dt)
        self.chunks += chunk
        return out


def serve(model, ecfg, use_kernels, forced=None, metrics=None, flight=None):
    from ray_lightning_tpu_torch.serve.engine import DecodeEngine
    from ray_lightning_tpu_torch.serve.scheduler import Scheduler

    engine = DecodeEngine(model, ecfg, use_kernels=use_kernels,
                          metrics=metrics)
    engine.warmup()
    sched = Scheduler(engine, metrics=metrics, flight=flight)
    probe = TickProbe(engine, sched, forced=forced)
    torch.cuda.synchronize()
    return engine, sched, probe


def drain(sched, requests):
    for r in requests:
        sched.submit(r)
    done = {}
    while sched.busy():
        for c in sched.tick():
            done[c.rid] = c
    torch.cuda.synchronize()
    return done


def device_kernels(prof):
    """The profile's device events by name, without the device-side copies
    of user annotations (such as the optimizer's step range), whose time
    is that of the kernels inside them."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def profile_window(sched, reqs, host: bool = True):
    """Serve ``reqs`` again under `torch.profiler` and print where the
    device time went: the busy share of the window's wall time and the
    kernels with the most device time. ``host=False`` traces the device
    only: the same readings, without the host operators whose
    aggregation took 29 of the 4b window's 40 s."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU] * host
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drain(sched, [dataclasses.replace(r, rid=f"p{r.rid}")
                      for r in reqs])
        wall = time.perf_counter() - t0
    events = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    print(json.dumps(dict(
        phase="profile", requests=len(reqs), wall_s=wall, device_busy_s=busy,
        device_busy_share=busy / wall,
        top=[dict(name=e.key[:80], ms=e.self_device_time_total / 1e3,
                  calls=e.count) for e in top])), flush=True)


def serve_profile(seed: int, n_layers: int) -> None:
    """Phase 4's serving window under `torch.profiler`, run last: once a
    profiled session has covered this serving run, every later profiler
    session of the process loses its first kernel records (PERF.md §7;
    ``--profile-sessions`` shows it), and phase 9(a) checks a capture."""
    model = build_model(seed, n_layers)
    _, sched, _ = serve(model, engine_config(), use_kernels=None)
    # the device traced alone: aggregating the host's operators took
    # most of the window's time
    profile_window(sched, make_requests(model.cfg.vocab_size, seed)[:4],
                   host=False)
    torch.cuda.empty_cache()


def serve_config(n_layers: int):
    """Llama-3-8B at full width, ``n_layers`` deep, bf16."""
    from ray_lightning_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.llama3_8b(max_seq_len=4096, n_layers=n_layers)


def build_model(seed: int, n_layers: int):
    """Llama-3-8B at full width, ``n_layers`` deep, random bf16 weights
    from a seeded CUDA generator."""
    from ray_lightning_tpu_torch.models.llama import init_weights

    cfg = serve_config(n_layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    model = init_weights(cfg, gen)
    torch.cuda.synchronize()
    log(f"serve: built {cfg.n_layers}-layer Llama-3-8B in "
        f"{time.perf_counter() - t0:.1f}s")
    return model


def engine_config():
    from ray_lightning_tpu_torch.serve.engine import EngineConfig

    return EngineConfig(capacity=4, block_size=16, blocks_per_slot=256,
                        prefill_chunk=128)


def make_requests(vocab_size: int, seed: int):
    """8 requests, prompts of 200-1500 tokens from ``seed``, 32 new
    tokens each; even indices greedy, odd ones sampled (temperature 0.8,
    top-k 50)."""
    from ray_lightning_tpu_torch.serve.scheduler import Request
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(200, 1501, 8)
    return [Request(rid=f"r{i}",
                    prompt=rng.integers(0, vocab_size, n).astype(np.int32),
                    max_new_tokens=32,
                    temperature=0.0 if i % 2 == 0 else 0.8,
                    top_k=None if i % 2 == 0 else 50, seed=seed + i)
            for i, n in enumerate(lens)]


def compare_lanes(model, ecfg, reqs, kernel_probe, kernel_done):
    """Serve the greedy ``reqs`` through the reference lanes, forced
    along the kernel lanes' tokens, and compare the logits of every
    step. Returns the JSON row and the list of what is out of
    tolerance (empty when the lanes agree)."""
    tokens = {r.rid: kernel_done[r.rid].tokens for r in reqs}
    engine, sched, probe = serve(model, ecfg, use_kernels=False,
                                 forced=(kernel_probe.logits, tokens))
    if engine.attention_path != "reference-gather":
        raise AssertionError("reference lanes not selected")
    ref = drain(sched, reqs)
    steps = [(rid, t, *torch.stack(v).tolist())
             for rid, t, *v in probe.steps]
    del engine, sched, probe
    problems = [f"{r.rid}: reference stream {ref[r.rid].tokens} was not "
                f"forced to {tokens[r.rid]}" for r in reqs
                if ref[r.rid].tokens != tokens[r.rid]]
    want_steps = sum(r.max_new_tokens for r in reqs)
    if len(steps) != want_steps:
        problems.append(f"compared {len(steps)} steps, not {want_steps}")
    worst = max(s[2] for s in steps)
    if not worst <= LOGIT_TOL:
        problems.append(f"logits differ by {worst:.4g} > {LOGIT_TOL}")
    differ = [dict(rid=rid, step=t, ref_margin=m)
              for rid, t, _, m, _ in steps if m > 0]
    problems += [f"{d['rid']} step {d['step']}: the reference prefers its "
                 f"own argmax by {d['ref_margin']:.4g} >= {LOGIT_TOL}"
                 for d in differ if not d["ref_margin"] < LOGIT_TOL]
    row = dict(phase="lanes", streams=len(reqs), steps=len(steps),
               logits_max_abs_diff=worst,
               prefill_logits_max_abs_diff=max(s[2] for s in steps
                                               if s[1] == 0),
               logits_max_abs=max(s[4] for s in steps),
               tolerance=LOGIT_TOL, argmax_differs=differ)
    return row, problems


def serve_phase(seed: int, n_layers: int):
    model = build_model(seed, n_layers)
    ecfg = engine_config()
    reqs = make_requests(model.cfg.vocab_size, seed)
    kernels = all_kernels()
    engine, sched, probe = serve(model, ecfg, use_kernels=None)
    if (engine.attention_path, engine.prefill_path) != ("paged-kernel",
                                                        "paged-kernel"):
        raise AssertionError(f"kernel lanes not selected: "
                             f"{engine.attention_path}/{engine.prefill_path}")
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    done = drain(sched, reqs)
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    # 13 (d)'s terms: the engine's bytes, the run's peak above them
    live = engine.live_bytes()
    increment = torch.cuda.max_memory_allocated() - resident
    # what (b) is held to, before the profiled window adds its ticks
    ref = dict(ticks=probe.ticks, chunks=probe.chunks,
               tick_s={k: list(v) for k, v in probe.tick_s.items()})
    want = serve_formula(n_layers, probe.ticks, probe.chunks)
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if sorted(done) != sorted(r.rid for r in reqs):
        raise AssertionError(f"completed {sorted(done)}")
    vocab = model.cfg.vocab_size
    for c in done.values():
        if len(c.tokens) != 32 or not all(0 <= t < vocab for t in c.tokens):
            raise AssertionError(f"{c.rid}: bad tokens {c.tokens}")
    n_tok = sum(len(c.tokens) for c in done.values())
    ttft = sorted(c.ttft_s for c in done.values())
    print(json.dumps(dict(
        phase="serve", layers=n_layers, requests=len(done),
        prompt_tokens=sum(len(r.prompt) for r in reqs), new_tokens=n_tok,
        ticks=probe.ticks, prefill_chunks=probe.chunks,
        wall_s=wall, decode_tokens_per_s=n_tok / wall,
        ttft_p50_s=statistics.median(ttft), ttft_max_s=ttft[-1],
        tpot_p50_s=statistics.median(c.tpot_s for c in done.values()),
        tick_ms_p50={k: statistics.median(v) * 1e3
                     for k, v in probe.tick_s.items() if v},
        tick_count={k: len(v) for k, v in probe.tick_s.items()},
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
        attention_path=engine.attention_path,
        prefill_path=engine.prefill_path, launches=launches)), flush=True)
    del engine, sched

    # -- 9b: the same requests with live metrics and a flight recorder ----
    t9 = time.perf_counter()
    for k, v in serve_metrics_phase(model, ecfg, reqs, ref, done).items():
        launches[k] += v
    t9 = time.perf_counter() - t9

    # -- the greedy half again through the reference lanes ----------------
    greedy = [r for r in reqs if r.temperature == 0.0]
    row, problems = compare_lanes(model, ecfg, greedy, probe, done)
    print(json.dumps(row), flush=True)
    if problems:
        raise AssertionError("kernel vs reference lanes: "
                             + "; ".join(problems))

    # -- 11 (a), (a') and (b): the driver and generate on this model ------
    t11 = time.perf_counter()
    for k, v in driver_inline_phase(model, ecfg, reqs, done).items():
        launches[k] += v
    for k, v in generate_phase(model, reqs, done).items():
        launches[k] += v
    t11 = time.perf_counter() - t11

    # -- 13 (a), (b), (d), (e): the rest of serving on this model ---------
    t13 = time.perf_counter()
    for phase in (lambda: spec_phase(seed, model, ecfg, reqs, done),
                  lambda: self_draft_phase(seed, reqs),
                  lambda: autotune_phase(model, ecfg, reqs, done)):
        for k, v in phase().items():
            launches[k] += v
    serve_plan_phase(model, ecfg, live, increment)
    t13 = time.perf_counter() - t13
    # -- 14 (c): a bursty trace through the autoscaled driver -------------
    for k, v in autoscale_phase(model, ecfg).items():
        launches[k] += v
    return launches, t9, t11, t13


# ---- phase 11: the serving front end on the card ---------------------------
#
# (a), (a') and (b) run inside phase 4, on its model and requests; (c)
# after it, on a 4-layer model of its own. Kernel launches inside (c)'s
# replica worker processes are theirs: (c)'s in-process inline reference
# is what this process counts.

#: (c)'s depth, cut for time: its params file holds every weight (16
#: layers: ~9 GB; 4: ~3.9 GB) and each replica worker loads it
DRIVER_PROC_LAYERS = 4
#: tokens replica 1 emits before (c) SIGKILLs it (its four requests
#: stream 32 tokens each)
DRIVER_KILL_AFTER = 24
#: where phase 11 keeps its run dirs and (c)'s params file (git-ignored;
#: removed after)
DRIVER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "rlt_logs", "chip_smoke_driver")
DRIVER_TIMEOUT_S = 300


def serve_formula(n_layers: int, ticks: int, chunks: int) -> dict:
    """Phase 4's formula: the decode L a tick, the prefill L a chunk,
    RMSNorm 2L+1 a model call; no flash."""
    want = {k.__name__: 0 for k in all_kernels()}
    want.update(paged_attention_kernel=n_layers * ticks,
                paged_prefill_kernel=n_layers * chunks,
                rms_norm_kernel=(2 * n_layers + 1) * (ticks + chunks))
    return want


def counted(fn, n_layers: int, problems: list, what: str, formula=None):
    """Run ``fn()`` with every launch counter zeroed just before and read
    just after, counting the engines' ticks and prefill chunks; holds
    the launches to phase 4's formula (or ``formula(ticks, chunks)``).
    Returns (fn's result, launches, wall seconds)."""
    from ray_lightning_tpu_torch.serve.cli import KernelCalls

    kernels = all_kernels()
    ticks = KernelCalls()
    for k in kernels:
        k.launches = 0
    with ticks.active():
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    want = (formula or functools.partial(serve_formula, n_layers))(
        ticks.ticks, ticks.chunks)
    if launches != want:
        problems.append(f"{what}: launches {launches} != {want} "
                        f"({ticks.ticks} ticks, {ticks.chunks} chunks)")
    return out, launches, wall


def same_streams(outputs: dict, want: dict, what: str, problems: list):
    bad = sorted(rid for rid in want if list(outputs.get(rid, []))
                 != list(want[rid]))
    if bad:
        problems.append(f"{what}: streams differ from the reference: {bad}")
    return not bad


def serve_row(phase: str, res, wall: float, launches: dict, **extra):
    meta = res.meta.values()
    n_tok = sum(len(v) for v in res.outputs.values())
    return dict(phase=phase, requests=len(res.outputs), new_tokens=n_tok,
                wall_s=wall, decode_tokens_per_s=n_tok / wall,
                ttft_p50_s=statistics.median(m["ttft_s"] for m in meta),
                tpot_p50_s=statistics.median(m["tpot_s"] for m in meta),
                restarts=res.restarts, launches=launches, **extra)


def check_run_dir(run_dir: str, rids, problems: list, what: str) -> dict:
    """Every completed request has its queue-wait, prefill and decode
    spans, and the merged completion histogram counts them all."""
    from ray_lightning_tpu_torch.serve.driver import aggregate_serve_metrics
    from ray_lightning_tpu_torch.telemetry.spans import (
        PH_DECODE,
        PH_PREFILL,
        PH_QUEUE_WAIT,
        read_spans,
    )

    spans = [s for p in glob.glob(os.path.join(run_dir, "telemetry",
                                               "rank*.spans.jsonl"))
             for s in read_spans(p)["spans"]]
    seen = {ph: {(s.get("meta") or {}).get("rid") for s in spans
                 if s["phase"] == ph}
            for ph in (PH_QUEUE_WAIT, PH_PREFILL, PH_DECODE)}
    missing = {ph: sorted(set(rids) - got) for ph, got in seen.items()
               if set(rids) - got}
    if missing:
        problems.append(f"{what}: requests without spans: {missing}")
    agg = aggregate_serve_metrics(run_dir) or {}
    hist_n = agg.get("latency", {}).get("ttft_s", {}).get("n")
    if hist_n != len(rids):
        problems.append(f"{what}: the merged completion histogram counts "
                        f"{hist_n}, not {len(rids)}")
    return dict(spans=len(spans), completion_hist_n=hist_n)


def driver_inline_phase(model, ecfg, reqs, phase4_done):
    """(a): two inline replicas over phase 4's model serve its requests;
    (a'): the live session on the same model. Returns their launches."""
    from ray_lightning_tpu_torch.serve.driver import (
        ReplicaGroupConfig,
        ServeDriver,
    )

    L = model.cfg.n_layers
    problems = []
    want = {rid: c.tokens for rid, c in phase4_done.items()}
    run_dir = os.path.join(DRIVER_DIR, "inline")
    shutil.rmtree(DRIVER_DIR, ignore_errors=True)
    drv = ServeDriver(model.cfg, model, ReplicaGroupConfig(
        n_replicas=2, backend="inline", engine=ecfg, run_dir=run_dir))
    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = counted(lambda: drv.run(reqs), L, problems,
                                  "(a)")
    equal = same_streams(res.outputs, want, "(a) vs phase 4", problems)
    files = check_run_dir(run_dir, list(want), problems, "(a)")
    print(json.dumps(serve_row(
        "driver_inline", res, wall, launches, layers=L, replicas=2,
        streams_equal_phase4=equal, engine_steps=res.stats["engine_steps"],
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
        **files)), flush=True)

    def session():
        s = ServeDriver(model.cfg, model, ReplicaGroupConfig(
            n_replicas=1, backend="inline", engine=ecfg,
            run_dir=os.path.join(DRIVER_DIR, "session")))
        s.start()
        for r in reqs[:4]:
            s.submit(r)
        s.add_replica()
        for r in reqs[4:]:
            s.submit(r)
        s.tick()
        if not s.replicas[0].sched.slots:
            problems.append("(a') replica 0 held no work at its removal")
        s.remove_replica(0, graceful=True)
        return s.stop()

    res2, launches2, wall2 = counted(session, L, problems, "(a')")
    equal2 = same_streams(res2.outputs, res.outputs, "(a') vs (a)",
                          problems)
    print(json.dumps(serve_row(
        "driver_session", res2, wall2, launches2, layers=L,
        streams_equal_a=equal2,
        replicas_spawned=res2.stats["replicas_spawned"],
        final_replicas=res2.stats["final_replicas"],
        served_by=sorted({m["replica"] for m in res2.meta.values()}))),
        flush=True)
    if problems:
        raise AssertionError("phase 11 (a): " + "; ".join(problems))
    return {k: launches[k] + launches2[k] for k in launches}


class LogitsProbe:
    """Wraps a model's lm_head projection (`Llama.logits`, which every
    logits `generate` takes a token from passes through) for one greedy
    B-1 `generate` call: records each step's f32 logits, or, given the
    kernel lane's ``(logits, tokens)``, compares each step's logits with
    the kernel lane's and returns a one-hot at the kernel lane's token,
    so the reference lane follows the kernel lane's stream."""

    def __init__(self, model, forced=None):
        self.model, self.forced = model, forced
        self.logits, self.steps = [], []
        self._fn = model.logits

    def __enter__(self):
        self.model.logits = self
        return self

    def __exit__(self, *exc):
        del self.model.logits

    def __call__(self, h):
        out = self._fn(h)
        row = out.reshape(-1, out.shape[-1])[0]
        t = len(self.logits)
        self.logits.append(row.clone())
        if self.forced is None:
            return out
        k_logits, k_tokens = self.forced
        tok = k_tokens[t]
        self.steps.append(((k_logits[t] - row).abs().max(),
                           row.max() - row[tok]))
        onehot = torch.zeros_like(out)
        onehot[..., tok] = 1.0
        return onehot


def generate_phase(model, reqs, phase4_done):
    """(b): phase 4's greedy prompts through `generate`, the kernel lane
    (the flash forward in each prefill, RMSNorm in every model call)
    against `force_reference()` lanes teacher-forced along its tokens."""
    from ray_lightning_tpu_torch.models.llama import generate
    from ray_lightning_tpu_torch.ops import dispatch
    from ray_lightning_tpu_torch.ops.kernels import flash

    L = model.cfg.n_layers
    greedy = [r for r in reqs if r.temperature == 0.0]
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    problems, lanes, rows = [], {}, []
    t0 = time.perf_counter()
    for r in greedy:
        before = flash.flash_fwd_kernel.launches
        with LogitsProbe(model) as probe:
            toks = generate(model, r.prompt[None], r.max_new_tokens)[0]
        n_flash = flash.flash_fwd_kernel.launches - before
        if n_flash != L:
            problems.append(f"{r.rid}: {n_flash} flash launches in its "
                            f"prefill, not {L}")
        lanes[r.rid] = (probe.logits, toks.tolist())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    calls = sum(r.max_new_tokens for r in greedy)  # prefill + decode steps
    want = {k.__name__: 0 for k in kernels}
    want.update(flash_fwd_kernel=L * len(greedy),
                rms_norm_kernel=(2 * L + 1) * calls)
    if launches != want:
        problems.append(f"generate launches {launches} != {want}")
    for r in greedy:
        with dispatch.force_reference(), LogitsProbe(
                model, forced=lanes[r.rid]) as probe:
            ref = generate(model, r.prompt[None], r.max_new_tokens)[0]
        if ref.tolist() != lanes[r.rid][1]:
            problems.append(f"{r.rid}: the reference lane was not forced")
        rows += [(r.rid, t, float(d), float(m))
                 for t, (d, m) in enumerate(probe.steps)]
    worst = max(d for _, _, d, _ in rows)
    if not worst <= LOGIT_TOL:
        problems.append(f"generate lanes' logits differ by {worst:.4g} > "
                        f"{LOGIT_TOL}")
    problems += [f"{rid} step {t}: the reference prefers its own argmax by "
                 f"{m:.4g} >= {LOGIT_TOL}" for rid, t, _, m in rows
                 if not m < LOGIT_TOL]
    agree = {r.rid: sum(a == b for a, b in zip(lanes[r.rid][1],
                                               phase4_done[r.rid].tokens))
             for r in greedy}
    print(json.dumps(dict(
        phase="generate", layers=L, prompts=len(greedy),
        prompt_lengths=[len(r.prompt) for r in greedy], wall_s=wall,
        steps=len(rows), logits_max_abs_diff=worst, tolerance=LOGIT_TOL,
        prefill_logits_max_abs_diff=max(d for _, t, d, _ in rows if t == 0),
        argmax_differs=[dict(rid=rid, step=t, ref_margin=m)
                        for rid, t, _, m in rows if m > 0],
        tokens_agreeing_with_engine=agree,
        tokens_compared=sum(r.max_new_tokens for r in greedy),
        launches=launches)), flush=True)
    if problems:
        raise AssertionError("phase 11 (b): " + "; ".join(problems))
    return launches


def driver_process_phase(seed: int):
    """(c): two process replicas on the card at 4 layers, replica 1
    SIGKILL'd mid-stream, against an inline driver at the same weights in
    this process. Returns the inline reference's launches."""
    from ray_lightning_tpu_torch.ops import build
    from ray_lightning_tpu_torch.serve.driver import (
        ReplicaGroupConfig,
        ServeDriver,
        save_params_npz,
    )

    problems = []
    t_all = time.perf_counter()
    model = build_model(seed, DRIVER_PROC_LAYERS)
    ecfg = engine_config()
    reqs = make_requests(model.cfg.vocab_size, seed)
    os.makedirs(DRIVER_DIR, exist_ok=True)
    params = os.path.join(DRIVER_DIR, "params.npz")
    t0 = time.perf_counter()
    save_params_npz(model, params)
    save_s = time.perf_counter() - t0
    inline = ServeDriver(model.cfg, model, ReplicaGroupConfig(
        n_replicas=2, backend="inline", engine=ecfg))
    ref, launches, ref_wall = counted(lambda: inline.run(reqs),
                                      DRIVER_PROC_LAYERS, problems,
                                      "(c) inline")
    del inline
    gc.collect()
    torch.cuda.empty_cache()
    run_dir = os.path.join(DRIVER_DIR, "process")
    drv = ServeDriver(serve_config(DRIVER_PROC_LAYERS), params,
                      ReplicaGroupConfig(
                          n_replicas=2, backend="process", engine=ecfg,
                          run_dir=run_dir, compile_cache_dir=build.BUILD,
                          start_timeout=DRIVER_TIMEOUT_S))
    t0 = time.perf_counter()
    res = drv.run(reqs, fault={"replica": 1,
                               "kill_after_tokens": DRIVER_KILL_AFTER})
    wall = time.perf_counter() - t0
    if res.restarts != {0: 0, 1: 1}:
        problems.append(f"(c) restarts {res.restarts} != {{0: 0, 1: 1}}")
    equal = same_streams(res.outputs, ref.outputs, "(c) vs inline",
                         problems)
    try:
        with open(os.path.join(run_dir, "flight.json")) as f:
            dumps = json.load(f)["dumps"]
    except (OSError, ValueError, KeyError) as exc:
        dumps = []
        problems.append(f"(c) no readable flight.json: {exc!r}")
    death = dumps[0]["death"] if dumps else {}
    if death.get("kind") != "retryable" or not death.get("respawning"):
        problems.append(f"(c) flight.json classification {death}")
    starts = res.stats["replica_starts"]
    print(json.dumps(serve_row(
        "driver_process", res, wall, {}, layers=DRIVER_PROC_LAYERS,
        replicas=2, streams_equal_inline=equal,
        params_file_gib=os.path.getsize(params) / 2**30, save_s=save_s,
        inline_wall_s=ref_wall, inline_launches=launches,
        replica_starts=starts, flight_death=death,
        flight_events=len(dumps[0].get("events", [])) if dumps else 0,
        respawn_warmup_s=[s["warmup_s"] for s in starts if s["attempt"]],
        respawn_nvcc_s=[s["build_s"] for s in starts if s["attempt"]],
        phase_wall_s=time.perf_counter() - t_all)), flush=True)
    if problems:
        shutil.rmtree(DRIVER_DIR, ignore_errors=True)
        raise AssertionError("phase 11 (c): " + "; ".join(problems))
    # 14 (d): the same params file and requests through a process
    # session that the autoscale controller grows
    process_scale_up(model, params, ecfg, reqs, ref.outputs)
    # 13 (c): the same params file and requests through a tensor-parallel
    # replica, against the one-card streams
    t13 = time.perf_counter()
    try:
        tp_launches = tp_serve_phase(model, params, ecfg, reqs, ref.outputs)
    finally:
        shutil.rmtree(DRIVER_DIR, ignore_errors=True)
    for k, v in tp_launches.items():
        launches[k] += v
    return launches, time.perf_counter() - t13


def process_scale_up(model, params: str, ecfg, reqs, want: dict) -> None:
    """14 (d): a live session of one process replica on 11 (c)'s params
    file; one poll of an `AutoscaleController` under a scripted burst (a
    sustained-pressure signal) adds the second process replica, timed
    (``scale_up_s``, the new replica's start split); then 11 (c)'s
    requests, submitted to the live session, every stream 11 (c)'s
    inline stream under phase 13's margin rule (their batches differ
    from ``run()``'s, which hands each replica its share at once)."""
    from ray_lightning_tpu_torch.autoscale import (
        AutoscaleController,
        ControllerConfig,
        PolicyConfig,
        read_ledger,
    )
    from ray_lightning_tpu_torch.ops import build
    from ray_lightning_tpu_torch.serve.driver import (
        ReplicaGroupConfig,
        ServeDriver,
    )

    problems = []
    t_all = time.perf_counter()
    run_dir = os.path.join(DRIVER_DIR, "scale_up")
    drv = ServeDriver(serve_config(DRIVER_PROC_LAYERS), params,
                      ReplicaGroupConfig(
                          n_replicas=1, backend="process", engine=ecfg,
                          run_dir=run_dir, compile_cache_dir=build.BUILD,
                          start_timeout=DRIVER_TIMEOUT_S))
    try:
        drv.start()
        burst = {"available": True, "pressure": 2.0, "queue_depth_now": 8.0,
                 "queue_depth_p50": 8.0, "occupancy": 1.0,
                 "total_slots": 4.0}
        ctl = AutoscaleController(drv, ControllerConfig(
            policy=PolicyConfig(min_replicas=1, max_replicas=2,
                                sustain_polls=1)),
            run_dir=run_dir, signal_fn=lambda: dict(burst))
        entry = ctl.step(now=0.0)
        out = entry["outcome"]
        if not (entry["decision"]["action"] == "scale_up" and out.get("ok")
                and out.get("added") == [1] and drv.n_live == 2):
            problems.append(f"the scale-up did not land: {entry}")
        for r in reqs:
            drv.submit(r)
        t0 = time.perf_counter()
        while drv.busy():
            drv.tick()
            time.sleep(0.002)
        serve_s = time.perf_counter() - t0
    finally:
        res = drv.stop()
    parted = hold_streams(model, reqs, res.outputs, want, "14 (d)",
                          problems)
    starts = res.stats["replica_starts"]
    new = next((st for st in starts if st["replica"] == 1
                and not st["attempt"]), None)
    if new is None:
        problems.append("no start record of the added replica")
    served = collections.Counter(m.get("replica") for m in res.meta.values())
    if set(served) != {0, 1}:
        problems.append(f"requests by replica {dict(served)}: the added "
                        "replica served none")
    PHASE14_S["process_scale_up"] = time.perf_counter() - t_all
    print(json.dumps(dict(
        phase="autoscale_process", layers=DRIVER_PROC_LAYERS,
        decision=entry["decision"], outcome=out,
        scale_up_s=ctl.scale_up_s[0] if ctl.scale_up_s else None,
        new_replica_start=new, ledger_lines=len(read_ledger(run_dir)),
        requests=len(reqs), requests_by_replica=dict(served),
        streams_bitwise=not parted, parted=parted, serve_s=serve_s,
        phase_wall_s=PHASE14_S["process_scale_up"])), flush=True)
    if problems:
        raise AssertionError("phase 14 (d): " + "; ".join(problems))


# ---- phase 13: the rest of serving -----------------------------------------
#
# (a), (b), (d) and (e) run inside phase 4, on its model and requests; (c)
# inside phase 11 (c), on its params file, requests and one-card streams.
# (c)'s rank processes count their own launches and report them with
# their results.

#: (a)'s draft: Llama-3-8B at full width, a quarter of phase 4's depth
SPEC_DRAFT_LAYERS = 4
#: tokens verified a tick (`DraftConfig(k)`)
SPEC_K = 4
#: (b): the f32 self-draft's depth (full width)
SELF_DRAFT_LAYERS = 2
#: (b): a rejected self-proposal is allowed only where the f32 plain
#: lane's top-2 margin is below this share of its largest |logit|
SELF_DRAFT_MARGIN = 1e-4
#: (c): ranks of the tensor-parallel replica (processes on the one card)
TP_SERVE = 2
#: (e)'s artifact (git-ignored; removed after)
TUNE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "rlt_logs", "chip_smoke_tune")


def spec_formula(n_layers: int, draft_layers: int, k: int, ticks: int,
                 chunks: int) -> dict:
    """A speculative engine's launches: no paged kernel (its lanes are
    the dense ones); RMSNorm 2L+1 a target call (one verify a tick, one a
    prefill chunk) and 2L'+1 a draft call (k trips a tick, one a
    chunk)."""
    want = {k_.__name__: 0 for k_ in all_kernels()}
    want["rms_norm_kernel"] = ((2 * n_layers + 1) * (ticks + chunks)
                               + (2 * draft_layers + 1) * (k * ticks
                                                           + chunks))
    return want


def plain_scores(model, req, prefix):
    """The plain lane's scores for the token after ``req.prompt + prefix``
    (`dispatch.force_reference`: plain attention and RMSNorm, no kernel
    launched), and the bound a margin is held to: the f32 logits for a
    greedy request; for a sampled one the scores its draw takes the
    argmax of (temperature, top-k, the Gumbel noise of its step's seed),
    with `LOGIT_TOL` scaled by 1 / temperature."""
    import numpy as np

    from ray_lightning_tpu_torch.ops import dispatch
    from ray_lightning_tpu_torch.serve.engine import _split_key
    from ray_lightning_tpu_torch.serve.scheduler import _key_data

    toks = torch.tensor(np.concatenate([req.prompt, np.asarray(
        prefix, np.int32)])[None], device=model.device)
    with torch.no_grad(), dispatch.force_reference():
        logits = model.logits(model.hidden(toks)[:, -1])[0].float()
    if req.temperature == 0.0:
        return logits, LOGIT_TOL
    key = _key_data(req.seed)
    for _ in range(len(prefix)):
        key, _seed = _split_key(key)
    _key, seed = _split_key(key)
    scaled = logits / req.temperature
    if req.top_k:
        kth = torch.topk(scaled, req.top_k).values[-1]
        scaled = torch.where(scaled >= kth, scaled,
                             torch.full_like(scaled, float("-inf")))
    g = torch.Generator(device=model.device)
    g.manual_seed(seed)
    u = torch.rand(scaled.shape, generator=g, device=model.device)
    return scaled - torch.log(-torch.log(u)), LOGIT_TOL / req.temperature


def hold_streams(model, reqs, got: dict, want: dict, what: str,
                 problems: list, bound=None) -> list:
    """Each stream of ``got`` token for token ``want``'s, but where the
    plain lane's top-2 margin at the first position they part is below
    the bound (`plain_scores`'; ``bound(scores)`` when given): a near
    tie, after which the streams are not compared. Returns where each
    parting happened, with its margin."""
    parted = []
    for r in reqs:
        a, b = list(got.get(r.rid, [])), list(want[r.rid])
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 None if len(a) == len(b) else min(len(a), len(b)))
        if t is None:
            continue
        scores, tol = plain_scores(model, r, b[:t])
        if bound is not None:
            tol = bound(scores)
        top = torch.topk(scores, 2).values
        margin = float(top[0] - top[1])
        parted.append(dict(rid=r.rid, step=t, margin=margin, bound=tol,
                           got=a[t] if t < len(a) else None,
                           want=b[t] if t < len(b) else None))
        if not margin < tol:
            problems.append(f"{what}: {r.rid} parts from its reference at "
                            f"step {t} where the plain lane's margin is "
                            f"{margin:.4g} >= {tol:.4g}")
    return parted


def spec_session(model, ecfg, reqs, draft_model, problems, what):
    """Serve ``reqs`` through an inline `ServeDriver` session whose one
    replica drafts with ``draft_model`` at ``SPEC_K``, counted by
    `spec_formula`. Returns (result, its scheduler, its engine's live
    bytes, launches, wall)."""
    from ray_lightning_tpu_torch.serve.driver import (
        ReplicaGroupConfig,
        ServeDriver,
    )
    from ray_lightning_tpu_torch.serve.engine import DraftConfig

    secfg = dataclasses.replace(ecfg, draft=DraftConfig(k=SPEC_K))
    drv = ServeDriver(model.cfg, model, ReplicaGroupConfig(
        n_replicas=1, backend="inline", engine=secfg,
        draft_model_cfg=draft_model.cfg), draft_params=draft_model)

    def run():
        drv.start()
        for r in reqs:
            drv.submit(r)
        while drv.busy():
            drv.tick()
        rep = drv.replicas[0]
        return drv.stop(), rep.sched, rep.engine.live_bytes()

    formula = functools.partial(spec_formula, model.cfg.n_layers,
                                draft_model.cfg.n_layers, SPEC_K)
    (res, sched, live), launches, wall = counted(
        run, model.cfg.n_layers, problems, what, formula)
    return res, sched, live, launches, wall


def spec_phase(seed: int, model, ecfg, reqs, phase4_done):
    """13 (a): phase 4's greedy requests through an inline driver whose
    draft is an independent quarter-depth Llama-3-8B, bf16. Returns the
    launches."""
    from ray_lightning_tpu_torch.serve.audit import speculative_plan

    problems = []
    greedy = [r for r in reqs if r.temperature == 0.0]
    want = {r.rid: phase4_done[r.rid].tokens for r in greedy}
    draft = build_model(seed + 13, SPEC_DRAFT_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    res, sched, live, launches, wall = spec_session(
        model, ecfg, greedy, draft, problems, "(a)")
    peak = torch.cuda.max_memory_allocated()
    parted = hold_streams(model, greedy, res.outputs, want, "(a)",
                          problems)
    plan = speculative_plan(model.cfg, draft.cfg, dataclasses.replace(
        ecfg, draft=sched.cfg.draft))
    for key in ("draft_params_bytes", "draft_pool_bytes"):
        if live[key] != plan[key]:
            problems.append(f"(a) the draft holds {live[key]} {key}, "
                            f"speculative_plan {plan[key]}")
    print(json.dumps(serve_row(
        "speculative", res, wall, launches, layers=model.cfg.n_layers,
        draft_layers=SPEC_DRAFT_LAYERS, k=SPEC_K,
        accepted_tokens_per_step=sched.accepted_tokens_per_step,
        parted=parted, live_bytes=live,
        plan={k: plan[k] for k in ("draft_params_bytes", "draft_pool_bytes",
                                   "expected_tokens_per_tick",
                                   "memory_bound_speedup_x")},
        max_memory_allocated_gib=peak / 2**30)), flush=True)
    del draft, res, sched
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("phase 13 (a): " + "; ".join(problems))
    return launches


class EmitProbe:
    """Wraps a speculative `DecodeEngine.tick` to record, for every
    decoding slot a tick's verify rejected a proposal of, the request and
    the stream position of the rejected proposal."""

    def __init__(self, engine, sched):
        self.engine, self.sched = engine, sched
        self.rejected = []
        self._tick = engine.tick
        engine.tick = self

    def __call__(self, tables, pos, decoding, *args, **kw):
        toks, n_emit, rngs = self._tick(tables, pos, decoding, *args, **kw)
        for s in map(int, decoding.nonzero()[0]):
            slot = self.sched.slots[s]
            if n_emit[s] < toks.shape[1]:
                self.rejected.append((slot.req, slot.req.rid,
                                      len(slot.emitted) + int(n_emit[s])))
        return toks, n_emit, rngs


def self_draft_phase(seed: int, reqs):
    """13 (b): a 2-layer full-width Llama-3-8B in f32 drafting for itself
    on 2 greedy requests: every proposal accepted (a rejection only where
    the f32 plain lane's margin is below ``SELF_DRAFT_MARGIN`` of its
    scale), the streams those of the f32 plain reference lane. The
    RMSNorm kernel takes f32 rows here: held first at the lane's rows.
    Returns the launches."""
    from ray_lightning_tpu_torch.models.llama import init_weights
    from ray_lightning_tpu_torch.ops.kernels.rmsnorm import (
        rms_norm_kernel, rms_norm_plain)
    from ray_lightning_tpu_torch.serve.engine import (
        DecodeEngine, DraftConfig)
    from ray_lightning_tpu_torch.serve.scheduler import Scheduler

    problems = []
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 2)
    for n in (C, C * SPEC_K, CH):
        x, w = rms_inputs(gen, n, D, torch.float32)
        x = x.float()
        err, share = hold(rms_norm_kernel(x, w), rms_norm_plain(x, w),
                          f"rms_norm f32 N {n}")
        print(json.dumps(dict(check="rms_norm", case=f"f32 x N {n}", N=n,
                              D=D, x="float32", w="float32",
                              max_abs_err=err, tolerance_share=share)),
              flush=True)
    cfg = dataclasses.replace(serve_config(SELF_DRAFT_LAYERS),
                              dtype=torch.float32)
    model = init_weights(cfg, gen)
    greedy = [r for r in reqs if r.temperature == 0.0][:2]
    ecfg = engine_config()
    # the f32 plain reference lane: the base engine's reference lanes, k
    # tokens past each request's end (the verify checks proposals there)
    ref = drain(Scheduler(DecodeEngine(model, ecfg, use_kernels=False)),
                [dataclasses.replace(r, max_new_tokens=r.max_new_tokens
                                     + SPEC_K) for r in greedy])

    def run():
        eng = DecodeEngine(model, dataclasses.replace(
            ecfg, draft=DraftConfig(k=SPEC_K)), draft_model=model)
        eng.warmup()
        sched = Scheduler(eng)
        probe = EmitProbe(eng, sched)
        return drain(sched, greedy), eng, sched, probe

    formula = functools.partial(spec_formula, cfg.n_layers, cfg.n_layers,
                                SPEC_K)
    (done, eng, sched, probe), launches, wall = counted(
        run, cfg.n_layers, problems, "(b)", formula)

    def bound(scores):
        return SELF_DRAFT_MARGIN * float(scores.abs().max())

    rejected = []
    for req, rid, t in probe.rejected:
        scores = plain_scores(model, req, ref[rid].tokens[:t])[0]
        top = torch.topk(scores, 2).values
        margin = float(top[0] - top[1])
        rejected.append(dict(rid=rid, step=t, margin=margin,
                             bound=bound(scores)))
        if not margin < bound(scores):
            problems.append(f"(b) {rid}: a proposal rejected at step {t} "
                            f"where the margin is {margin:.4g}")
    rate = sched.accepted_tokens_per_step
    if rate != SPEC_K and not rejected:
        problems.append(f"(b) accepted_tokens_per_step {rate} != {SPEC_K}")
    parted = hold_streams(model, greedy, {r: c.tokens for r, c in
                                          done.items()},
                          {r.rid: ref[r.rid].tokens[:r.max_new_tokens]
                           for r in greedy}, "(b)", problems, bound=bound)
    print(json.dumps(dict(
        phase="speculative_self_draft_f32", layers=cfg.n_layers, k=SPEC_K,
        requests=len(greedy), accepted_tokens_per_step=rate,
        rejected=rejected, parted=parted, wall_s=wall, ticks=eng.steps,
        launches=launches)), flush=True)
    del model, eng, sched
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("phase 13 (b): " + "; ".join(problems))
    return launches


def serve_plan_phase(model, ecfg, live: dict, increment: int) -> None:
    """13 (d): the serve plan of phase 4's configuration (what ``plan
    --serve`` prints, at its 16 layers) against phase 4's engine: the
    weights, the pool and ``last_logits`` to the byte; the gathered view
    the kernel lanes retire (the reference lanes' term) above the kernel
    lanes' measured peak increment. Then the CLI's verdict at the full
    32 layers."""
    import contextlib
    import io

    from ray_lightning_tpu_torch.__main__ import main as cli
    from ray_lightning_tpu_torch.serve.audit import (
        format_serve_summary, serve_memory_summary)

    problems = []
    plan = serve_memory_summary(model.cfg, ecfg)
    ref_plan = serve_memory_summary(model.cfg, ecfg, fused=False,
                                    fused_prefill=False)
    for key in ("params_bytes", "pool_bytes", "last_logits_bytes"):
        if plan[key] != live[key]:
            problems.append(f"{key}: plan {plan[key]} != live {live[key]}")
    if not ref_plan["gathered_view_bytes"] > increment:
        problems.append(f"the retired view {ref_plan['gathered_view_bytes']}"
                        f" is not above the peak increment {increment}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        # the plan only: its decode-step audit is phase 19 (c)'s
        rc = cli(["plan", "--serve", "--preset", "llama3-8b", "--seq",
                  str(ecfg.max_slot_len), "--serve-slots",
                  str(ecfg.capacity), "--json", "--no-trace"])
    full = json.loads(out.getvalue().strip().splitlines()[-1])
    if rc != 0 or not full["fits"]:
        problems.append(f"plan --serve at 32 layers: rc {rc}")
    print(json.dumps(dict(
        phase="serve_plan", layers=model.cfg.n_layers,
        plan={k: plan[k] for k in ("params_bytes", "pool_bytes",
                                   "last_logits_bytes",
                                   "gathered_view_bytes",
                                   "per_device_bytes", "budget_bytes",
                                   "attention_path",
                                   "prefill_attention_path")},
        live=live, retired_view_bytes=ref_plan["gathered_view_bytes"],
        peak_increment_bytes=increment,
        verdict=format_serve_summary(plan).splitlines()[-1].strip(),
        verdict_32_layers=format_serve_summary(
            full["serve"]).splitlines()[-1].strip(),
        card_total_memory=torch.cuda.get_device_properties(0).total_memory)),
        flush=True)
    if problems:
        raise AssertionError("phase 13 (d): " + "; ".join(problems))


def autotune_phase(model, ecfg, reqs, phase4_done):
    """13 (e): ``serve llama3-8b --autotune`` at phase 4's geometry; every
    candidate's kernels held against their plain versions here too; the
    artifact's engine serves one of phase 4's greedy requests equal to
    its phase-4 stream (the margin rule). Returns that run's launches."""
    import contextlib
    import io

    from ray_lightning_tpu_torch.__main__ import main as cli
    from ray_lightning_tpu_torch.serve import sweep

    problems = []
    shutil.rmtree(TUNE_DIR, ignore_errors=True)
    os.makedirs(TUNE_DIR)
    path = os.path.join(TUNE_DIR, "autotune.json")
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli(["serve", "llama3-8b", "--autotune", path, "--slots",
                  str(ecfg.capacity), "--block-size", str(ecfg.block_size),
                  "--seq-budget", str(ecfg.max_slot_len),
                  "--prefill-chunk", str(ecfg.prefill_chunk)])
    sweep_s = time.perf_counter() - t0
    art = sweep.load_artifact(path)
    if rc != 0 or art["winner_source"] != "measured":
        problems.append(f"the sweep: rc {rc}, {art['winner_source']}")
    rows = []
    for cand, r in zip(sweep.candidate_grid(ecfg), art["results"]):
        x = sweep.case_inputs(model.cfg, ecfg, cand, "cuda", torch.bfloat16,
                              seed=SEED)
        got, want = sweep.kernel_calls(x), sweep.kernel_calls(x, False)
        shares = {}
        for name in got:
            shares[name] = hold(got[name](), want[name](),
                                f"autotune P {cand.block_size} {name}")[1]
        ok = all(r[c]["ok"] for c in ("decode", "prefill", "shared_spec"))
        if not ok:
            problems.append(f"P {cand.block_size}: the sweep's own check "
                            f"failed {r}")
        rows.append(dict(block_size=cand.block_size,
                         blocks_per_slot=cand.blocks_per_slot,
                         tolerance_share=shares, sweep_ok=ok,
                         **r.get("timing", {})))
    del x, got, want
    tuned = sweep.apply_autotune(ecfg, art)
    greedy = [r for r in reqs if r.temperature == 0.0][:1]

    def one():
        _, sched, _ = serve(model, tuned, use_kernels=None)
        return drain(sched, greedy)

    done, launches, wall = counted(one, model.cfg.n_layers, problems,
                                   "(e) tuned")
    parted = hold_streams(model, greedy, {r: c.tokens for r, c in
                                          done.items()},
                          {r.rid: phase4_done[r.rid].tokens
                           for r in greedy}, "(e)", problems)
    print(json.dumps(dict(
        phase="autotune", candidates=rows, winner=art["winner"],
        winner_source=art["winner_source"], device=art["device"],
        sweep_wall_s=sweep_s, tuned_serve_wall_s=wall, parted=parted,
        launches=launches)), flush=True)
    shutil.rmtree(TUNE_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("phase 13 (e): " + "; ".join(problems))
    return launches


def tp_serve_phase(model, params: str, ecfg, reqs, want: dict):
    """13 (c): a live session on one tensor-parallel replica of
    ``TP_SERVE`` rank processes sharing the card over gloo, 11 (c)'s
    params file and requests: the streams 11 (c)'s one-card ones (the
    margin rule), each rank's launches by phase 4's formula at H 16 / Hkv
    4, its bytes `serve_memory_summary(tp=2)`'s. A correctness lane:
    every all-reduce crosses the host. Returns both ranks' launches."""
    from ray_lightning_tpu_torch.ops import build
    from ray_lightning_tpu_torch.serve.audit import serve_memory_summary
    from ray_lightning_tpu_torch.serve.driver import (
        ReplicaGroupConfig, ServeDriver)

    problems = []
    free_card("serve_tp")
    L = model.cfg.n_layers
    drv = ServeDriver(model.cfg, params, ReplicaGroupConfig(
        n_replicas=1, backend="process", tp=TP_SERVE, engine=ecfg,
        run_dir=os.path.join(DRIVER_DIR, "tp"),
        compile_cache_dir=build.BUILD, start_timeout=DRIVER_TIMEOUT_S))
    t0 = time.perf_counter()
    drv.start()
    start_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    for r in reqs:
        drv.submit(r)
    while drv.busy():
        drv.tick()
        time.sleep(0.002)
    res = drv.stop()
    wall = time.perf_counter() - t1
    parted = hold_streams(model, reqs, res.outputs, want, "(c)", problems)
    ranks = res.stats["replica_ranks"][0]
    plan = serve_memory_summary(model.cfg, ecfg, tp=TP_SERVE)
    chunks = sum(-(-len(r.prompt) // ecfg.prefill_chunk) for r in reqs)
    total = {k.__name__: 0 for k in all_kernels()}
    for r in ranks:
        if r["launches"] != serve_formula(L, r["steps"], chunks):
            problems.append(f"rank {r['rank']} launches {r['launches']} != "
                            f"{serve_formula(L, r['steps'], chunks)}")
        for key in ("params_bytes", "pool_bytes", "last_logits_bytes"):
            if r["live_bytes"][key] != plan[key]:
                problems.append(f"rank {r['rank']} holds {r['live_bytes'][key]}"
                                f" {key}, the plan {plan[key]}")
        for k, v in r["launches"].items():
            total[k] += v
    print(json.dumps(serve_row(
        "serve_tp", res, wall, [r["launches"] for r in ranks],
        layers=L, ranks=TP_SERVE, backend="gloo",
        lane="correctness (every all-reduce crosses the host)",
        heads_a_rank=H // TP_SERVE, kv_heads_a_rank=HKV // TP_SERVE,
        tick_ms_mean=wall / max(1, ranks[0]["steps"]) * 1e3,
        ticks=ranks[0]["steps"], start_s=start_s, parted=parted,
        live_bytes=[r["live_bytes"] for r in ranks],
        plan={k: plan[k] for k in ("params_bytes", "pool_bytes",
                                   "last_logits_bytes")},
        replica_starts=res.stats["replica_starts"])), flush=True)
    if problems:
        raise AssertionError("phase 13 (c): " + "; ".join(problems))
    return total


# ---- phase 5: training at full width ----------------------------------------

#: the train phase: depth, optimizer steps, batch, sequence; the tokens
#: are uniform over the first TRAIN_TOKENS ids, so there is something to
#: learn in 8 steps (the model starts uniform over all 128256)
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_TOKENS = 4, 8, 8192
#: the train phase's peak learning rate (AdamW, warmup 2, cosine)
TRAIN_LR = 3e-4


class StepProbe:
    """Per-step host metrics and the host clock at each step's end (the
    metrics fetch at ``log_every_n_steps=1`` synchronises every step);
    with ``caught`` set to a warnings list, its length at each step's
    end (the synchronising calls so far, under the sync debug mode)."""

    def __init__(self):
        from ray_lightning_tpu_torch.core.callbacks import Callback

        probe = self

        class _CB(Callback):
            def on_train_epoch_start(self, trainer, module):
                if probe.t_loop is None:
                    probe.t_loop = time.perf_counter()

            def on_train_batch_end(self, trainer, module, metrics,
                                   batch_idx):
                probe.rows.append((float(metrics["loss"]),
                                   float(metrics["grad_norm"])))
                probe.t.append(time.perf_counter())
                if probe.caught is not None:
                    probe.caught_at.append(len(probe.caught))

        self.rows, self.t, self.callback = [], [], _CB()
        self.caught, self.caught_at = None, []
        #: the loop's start (after the warm start), and the fit's
        #: callback_metrics (train_once)
        self.t_loop, self.metrics = None, {}

    def first_step_s(self) -> float:
        """The first step's wall from the loop's start (the warm start
        before it is not in it)."""
        return self.t[1] - self.t_loop


def train_once(cfg, tokens, seed: int, callbacks=(), strategy=None,
               inspect=None, batch: int = None, steps: int = None,
               module_kw=None, **trainer_kw):
    """One `Trainer.fit` of `LlamaModule` over ``tokens`` (``strategy``
    default `SingleDevice()``, more `Trainer` keywords in
    ``trainer_kw``, more `LlamaModule` keywords in ``module_kw``;
    ``batch`` and ``steps`` default to phase 5's); returns the StepProbe
    (its ``metrics`` the fit's callback_metrics), the fit's wall time,
    the peak device memory and the parameter count. ``inspect(trainer,
    module)`` runs after the fit, before both are freed."""
    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.llama import LlamaModule
    from ray_lightning_tpu_torch.parallel.strategy import SingleDevice

    steps = steps or TRAIN_STEPS
    probe = StepProbe()
    module = LlamaModule(cfg, lr=TRAIN_LR, warmup_steps=2,
                         total_steps=TRAIN_STEPS, **(module_kw or {}))
    trainer = Trainer(strategy=strategy or SingleDevice(),
                      max_steps=steps,
                      log_every_n_steps=1, enable_checkpointing=False,
                      enable_progress_bar=False, seed=seed,
                      callbacks=[probe.callback, *callbacks], **trainer_kw)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    probe.t.append(t0)
    trainer.fit(module, DataLoader({"tokens": tokens},
                                   batch_size=batch or TB))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if trainer.global_step != steps:
        raise AssertionError(f"fit ran {trainer.global_step} steps")
    probe.metrics = dict(trainer.callback_metrics)
    n_params = module.num_params()
    if inspect is not None:
        inspect(trainer, module)
    del trainer, module
    return probe, wall, torch.cuda.max_memory_allocated(), n_params


def train_inputs(seed: int):
    """The train phase's config and its seeded tokens [steps * B, S + 1]."""
    import numpy as np

    from ray_lightning_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.llama3_8b(max_seq_len=TS, n_layers=TRAIN_LAYERS)
    tokens = np.random.default_rng(seed).integers(
        0, TRAIN_TOKENS, (TRAIN_STEPS * TB, TS + 1)).astype(np.int64)
    return cfg, tokens


def train_reference(cfg, tokens, seed: int, **kw):
    """The fit through the reference lanes, which must launch no kernel
    (``kw``: more `train_once` keywords)."""
    from ray_lightning_tpu_torch.ops import dispatch

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    with dispatch.force_reference():
        out = train_once(cfg, tokens, seed, **kw)
    launched = {k.__name__: k.launches for k in kernels if k.launches}
    if launched:
        raise AssertionError(f"reference lanes launched {launched}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def compare_train(rows, ref_rows):
    """(max |delta loss|, max |delta grad_norm| / grad_norm, problems)
    of the kernel lanes' per-step metrics against the reference lanes'."""
    d_loss = max(abs(a[0] - b[0]) for a, b in zip(rows, ref_rows))
    d_gn = max(abs(a[1] - b[1]) / b[1] for a, b in zip(rows, ref_rows))
    problems = []
    if len(rows) != len(ref_rows):
        problems.append(f"{len(rows)} steps against {len(ref_rows)}")
    if not d_loss <= TRAIN_LOSS_TOL:
        problems.append(f"loss differs by {d_loss:.4g} > {TRAIN_LOSS_TOL}")
    if not d_gn <= TRAIN_GNORM_RTOL:
        problems.append(f"grad_norm differs by {d_gn:.4g} (relative) > "
                        f"{TRAIN_GNORM_RTOL}")
    return d_loss, d_gn, problems


def profile_train(cfg, tokens, seed: int, first: int = 3):
    """The kernel-lanes fit again, under `torch.profiler` from step
    ``first`` to its end: the device's busy share of that window's wall
    time and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from ray_lightning_tpu_torch.core.callbacks import Callback

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    class Window(Callback):
        def on_train_batch_start(self, trainer, module, batch, batch_idx):
            if batch_idx == first:
                torch.cuda.synchronize()
                prof.start()
                window["t0"] = time.perf_counter()

    train_once(cfg, tokens, seed, callbacks=[Window()])
    wall = time.perf_counter() - window["t0"]  # the fit ends synchronised
    prof.stop()
    events = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:16]
    steps = TRAIN_STEPS - first
    print(json.dumps(dict(
        phase="train_profile", steps=steps, wall_s=wall,
        device_busy_s=busy, device_busy_share=busy / wall,
        top=[dict(name=e.key[:160], ms_per_step=e.self_device_time_total
                  / 1e3 / steps, calls_per_step=e.count / steps)
             for e in top])), flush=True)
    gc.collect()
    torch.cuda.empty_cache()


def train_phase(seed: int):
    """Returns the kernels' launch counts of the kernel-lanes fit and its
    per-step (loss, grad_norm)."""
    import numpy as np

    cfg, tokens = train_inputs(seed)
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    live = {}
    probe, wall, peak, n_params = train_once(
        cfg, tokens, seed, inspect=lambda t, m: live.update(
            live_bytes(t, m)))
    live["peak"] = peak
    launches = {k.__name__: k.launches for k in kernels}
    L, n = TRAIN_LAYERS, TRAIN_STEPS
    want = expected_launches(n)
    if launches != want:
        raise AssertionError(f"train launch counts {launches} != {want}")
    losses = [r[0] for r in probe.rows]
    if not all(map(np.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    gc.collect()
    torch.cuda.empty_cache()

    # the same steps from the same weights through the reference lanes
    ref, ref_wall, ref_peak, _ = train_reference(cfg, tokens, seed)
    d_loss, d_gn, problems = compare_train(probe.rows, ref.rows)

    step_s = statistics.median(b - a for a, b in zip(probe.t[2:],
                                                     probe.t[3:]))
    ref_step_s = statistics.median(b - a for a, b in zip(ref.t[2:],
                                                         ref.t[3:]))
    tok = TB * TS
    d, f, v = cfg.dim, cfg.hidden_dim, cfg.vocab_size
    hd, hkv = cfg.head_dim, cfg.n_kv_heads
    per_layer = d * (TH + 2 * hkv) * hd + TH * hd * d + 3 * d * f
    n_matmul = L * per_layer + v * d
    attn = 12 * L * TB * TH * visible_pairs(TS, TS, True, 0) * hd
    flops = 6 * n_matmul * tok + attn
    row = dict(
        phase="train", layers=L, steps=n, batch=TB, seq=TS, params=n_params,
        matmul_params=n_matmul, losses=losses,
        grad_norms=[r[1] for r in probe.rows],
        ref_losses=[r[0] for r in ref.rows],
        ref_grad_norms=[r[1] for r in ref.rows],
        loss_max_abs_diff=d_loss, grad_norm_max_rel_diff=d_gn,
        loss_tol=TRAIN_LOSS_TOL, grad_norm_rtol=TRAIN_GNORM_RTOL,
        fit_wall_s=wall, step_s_p50=step_s, tokens_per_s=tok / step_s,
        flops_per_step=flops, mfu=flops / step_s / BF16_FLOPS_PER_S,
        max_memory_allocated_gib=peak / 2**30, ref_fit_wall_s=ref_wall,
        ref_step_s_p50=ref_step_s,
        ref_max_memory_allocated_gib=ref_peak / 2**30, launches=launches)
    print(json.dumps(row), flush=True)
    if problems:
        raise AssertionError("train kernel vs reference lanes: "
                             + "; ".join(problems))
    profile_train(cfg, tokens, seed)
    return launches, probe.rows, step_s, live

# ---- phase 6: training across processes -------------------------------------
#
# The workers of `fit_distributed` import this file by its name
# (`chip_smoke`; the standard pickle sends the factories below by
# reference), so everything they run is defined at module level.

#: 6 (c)'s run stops and saves here; 14 (a) and 8 (a) resume from it
RESUME_AT = 4
#: limit of one `fit_distributed` call, in seconds
DIST_TIMEOUT_S = 600
#: where the phase writes its checkpoints (git-ignored; removed after)
DIST_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "rlt_logs", "chip_smoke")


#: what the workers' side-channel callables delivered (in the driver)
RECEIVED = []


def _receive(item) -> None:
    RECEIVED.append(item)


def _to_driver(item) -> None:
    """Rank 0 sends ``item`` to the driver as a callable that the
    driver's pump runs there (the side channel's trampoline)."""
    from ray_lightning_tpu_torch.runtime import session

    if session.get_actor_rank() == 0:
        session.put_queue(functools.partial(_receive, item))


class DistProbe(Callback):
    """Runs in a worker: the per-step (step, loss, grad_norm) and the host
    clock at each step's end (the metrics fetch at ``log_every_n_steps=1``
    synchronises every step), the kernels' launches over the fit (zeroed
    at its start, read at its end) and its peak device memory; rank 0
    sends them to the driver when the fit ends."""

    def on_fit_start(self, trainer, module):
        for k in all_kernels():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        self.rows, self.t = [], [time.perf_counter()]
        self.t_loop = None

    def on_train_epoch_start(self, trainer, module):
        if self.t_loop is None:
            self.t_loop = time.perf_counter()

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        self.rows.append((trainer.global_step, float(metrics["loss"]),
                          float(metrics["grad_norm"])))
        self.t.append(time.perf_counter())

    def on_fit_end(self, trainer, module):
        import torch.distributed as dist

        torch.cuda.synchronize()
        m = trainer.callback_metrics
        _to_driver(dict(
            kind="fit", rows=self.rows, t=self.t,
            launches={k.__name__: k.launches for k in all_kernels()},
            peak=torch.cuda.max_memory_allocated(),
            strategy=type(trainer.strategy).__name__,
            world=trainer.strategy.world_size,
            backend=dist.get_backend(), device=str(trainer.strategy.device),
            overlap=trainer.strategy.overlap,
            first_step_s=self.t[1] - self.t_loop if len(self.t) > 1
            else None,
            compile_time_s=m.get("compile_time_s"),
            compile_build_s=m.get("compile_build_s"),
            init_path=trainer.init_path,
            init_path_reason=trainer.init_path_reason,
            init_peak=trainer.init_peak_bytes,
            env={k: os.environ.get(k) for k in (
                SMOKE_DRIVER_ONLY, "CUDA_VISIBLE_DEVICES", "LOCAL_RANK")}))


class TimedLlama(LlamaModule):
    """`LlamaModule` that times a resume's restore in the worker: from
    the optimizer's construction, which the trainer runs just before the
    restore, to ``on_load_checkpoint``, which it runs just after."""

    def configure_optimizers(self):
        self._t_restore = time.perf_counter()
        return super().configure_optimizers()

    def on_load_checkpoint(self, checkpoint):
        torch.cuda.synchronize()
        _to_driver(dict(kind="restore",
                        restore_s=time.perf_counter() - self._t_restore))


class TimedCheckpoint(ModelCheckpoint):
    """`ModelCheckpoint` that times each save (DCP write, barrier, digest
    and meta.json) in the worker; with ``digests``, each save also sends
    its `save_digests` (14 (a) holds its restore against them), whose
    seconds the save's leave out."""

    def __init__(self, *a, digests: bool = False, **kw):
        super().__init__(*a, **kw)
        self.digests = digests
        self._digest_s = 0.0

    def on_save_checkpoint(self, trainer, module, checkpoint):
        if self.digests:
            t0 = time.perf_counter()
            rec = save_digests(trainer, checkpoint)
            torch.cuda.synchronize()
            self._digest_s = time.perf_counter() - t0
            _to_driver(dict(kind="save_digests", digest_s=self._digest_s,
                            **rec))

    def _maybe_save(self, trainer, module, metrics, step_based=False):
        t0 = time.perf_counter()
        self._digest_s = 0.0
        super()._maybe_save(trainer, module, metrics, step_based)
        _to_driver(dict(kind="save", step=trainer.global_step,
                        path=self.best_model_path,
                        save_s=time.perf_counter() - t0 - self._digest_s))


def dist_module(seed: int):
    cfg, _ = train_inputs(seed)
    return TimedLlama(cfg, lr=TRAIN_LR, warmup_steps=2,
                      total_steps=TRAIN_STEPS)


def dist_trainer(strategy: str, max_steps: int, seed: int,
                 ckpt_dir=None, overlap: str = "off", digests: bool = False):
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import FSDP, DataParallel

    callbacks = [DistProbe()]
    if ckpt_dir is not None:
        callbacks.append(TimedCheckpoint(dirpath=ckpt_dir,
                                         every_n_train_steps=RESUME_AT,
                                         save_top_k=-1, digests=digests))
    return Trainer(strategy={"fsdp": FSDP, "ddp": DataParallel}[strategy](
                       overlap=overlap),
                   max_steps=max_steps, log_every_n_steps=1,
                   enable_checkpointing=False, enable_progress_bar=False,
                   seed=seed, callbacks=callbacks)


def dist_data(seed: int):
    from ray_lightning_tpu_torch.core.data import DataLoader

    _, tokens = train_inputs(seed)
    return DataLoader({"tokens": tokens}, batch_size=TB)


def free_card(what: str) -> None:
    """Release the driver's cached device memory before a worker takes
    the card, and say what is free."""
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(json.dumps(dict(phase="card_memory", before=what,
                          free_gib=free / 2**30, total_gib=total / 2**30,
                          driver_allocated_gib=torch.cuda.memory_allocated()
                          / 2**30)), flush=True)


# ---- processes started ahead of their phase ---------------------------
#
# A fresh process spends seconds importing torch, the port and torch's
# compiler stack (`torch._dynamo`, which a torch optimizer imports at its
# first parameter group) before it touches the card. Phases 12 (c), 14
# (a) and 17 start their rank processes early: they import while the
# phase before runs, then wait for a gate file the phase opens; their
# time limits count from the gate.


def await_gate(path: str) -> dict:
    """Wait for the gate ``path`` to open; the arguments the phase wrote
    there ({} for none)."""
    while not os.path.exists(path):
        time.sleep(0.05)
    with open(path) as f:
        return json.load(f)


def open_gate(path: str, **args) -> float:
    """Open the gate ``path`` (atomically, with ``args`` for the waiting
    processes); returns the time it opened (perf_counter)."""
    with open(path + ".tmp", "w") as f:
        json.dump(args, f)
    os.replace(path + ".tmp", path)
    return time.perf_counter()


def warm_imports() -> float:
    """A fresh rank's imports, paid before its gate opens: the port's
    trainer, data and strategies, torch.distributed's FSDP, DTensor and
    checkpoint modules, and `torch._dynamo`. Touches no device. Returns
    the seconds."""
    t0 = time.perf_counter()
    import torch._dynamo  # noqa: F401
    import torch.distributed.checkpoint  # noqa: F401
    import torch.distributed.fsdp  # noqa: F401
    import torch.distributed.tensor  # noqa: F401

    from ray_lightning_tpu_torch.core import data, trainer  # noqa: F401
    from ray_lightning_tpu_torch.parallel import strategy  # noqa: F401

    return time.perf_counter() - t0


def _spawn(target: str, args: str, what: str, timeout: float,
           root_dir: str, ranks: int, env=None) -> list:
    """Start ``ranks`` processes running ``chip_smoke.<target>(rank,
    ranks, port, <args>out)`` on the card (each waits for its phase's
    gate); returns the processes, their outputs, their logs and their
    time limit, counted from the gate's opening."""
    from ray_lightning_tpu_torch.utils.dist import find_free_port

    port = find_free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "0", "LOCAL_RANK": "0",
           **(env or {}),
           "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH",
                                                            "")}
    outs = [os.path.join(root_dir, f"{what}{r}.json") for r in range(ranks)]
    logs = [os.path.join(root_dir, f"{what}{r}.log") for r in range(ranks)]
    procs = []
    for r in range(ranks):
        # unbuffered, with the fault handler: a rank that dies in native
        # code leaves its Python stack in the log
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-u", "-X", "faulthandler", "-c",
                 f"import chip_smoke; chip_smoke.{target}({r}, "
                 f"{ranks}, {port}, {args}{outs[r]!r})"],
                cwd=root, env=env, stdout=f, stderr=subprocess.STDOUT))
    return [procs, outs, logs, timeout]


def _reap(spawned, opened: float) -> tuple:
    """Wait for a `_spawn`'s processes until its time limit from
    ``opened`` (the gate's opening), kill what is left; (return codes,
    outputs or None each, log tails)."""
    procs, outs, logs, timeout = spawned
    deadline = opened + timeout
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            pass
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    got, tails = [], []
    for o, lg in zip(outs, logs):
        if os.path.exists(o):
            with open(o) as f:
                got.append(json.load(f))
        else:
            got.append(None)
        with open(lg) as f:
            tails.append(f.read()[-3000:])
    return [p.returncode for p in procs], got, tails


def run_dist(kind: str, module_factory, trainer_factory, data_factory,
             **kw):
    """One `fit_distributed` / `predict_distributed` on one process (the
    card's machine holds one card; NCCL refuses two ranks on it); returns
    the result and the side channel's items by kind."""
    import chip_smoke as me  # the module the trampoline's items land in
    from ray_lightning_tpu_torch.runtime import fit as fit_mod

    me.RECEIVED.clear()
    t0 = time.perf_counter()
    res = fit_mod.run_distributed(
        kind, module_factory, trainer_factory, data_factory, 1,
        timeout=DIST_TIMEOUT_S, log_dir=os.path.join(DIST_DIR, "workers"),
        return_weights=False, **kw)
    by_kind = {}
    for item in me.RECEIVED:
        by_kind.setdefault(item["kind"], []).append(item)
    return res, by_kind, time.perf_counter() - t0


def expected_launches(steps: int, warm_ups: int = 1,
                      layers: int = TRAIN_LAYERS):
    """The kernels' launches of a fit of ``steps`` train steps (phase 5's
    counts; ``layers`` blocks): the warm start's forward and backward (one
    a fit, the trainer's default) launch what a step does."""
    L, n = layers, steps + warm_ups
    want = {k.__name__: 0 for k in all_kernels()}
    want.update(flash_fwd_kernel=2 * L * n,
                flash_bwd_dkv_kernel=L * n,
                flash_bwd_dq_kernel=L * n,
                rms_norm_kernel=(4 * L + 1) * n)
    return want


def same_steps(rows, ref_rows, what: str, problems: list):
    """``rows`` [(loss, grad_norm)] against phase 5's single-device kernel
    lane: the same kernels at world size 1 give the same numbers, so any
    difference is a fault (no tolerance)."""
    d_loss = max(abs(a[0] - b[0]) for a, b in zip(rows, ref_rows))
    d_gn = max(abs(a[1] - b[1]) for a, b in zip(rows, ref_rows))
    if len(rows) != len(ref_rows) or rows != ref_rows:
        problems.append(f"{what}: per-step loss/grad_norm differ from the "
                        f"single-device lane by {d_loss:.3g} / {d_gn:.3g}")
    return d_loss, d_gn


def fit_row(phase: str, probe: dict, wall: float, ref_rows, want,
            problems: list, **extra):
    rows = [(r[1], r[2]) for r in probe["rows"]]
    d_loss, d_gn = same_steps(rows, ref_rows, phase, problems)
    if probe["launches"] != want:
        problems.append(f"{phase}: launches {probe['launches']} != {want}")
    t = probe["t"]
    steps = [b - a for a, b in zip(t[1:], t[2:])]
    row = dict(
        phase=phase, strategy=probe["strategy"], world=probe["world"],
        backend=probe["backend"], device=probe["device"],
        steps=[r[0] for r in probe["rows"]], losses=[r[0] for r in rows],
        grad_norms=[r[1] for r in rows], loss_max_abs_diff=d_loss,
        grad_norm_max_abs_diff=d_gn,
        step_s_p50=statistics.median(steps) if steps else None,
        max_memory_allocated_gib=probe["peak"] / 2**30,
        launches=probe["launches"], call_wall_s=wall, **extra)
    print(json.dumps(row), flush=True)
    return row


def dist_phase(seed: int, ref_rows):
    """Phase 6; returns the kernels' launches over its fits and (c)'s
    step-4 checkpoint, which 14 (a) and 8 (a) resume (the caller removes
    it)."""
    import numpy as np

    import chip_smoke as me  # the name the workers import
    from ray_lightning_tpu_torch.checkpoint import verify_checkpoint
    from ray_lightning_tpu_torch.checkpoint.io import compute_state_digest
    from ray_lightning_tpu_torch.parallel.strategy import DataParallel

    problems = []
    total = {k.__name__: 0 for k in all_kernels()}
    P = functools.partial
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)

    # (a) fit_distributed, FSDP(overlap="on"), one NCCL rank started by
    # the loopback transport (10 (b))
    fsdp = hot_loop_remote(seed, ref_rows, problems)
    # 12 (d): FSDP builds on the meta device and fills its shards leaf
    # by leaf; the rows above are phase 5's bitwise all the same
    if fsdp["init_path"] != "meta":
        problems.append(f"dist_fsdp initialised {fsdp['init_path']} "
                        f"({fsdp['init_path_reason']})")
    print(json.dumps(dict(phase="meta_init", fit="dist_fsdp",
                          init_path=fsdp["init_path"],
                          init_peak_gib=fsdp["init_peak"] / 2**30)),
          flush=True)
    for k, v in fsdp["launches"].items():
        total[k] += v

    # (b) DataParallel in this process: a one-rank NCCL group the
    # strategy starts itself
    cfg, tokens = train_inputs(seed)
    for k in all_kernels():
        k.launches = 0
    strategy = DataParallel()
    probe, wall, peak, _ = train_once(cfg, tokens, seed, strategy=strategy)
    import torch.distributed as dist

    backend = dist.get_backend()
    strategy.teardown()
    launches = {k.__name__: k.launches for k in all_kernels()}
    for k, v in launches.items():
        total[k] += v
    fit_row("dist_ddp_in_process", dict(
        rows=[(i + 1, *r) for i, r in enumerate(probe.rows)], t=probe.t,
        launches=launches, peak=peak, strategy="DataParallel", world=1,
        backend=backend, device="cuda:0"), wall, ref_rows,
        expected_launches(TRAIN_STEPS), problems)
    del probe, strategy

    # (c) save at RESUME_AT; 14 (a) resumes it on two tensor ranks and 8
    # (a) on one FSDP rank (two fresh attempts under the supervisor).
    # 14 (a)'s ranks start now and import while the save runs
    grow_ranks = elastic_start(seed)
    free_card("dist_save")
    ckdir = os.path.join(DIST_DIR, "ckpt")
    disk = shutil.disk_usage(DIST_DIR)
    # the JAX package's own digest knob for 8B-scale checkpoints:
    # (relpath, size) of every file instead of 23 GB of sha256
    env = {"RLT_CKPT_DIGEST": "size"}
    # the save's digests: what 14 (a)'s restore is held against
    _, got1, wall1 = run_dist("fit", P(me.dist_module, seed),
                              P(me.dist_trainer, "fsdp", RESUME_AT, seed,
                                ckdir, digests=True), P(me.dist_data, seed),
                              env=env)
    save = got1["save"][0]
    path = save["path"]
    nbytes = sum(os.path.getsize(os.path.join(r, f))
                 for r, _, fs in os.walk(path) for f in fs)
    t0 = time.perf_counter()
    compute_state_digest(path, "size")
    digest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok, reason = verify_checkpoint(path)
    verify_s = time.perf_counter() - t0
    if not ok:
        problems.append(f"verify_checkpoint({path}): {reason}")
    first = got1["fit"][0]
    fsdp_rows = [(r[1], r[2]) for r in fsdp["rows"]]
    fit_row("dist_save", first, wall1, fsdp_rows[:RESUME_AT],
            expected_launches(RESUME_AT), problems)
    for k, v in first["launches"].items():
        total[k] += v
    print(json.dumps(dict(
        phase="dist_checkpoint", path=os.path.relpath(path, DIST_DIR),
        bytes=nbytes, files=sum(len(fs) for _, _, fs in os.walk(path)),
        save_s=save["save_s"], digest_mode="size", digest_s=digest_s,
        verify_s=verify_s,
        verify=reason, disk_total_gib=disk.total / 2**30,
        disk_free_gib=disk.free / 2**30,
        disk_free_after_save_gib=shutil.disk_usage(DIST_DIR).free / 2**30)),
        flush=True)
    if problems:
        raise AssertionError("distributed training: " + "; ".join(problems))
    # 14 (a): this checkpoint grown onto two tensor ranks
    for k, v in elastic_phase(seed, path, got1["save_digests"][0],
                              fsdp_rows[RESUME_AT:], grow_ranks).items():
        total[k] += v

    # (d) the reference's matrix: fit, load the best checkpoint, predict
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.mlp import MNISTClassifier
    from ray_lightning_tpu_torch.parallel.strategy import SingleDevice

    mdir = os.path.join(DIST_DIR, "mnist")
    res, _, wall = run_dist("fit", me.mnist_module,
                            P(me.mnist_trainer, mdir), me.mnist_data)
    best = res.best_model_path
    pred, _, pwall = run_dist("predict", me.mnist_module,
                              P(me.mnist_trainer, None), me.mnist_eval_data,
                              ckpt_path=best)
    # no device given: the port's default, the card
    loaded = MNISTClassifier.load_from_checkpoint(best)
    if next(loaded.model.parameters()).device.type != "cuda":
        problems.append("load_from_checkpoint built the model on "
                        f"{next(loaded.model.parameters()).device}")
    local = Trainer(strategy=SingleDevice(), enable_checkpointing=False,
                    enable_progress_bar=False).predict(
        loaded, me.mnist_eval_data())
    acc = float(np.mean(np.concatenate(local)
                        == me.mnist_eval_data().data["y"]))
    same = all(np.array_equal(a, b) for a, b in zip(pred.predictions, local))
    if not (acc >= 0.5 and same and len(pred.predictions) == len(local)):
        problems.append(f"mnist matrix: accuracy {acc}, reload predictions "
                        f"equal the fit's: {same}")
    print(json.dumps(dict(
        phase="dist_mnist", best_model_path=os.path.relpath(best, DIST_DIR),
        val_accuracy=res.metrics.get("ptl/val_accuracy"), accuracy=acc,
        reload_equals_fit=same, fit_wall_s=wall, predict_wall_s=pwall)),
        flush=True)
    shutil.rmtree(mdir)
    if problems:
        raise AssertionError("distributed training: " + "; ".join(problems))
    return total, path


def mnist_module(lr: float = 1e-2):
    from ray_lightning_tpu_torch.models.mlp import MNISTClassifier

    return MNISTClassifier(lr=lr)


def mnist_trainer(ckpt_dir):
    from ray_lightning_tpu_torch.core.callbacks import EarlyStopping
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import RayXlaPlugin

    callbacks = []
    if ckpt_dir is not None:
        callbacks = [
            EarlyStopping(monitor="ptl/val_accuracy", mode="max",
                          patience=2),
            ModelCheckpoint(dirpath=ckpt_dir, monitor="ptl/val_accuracy",
                            mode="max")]
    return Trainer(strategy=RayXlaPlugin(num_workers=1), max_epochs=3,
                   enable_checkpointing=False, enable_progress_bar=False,
                   callbacks=callbacks, seed=SEED)


def mnist_data():
    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.models.mlp import synthetic_mnist

    data = synthetic_mnist(1024, seed=SEED)
    return (DataLoader(data, batch_size=32, shuffle=True, seed=SEED),
            DataLoader(data, batch_size=32))


def mnist_eval_data():
    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.models.mlp import synthetic_mnist

    return DataLoader(synthetic_mnist(1024, seed=SEED), batch_size=32)


# ---- phase 7: the sweep -----------------------------------------------------
#
# Trial processes import this file by its name (`chip_smoke`), as phase
# 6's workers do: the trainables, callbacks and factories below are
# module level, and the trainables go to `sweep.run` as partials.

#: the Llama trials' learning rates: phase 5's (whose steps the trial
#: must repeat bit for bit) and 0, which cannot learn and which ASHA must
#: stop at its first report (a third arm would cost one 8B trial start,
#: about 30 s of the script's time limit)
SWEEP_LRS = (TRAIN_LR, 0.0)
#: a validation pass every SWEEP_VAL_EVERY steps: four reports in 8 steps
SWEEP_VAL_EVERY = 2
SWEEP_ASHA = dict(max_t=4, grace_period=1, reduction_factor=2)
#: the reference's Tune example at one card (BASELINE config 5): the
#: MNIST trials' learning rates and epochs, under ASHA over the epochs.
#: At these rates no two (trial, epoch) reports share a validation loss,
#: so the best checkpoint's reload can tell them apart; the lr-0 arm
#: cannot learn, ASHA must stop it at its first report, and a trial
#: follows it on the card
SWEEP_MNIST_LRS = (3e-5, 0.0, 1e-4)
SWEEP_MNIST_EPOCHS = 2
SWEEP_MNIST_ASHA = dict(max_t=SWEEP_MNIST_EPOCHS, grace_period=1,
                        reduction_factor=2)
#: the best checkpoint's validation loss on reload against its trial's
#: last report, relative; the phase fails unless every other report lies
#: outside it
SWEEP_LOSS_RTOL = 1e-5
#: card memory (GiB) a trial may find taken beyond what the sweep's first
#: trial found: less than one CUDA context, so a process of an earlier
#: trial left on the card shows
SWEEP_FREE_SLACK_GIB = 0.25
#: limit of one trial, in seconds
SWEEP_TRIAL_TIMEOUT_S = 600
#: where the phase keeps its trials (git-ignored; removed after)
SWEEP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "rlt_sweeps", "chip_smoke")
#: what a trial leaves in its dir: its record, also when the scheduler
#: stops it (a stopped trial returns nothing)
TRIAL_RECORD = "smoke_record.json"


def timed_report(metrics: dict, times: list):
    """A `TuneReportCallback` that appends to ``times`` the seconds of
    each report, from the call to the scheduler's verdict (the duplex
    channel's round trip)."""
    from ray_lightning_tpu_torch.sweep.callbacks import TuneReportCallback

    class TimedReport(TuneReportCallback):
        def _fire(self, trainer, extra=None):
            t0 = time.perf_counter()
            try:
                super()._fire(trainer, extra)
            finally:
                times.append(time.perf_counter() - t0)

    return TimedReport(metrics=metrics)


class WorkerPid(Callback):
    """In a trial's `fit_distributed` worker: leaves the worker's pid in
    the trial dir (``RLT_TRIAL_DIR``, which workers inherit)."""

    def on_fit_start(self, trainer, module):
        d = os.path.join(os.environ["RLT_TRIAL_DIR"], "worker_pids")
        os.makedirs(d, exist_ok=True)
        open(os.path.join(d, str(os.getpid())), "w").close()


def live_worker_pids() -> list:
    """The pids `WorkerPid` left in this trial's dir whose processes are
    still running."""
    from ray_lightning_tpu_torch import sweep

    d = os.path.join(sweep.get_trial_dir(), "worker_pids")
    live = []
    for name in (os.listdir(d) if os.path.isdir(d) else ()):
        try:
            os.kill(int(name), 0)
        except ProcessLookupError:
            continue
        live.append(int(name))
    return live


class SweepProbe(Callback):
    """In a trial: the per-step (loss, grad_norm), the validation passes
    and the wall clock when the model is built (fit start) and when the
    first step ends. Listed before the report callback, so a stop
    verdict at a validation pass comes after it is counted."""

    def __init__(self, record: dict):
        self.record = record
        record.update(rows=[], val_passes=0)

    def on_fit_start(self, trainer, module):
        torch.cuda.synchronize()
        self.record["t_model"] = time.time()

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        rows = self.record["rows"]
        rows.append((float(metrics["loss"]), float(metrics["grad_norm"])))
        if len(rows) == 1:
            self.record["t_first_step"] = time.time()

    def on_validation_epoch_end(self, trainer, module, metrics):
        self.record["val_passes"] += 1


def _trial_record() -> dict:
    """A trial's identity and the start of its start split: the wall
    clock of its process's start and of this module's imports, the cards
    it sees, the card memory free before it allocates anything."""
    from ray_lightning_tpu_torch.runtime import session

    free, _ = torch.cuda.mem_get_info()  # the trial's CUDA context
    return dict(t_start=session.get_session().started_at,
                t_imported=IMPORTED_AT,
                cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
                device_count=torch.cuda.device_count(),
                device_name=torch.cuda.get_device_name(),
                mem_free_gib=free / 2**30)


def _write_record(record: dict) -> None:
    from ray_lightning_tpu_torch import sweep

    record["t_end"] = time.time()
    with open(os.path.join(sweep.get_trial_dir(), TRIAL_RECORD), "w") as f:
        json.dump(record, f)


def llama_trainable(config, seed: int):
    """A trial of (a): phase 5's fit at ``config["lr"]`` in this trial
    process, validating one held-out batch every SWEEP_VAL_EVERY steps
    and reporting its loss. Returns (and leaves in the trial dir) its
    record: rows, launches, peak memory, the start split."""
    import numpy as np

    from ray_lightning_tpu_torch.core.callbacks import (
        MemoryMonitor,
        ThroughputMonitor,
    )
    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.ops import build
    from ray_lightning_tpu_torch.parallel.strategy import SingleDevice

    record = dict(lr=config["lr"], **_trial_record())
    trainer = None
    try:
        for name in ("flash_fwd", "flash_bwd", "rmsnorm"):
            build.load(name)
        record["t_kernels"] = time.time()
        for k in all_kernels():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        cfg, tokens = train_inputs(seed)
        val = np.random.default_rng(seed + 1).integers(
            0, TRAIN_TOKENS, (TB, TS + 1)).astype(np.int64)
        record["report_s"] = []
        trainer = Trainer(
            strategy=SingleDevice(), max_steps=TRAIN_STEPS,
            val_check_interval=SWEEP_VAL_EVERY, log_every_n_steps=1,
            enable_checkpointing=False, enable_progress_bar=False, seed=seed,
            callbacks=[SweepProbe(record), ThroughputMonitor(),
                       MemoryMonitor(log_stats=False),
                       timed_report({"loss": "val_loss"},
                                    record["report_s"])])
        trainer.fit(LlamaModule(cfg, lr=config["lr"], warmup_steps=2,
                                total_steps=TRAIN_STEPS),
                    DataLoader({"tokens": tokens}, batch_size=TB),
                    DataLoader({"tokens": val}, batch_size=TB))
        return record
    finally:
        torch.cuda.synchronize()
        metrics = trainer.callback_metrics if trainer is not None else {}
        record.update(
            launches={k.__name__: k.launches for k in all_kernels()},
            peak=torch.cuda.max_memory_allocated(),
            step_time_s=metrics.get("step_time_s"),
            hbm_peak_bytes=metrics.get("hbm_peak_bytes"))
        _write_record(record)


def sweep_mnist_trainer():
    """The reference example's trainer: `RayXlaPlugin` on the card (one
    NCCL worker), checkpoint-then-report every epoch."""
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import RayXlaPlugin
    from ray_lightning_tpu_torch.sweep import TuneReportCheckpointCallback

    return Trainer(
        strategy=RayXlaPlugin(num_workers=1, use_gpu=True),
        max_epochs=SWEEP_MNIST_EPOCHS,
        callbacks=[WorkerPid(), TuneReportCheckpointCallback(
            metrics={"loss": "ptl/val_loss", "acc": "ptl/val_accuracy"})],
        enable_checkpointing=False, enable_progress_bar=False, seed=SEED)


def mnist_trainable(config):
    """A trial of (b): the MNIST fit through `fit_distributed` in one
    worker of its own; the worker's reports reach the sweep through this
    process's pump. A stop verdict raises in that pump, and the worker
    group must be down when it reaches here: the record lists the
    trial's workers still running as it returns."""
    import chip_smoke as me  # the name this trial's worker imports
    from ray_lightning_tpu_torch import sweep
    from ray_lightning_tpu_torch.runtime import fit_distributed

    record = dict(lr=config["lr"], **_trial_record())
    try:
        t0 = time.time()
        res = fit_distributed(
            functools.partial(me.mnist_module, config["lr"]),
            me.sweep_mnist_trainer, me.mnist_data, 1,
            return_weights=False, timeout=DIST_TIMEOUT_S,
            log_dir=os.path.join(sweep.get_trial_dir(), "workers"))
        record.update(fit_call_s=time.time() - t0,
                      val_accuracy=res.metrics["ptl/val_accuracy"])
        return record
    finally:
        record["workers_alive"] = live_worker_pids()
        _write_record(record)


def trial_line(sweep_name: str, t, record: dict, **extra) -> dict:
    """One JSON line of a trial: status, iterations, wall and start
    split."""
    row = dict(
        phase="sweep_trial", sweep=sweep_name, trial=t.trial_id,
        lr=t.config["lr"], status=t.status, iterations=t.iterations,
        losses=[h["loss"] for h in t.history],
        trial_wall_s=record["t_end"] - record["t_start"],
        imports_s=record["t_imported"] - record["t_start"],
        mem_free_gib_at_start=record["mem_free_gib"],
        cuda_visible_devices=record["cuda_visible_devices"],
        device_count=record["device_count"], **extra)
    print(json.dumps(row), flush=True)
    return row


def sweep_phase(seed: int, ref_rows):
    """Phase 7; returns the kernels' launches over the Llama trials."""
    import numpy as np

    import chip_smoke as me  # the name the trial processes import
    from ray_lightning_tpu_torch import sweep
    from ray_lightning_tpu_torch.checkpoint import verify_checkpoint
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.mlp import MNISTClassifier
    from ray_lightning_tpu_torch.parallel.strategy import SingleDevice
    from ray_lightning_tpu_torch.sweep.analysis import Trial

    problems = []
    total = {k.__name__: 0 for k in all_kernels()}
    card = torch.cuda.get_device_name(0)
    shutil.rmtree(SWEEP_DIR, ignore_errors=True)

    def records(analysis):
        out = []
        for t in analysis.trials:
            with open(os.path.join(t.trial_dir, TRIAL_RECORD)) as f:
                out.append(json.load(f))
        return out

    def check_trials(analysis, recs, asha: dict):
        """What every trial of a sweep on the one card must show: card 0
        only; one trial after another (the runner saw their reports in
        trial order); the card as free at each start as at the first;
        the status and reports a replay of the histories through a fresh
        ASHA gives; the lr-0 arm, which cannot learn, stopped before
        ``max_t``."""
        replay = sweep.ASHAScheduler(metric="loss", mode="min", **asha)
        for i, (t, rec) in enumerate(zip(analysis.trials, recs)):
            if (rec["cuda_visible_devices"], rec["device_count"],
                    rec["device_name"]) != ("0", 1, card):
                problems.append(
                    f"{t.trial_id} saw CUDA_VISIBLE_DEVICES="
                    f"{rec['cuda_visible_devices']}, {rec['device_count']} "
                    f"card(s) ({rec['device_name']})")
            if i and rec["t_start"] < recs[i - 1]["t_end"]:
                problems.append(f"{t.trial_id} started before "
                                f"{analysis.trials[i - 1].trial_id} ended")
            if i and (rec["mem_free_gib"]
                      < recs[0]["mem_free_gib"] - SWEEP_FREE_SLACK_GIB):
                problems.append(
                    f"{t.trial_id} found {rec['mem_free_gib']:.3f} GiB "
                    f"free, {recs[0]['mem_free_gib']:.3f} before the first "
                    "trial")
            status, seen = Trial.DONE, 0
            for seen, h in enumerate(t.history, start=1):
                if replay.on_result(t.trial_id, seen, h["loss"]) == "stop":
                    status = Trial.STOPPED
                    break
            if (status, seen) != (t.status, t.iterations):
                problems.append(f"{t.trial_id}: {t.status} after "
                                f"{t.iterations} reports; the replay says "
                                f"{status} after {seen}")
        arm = next(t for t in analysis.trials if t.config["lr"] == 0.0)
        if not (arm.status == Trial.STOPPED
                and arm.iterations < asha["max_t"]):
            problems.append(f"the lr-0 arm ended {arm.status} after "
                            f"{arm.iterations} reports")

    # (a) Llama-3-8B trials, one card, so one at a time
    free_card("sweep_llama")
    t0 = time.perf_counter()
    llama = sweep.run(
        functools.partial(me.llama_trainable, seed=seed),
        config={"lr": sweep.grid_search(list(SWEEP_LRS))}, metric="loss",
        mode="min", scheduler=sweep.ASHAScheduler(**SWEEP_ASHA),
        executor="process", resources_per_trial=sweep.GpuResources(gpus=1),
        storage_dir=os.path.join(SWEEP_DIR, "llama"),
        trial_timeout=SWEEP_TRIAL_TIMEOUT_S)
    llama_wall = time.perf_counter() - t0
    recs = records(llama)
    check_trials(llama, recs, SWEEP_ASHA)
    L = TRAIN_LAYERS
    round_trips = []
    for t, rec in zip(llama.trials, recs):
        steps = len(rec["rows"])
        passes = steps // SWEEP_VAL_EVERY
        if (t.iterations, rec["val_passes"]) != (passes, passes):
            problems.append(f"{t.trial_id}: {steps} steps, "
                            f"{rec['val_passes']} validation passes, "
                            f"{t.iterations} reports")
        want = expected_launches(steps)
        want["flash_fwd_kernel"] += L * passes
        want["rms_norm_kernel"] += (2 * L + 1) * passes
        if rec["launches"] != want:
            problems.append(f"{t.trial_id}: launches {rec['launches']} "
                            f"!= {want}")
        for k, v in rec["launches"].items():
            total[k] += v
        rows = [tuple(r) for r in rec["rows"]]
        same = None
        if t.config["lr"] == TRAIN_LR:
            same = rows == ref_rows[:steps]
            if not same:
                problems.append(f"{t.trial_id} (lr {TRAIN_LR}): rows differ "
                                "from phase 5's kernel lane")
        round_trips += rec["report_s"]
        trial_line(
            "llama", t, rec, steps=steps, val_passes=rec["val_passes"],
            kernels_s=rec["t_kernels"] - rec["t_imported"],
            model_s=rec["t_model"] - rec["t_kernels"],
            first_step_s=rec["t_first_step"] - rec["t_model"],
            step_ms_mean=(rec["step_time_s"] * 1e3
                          if rec["step_time_s"] else None),
            peak_gib=rec["peak"] / 2**30,
            hbm_peak_gib=(rec["hbm_peak_bytes"] / 2**30
                          if rec["hbm_peak_bytes"] else None),
            report_ms=[s * 1e3 for s in rec["report_s"]],
            rows_equal_phase5=same, launches=rec["launches"])
    print(json.dumps(dict(
        phase="sweep", sweep="llama", trials=len(llama.trials),
        wall_s=llama_wall, best_config=llama.best_config,
        statuses=[t.status for t in llama.trials],
        report_round_trip_ms_p50=statistics.median(round_trips) * 1e3,
        report_round_trip_ms_max=max(round_trips) * 1e3,
        reports=len(round_trips))), flush=True)

    # (b) the reference's Tune example: sweep driver -> trial process ->
    # fit_distributed worker (NCCL), checkpoint-then-report every epoch,
    # under ASHA: the stopped arm's verdict raises in its trial's pump,
    # which must take its worker off the card before the next trial
    free_card("sweep_mnist")
    t0 = time.perf_counter()
    mnist = sweep.run(
        me.mnist_trainable,
        config={"lr": sweep.grid_search(list(SWEEP_MNIST_LRS))},
        metric="loss", mode="min",
        scheduler=sweep.ASHAScheduler(**SWEEP_MNIST_ASHA),
        executor="process", resources_per_trial=sweep.GpuResources(gpus=1),
        storage_dir=os.path.join(SWEEP_DIR, "mnist"),
        trial_timeout=SWEEP_TRIAL_TIMEOUT_S)
    mnist_wall = time.perf_counter() - t0
    recs = records(mnist)
    check_trials(mnist, recs, SWEEP_MNIST_ASHA)
    for t, rec in zip(mnist.trials, recs):
        if (len(t.checkpoints) != t.iterations
                or (t.status == Trial.DONE
                    and t.iterations != SWEEP_MNIST_EPOCHS)):
            problems.append(f"{t.trial_id}: {t.status}, {t.iterations} "
                            f"reports, {len(t.checkpoints)} checkpoints")
        if rec["workers_alive"]:
            problems.append(f"{t.trial_id}: worker(s) "
                            f"{rec['workers_alive']} still ran as the trial "
                            "returned")
        trial_line("mnist", t, rec, fit_call_s=rec.get("fit_call_s"),
                   accs=[h["acc"] for h in t.history],
                   checkpoints=len(t.checkpoints),
                   workers_alive_at_return=rec["workers_alive"])
    best_trial = mnist.best_trial
    best = mnist.best_checkpoint
    ok, reason = verify_checkpoint(best)
    if not ok:
        problems.append(f"verify_checkpoint({best}): {reason}")
    # no device given: the port's default, the card
    loaded = MNISTClassifier.load_from_checkpoint(best)
    device = next(loaded.model.parameters()).device
    if device.type != "cuda":
        problems.append(f"load_from_checkpoint built the model on {device}")
    evaluator = Trainer(strategy=SingleDevice(), enable_checkpointing=False,
                        enable_progress_bar=False)
    preds = np.concatenate(evaluator.predict(loaded, me.mnist_eval_data()))
    acc = float(np.mean(preds == me.mnist_eval_data().data["y"]))
    loss = float(evaluator.validate(loaded, me.mnist_data()[1])[
        "ptl/val_loss"])
    reported = best_trial.last_result
    tol = SWEEP_LOSS_RTOL * abs(reported["loss"])
    if acc != reported["acc"] or abs(loss - reported["loss"]) > tol:
        problems.append(f"the best checkpoint gives accuracy {acc}, loss "
                        f"{loss}; its trial reported {reported['acc']}, "
                        f"{reported['loss']} (loss to {tol})")
    # the reload check must be able to fail: no other report of the
    # sweep (another trial, an earlier epoch) lies inside its tolerance
    others = [h["loss"] for t in mnist.trials
              for h in (t.history[:-1] if t is best_trial else t.history)]
    gap = min(abs(v - reported["loss"]) for v in others)
    if gap <= tol:
        problems.append(f"another report's loss lies {gap} from the best "
                        f"one's, inside the reload tolerance {tol}")
    print(json.dumps(dict(
        phase="sweep", sweep="mnist", trials=len(mnist.trials),
        wall_s=mnist_wall, best_config=mnist.best_config,
        statuses=[t.status for t in mnist.trials],
        best_checkpoint=os.path.relpath(best, SWEEP_DIR),
        reload_device=str(device), reload_accuracy=acc,
        reported_accuracy=reported["acc"], reload_loss=loss,
        reported_loss=reported["loss"], loss_tolerance=tol,
        nearest_other_loss_gap=gap)), flush=True)
    del loaded
    shutil.rmtree(SWEEP_DIR)
    if problems:
        raise AssertionError("sweep: " + "; ".join(problems))
    return total


# ---- phase 8: resilience on the card -----------------------------------------
#
# (a) and (c) run `fit_distributed(resilience=...)`, whose workers import
# this file by its name, as phase 6's do; (b) and (d) run in this process.

#: where the phase keeps its supervised runs (git-ignored; removed after)
RES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "rlt_logs", "chip_smoke_resilience")
#: (a): the supervisor's step cadence and the step whose batch end kills
#: the worker. Both attempts resume phase 6 (c)'s step-4 checkpoint and
#: write none (no step of 5-8 is a multiple of 16: the card's machine
#: may write 45 GiB a run, and 6 (c)'s 23 GB save is the one the
#: script's budget holds), so the second attempt replays steps 5-6
RES_SAVE_EVERY, RES_KILL_AT = 16, 6
#: card memory (GiB) the second attempt may find taken beyond the first's:
#: less than one CUDA context, so the killed rank's memory must be gone
RES_FREE_SLACK_GIB = 0.25
#: (c): the silent-heartbeat budget and the heartbeat interval (s): five
#: missed heartbeats, short for the script's time limit
RES_STALL_S, RES_HEARTBEAT_S = 10.0, 2.0
#: (c): the budget for a rank's first heartbeat (s): an MNIST worker's
#: start on the card, many times over, and short of the script's time
#: limit should a hang ever be judged by it
RES_STARTUP_GRACE_S = 120.0
#: (c): preempt at 3 (drained at 4's boundary), hang at 6, corrupt the
#: newest checkpoint and die at 9; saves every 3 steps
RES_MNIST_SAVE_EVERY = 3
RES_MNIST_FAULTS = ("preempt:rank=0,step=3;hang:rank=0,step=6,secs=600;"
                    "corrupt_latest:rank=0,step=9,dir={d};kill:rank=0,step=9")


def _res_policy(max_restarts: int):
    """Backoff from 0.25 s: (c)'s three relaunches sleep 1.75 s in all
    (7 s from 1 s), short for the script's time limit."""
    from ray_lightning_tpu_torch.resilience import RetryPolicy

    return RetryPolicy(max_restarts=max_restarts, backoff_base_s=0.25,
                       jitter=0.0)


def res_module(seed: int):
    """(a)'s module: the card's free memory is read first, in the fresh
    worker before it allocates anything (its CUDA context exists)."""
    free, _ = torch.cuda.mem_get_info()
    _to_driver(dict(kind="mem", free=free, t=time.time()))
    return dist_module(seed)


class ResProbe(Callback):
    """In (a)'s worker: each step's (step, loss, grad_norm) and the
    kernels' launches since the fit started, sent at once (a killed
    attempt's steps arrive too); the save's seconds (from the trainer's
    save hook to the next batch's start)."""

    def on_fit_start(self, trainer, module):
        from ray_lightning_tpu_torch.runtime import session

        for k in all_kernels():
            k.launches = 0
        self._save_t0 = None
        self._t_loop = None
        _to_driver(dict(kind="start", step=trainer.global_step,
                        pid=os.getpid(), t=time.time(),
                        proc_start=session.get_session().started_at))

    def on_train_epoch_start(self, trainer, module):
        if self._t_loop is None:
            self._t_loop = time.perf_counter()

    def on_train_batch_start(self, trainer, module, batch, batch_idx):
        if self._save_t0 is not None:
            torch.cuda.synchronize()
            _to_driver(dict(kind="save",
                            save_s=time.perf_counter() - self._save_t0))
            self._save_t0 = None

    def on_save_checkpoint(self, trainer, module, checkpoint):
        torch.cuda.synchronize()
        self._save_t0 = time.perf_counter()

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        first = {}
        if self._t_loop is not None:
            # the attempt's first step: its wall from the loop's start,
            # and the warm start before it
            m = trainer.callback_metrics
            first = dict(first_step_s=time.perf_counter() - self._t_loop,
                         compile_time_s=m.get("compile_time_s"),
                         compile_build_s=m.get("compile_build_s"))
            self._t_loop = None
        _to_driver(dict(
            kind="step", step=trainer.global_step,
            loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
            launches={k.__name__: k.launches for k in all_kernels()},
            **first))


def res_trainer(seed: int):
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import FSDP

    return Trainer(strategy=FSDP(), max_steps=TRAIN_STEPS,
                   log_every_n_steps=1, enable_checkpointing=False,
                   enable_progress_bar=False, seed=seed,
                   callbacks=[ResProbe()])


class ResMnistProbe(Callback):
    """In (c)'s workers: the pid (to check no worker outlives its
    attempt) and the step each attempt starts from."""

    def on_fit_start(self, trainer, module):
        d = os.path.join(RES_DIR, "pids")
        os.makedirs(d, exist_ok=True)
        open(os.path.join(d, str(os.getpid())), "w").close()
        _to_driver(dict(kind="start", step=trainer.global_step))


def res_mnist_trainer():
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import RayXlaPlugin

    return Trainer(strategy=RayXlaPlugin(num_workers=1, use_gpu=True),
                   max_epochs=2, log_every_n_steps=1,
                   enable_checkpointing=False, enable_progress_bar=False,
                   seed=SEED, callbacks=[ResMnistProbe()])


def res_fit(module_factory, trainer_factory, data_factory, cfg, **kw):
    """One supervised `fit_distributed` on the card; the result (or the
    SupervisedFailure), the side channel's items and the call's wall."""
    import chip_smoke as me
    from ray_lightning_tpu_torch.resilience import supervise
    from ray_lightning_tpu_torch.resilience.supervisor import (
        SupervisedFailure,
    )

    me.RECEIVED.clear()
    t0 = time.perf_counter()
    try:
        out = supervise("fit", module_factory, trainer_factory,
                        data_factory, 1, resilience=cfg,
                        timeout=DIST_TIMEOUT_S,
                        log_dir=os.path.join(RES_DIR, "workers"), **kw)
    except SupervisedFailure as exc:
        out = exc
    return out, list(me.RECEIVED), time.perf_counter() - t0


def resilience_kill(seed: int, ref_rows, ckpt: str, problems: list):
    """(a): phase 5's fit under FSDP in a supervised worker whose
    checkpoint directory holds phase 6 (c)'s step-4 checkpoint ``ckpt``
    (hard links: no bytes written): resumed from it, SIGKILL'd at step 6
    and resumed from it again."""
    import chip_smoke as me
    from ray_lightning_tpu_torch.autoscale import CapacityOracle
    from ray_lightning_tpu_torch.elastic import ElasticBudget
    from ray_lightning_tpu_torch.resilience import ResilienceConfig
    from ray_lightning_tpu_torch.telemetry import TelemetryConfig

    P = functools.partial
    free_card("res_kill")
    ckdir = os.path.join(RES_DIR, "llama")
    shutil.copytree(ckpt, os.path.join(ckdir, os.path.basename(ckpt)),
                    copy_function=os.link)
    # 14: the elastic ladder up to world 2 over a capacity oracle whose
    # probe file says one world: the relaunch stays at 1 and the ledger
    # records the refused grow with the oracle's source
    os.makedirs(RES_DIR, exist_ok=True)
    cap_file = os.path.join(RES_DIR, "capacity")
    with open(cap_file, "w") as f:
        f.write("1")
    # telemetry on (the default), its ledger refreshed every step: the
    # SIGKILL'd attempt leaves one at step 6, so the goodput can charge
    # its replayed steps 5-6
    cfg = ResilienceConfig(
        checkpoint_dir=ckdir, policy=_res_policy(1),
        save_every_n_steps=RES_SAVE_EVERY, async_save=False,
        heartbeat_interval_s=RES_HEARTBEAT_S,
        faults=f"kill:rank=0,step={RES_KILL_AT}",
        telemetry=TelemetryConfig(flush_every_n_steps=1),
        elastic=ElasticBudget(max_world=2, oracle=CapacityOracle(
            probe_file=cap_file)))
    # the JAX package's digest knob for 8B checkpoints (as phase 6)
    sup, items, wall = res_fit(P(me.res_module, seed),
                               P(me.res_trainer, seed), P(me.dist_data, seed),
                               cfg, env={"RLT_CKPT_DIGEST": "size"},
                               return_weights=False)
    by = {}
    for it in items:
        by.setdefault(it["kind"], []).append(it)
    starts, mems = by.get("start", []), by.get("mem", [])
    # split the step items by attempt: a step number that does not grow
    # starts the next attempt
    attempts, last = [], None
    for it in by.get("step", []):
        if last is None or it["step"] <= last:
            attempts.append([])
        attempts[-1].append(it)
        last = it["step"]
    row = dict(phase="resilience_kill", wall_s=wall)
    if not hasattr(sup, "failures"):
        problems.append(f"(a) supervised fit failed: {sup}")
        print(json.dumps(row), flush=True)
        return {}
    [failure] = sup.failures or [{}]
    if not (sup.total_attempts == 2 and failure.get("kind") == "retryable"
            and "SIGKILL" in failure.get("cause", "")):
        problems.append(f"(a) attempts {sup.total_attempts}, failures "
                        f"{sup.failures}")
    if [s["step"] for s in starts] != [RESUME_AT, RESUME_AT] or \
            len(attempts) != 2:
        problems.append(f"(a) attempts started at {[s['step'] for s in starts]}"
                        f" and ran {[[i['step'] for i in a] for a in attempts]}")
        print(json.dumps(row), flush=True)
        return {}
    first, second = attempts
    rows1 = [(i["loss"], i["grad_norm"]) for i in first]
    rows2 = [(i["loss"], i["grad_norm"]) for i in second]
    if [i["step"] for i in first] != list(range(RESUME_AT + 1,
                                                RES_KILL_AT + 1)) or \
            rows1 != ref_rows[RESUME_AT:RES_KILL_AT]:
        problems.append("(a) the killed attempt's steps 5-6 differ from "
                        "phase 5's")
    if [i["step"] for i in second] != list(range(RESUME_AT + 1,
                                                 TRAIN_STEPS + 1)) or \
            rows2 != ref_rows[RESUME_AT:]:
        problems.append("(a) the resumed attempt's steps 5-8 differ from "
                        "phase 5's")
    launches = [a[-1]["launches"] for a in attempts]
    if launches[1] != expected_launches(TRAIN_STEPS - RESUME_AT):
        problems.append(f"(a) resumed launches {launches[1]}")
    if launches[0] != expected_launches(RES_KILL_AT - RESUME_AT):
        problems.append(f"(a) killed attempt's launches {launches[0]}")
    free = [m["free"] / 2**30 for m in mems]
    if len(free) != 2 or free[1] < free[0] - RES_FREE_SLACK_GIB:
        problems.append(f"(a) free card memory at the attempts' starts "
                        f"{free} GiB")
    saves = [s["save_s"] for s in by.get("save", [])]
    if saves:
        problems.append(f"(a) saved {len(saves)} checkpoint(s)")
    restore = [r["restore_s"] for r in by.get("restore", [])]
    setup = [s["t"] - s["proc_start"] for s in starts]
    g = check_goodput("(a)", sup, os.path.join(ckdir, "telemetry"), problems)
    if g:
        b = g["buckets"]
        launch = [a.get("launch_s") for a in _ledgers(ckdir)]
        if not (b["rollback_replay_s"] > 0
                and [a["replay_steps"] for a in g["attempts"]] == [
                    0, RES_KILL_AT - RESUME_AT]):
            problems.append(f"(a) replay {b['rollback_replay_s']} s, "
                            f"attempts {g['attempts']}")
        # the ledgers' launch seconds end where the fit starts, before
        # the restore that ends the worker's setup
        if len(launch) != 2 or not all(
                1.0 < x <= y + 1.0 for x, y in zip(launch, setup)):
            problems.append(f"(a) launch_s {launch} against the workers' "
                            f"setup {setup}")
        # each fresh attempt's one-time cost is the warm start's: booked
        # as compile_s, beside the first step it no longer slows
        compile_s = [a["buckets"]["compile_s"] for a in _ledgers(ckdir)]
        if len(compile_s) != 2 or not all(c > 0 for c in compile_s):
            problems.append(f"(a) compile_s {compile_s} per attempt")
        row.update(goodput=g["buckets"], goodput_wall_s=g["wall_s"],
                   goodput_fraction=g["goodput_fraction"],
                   goodput_attempts=g["attempts"], ledger_launch_s=launch,
                   ledger_compile_s=compile_s)
    refused = elastic_refusal(sup, ckdir, problems)
    row.update(
        attempts=sup.total_attempts, failure=failure, reshards=refused,
        starts=[s["step"] for s in starts],
        losses=[r[0] for r in rows1 + rows2],
        rows_equal_phase5=rows1 == ref_rows[RESUME_AT:RES_KILL_AT]
        and rows2 == ref_rows[RESUME_AT:],
        free_gib_at_attempt_start=free, save_s=saves, restore_s=restore,
        # failure classified (driver clock) -> the relaunched worker's
        # process start; then its imports, rendezvous, build and restore
        relaunch_s=starts[1]["proc_start"] - failure["at"],
        worker_setup_s=setup,
        first_step_s=[a[0].get("first_step_s") for a in attempts],
        compile_time_s=[a[0].get("compile_time_s") for a in attempts],
        compile_build_s=[a[0].get("compile_build_s") for a in attempts],
        launches=launches)
    print(json.dumps(row), flush=True)
    total = {k: launches[0][k] + launches[1][k] for k in launches[0]}
    shutil.rmtree(ckdir, ignore_errors=True)
    return total


def elastic_refusal(sup, ckdir: str, problems: list) -> dict:
    """(a) under the elastic ladder: exactly one ``grow_refused`` entry,
    its capacity from the oracle's probe file, in the result, in
    ``reshards.jsonl`` and in the report's reshard section; no world
    change."""
    entries = []
    with open(os.path.join(ckdir, "reshards.jsonl")) as f:
        head = json.loads(f.readline())
        entries = [json.loads(ln) for ln in f if ln.strip()]
    report = _cli_json(["report", ckdir]).get("reshards") or {}
    want = [("grow_refused", 1, 2, 1, "file")]
    for what, got in (("result", sup.reshards), ("ledger", entries)):
        if [(e.get("reason"), e.get("from_world"), e.get("resolved_max"),
             e.get("capacity"), e.get("capacity_source"))
                for e in got] != want:
            problems.append(f"(a) elastic {what}: {got}")
    if head.get("version") != "rlt-reshards-v1" or \
            sup.final_world is not None:
        problems.append(f"(a) reshard ledger header {head}, final world "
                        f"{sup.final_world}")
    if [(r.get("capacity"), r.get("capacity_source"))
            for r in report.get("grow_refused", [])] != [(1, "file")]:
        problems.append(f"(a) the report's reshard section {report}")
    return dict(entries=entries, report=report)


def _ledgers(ckdir: str):
    """A supervised run's rank-0 goodput ledgers, attempt order."""
    from ray_lightning_tpu_torch.telemetry.goodput import read_ledgers

    return read_ledgers(os.path.join(ckdir, "telemetry"))


def guard_fit(cfg, tokens, seed: int, guard, mask: bool = False,
              callbacks=(), max_steps: int = TRAIN_STEPS, sync_debug=False,
              **trainer_kw):
    """Phase 5's fit in this process with the trainguard: optionally a
    float mask of ones in every batch, more callbacks (a fault plan), and
    ``torch.cuda.set_sync_debug_mode("warn")`` with its warnings counted;
    ``trainer_kw`` goes to the `Trainer` (phase 9's telemetry and
    profile). Returns (probe, wall, peak, metrics, syncs, module,
    launches); ``module.trainer`` is the fit's trainer."""
    import warnings

    import numpy as np

    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import SingleDevice

    for k in all_kernels():
        k.launches = 0
    probe = StepProbe()
    module = LlamaModule(cfg, lr=TRAIN_LR, warmup_steps=2,
                         total_steps=TRAIN_STEPS)
    trainer = Trainer(strategy=SingleDevice(), max_steps=max_steps,
                      log_every_n_steps=1, enable_checkpointing=False,
                      enable_progress_bar=False, seed=seed, guard=guard,
                      default_root_dir=RES_DIR,
                      callbacks=[probe.callback, *callbacks], **trainer_kw)
    data = {"tokens": tokens}
    if mask:
        data["mask"] = np.ones((len(tokens), TS), np.float32)
    torch.cuda.reset_peak_memory_stats()
    syncs = None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        probe.caught = caught
        if sync_debug:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            probe.t.append(t0)
            trainer.fit(module, DataLoader(data, batch_size=TB))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
    if sync_debug:
        marks = [i for i, w in enumerate(caught)
                 if "synchroniz" in str(w.message)]
        syncs = len(marks)
        # each step's synchronising calls, and each call's site
        ends = [0, *probe.caught_at]
        probe.sync_steps = [sum(a <= i < b for i in marks)
                            for a, b in zip(ends, ends[1:])]
        probe.sync_sites = collections.Counter(
            f"{os.path.basename(caught[i].filename)}:{caught[i].lineno}"
            for i in marks)
    launches = {k.__name__: k.launches for k in all_kernels()}
    return (probe, wall, torch.cuda.max_memory_allocated(),
            dict(trainer.callback_metrics), syncs, module, launches)


def _step_ms(probe) -> float:
    return statistics.median(b - a for a, b in zip(probe.t[2:],
                                                   probe.t[3:])) * 1e3


def resilience_guard(seed: int, ref_rows, problems: list):
    """(b): the trainguard in this process (SingleDevice) and (d): the
    SDC digest of the weights on the card against the host's."""
    import numpy as np

    from ray_lightning_tpu_torch.resilience import GuardConfig
    from ray_lightning_tpu_torch.resilience.faults import (
        Fault,
        FaultInjector,
    )
    from ray_lightning_tpu_torch.resilience.guard import local_digest

    cfg, tokens = train_inputs(seed)
    total = {k.__name__: 0 for k in all_kernels()}
    free_card("res_guard")

    def add(launches, steps, what):
        if launches != expected_launches(steps):
            problems.append(f"(b) {what}: launches {launches}")
        for k, v in launches.items():
            total[k] += v

    # (b1) guard off and on over phase 5's steps, both under the sync
    # debug mode: the rows equal phase 5's, the guard adds no sync
    runs = {}
    for name, guard in (("unguarded", None), ("guarded", GuardConfig())):
        probe, wall, peak, metrics, syncs, module, launches = guard_fit(
            cfg, tokens, seed, guard, sync_debug=True)
        del module
        gc.collect()
        torch.cuda.empty_cache()
        add(launches, TRAIN_STEPS, name)
        if probe.rows != ref_rows:
            problems.append(f"(b1) {name} rows differ from phase 5's")
        runs[name] = dict(step_ms_p50=_step_ms(probe), fit_wall_s=wall,
                          peak_gib=peak / 2**30, syncs=syncs,
                          syncs_per_step=syncs / TRAIN_STEPS,
                          sync_sites=dict(probe.sync_sites),
                          rows_equal_phase5=probe.rows == ref_rows)
    if runs["guarded"]["syncs"] > runs["unguarded"]["syncs"]:
        problems.append(f"(b1) the guarded fit synchronised "
                        f"{runs['guarded']['syncs']} times, the unguarded "
                        f"{runs['unguarded']['syncs']}")
    print(json.dumps(dict(
        phase="resilience_guard_on_off", **{
            f"{n}_{k}": v for n, r in runs.items() for k, v in r.items()},
        guard_step_ms=runs["guarded"]["step_ms_p50"]
        - runs["unguarded"]["step_ms_p50"],
        guard_peak_gib=runs["guarded"]["peak_gib"]
        - runs["unguarded"]["peak_gib"])), flush=True)

    # (b2) 8 clean masked batches against 9 with a poisoned one at step
    # 3: the skip leaves every update (loss, grad_norm) and the final
    # weights bitwise as the clean run's
    guard = GuardConfig()
    probe_c, wall_c, peak_c, _, _, module, launches = guard_fit(
        cfg, tokens, seed, guard, mask=True)
    add(launches, TRAIN_STEPS, "masked clean")
    clean_params = {k: v.detach().cpu() for k, v in module.params.items()}
    del module
    gc.collect()
    torch.cuda.empty_cache()
    # the extra batch, poisoned, becomes step 3; the rest are phase 5's
    nine = np.concatenate([tokens[:2 * TB], tokens[2 * TB:3 * TB],
                           tokens[2 * TB:]])
    probe_n, wall_n, peak_n, metrics, _, module, launches = guard_fit(
        cfg, nine, seed, guard, mask=True, max_steps=TRAIN_STEPS + 1,
        callbacks=[FaultInjector([Fault("nan_loss", None, 3, {})])])
    add(launches, TRAIN_STEPS + 1, "masked nan")
    kept = probe_n.rows[:2] + probe_n.rows[3:]
    same_params = all(torch.equal(p.detach().cpu(), clean_params[k])
                      for k, p in module.params.items())
    counters = {k: metrics.get(k) for k in (
        "guard_skipped_steps", "guard_last_anomaly", "guard_streak")}
    if not (counters["guard_skipped_steps"] == 1
            and counters["guard_last_anomaly"] == 2
            and np.isnan(probe_n.rows[2][0]) and kept == probe_c.rows
            and same_params):
        problems.append(f"(b2) counters {counters}, updates equal "
                        f"{kept == probe_c.rows}, params equal {same_params}")
    print(json.dumps(dict(
        phase="resilience_guard_nan", steps=len(probe_n.rows),
        updates=len(kept), **counters, updates_equal_clean=kept == probe_c.rows,
        params_equal_clean=same_params, clean_step_ms_p50=_step_ms(probe_c),
        nan_fit_wall_s=wall_n, clean_fit_wall_s=wall_c,
        clean_peak_gib=peak_c / 2**30, nan_peak_gib=peak_n / 2**30)),
        flush=True)

    # (d) the SDC digest of the weights on the card: timed, and equal to
    # the digest of the same bytes on the host (the clean run's copy,
    # bitwise these weights), summed in numpy
    params = dict(module.params)
    on_card = int(local_digest(params))
    ms = time_ms(lambda: local_digest(params), reps=5)
    host = 0
    for i, name in enumerate(sorted(clean_params)):
        words = clean_params[name].numpy().view(np.uint32)
        leaf = int(words.sum(dtype=np.uint64)) & 0xFFFFFFFF
        host = (host + leaf * (2 * i + 1)) & 0xFFFFFFFF
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    if on_card != host:
        problems.append(f"(d) digest on the card {on_card} != host {host}")
    print(json.dumps(dict(
        phase="resilience_sdc_digest", digest=on_card, host_digest=host,
        equal=on_card == host, leaves=len(params), bytes=nbytes, ms=ms,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        note="world size 1: the probe records, no peer to compare")),
        flush=True)
    del module, params, clean_params
    gc.collect()
    torch.cuda.empty_cache()
    return total


def resilience_mnist(problems: list):
    """(c): preemption, a stall and a corrupted checkpoint under one
    supervised MNIST run on the card, against an uninterrupted one; a
    fatal error fails fast."""
    import chip_smoke as me
    from ray_lightning_tpu_torch.resilience import ResilienceConfig

    free_card("res_mnist")

    def cfg(name, faults=None, max_restarts=2):
        return ResilienceConfig(
            checkpoint_dir=os.path.join(RES_DIR, name),
            policy=_res_policy(max_restarts),
            save_every_n_steps=RES_MNIST_SAVE_EVERY, async_save=False,
            heartbeat_interval_s=RES_HEARTBEAT_S, stall_timeout_s=RES_STALL_S,
            startup_grace_s=RES_STARTUP_GRACE_S, faults=faults)

    common = (me.mnist_module, me.res_mnist_trainer, me.mnist_data)
    base, _, base_wall = res_fit(*common, cfg("base"))
    d = os.path.join(RES_DIR, "faults")
    hurt, items, hurt_wall = res_fit(
        *common, cfg("faults", RES_MNIST_FAULTS.format(d=d)))
    starts = [it["step"] for it in items if it["kind"] == "start"]
    fatal, _, fatal_wall = res_fit(*common, cfg("fatal",
                                                "raise:rank=0,step=2"))
    row = dict(phase="resilience_mnist", base_wall_s=base_wall,
               faults_wall_s=hurt_wall, fatal_wall_s=fatal_wall,
               attempt_starts=starts)
    if not hasattr(hurt, "failures") or not hasattr(base, "result"):
        problems.append(f"(c) supervised runs failed: {base} / {hurt}")
        print(json.dumps(row), flush=True)
        return
    kinds = [(f["kind"], f["cause"]) for f in hurt.failures]
    same = all(torch.equal(v, hurt.result.state_dict[k])
               for k, v in base.result.state_dict.items())
    # drained at step 4 (the notice lands after step 3's boundary check),
    # the hang's relaunch from step 6, the corrupt step 9 skipped: 6 again
    if kinds != [("preemption", "worker-preempt"), ("retryable", "stall"),
                 ("retryable", "worker-signal:SIGKILL")] \
            or starts != [0, 4, 6, 6] or not same:
        problems.append(f"(c) failures {kinds}, starts {starts}, weights "
                        f"equal the uninterrupted run's: {same}")
    fatal_ok = (type(fatal).__name__ == "SupervisedFailure"
                and fatal.classified.kind == "fatal" and fatal.attempts == 1)
    if not fatal_ok:
        problems.append(f"(c) the raise did not fail fast: {fatal}")
    pids = os.listdir(os.path.join(RES_DIR, "pids"))
    alive = [int(p) for p in pids if not _dead(int(p))]
    if alive:
        problems.append(f"(c) workers {alive} outlived their attempts")
    goodput = {}
    for name, sup in (("base", base), ("faults", hurt)):
        g = check_goodput(f"(c) {name}", sup, os.path.join(
            RES_DIR, name, "telemetry"), problems)
        goodput[name] = dict(wall_s=g.get("wall_s"),
                             fraction=g.get("goodput_fraction"),
                             buckets=g.get("buckets"),
                             compile_s=[a["buckets"]["compile_s"] for a in
                                        _ledgers(os.path.join(RES_DIR,
                                                              name))])
    if goodput["faults"]["buckets"] and not (
            goodput["faults"]["buckets"]["backoff_s"] > 0):
        problems.append("(c) the faulted run's goodput has no backoff")
    timeline = timeline_cli(os.path.join(RES_DIR, "faults", "telemetry"),
                            problems)
    row.update(failures=kinds, weights_equal_uninterrupted=same,
               base_val_accuracy=base.result.metrics.get("ptl/val_accuracy"),
               fatal_fails_fast=fatal_ok, workers=len(pids),
               workers_alive=alive, goodput=goodput, timeline=timeline)
    print(json.dumps(row), flush=True)


def _dead(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def resilience_phase(seed: int, ref_rows, ckpt: str):
    """Phase 8 (``ckpt``: phase 6 (c)'s step-4 checkpoint, removed here
    after (a)); returns the kernels' launches over its fits."""
    problems = []
    for d in (SWEEP_DIR, RES_DIR):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(RES_DIR)
    try:
        total = resilience_kill(seed, ref_rows, ckpt, problems)
    finally:
        shutil.rmtree(DIST_DIR, ignore_errors=True)
    for k, v in resilience_guard(seed, ref_rows, problems).items():
        total[k] = total.get(k, 0) + v
    resilience_mnist(problems)
    shutil.rmtree(RES_DIR, ignore_errors=True)
    if problems:
        raise AssertionError("resilience: " + "; ".join(problems))
    return total


# ---- phase 9: telemetry on the card -------------------------------------------
#
# (a) phase 5's fit with the span recorder and a profile window, right
# after phase 5; (b) phase 4's model and requests with live metrics, inside
# phase 4; (c) phase 8's supervised runs assemble their goodput; (d) the
# matmul probe, after the card's name.

#: where phase 9 writes spans, ledgers, metrics and traces (git-ignored;
#: removed after)
TEL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "rlt_logs", "chip_smoke_telemetry")
#: (a)'s profile window: the two steps after step 4's end
TEL_PROFILE_START, TEL_PROFILE_STEPS = 4, 2
#: each train kernel's symbol in a profiler trace (its __global__ name)
TRAIN_SYMBOLS = {"flash_fwd_kernel": r"\bflash_fwd\b",
                 "flash_bwd_dkv_kernel": r"\bflash_bwd_dkv\b",
                 "flash_bwd_dq_kernel": r"\bflash_bwd_dq\b",
                 "rms_norm_kernel": r"\brms_rows\b"}
#: the supervised goodput's books: the measured buckets may exceed the
#: driver's wall by this share at most (clocks of separate processes)
GOODPUT_TOL = 0.05


def _timed(obj, names):
    """``obj`` with each method in ``names`` adding its host seconds to
    ``obj.host_s`` (the telemetry's own cost, on the host clock)."""
    obj.host_s = 0.0
    for name in names:
        def timed(*a, _f=getattr(obj, name), **k):
            t0 = time.perf_counter()
            try:
                return _f(*a, **k)
            finally:
                obj.host_s += time.perf_counter() - t0
        setattr(obj, name, timed)
    return obj


class TimeRecorder(Callback):
    """Times the span recorder's own calls (records and flushes) once the
    trainer has built it."""

    def on_fit_start(self, trainer, module):
        self.rec = _timed(trainer.telemetry_recorder, ("record", "flush"))


def _nearest_rank_bucket(hist, q: float) -> int:
    """The bucket of the observation `Histogram.quantile` reads at q."""
    import math

    target = max(1, math.ceil(q * hist.n))
    cum = 0
    for idx in sorted(hist.counts):
        cum += hist.counts[idx]
        if cum >= target:
            return idx
    raise AssertionError("empty histogram")


def serve_metrics_phase(model, ecfg, reqs, ref, ref_done):
    """(b): phase 4's model and requests with a live `MetricsRegistry`
    and `FlightRecorder` under TEL_DIR, held to phase 4's run (``ref``:
    its ticks, prefill chunks and tick times; ``ref_done``: its
    completions). Returns the kernels' launches."""
    from ray_lightning_tpu_torch.telemetry.metrics import (
        FlightRecorder,
        MetricsRegistry,
        aggregate_metrics_dir,
        flight_path,
        read_flight,
    )

    tdir = os.path.join(TEL_DIR, "serve")
    shutil.rmtree(tdir, ignore_errors=True)
    reg = _timed(MetricsRegistry(tdir),
                 ("count", "gauge", "observe", "tick_end"))
    fr = _timed(FlightRecorder(flight_path(tdir, 0)), ("record",))
    engine, sched, probe = serve(model, ecfg, use_kernels=None, metrics=reg,
                                 flight=fr)
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    done = drain(sched, reqs)
    launches = {k.__name__: k.launches for k in kernels}
    reg.close()
    fr.close()
    n_layers = model.cfg.n_layers
    problems = []
    want = serve_formula(n_layers, probe.ticks, probe.chunks)
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    if (probe.ticks, probe.chunks) != (ref["ticks"], ref["chunks"]):
        problems.append(f"ticks, chunks {probe.ticks}, {probe.chunks} != "
                        f"phase 4's {ref['ticks']}, {ref['chunks']}")
    greedy = [r.rid for r in reqs if r.temperature == 0.0]
    if any(done[rid].tokens != ref_done[rid].tokens for rid in greedy):
        problems.append("greedy streams differ from phase 4's kernel lane")
    sampled_equal = all(done[r.rid].tokens == ref_done[r.rid].tokens
                        for r in reqs if r.temperature != 0.0)
    c = reg.counters()
    n_tok = sum(len(x.tokens) for x in done.values())
    truth = dict(admissions=len(reqs), completions=len(reqs),
                 decode_tokens=n_tok,
                 prefill_tokens=probe.chunks * ecfg.prefill_chunk)
    if {k: c.get(k) for k in truth} != truth:
        problems.append(f"counters {c} against ground truth {truth}")
    quantiles = {}
    for name in ("ttft_s", "tpot_s"):
        # the histogram reads a quantile by nearest rank: the host's p50
        # is the same rank of the completions' own times (phase 4 prints
        # the interpolated median of its run, which the first wave of
        # admissions and the second can set far apart)
        h = reg.histogram(name)
        host = sorted(getattr(x, name) for x in done.values())
        host_p50 = host[max(1, -(-len(host) // 2)) - 1]
        gap = abs(_nearest_rank_bucket(h, 0.5) - h.bucket_index(host_p50))
        quantiles[name] = dict(p50=h.quantile(0.5), host_p50=host_p50,
                               host_median=statistics.median(host),
                               buckets_apart=gap, n=h.n)
        if h.n != len(reqs) or gap > 1:
            problems.append(f"{name}: p50 {h.quantile(0.5)} is {gap} "
                            f"buckets from the host's {host_p50} (n {h.n})")
    ring = read_flight(flight_path(tdir, 0)) or {}
    ticks = [e["tick"] for e in ring.get("events", []) if e["kind"] == "tick"]
    if not ticks or ticks[-1] != reg.ticks:
        problems.append(f"flight ring's last tick {ticks[-1:]} != "
                        f"{reg.ticks} ticks")
    agg = aggregate_metrics_dir(tdir) or {}
    if agg.get("counters") != c:
        problems.append(f"aggregate {agg.get('counters')} != {c}")
    tick_ms = {k: statistics.median(v) * 1e3
               for k, v in probe.tick_s.items() if v}
    ref_ms = {k: statistics.median(v) * 1e3
              for k, v in ref["tick_s"].items() if v}
    print(json.dumps(dict(
        phase="telemetry_serve", requests=len(done), ticks=probe.ticks,
        prefill_chunks=probe.chunks, counters=c, quantiles=quantiles,
        greedy_equal_phase4=not any(
            done[rid].tokens != ref_done[rid].tokens for rid in greedy),
        sampled_equal_phase4=sampled_equal, flight_events=len(ring.get(
            "events", [])), flight_last_tick=ticks[-1:],
        tick_ms_p50_on=tick_ms, tick_ms_p50_off=ref_ms,
        # the registry's and the recorder's own calls (off: no-ops)
        metrics_us_a_tick=(reg.host_s + fr.host_s) / probe.ticks * 1e6,
        registry_us_a_tick=reg.host_s / probe.ticks * 1e6,
        flight_us_a_tick=fr.host_s / probe.ticks * 1e6,
        tick_ms_on_minus_off={k: tick_ms[k] - ref_ms[k]
                              for k in tick_ms if k in ref_ms},
        launches=launches)), flush=True)
    del engine, sched
    if problems:
        raise AssertionError("telemetry serve: " + "; ".join(problems))
    return launches


def _trace_kernels(path: str):
    """{wrapper: kernel events} of the train kernels in an exported
    Chrome trace (by symbol), the trace's kernel-launch calls on the
    host that have no kernel event (by correlation id), and the most
    that a kernel's start precedes its own launch call, in µs (positive
    only when the device's timestamps run early against the host's: a
    kernel that seems to start before its window opens is dropped)."""
    import re

    from ray_lightning_tpu_torch.telemetry.profiler import _LAUNCH

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = [e.get("name", "") for e in kernels]
    seen = {e.get("args", {}).get("correlation") for e in kernels}
    calls = {e.get("args", {}).get("correlation"): e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and _LAUNCH.match(e.get("name", ""))}
    lead_us = max((float(calls[c]["ts"]) - float(k["ts"]) for k in kernels
                   if (c := k.get("args", {}).get("correlation")) in calls),
                  default=None)
    orphans = [e for c, e in calls.items() if c not in seen]
    if orphans:
        # which launches lost their kernels: the host op each was made
        # in, and its place among the window's launches
        ops = [e for e in events if e.get("cat") == "cpu_op"]
        launches = sorted((e for e in events
                           if e.get("cat") in ("cuda_runtime", "cuda_driver")
                           and _LAUNCH.match(e.get("name", ""))),
                          key=lambda e: e["ts"])
        order = {id(e): i for i, e in enumerate(launches)}
        lost = []
        for o in sorted(orphans, key=lambda e: e["ts"])[:12]:
            inside = [c for c in ops
                      if c["ts"] <= o["ts"] <= c["ts"] + c.get("dur", 0)]
            lost.append(dict(
                launch=o["name"], index=order.get(id(o)),
                op=min(inside, key=lambda c: c.get("dur", 0))["name"][:60]
                if inside else None))
        log(f"launches without a kernel in {path}: {json.dumps(lost)}")
    return {fn: sum(bool(re.search(pat, n)) for n in names)
            for fn, pat in TRAIN_SYMBOLS.items()}, len(orphans), lead_us


def telemetry_train(seed: int, ref_rows, ref_step_s: float):
    """(a): phase 5's fit off, with telemetry, and with telemetry and a
    profile window. Returns the kernels' launches over the three fits."""
    import re

    from ray_lightning_tpu_torch.telemetry import (
        ProfileConfig,
        TelemetryConfig,
        read_spans,
    )
    from ray_lightning_tpu_torch.telemetry.goodput import read_ledgers

    cfg, tokens = train_inputs(seed)
    shutil.rmtree(os.path.join(TEL_DIR, "train"), ignore_errors=True)
    problems, runs = [], {}
    total = {k.__name__: 0 for k in all_kernels()}
    prof_dir = os.path.join(TEL_DIR, "train", "profile")
    timer = TimeRecorder()
    fits = (
        ("off", True, {}),
        ("on", True, dict(telemetry=TelemetryConfig(
            dir=os.path.join(TEL_DIR, "train", "on")), callbacks=[timer])),
        ("profiled", False, dict(
            telemetry=TelemetryConfig(
                dir=os.path.join(TEL_DIR, "train", "profiled")),
            profile=ProfileConfig(dir=prof_dir, start_step=TEL_PROFILE_START,
                                  num_steps=TEL_PROFILE_STEPS))),
    )
    for name, sync_debug, kw in fits:
        probe, wall, peak, _, syncs, module, launches = guard_fit(
            cfg, tokens, seed, None, sync_debug=sync_debug, **kw)
        trainer = module.trainer
        if probe.rows != ref_rows:
            problems.append(f"{name}: rows differ from phase 5's")
        if launches != expected_launches(TRAIN_STEPS):
            problems.append(f"{name}: launches {launches}")
        for k, v in launches.items():
            total[k] += v
        runs[name] = dict(step_ms_p50=_step_ms(probe), fit_wall_s=wall,
                          syncs=syncs, rows_equal_phase5=probe.rows == ref_rows)
        if sync_debug:
            runs[name].update(sync_steps=probe.sync_steps,
                              sync_sites=dict(probe.sync_sites))
        rec = trainer.telemetry_recorder
        if rec.enabled:
            [path] = [os.path.join(rec.directory, f)
                      for f in os.listdir(rec.directory)
                      if f.endswith(".spans.jsonl")]
            count = {}
            for sp in read_spans(path)["spans"]:
                count[sp["phase"]] = count.get(sp["phase"], 0) + 1
            [led] = read_ledgers(rec.directory)
            books = sum(led["buckets"].values())
            runs[name].update(spans=count, ledger_wall_s=led["wall_s"],
                              ledger_buckets=led["buckets"],
                              goodput_fraction=trainer.callback_metrics[
                                  "goodput_fraction"])
            if count.get("dispatch") != TRAIN_STEPS or \
                    count.get("step") != TRAIN_STEPS:
                problems.append(f"{name}: span counts {count}")
            # productive is the wall less the stalls: the sum is the wall
            # up to float rounding
            if not (led["completed"] and led["end_step"] == TRAIN_STEPS
                    and abs(books - led["wall_s"]) <= 1e-9 * led["wall_s"]):
                problems.append(f"{name}: ledger {led}")
        ctl = trainer._profiler
        if ctl is not None:
            want = expected_launches(TEL_PROFILE_STEPS, warm_ups=0)
            rec_ = ctl.records[0] if ctl.records else {}
            events = rec_.get("device_events", {})
            in_session = {fn: sum(n for key, n in events.items()
                                  if re.search(pat, key))
                          for fn, pat in TRAIN_SYMBOLS.items()}
            in_trace, orphans, lead_us = (
                _trace_kernels(rec_["trace"]) if rec_.get("trace")
                else ({}, None, None))
            runs[name].update(
                captures=ctl.captures, empty_captures=ctl.empty_captures,
                incomplete_captures=ctl.incomplete_captures,
                kernel_launches=rec_.get("kernel_launches"),
                lost_kernel_events=rec_.get("lost_kernel_events"),
                trace_launches_without_kernel=orphans,
                kernel_lead_us=lead_us, disabled=ctl.disabled_reason, window=[rec_.get("start_step"),
                                                      rec_.get("end_step")],
                kernels_in_session=in_session, kernels_in_trace=in_trace,
                trace_mib=os.path.getsize(rec_["trace"]) / 2**20
                if rec_.get("trace") else None,
                device_event_kinds=len(events))
            if ctl.disabled_reason or ctl.captures != 1 or \
                    ctl.empty_captures or ctl.incomplete_captures or \
                    not rec_.get("kernel_launches") or orphans:
                problems.append(f"{name}: captures {ctl.captures}, empty "
                                f"{ctl.empty_captures}, incomplete "
                                f"{ctl.incomplete_captures}, launches "
                                f"{rec_.get('kernel_launches')}, launches "
                                f"without a kernel in the trace {orphans}, "
                                f"disabled {ctl.disabled_reason}")
            for fn in TRAIN_SYMBOLS:
                if not in_session.get(fn) == in_trace.get(fn) == want[fn]:
                    problems.append(
                        f"{name}: {fn} launched {in_session.get(fn)} times "
                        f"in the session, {in_trace.get(fn)} in the trace, "
                        f"not {want[fn]} ({TEL_PROFILE_STEPS} steps)")
        del module, trainer
        gc.collect()
        torch.cuda.empty_cache()
    # the first sync-debug fit of a process takes one more synchronising
    # call in its first step (a lazy initialisation in torch); the steps
    # after it, and the sites, must be the same with telemetry on
    on, off = runs["on"], runs["off"]
    if on["sync_steps"][1:] != off["sync_steps"][1:] or \
            on["syncs"] > off["syncs"] or \
            set(on["sync_sites"]) - set(off["sync_sites"]):
        problems.append(f"synchronising calls a step on {on['sync_steps']} "
                        f"{on['sync_sites']}, off {off['sync_steps']} "
                        f"{off['sync_sites']}")
    print(json.dumps(dict(
        phase="telemetry_train", **{f"{n}_{k}": v for n, r in runs.items()
                                    for k, v in r.items()},
        syncs_per_step={n: r["syncs"] / TRAIN_STEPS for n, r in runs.items()
                        if r["syncs"] is not None},
        step_ms_on_minus_off=runs["on"]["step_ms_p50"]
        - runs["off"]["step_ms_p50"],
        # the recorder's own calls over the fit's steps
        telemetry_ms_a_step=timer.rec.host_s / TRAIN_STEPS * 1e3,
        phase5_step_ms_p50=ref_step_s * 1e3)), flush=True)
    shutil.rmtree(os.path.join(TEL_DIR, "train"), ignore_errors=True)
    if problems:
        raise AssertionError("telemetry train: " + "; ".join(problems))
    return total


def check_goodput(what: str, sup, tdir: str, problems: list) -> dict:
    """(c): a supervised run's assembled goodput: present, its buckets
    summing to the supervised wall, the measured ones not past it by more
    than GOODPUT_TOL, and persisted in ``tdir`` as goodput.json."""
    from ray_lightning_tpu_torch.telemetry import buckets_consistent
    from ray_lightning_tpu_torch.telemetry.goodput import read_goodput

    g = getattr(sup, "goodput", None)
    if not g:
        problems.append(f"{what}: no goodput")
        return {}
    b = g["buckets"]
    if not (buckets_consistent(g, GOODPUT_TOL)
            and b["other_s"] >= -GOODPUT_TOL * g["wall_s"]):
        problems.append(f"{what}: goodput books {b} against wall "
                        f"{g['wall_s']}")
    if read_goodput(tdir) != json.loads(json.dumps(g)):
        problems.append(f"{what}: goodput.json differs from the result's")
    return g


def timeline_cli(tdir: str, problems: list) -> dict:
    """(c): ``python -m ray_lightning_tpu_torch timeline <dir> --json``
    over a supervised run's telemetry, through the CLI's entry point in
    this process: events from every ledger there, and a Chrome trace
    that passes the validator."""
    import contextlib
    import io

    from ray_lightning_tpu_torch.__main__ import main as cli
    from ray_lightning_tpu_torch.telemetry.goodput import read_ledgers
    from ray_lightning_tpu_torch.telemetry.timeline import (
        validate_chrome_trace,
    )

    t0 = time.perf_counter()
    chrome = os.path.join(tdir, "timeline.trace.json")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rcs = [cli(["timeline", tdir, "--json"])]
    doc_text = out.getvalue()
    with contextlib.redirect_stdout(io.StringIO()):
        rcs.append(cli(["timeline", tdir, "--chrome", chrome]))
    wall = time.perf_counter() - t0
    if any(rcs):
        problems.append(f"timeline CLI failed: exit {rcs}")
        return {}
    doc = json.loads(doc_text)
    files = os.listdir(tdir)
    span_files = [f for f in files if f.endswith(".spans.jsonl")]
    ledgers = read_ledgers(tdir, rank=None)
    want = {"spans": bool(span_files), "goodput": bool(ledgers)}
    got = doc["sources"]
    for source, present in want.items():
        if present and not got.get(source):
            problems.append(f"timeline: no {source} events from {tdir}")
    if got.get("goodput") != len(ledgers):
        problems.append(f"timeline: {got.get('goodput')} attempts, "
                        f"{len(ledgers)} ledgers")
    with open(chrome) as f:
        bad = validate_chrome_trace(json.load(f))
    if bad:
        problems.append(f"timeline chrome trace: {bad[:3]}")
    return dict(sources=got, span_files=len(span_files),
                ledgers=len(ledgers), chrome_valid=not bad, cli_s=wall)


def probe_line() -> None:
    """(d): the bf16 matmul probe beside the card's spec-sheet peak."""
    from ray_lightning_tpu_torch.utils.probe import (
        device_peak_tflops,
        matmul_tflops,
    )

    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    rate = matmul_tflops()
    print(json.dumps(dict(phase="probe", device=name, matmul_tflops=rate,
                          peak_tflops=device_peak_tflops(name),
                          probe_s=time.perf_counter() - t0)), flush=True)


def profile_sessions_child(first: str, sessions: int) -> None:
    """One fresh process's profiler sessions, each around one matmul on
    the card: the device events each session recorded. ``first`` is the
    first session's activities ("cuda" or "cpu+cuda"); the rest alternate
    between the two."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(256, 256, device="cuda")
    x @ x
    torch.cuda.synchronize()
    kinds = {"cuda": [ProfilerActivity.CUDA],
             "cpu+cuda": [ProfilerActivity.CPU, ProfilerActivity.CUDA]}
    other = "cpu+cuda" if first == "cuda" else "cuda"
    order = [(first, other)[i % 2] for i in range(sessions)]
    out = []
    for kind in order:
        with profile(activities=kinds[kind]) as prof:
            x @ x
            torch.cuda.synchronize()
        out.append(dict(activities=kind, device_events=sum(
            e.count for e in device_kernels(prof))))
    print(json.dumps(dict(phase="profile_sessions_child", pid=os.getpid(),
                          sessions=out)), flush=True)


#: `--profile-sessions`' train windows: what is profiled before each
#: (nothing, 2000 decode-kernel calls at the serving shape, or phase 4's
#: serving window at 2 or 16 layers) and the primer kernels its capture
#: runs in its warm-up (0: the capture records from its first launch)
DISTURBANCES = tuple((kind, primers)
                     for kind in ("clean", "decode", "serve2", "serve16",
                                  "clean")
                     for primers in (0, 16, 64))


def disturb(kind: str, models: dict) -> None:
    """One profiled session of ``kind`` (see DISTURBANCES)."""
    from torch.profiler import ProfilerActivity, profile

    from ray_lightning_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_kernel)

    if kind == "decode":
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        args, kw = KernelInputs(gen).decode(DECODE_LENGTHS, (0,) * C)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            for _ in range(2000):
                paged_attention_kernel(*args, **kw)
            torch.cuda.synchronize()
    elif kind.startswith("serve"):
        n = int(kind[len("serve"):])
        if n not in models:
            models[n] = build_model(SEED, n)
        model = models[n]
        _, sched, _ = serve(model, engine_config(), use_kernels=None)
        profile_window(sched, make_requests(model.cfg.vocab_size,
                                            SEED)[:4])


class WindowProbe(Callback):
    """`--profile-sessions`' second part: before each two-step `Capture`
    of a fit (one every third step), one profiled session of the next
    DISTURBANCES kind, and the capture with that many primer kernels;
    each window's kernel launches and lost kernel events."""

    def __init__(self):
        self.cap, self.rows, self.models = None, [], {}

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        from ray_lightning_tpu_torch.telemetry import profiler

        step = trainer.global_step
        if self.cap is not None and step == self.stop_at:
            rec = self.cap.stop()
            counts, orphans, lead_us = _trace_kernels(rec["trace"])
            os.remove(rec["trace"])
            self.rows.append(dict(
                after=self.kind, primers=self.primers,
                start_step=self.start,
                kernel_launches=rec["kernel_launches"],
                lost_kernel_events=rec["lost_kernel_events"],
                trace_launches_without_kernel=orphans, kernel_lead_us=lead_us,
                train_kernels=counts))
            self.cap = None
        if self.cap is None and step % 3 == 1 and \
                len(self.rows) < len(DISTURBANCES):
            self.kind, self.primers = DISTURBANCES[len(self.rows)]
            if self.kind != "clean":
                disturb(self.kind, self.models)
            torch.cuda.synchronize()
            self.cap = profiler.Capture(os.path.join(TEL_DIR, "windows"),
                                        f"w{step}", True)
            saved = profiler.PRIMER_LAUNCHES
            profiler.PRIMER_LAUNCHES = self.primers
            try:
                self.cap.start()
            finally:
                profiler.PRIMER_LAUNCHES = saved
            self.start, self.stop_at = step, step + 2


def profile_windows() -> None:
    """Phase 5's fit with a `WindowProbe`, one window a DISTURBANCES
    kind."""
    import numpy as np

    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import SingleDevice

    cfg, tokens = train_inputs(SEED)
    steps = 3 * len(DISTURBANCES) + 1
    reps = -(-steps // TRAIN_STEPS)
    probe = WindowProbe()
    trainer = Trainer(strategy=SingleDevice(), max_steps=steps,
                      log_every_n_steps=1, enable_checkpointing=False,
                      enable_progress_bar=False, seed=SEED,
                      callbacks=[probe])
    trainer.fit(LlamaModule(cfg, lr=TRAIN_LR, warmup_steps=2,
                            total_steps=steps),
                DataLoader({"tokens": np.concatenate([tokens] * reps)},
                           batch_size=TB))
    shutil.rmtree(TEL_DIR, ignore_errors=True)
    for row in probe.rows:
        print(json.dumps(dict(phase="profile_window", **row)), flush=True)


def profile_sessions(processes: int, sessions: int = 4) -> None:
    """How often a profiler session records no device event: in fresh
    processes, the first session against the later ones, with CUDA
    activity alone and with CPU activity beside it."""
    root = os.path.dirname(os.path.abspath(__file__))
    rows = []
    for i in range(processes):
        first = "cuda" if i % 2 == 0 else "cpu+cuda"
        out = subprocess.run(
            [sys.executable, "-c", "import chip_smoke; chip_smoke."
             f"profile_sessions_child({first!r}, {sessions})"],
            capture_output=True, text=True, cwd=root, timeout=300)
        line = [ln for ln in out.stdout.splitlines()
                if ln.startswith("{")][-1:]
        if out.returncode or not line:
            raise AssertionError(f"profile child: {out.stderr[-800:]}")
        rows.append(json.loads(line[0])["sessions"])
        print(line[0], flush=True)
    empty = {}
    for sess in rows:
        for j, s_ in enumerate(sess):
            key = f"{'first' if j == 0 else 'later'}_{s_['activities']}"
            tot = empty.setdefault(key, [0, 0])
            tot[0] += s_["device_events"] == 0
            tot[1] += 1
    print(json.dumps(dict(phase="profile_sessions", processes=processes,
                          sessions_each=sessions,
                          empty_of_total=empty)), flush=True)


def old_split_plan(c: int, hkv: int, n_tiles: int, sms: int):
    """The parent build's decode plan: (n_split, tiles per split) over
    ``n_tiles`` 16-position tiles, about sixteen one-warp blocks an SM."""
    want = max(1, -(-16 * sms // (c * hkv)))
    n_split = max(1, min(want, n_tiles // 2))
    tps = -(-n_tiles // n_split)
    return -(-n_tiles // tps), tps


def ab_phase(old_csrc: str):
    """Interleaved reading (old, new, new, old) of the paged decode and
    RMSNorm against a build of older sources, on the same inputs in one
    process: ``old_csrc`` is a copy of an older commit's ``ops/csrc``,
    with its ``ops/kernels/rmsnorm_triton.py`` beside it in
    ``../kernels``. The dQ and prefill, whose sources this tree shares
    with its parent, are timed the same way as a control on the turns.
    Old kernels are called as their wrappers called them: the decode
    through ``paged_decode_bf16`` (q, pool_k, pool_v, tables, lengths,
    pad, part_acc, part_ml, out, C, H, Hkv, HD, P, M, n_split, tps,
    scale, stream) with `old_split_plan`'s ranges and its f32 scratch,
    RMSNorm through the Triton source's ``launch``. Also printed: the
    host microseconds of one wrapper call, old and new, and where the
    old and new decode's device time goes, by kernel."""
    import ctypes
    import importlib.util
    import os

    from ray_lightning_tpu_torch.ops import build
    from ray_lightning_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_kernel, sm_count)
    from ray_lightning_tpu_torch.ops.kernels.paged_prefill import (
        launch_plan, paged_prefill_kernel)
    from ray_lightning_tpu_torch.ops.kernels.rmsnorm import rms_norm_kernel

    csrc, out = build.CSRC, build.BUILD
    build.CSRC, build.BUILD = old_csrc, os.path.join(out, "ab_old")
    try:
        build.build_all(["flash_bwd", "paged_prefill", "paged_attention"])
        old_dq = ctypes.CDLL(build._lib_path("flash_bwd")).flash_bwd_dq_bf16
        old_pf = ctypes.CDLL(
            build._lib_path("paged_prefill")).paged_prefill_bf16
        old_pd = ctypes.CDLL(
            build._lib_path("paged_attention")).paged_decode_bf16
    finally:
        build.CSRC, build.BUILD = csrc, out
    spec = importlib.util.spec_from_file_location("old_rmsnorm", os.path.join(
        old_csrc, os.pardir, "kernels", "rmsnorm_triton.py"))
    old_triton = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(old_triton)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    old_dq.argtypes = [vp] * 7 + [ci] * 8 + [ctypes.c_float, vp]
    old_pf.argtypes = [vp] * 8 + [ci] * 11 + [ctypes.c_float, vp]
    old_pd.argtypes = [vp] * 9 + [ci] * 8 + [ctypes.c_float, vp]
    old_dq.restype = old_pf.restype = old_pd.restype = ci

    def turns(what, shape, old_fn, new_fn, host=False):
        t = [time_ms(f) for f in (old_fn, new_fn, new_fn, old_fn)]
        row = dict(ab=what, shape=shape, old_ms=[t[0], t[3]],
                   new_ms=[t[1], t[2]], old_over_new=(t[0] + t[3])
                   / (t[1] + t[2]))
        if host:
            h = [host_us(f) for f in (old_fn, new_fn, new_fn, old_fn)]
            row.update(old_host_us=[h[0], h[3]], new_host_us=[h[1], h[2]])
        print(json.dumps(row), flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    sms = sm_count(0)

    # -- the decode: the parent's host path and two kernels
    def old_decode(q, pool_k, pool_v, tables, lengths, pad):
        c, h, hd = q.shape
        _, p, hkv, _ = pool_k.shape
        m = tables.shape[1]
        n_split, tps = old_split_plan(c, hkv, -(-m * p // 16), sms)
        part_acc = torch.empty((c, h, n_split, hd), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((c, h, n_split, 2), dtype=torch.float32,
                              device=q.device)
        o = torch.empty_like(q)
        build.check(old_pd(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                           tables.data_ptr(), lengths.data_ptr(),
                           pad.data_ptr(), part_acc.data_ptr(),
                           part_ml.data_ptr(), o.data_ptr(), c, h, hkv, hd, p,
                           m, n_split, tps, hd ** -0.5,
                           torch.cuda.current_stream(q.device).cuda_stream),
                    "old decode")
        return o

    cases = {"serving": (H, HKV, HD, P, M, DECODE_LENGTHS, (0, 0, 0, 0)),
             **DECODE_OWED}
    for name, (h, hkv, hd, p, m, lengths, pad) in cases.items():
        args, kw = KernelInputs(gen, h, hkv, hd, p, m).decode(lengths, pad)
        hold(old_decode(*args, **kw), paged_attention_kernel(*args, **kw),
             f"old decode {name}")
        turns("paged_decode", dict(case=name),
              lambda: old_decode(*args, **kw),
              lambda: paged_attention_kernel(*args, **kw),
              host=name == "serving")
        if name == "serving":
            print(json.dumps(dict(ab="paged_decode device ms by kernel",
                                  old=kernel_profile(
                                      lambda: old_decode(*args, **kw), 50),
                                  new=kernel_profile(
                                      lambda: paged_attention_kernel(
                                          *args, **kw), 50))), flush=True)
    torch.cuda.empty_cache()

    # -- RMSNorm: the parent's Triton kernel
    def old_rms(x, w):
        o = torch.empty_like(x)
        n = x.numel() // x.shape[-1]
        old_triton.launch(x.view(n, -1), w, o.view(n, -1), 1e-5)
        return o

    for n, d, wdt in RMS_CASES:
        x, w = rms_inputs(gen, n, d, wdt)
        hold(old_rms(x, w), rms_norm_kernel(x, w), f"old rms_norm {n} {d}")
        turns("rms_norm", dict(N=n, D=d, w=str(wdt).split(".")[-1]),
              lambda: old_rms(x, w), lambda: rms_norm_kernel(x, w),
              host=(n, d, wdt) == RMS_CASES[0])

    # -- control: dQ and prefill, unchanged sources
    stream = torch.cuda.current_stream().cuda_stream
    c = FlashCase(gen, *FLASH_CASES["train causal"])
    B, Sq, Sk, H_, Hkv, hd = c.shape
    dq = torch.empty_like(c.q)
    ptrs = [t.data_ptr() for t in (c.q, c.k, c.v, c.do, c.lse, c.delta, dq)]

    def old_dq_fn():
        build.check(old_dq(*ptrs, B, Sq, Sk, H_, Hkv, hd, int(c.args[0]),
                           c.args[1], hd ** -0.5, stream), "old dq")

    old_dq_fn()
    hold(dq, c.dq_plain(), "old dq", SLAB)
    turns("flash_bwd_dq (control)", dict(case="train causal"), old_dq_fn,
          c.dq)
    del c
    torch.cuda.empty_cache()
    inp = KernelInputs(gen)
    pos = PREFILL_POS[-1]
    args, kw = inp.prefill(pos, [0])
    q, pool_k, pool_v, tab, _ = args
    bq, n_split, tps = launch_plan(1, CH, H, HKV, M * P, pos, sms)
    part_acc = torch.empty((1, CH, H, n_split, HD), dtype=torch.float32,
                           device="cuda")
    part_ml = torch.empty((1, CH, H, n_split, 2), dtype=torch.float32,
                          device="cuda")
    o = torch.empty_like(q)
    ptrs = [t.data_ptr() for t in (q, pool_k, pool_v, tab, kw["pad"],
                                   part_acc, part_ml, o)]

    def old_pf_fn():
        build.check(old_pf(*ptrs, 1, CH, H, HKV, HD, P, M, pos, bq, n_split,
                           tps, HD ** -0.5, stream), "old prefill")

    old_pf_fn()
    hold(o, paged_prefill_kernel(*args, **kw), "old prefill")
    turns("paged_prefill (control)", dict(B=1, pos=pos), old_pf_fn,
          lambda: paged_prefill_kernel(*args, **kw))


def train_spread(seeds):
    """The train phase's lane comparison (8 steps through `Trainer.fit`,
    kernel lanes against reference lanes) at each of ``seeds``, which
    draw both the weights and the tokens: the spread of sound kernels'
    readings that TRAIN_LOSS_TOL and TRAIN_GNORM_RTOL are set from."""
    readings = []
    for seed in seeds:
        cfg, tokens = train_inputs(seed)
        probe = train_once(cfg, tokens, seed)[0]
        gc.collect()
        torch.cuda.empty_cache()
        ref = train_reference(cfg, tokens, seed)[0]
        d_loss, d_gn, _ = compare_train(probe.rows, ref.rows)
        row = dict(phase="train_spread", seed=seed, loss_max_abs_diff=d_loss,
                   grad_norm_max_rel_diff=d_gn,
                   losses=[r[0] for r in probe.rows],
                   ref_losses=[r[0] for r in ref.rows])
        print(json.dumps(row), flush=True)
        readings.append(row)
    print(json.dumps(dict(
        phase="train_spread_summary", seeds=list(seeds),
        loss_max_abs_diff=max(r["loss_max_abs_diff"] for r in readings),
        grad_norm_max_rel_diff=max(r["grad_norm_max_rel_diff"]
                                   for r in readings))), flush=True)


# ---- phase 10: the hot loop and the remote path -----------------------------

#: set in this process only: a remote transport's worker must not see it
SMOKE_DRIVER_ONLY = "RLT_SMOKE_DRIVER_ONLY"
#: how far the prefetched lane's peak may pass the synchronous lane's:
#: its buffers (up to depth + 1 batches of [TB, TS + 1] int64, 33 KB
#: each) with the allocator's rounding, far below this
HOT_PEAK_SLACK_BYTES = 8 * 2**20


def hot_loop_sync(seed: int, ref_rows):
    """(a) phase 5's fit as the default lane (prefetched two ahead,
    warm-started) and as the synchronous lane, in this process: rows
    equal to phase 5's, launches its counts (the warm-up's in the
    default lane only), each lane's readings. Returns the launches."""
    cfg, tokens = train_inputs(seed)
    problems, lanes = [], {}
    total = {k.__name__: 0 for k in all_kernels()}
    for name, kw, warm_ups in (
            ("prefetched", {}, 1),
            ("synchronous", dict(prefetch_to_device=0, warm_start=False),
             0)):
        gc.collect()
        torch.cuda.empty_cache()
        for k in all_kernels():
            k.launches = 0
        probe, wall, peak, _ = train_once(cfg, tokens, seed, **kw)
        launches = {k.__name__: k.launches for k in all_kernels()}
        for k, v in launches.items():
            total[k] += v
        if probe.rows != ref_rows:
            problems.append(f"{name}: rows differ from phase 5's")
        if launches != expected_launches(TRAIN_STEPS, warm_ups):
            problems.append(f"{name}: launches {launches}")
        m = probe.metrics
        lanes[name] = dict(
            step_s_p50=statistics.median(
                b - a for a, b in zip(probe.t[2:], probe.t[3:])),
            first_step_s=probe.first_step_s(), fit_wall_s=wall,
            compile_time_s=m.get("compile_time_s", 0.0),
            compile_build_s=m.get("compile_build_s", 0.0),
            prefetch_occupancy=m.get("prefetch_occupancy"),
            prefetch_wait_s=m.get("prefetch_wait_s"),
            peak_bytes=peak, peak_gib=peak / 2**30,
            rows_equal_phase5=probe.rows == ref_rows, launches=launches)
        del probe
    extra = lanes["prefetched"]["peak_bytes"] - \
        lanes["synchronous"]["peak_bytes"]
    if extra > HOT_PEAK_SLACK_BYTES:
        problems.append(f"the prefetched lane's peak passes the "
                        f"synchronous one's by {extra} bytes")
    if not lanes["prefetched"]["compile_time_s"] > 0:
        problems.append("the default lane booked no warm start")
    print(json.dumps(dict(phase="hot_loop_sync", lanes=lanes,
                          peak_extra_bytes=extra)), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("hot loop (a): " + "; ".join(problems))
    return total


def hot_loop_remote(seed: int, ref_rows, problems: list) -> dict:
    """(b), run as phase 6 (a): phase 5's fit through
    ``fit_distributed`` under ``FSDP(overlap="on")`` in one worker
    started by `LoopbackTransport` on ``hosts=["localhost"]``: rows and
    launches phase 5's, an NCCL rank on cuda:0 of the visible set, none
    of the driver's own environment. Returns the worker's probe."""
    import chip_smoke as me
    from ray_lightning_tpu_torch.runtime import LoopbackTransport

    P = functools.partial
    free_card("dist_fsdp")
    transport = LoopbackTransport()
    os.environ[SMOKE_DRIVER_ONLY] = "driver"
    try:
        _, got, wall = run_dist(
            "fit", P(me.dist_module, seed),
            P(me.dist_trainer, "fsdp", TRAIN_STEPS, seed, overlap="on"),
            P(me.dist_data, seed), hosts=["localhost"], transport=transport)
    finally:
        os.environ.pop(SMOKE_DRIVER_ONLY, None)
    probe = got["fit"][0]
    env = probe["env"]
    fit_row("dist_fsdp", probe, wall, ref_rows,
            expected_launches(TRAIN_STEPS), problems,
            spawned=transport.spawned, overlap=probe["overlap"], env=env,
            first_step_s=probe["first_step_s"],
            compile_time_s=probe["compile_time_s"],
            compile_build_s=probe["compile_build_s"])
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if not (probe["backend"] == "nccl" and probe["device"] == "cuda:0"
            and probe["overlap"] == "on" and env[SMOKE_DRIVER_ONLY] is None
            and env["CUDA_VISIBLE_DEVICES"] == visible
            and env["LOCAL_RANK"] == "0"
            and transport.spawned == [("localhost", 0)]):
        problems.append(f"dist_fsdp: worker on {probe['device']} "
                        f"({probe['backend']}, overlap {probe['overlap']}), "
                        f"environment {env} (the driver's "
                        f"CUDA_VISIBLE_DEVICES {visible!r}), spawned "
                        f"{transport.spawned}")
    return probe


def hot_loop_perf() -> None:
    """(c) ``python -m ray_lightning_tpu_torch perf --smoke`` on the card,
    through the CLI's entry point in this process (a process of its own
    would pay the imports again): its exit code and its JSON line."""
    import contextlib
    import io

    from ray_lightning_tpu_torch.__main__ import main as cli

    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli(["perf", "--smoke"])
    lines = out.getvalue().strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    print(json.dumps(dict(phase="hot_loop_perf", rc=rc,
                          wall_s=time.perf_counter() - t0, perf=result)),
          flush=True)
    if rc != 0 or result is None:
        raise AssertionError(f"hot loop (c): perf --smoke exited {rc}:\n"
                             f"{out.getvalue()[-3000:]}")


#: every CUDA source the kernels are built from
# ---- phase 12: the planner and the tensor axis on the card ------------------
#
# (a) reads phase 5's trainer before it is freed; (b) and (c) run after
# phase 10 (a). (c)'s two ranks are processes of their own that import
# this file by its name, so the worker is module level.

#: phase 12 (b)'s optimizer steps at the planned batch
BMAX_STEPS = 2
#: phase 12 (c): tensor ranks (processes) on the one card, over gloo
TP_RANKS = 2
TP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "rlt_logs", "chip_smoke_tp")
TP_TIMEOUT_S = 420
#: 12 (c)'s ranks start with phase 12 and wait for this file
TP_GATE = os.path.join(TP_DIR, "go")
#: 12 (c)'s BERT leg: steps of 16 (b)'s fit (its schedule: warmup 2 of
#: BERT_STEPS) under ShardedMesh(tensor=TP_RANKS); the first BERT_EARLY
#: are held to 16 (b)'s early limits, the rest to its whole-fit ones
TP_BERT_STEPS = 4
#: 12 (c)'s BERT rows, for 16 (b) to hold against its kernel lane
TP_BERT = {}
#: the seconds of the legs slice 17 added (12 (c)'s BERT fit, 16 (a)'s
#: H 6 flash row, 17 (e)'s tensor=2 fit), for the timing line
LEGS_S = {}


def live_bytes(trainer, module) -> dict:
    """The bytes a fitted trainer holds: its parameters' storage (each
    rank's shard) and its optimizer's state tensors."""
    from ray_lightning_tpu_torch.parallel.tensor import local

    opt = trainer.state.optimizer
    return dict(
        params=sum(local(p).untyped_storage().nbytes()
                   for p in module.params.values()),
        opt=sum(local(t).untyped_storage().nbytes()
                for st in opt.state.values() for t in st.values()
                if isinstance(t, torch.Tensor)))


def _plan(strategy, n: int, batch: int, kind: str = None):
    """`plan_train_memory` of phase 5's model under ``strategy`` with the
    flagship activation bound at ``batch`` x TS (no card touched)."""
    from ray_lightning_tpu_torch.parallel.plan import (
        H100_KIND,
        llama_activation_bytes,
        plan_train_memory,
    )

    cfg, _ = train_inputs(SEED)
    return plan_train_memory(
        LlamaModule(cfg), strategy, n, None,
        activation_bytes_per_device=llama_activation_bytes(cfg, batch, TS)
        if batch else 0, device_kind=kind or H100_KIND)


def planned_max_batch():
    """`find_max_local_batch` for phase 5's model on one card at TS."""
    from ray_lightning_tpu_torch.parallel.plan import (
        find_max_local_batch,
        llama_activation_bytes,
    )
    from ray_lightning_tpu_torch.parallel.strategy import SingleDevice

    cfg, _ = train_inputs(SEED)
    return find_max_local_batch(
        LlamaModule(cfg), SingleDevice(), 1, None,
        lambda b: llama_activation_bytes(cfg, b, TS))


def plan_terms(plan) -> dict:
    return dict(params=plan.params_bytes_per_device,
                opt=plan.opt_bytes_per_device,
                grads=plan.grads_bytes_per_device,
                activations=plan.activation_bytes_per_device,
                total=plan.per_device_total, budget=plan.budget)


def plan_vs_fit(live: dict, problems: list) -> None:
    """12 (a): phase 5's fit against its plan, term by term."""
    from ray_lightning_tpu_torch.parallel.strategy import SingleDevice

    t0 = time.perf_counter()
    plan = _plan(SingleDevice(), 1, TB, torch.cuda.get_device_name(0))
    plan_s = time.perf_counter() - t0
    total_memory = torch.cuda.get_device_properties(0).total_memory
    if plan.params_bytes_per_device != live["params"]:
        problems.append(f"plan params {plan.params_bytes_per_device} != "
                        f"live {live['params']}")
    if plan.opt_bytes_per_device != live["opt"]:
        problems.append(f"plan optimizer {plan.opt_bytes_per_device} != "
                        f"live {live['opt']}")
    if not plan.per_device_total >= live["peak"]:
        problems.append(f"plan total {plan.per_device_total} < the fit's "
                        f"peak {live['peak']}")
    if not plan.hbm_bytes_per_device <= total_memory:
        problems.append(f"the table's {plan.hbm_bytes_per_device} bytes "
                        f"exceed the card's {total_memory}")
    print(json.dumps(dict(
        phase="plan_vs_fit", plan=plan_terms(plan), live=live,
        plan_minus_peak_gib=(plan.per_device_total - live["peak"]) / 2**30,
        hbm_bytes=plan.hbm_bytes_per_device, total_memory=total_memory,
        plan_s=plan_s, summary=plan.summary())), flush=True)


def bmax_phase(seed: int, problems: list) -> dict:
    """12 (b): `find_max_local_batch`'s batch, trained BMAX_STEPS steps in
    this process: no OOM and a peak within the plan. Returns the
    kernels' launches."""
    import numpy as np

    b_max, plan = planned_max_batch()
    cfg, _ = train_inputs(seed)
    tokens = np.random.default_rng(seed).integers(
        0, TRAIN_TOKENS, (BMAX_STEPS * b_max, TS + 1)).astype(np.int64)
    free_card("bmax")
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    probe, wall, peak, _ = train_once(cfg, tokens, seed, batch=b_max,
                                      steps=BMAX_STEPS)
    launches = {k.__name__: k.launches for k in kernels}
    if launches != expected_launches(BMAX_STEPS):
        problems.append(f"bmax launches {launches}")
    if not peak <= plan.per_device_total:
        problems.append(f"B_max {b_max}: peak {peak} > plan "
                        f"{plan.per_device_total}")
    losses = [r[0] for r in probe.rows]
    if not all(map(np.isfinite, losses)):
        problems.append(f"B_max losses {losses}")
    step_s = probe.t[-1] - probe.t[-2]
    print(json.dumps(dict(
        phase="bmax", b_max=b_max, seq=TS, steps=BMAX_STEPS,
        plan=plan_terms(plan), peak=peak,
        plan_minus_peak_gib=(plan.per_device_total - peak) / 2**30,
        losses=losses, step_s=step_s, tokens_per_s=b_max * TS / step_s,
        fit_wall_s=wall, launches=launches)), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def tp_bert(seed: int, world: int) -> dict:
    """12 (c)'s BERT leg on this rank: 16 (b)'s BERT-base fit (its
    inputs, module and seed) under ``ShardedMesh(tensor=world)`` for
    TP_BERT_STEPS steps, H 12 / world heads a rank: its rows, launches,
    peak and bytes."""
    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.bert import BertClassifierModule
    from ray_lightning_tpu_torch.parallel.strategy import ShardedMesh

    cfg, data = bert_inputs(seed)
    probe = StepProbe()

    class Zero(Callback):
        def on_fit_start(self, trainer, module):
            for k in all_kernels():
                k.launches = 0

    module = BertClassifierModule(cfg, num_classes=2, lr=BERT_LR,
                                  warmup_steps=2, total_steps=BERT_STEPS)
    trainer = Trainer(strategy=ShardedMesh(tensor=world),
                      max_steps=TP_BERT_STEPS, log_every_n_steps=1,
                      enable_checkpointing=False, enable_progress_bar=False,
                      seed=seed, callbacks=[Zero(), probe.callback])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    probe.t.append(t0)
    # both ranks of the tensor group read every row
    trainer.fit(module, DataLoader(data, batch_size=BERT_B))
    torch.cuda.synchronize()
    rec = dict(rows=probe.rows, t=probe.t,
               fit_wall_s=time.perf_counter() - t0,
               launches={k.__name__: k.launches for k in all_kernels()},
               peak=torch.cuda.max_memory_allocated(),
               init_path=trainer.init_path,
               layers=cfg.n_layers, heads_a_rank=cfg.n_heads // world,
               **live_bytes(trainer, module))
    del trainer, module
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def tp_worker(rank: int, world: int, port: int, seed: int,
              out: str) -> None:
    """One rank of 12 (c): phase 5's fit under ``ShardedMesh(tensor=
    world)`` in a gloo group on the visible card, then 16 (b)'s BERT-base
    under the same mesh (`tp_bert`); writes each fit's per-step rows,
    launches, parameter and optimizer bytes and peak to ``out``. Started
    with phase 12, it imports while (a)-(b) run and waits for
    TP_GATE."""
    warm_s = warm_imports()
    import torch.distributed as dist

    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import ShardedMesh

    await_gate(TP_GATE)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    cfg, tokens = train_inputs(seed)
    probe = StepProbe()

    class Zero(Callback):
        def on_fit_start(self, trainer, module):
            for k in all_kernels():
                k.launches = 0

    module = LlamaModule(cfg, lr=TRAIN_LR, warmup_steps=2,
                         total_steps=TRAIN_STEPS)
    trainer = Trainer(strategy=ShardedMesh(tensor=world),
                      max_steps=TRAIN_STEPS, log_every_n_steps=1,
                      enable_checkpointing=False, enable_progress_bar=False,
                      seed=seed, callbacks=[Zero(), probe.callback])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    probe.t.append(t0)
    # both ranks of the tensor group read every row
    trainer.fit(module, DataLoader({"tokens": tokens}, batch_size=TB))
    torch.cuda.synchronize()
    rec = dict(
        rank=rank, rows=probe.rows, t=probe.t, t_loop=probe.t_loop,
        fit_wall_s=time.perf_counter() - t0, warm_s=warm_s,
        launches={k.__name__: k.launches for k in all_kernels()},
        peak=torch.cuda.max_memory_allocated(),
        backend=dist.get_backend(), init_path=trainer.init_path,
        init_peak=trainer.init_peak_bytes,
        device=str(trainer.strategy.device),
        mesh=trainer.strategy.mesh_shape,
        **live_bytes(trainer, module))
    del trainer, module
    gc.collect()
    torch.cuda.empty_cache()
    rec["bert"] = tp_bert(seed, world)
    with open(out, "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def tp_start(seed: int) -> list:
    """Start 12 (c)'s TP_RANKS processes, which import while phase 12's
    (a)-(b) run and wait for TP_GATE."""
    shutil.rmtree(TP_DIR, ignore_errors=True)
    os.makedirs(TP_DIR)
    return _spawn("tp_worker", f"{seed}, ", "rank", TP_TIMEOUT_S, TP_DIR,
                  TP_RANKS)


def tp_phase(seed: int, ref_rows, problems: list, spawned) -> dict:
    """12 (c): TP_RANKS processes on the one card (``spawned`` by
    `tp_start`), each a rank of ``ShardedMesh(tensor=TP_RANKS)`` over
    gloo, against phase 5's rows. A correctness lane, not a speed: every
    all-reduce crosses the host. Returns the kernels' launches, both
    ranks together."""
    from ray_lightning_tpu_torch.parallel.strategy import ShardedMesh

    free_card("tensor_parallel")
    t0 = open_gate(TP_GATE)
    rc, got, tails = _reap(spawned, t0)
    wall = time.perf_counter() - t0
    total = {k.__name__: 0 for k in all_kernels()}
    if any(rc) or not all(got):
        problems.append("tensor-parallel ranks failed: " + " | ".join(
            f"rank {r} (rc {c}): {t}" for r, (c, t) in enumerate(
                zip(rc, tails))))
        return total
    ranks = got
    plan = _plan(ShardedMesh(tensor=TP_RANKS), TP_RANKS, TB)
    want = expected_launches(TRAIN_STEPS)
    d_loss, d_gn, rel = compare_train(ranks[0]["rows"], ref_rows)
    problems.extend(f"tensor lane against phase 5: {p}" for p in rel)
    for r in ranks:
        if r["rows"] != ranks[0]["rows"]:
            problems.append(f"rank {r['rank']}'s rows differ from rank 0's")
        if r["launches"] != want:
            problems.append(f"rank {r['rank']} launches {r['launches']} "
                            f"!= {want} (H {TH // TP_RANKS} / Hkv "
                            f"{THKV // TP_RANKS} a launch)")
        if r["params"] != plan.params_bytes_per_device:
            problems.append(f"rank {r['rank']} holds {r['params']} "
                            "parameter bytes, the plan "
                            f"{plan.params_bytes_per_device}")
        if r["opt"] != plan.opt_bytes_per_device:
            problems.append(f"rank {r['rank']} holds {r['opt']} optimizer "
                            f"bytes, the plan {plan.opt_bytes_per_device}")
        if r["backend"] != "gloo" or r["init_path"] != "meta":
            problems.append(f"rank {r['rank']}: {r['backend']}, "
                            f"{r['init_path']} init")
        for k, v in r["launches"].items():
            total[k] += v
    tp_bert_check(ranks, problems, total)
    t = ranks[0]["t"]
    step_s = statistics.median(b - a for a, b in zip(t[2:], t[3:]))
    print(json.dumps(dict(
        phase="tensor_parallel", ranks=TP_RANKS, backend="gloo",
        lane="correctness (every all-reduce crosses the host)",
        mesh=ranks[0]["mesh"], heads_a_rank=TH // TP_RANKS,
        kv_heads_a_rank=THKV // TP_RANKS,
        losses=[r[0] for r in ranks[0]["rows"]],
        grad_norms=[r[1] for r in ranks[0]["rows"]],
        loss_max_abs_diff=d_loss, grad_norm_max_rel_diff=d_gn,
        loss_tol=TRAIN_LOSS_TOL, grad_norm_rtol=TRAIN_GNORM_RTOL,
        plan=plan_terms(plan),
        params_bytes=[r["params"] for r in ranks],
        opt_bytes=[r["opt"] for r in ranks],
        peak_gib=[r["peak"] / 2**30 for r in ranks],
        init_peak_gib=[r["init_peak"] / 2**30 for r in ranks],
        step_s_p50=step_s, tokens_per_s=TB * TS / step_s,
        fit_wall_s=[r["fit_wall_s"] for r in ranks], call_wall_s=wall,
        warm_s=[r["warm_s"] for r in ranks],
        launches=[r["launches"] for r in ranks])), flush=True)
    shutil.rmtree(TP_DIR, ignore_errors=True)
    return total


def bert_plan(world: int):
    """`plan_train_memory` of 16 (b)'s BERT-base under ``ShardedMesh(
    tensor=world)`` (no card touched)."""
    from ray_lightning_tpu_torch.models.bert import (
        BertClassifierModule,
        BertConfig,
    )
    from ray_lightning_tpu_torch.parallel.plan import plan_train_memory
    from ray_lightning_tpu_torch.parallel.strategy import ShardedMesh

    cfg = BertConfig.base(max_seq_len=BERT_S, dropout=0.0)
    return plan_train_memory(BertClassifierModule(cfg, num_classes=2),
                             ShardedMesh(tensor=world), world, None)


def tp_bert_check(ranks, problems: list, total: dict) -> None:
    """12 (c)'s BERT leg: the ranks' rows alike, each rank's flash
    launches by 16 (b)'s formula at H 12 / TP_RANKS (12 forwards, 12
    dK/dV and 12 dQ a step and the warm-up) and its bytes the plan's;
    keeps the rows in TP_BERT for 16 (b), adds the launches to
    ``total``."""
    bert = [r["bert"] for r in ranks]
    L, n = bert[0]["layers"], TP_BERT_STEPS + 1
    want = {k.__name__: 0 for k in all_kernels()}
    want.update(flash_fwd_kernel=L * n, flash_bwd_dkv_kernel=L * n,
                flash_bwd_dq_kernel=L * n)
    plan = bert_plan(TP_RANKS)
    for rank, b in enumerate(bert):
        if b["rows"] != bert[0]["rows"]:
            problems.append(f"BERT: rank {rank}'s rows differ from rank 0's")
        if b["launches"] != want:
            problems.append(f"BERT rank {rank} launches {b['launches']} != "
                            f"{want} (H {b['heads_a_rank']} a launch)")
        if (b["params"], b["opt"]) != (plan.params_bytes_per_device,
                                       plan.opt_bytes_per_device):
            problems.append(
                f"BERT rank {rank} holds {b['params']} parameter and "
                f"{b['opt']} optimizer bytes, the plan "
                f"{plan.params_bytes_per_device} and "
                f"{plan.opt_bytes_per_device}")
        for k, v in b["launches"].items():
            total[k] += v
    losses = [x[0] for x in bert[0]["rows"]]
    if len(losses) != TP_BERT_STEPS or not all(map(math.isfinite, losses)):
        problems.append(f"BERT tensor lane losses {losses}")
    TP_BERT.update(rows=bert[0]["rows"])
    t = bert[0]["t"]
    step_s = statistics.median(b - a for a, b in zip(t[2:], t[3:]))
    LEGS_S["tp_bert"] = max(b["fit_wall_s"] for b in bert)
    print(json.dumps(dict(
        phase="tensor_parallel_bert", ranks=TP_RANKS, backend="gloo",
        lane="correctness (every all-reduce crosses the host)",
        layers=L, heads_a_rank=bert[0]["heads_a_rank"], batch=BERT_B,
        seq=BERT_S, steps=TP_BERT_STEPS, losses=losses,
        grad_norms=[x[1] for x in bert[0]["rows"]],
        plan=plan_terms(plan), params_bytes=[b["params"] for b in bert],
        opt_bytes=[b["opt"] for b in bert],
        peak_gib=[b["peak"] / 2**30 for b in bert],
        init_path=[b["init_path"] for b in bert], step_s_p50=step_s,
        fit_wall_s=[b["fit_wall_s"] for b in bert],
        launches=[b["launches"] for b in bert])), flush=True)


def planner_phase(seed: int, ref_rows, live: dict) -> dict:
    """Phase 12 (a)-(c); returns the kernels' launches of (b) and (c)."""
    problems = []
    tp_ranks = tp_start(seed)  # they import while (a)-(b) run
    plan_vs_fit(live, problems)
    total = bmax_phase(seed, problems)
    for k, v in tp_phase(seed, ref_rows, problems, tp_ranks).items():
        total[k] += v
    if problems:
        raise AssertionError("the planner and the tensor axis: "
                             + "; ".join(problems))
    return total


# ---- phase 15: the Llama training path's knobs ------------------------
#
# (a) the AdamW kernel (bf16 first moment) against its plain version at
# phase 5's parameter set; (b) phase 5's fit with the bf16 first moment,
# remat policy "attn_out" and the inline CE, kernel lane against reference
# lane under phase 5's limits, against its plan; (c) a "dots" fit and a
# tied fit under FSDP with the bf16 first moment, two steps each; (d) the
# Llama example at 1B, two steps. Runs after phase 12.

#: (a): the step counts the kernel is checked at (the bias corrections of
#: a first and a late step), the learning rate and AdamW's constants as
#: `LlamaModule` gives them
ADAMW_STEPS = (1, 100)
ADAMW_LR, ADAMW_BETAS, ADAMW_EPS, ADAMW_WD = 3e-4, (0.9, 0.95), 1e-8, 0.1
#: (c): the short fits' steps
KNOB_STEPS = 2


def _bits(ts) -> list:
    """An integer checksum of each tensor's bits (a changed element
    changes it): what a skipped step must leave as it was."""
    ints = {4: torch.int32, 2: torch.int16}
    return [int(t.view(ints[t.element_size()]).sum(dtype=torch.int64))
            for t in ts]


def _ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in f32 ulps of ``want``."""
    w = want.abs()
    ulp = torch.nextafter(w, torch.full_like(w, math.inf)) - w
    return float(((got - want).abs() / ulp).max())


def adamw_check(gen: torch.Generator):
    """15 (a): `adamw_step_kernel` on phase 5's 27 parameters (1.92 G
    elements) against `adamw_step_plain` on copies: at steps 1 and 100 a
    skipped step (``found_inf`` 1) leaves both lanes' parameters, moments
    and step counts bitwise as they were, and a real one agrees, the
    first and second moments bitwise and the parameters within 1 ulp (the
    two compute the same operations, each rounded once, but for the
    bias corrections' ``powf``). Timed with CUDA events beside its bound
    (24 bytes an element over 3.35 TB/s) and torch's fused AdamW (f32
    moments) on the same tensors. Returns the kernels' row."""
    from ray_lightning_tpu_torch.models.llama import Llama
    from ray_lightning_tpu_torch.ops.kernels.adamw import (
        adamw_bytes,
        adamw_step_kernel,
        adamw_step_plain,
    )

    cfg, _ = train_inputs(SEED)
    shapes = [tuple(p.shape) for p in Llama(
        cfg, device="meta", param_dtype=torch.float32).parameters()]
    dev = "cuda"

    def randn(s, scale):
        return torch.randn(s, generator=gen, device=dev).mul_(scale)

    pk = [randn(s, 0.02) for s in shapes]
    g = [randn(s, 1e-3) for s in shapes]
    mk = [randn(s, 1e-4).to(torch.bfloat16) for s in shapes]
    vk = [randn(s, 1e-3).square_() for s in shapes]
    sk = [torch.zeros((), device=dev) for _ in shapes]
    pp, mp, vp, sp = ([t.clone() for t in ts] for ts in (pk, mk, vk, sk))
    n = sum(t.numel() for t in pk)
    lr = torch.full((), ADAMW_LR, device=dev)
    done = torch.zeros(len(pk), dtype=torch.int32, device=dev)
    b1, b2 = ADAMW_BETAS

    def kernel(found=None):
        adamw_step_kernel(pk, g, mk, vk, sk, lr, found, b1, b2, ADAMW_EPS,
                          ADAMW_WD, done)

    def plain(found=None):
        adamw_step_plain(pp, g, mp, vp, sp, lr, found, b1, b2, ADAMW_EPS,
                         ADAMW_WD)

    skip = torch.ones((), device=dev)
    checks, max_err, max_ulps = [], 0.0, 0.0
    for step in ADAMW_STEPS:
        for lane in ((pp, pk), (mp, mk), (vp, vk)):
            for a, b in zip(*lane):
                a.copy_(b)
        for s_ in sk + sp:
            s_.fill_(step - 1)
        before = _bits(pk + mk + vk + sk), _bits(pp + mp + vp + sp)
        launched = adamw_step_kernel.launches
        kernel(skip)
        plain(skip)
        torch.cuda.synchronize()
        after = _bits(pk + mk + vk + sk), _bits(pp + mp + vp + sp)
        if after != before or adamw_step_kernel.launches != launched + 1:
            raise AssertionError(f"adamw at step {step}: found_inf 1 "
                                 "changed the state")
        kernel()
        plain()
        torch.cuda.synchronize()
        ulps = max(_ulps(a, b) for a, b in zip(pk, pp))
        err = max(float((a - b).abs().max()) for a, b in zip(pk, pp))
        m_same = all(torch.equal(a, b) for a, b in zip(mk, mp))
        v_same = all(torch.equal(a, b) for a, b in zip(vk, vp))
        s_ok = all(float(a) == step == float(b) for a, b in zip(sk, sp))
        finite = all(bool(torch.isfinite(a).all()) for a in pk)
        checks.append(dict(step=step, param_max_ulps=ulps,
                           param_max_abs_err=err, exp_avg_bitwise=m_same,
                           exp_avg_sq_bitwise=v_same, steps_ok=s_ok))
        if not (ulps <= 1.0 and m_same and v_same and s_ok and finite):
            raise AssertionError(f"adamw kernel against plain at step "
                                 f"{step}: {checks[-1]}")
        max_err, max_ulps = max(max_err, err), max(max_ulps, ulps)
    kernel_ms = time_ms(kernel)
    plain_ms = time_ms(plain, reps=3)
    # torch's fused AdamW, f32 moments, on the plain lane's tensors
    del mp
    lib_m = [torch.zeros_like(t) for t in pp]
    library_ms = time_ms(lambda: torch._fused_adamw_(
        pp, g, lib_m, vp, [], sp, lr=lr, beta1=b1, beta2=b2,
        weight_decay=ADAMW_WD, eps=ADAMW_EPS, amsgrad=False,
        maximize=False))
    b_ms, b_by = bound(adamw_bytes(pk, mk), 0)
    row = dict(kernel="adamw_step", shape=dict(
        tensors=len(pk), elements=n, exp_avg="bfloat16",
        steps=list(ADAMW_STEPS)), checks=checks, max_abs_err=max_err,
        param_max_ulps=max_ulps, kernel_ms=kernel_ms, plain_ms=plain_ms,
        library_ms=library_ms, library="torch._fused_adamw_ (f32 moments)",
        bound_ms=b_ms, bound_by=b_by, bytes=adamw_bytes(pk, mk),
        library_bytes=adamw_bytes(pp, lib_m))
    print(json.dumps(row), flush=True)
    del pk, g, mk, vk, pp, vp, lib_m
    gc.collect()
    torch.cuda.empty_cache()
    return row


def knob_launches(steps: int, warm_ups: int = 1, attn_out=False,
                  mu=False, layers: int = TRAIN_LAYERS) -> dict:
    """A fit's launches under the knobs: "attn_out" runs the flash
    forward once a layer and step (never again in the backward), the
    bf16 first moment one AdamW launch a step and warm-up (the warm-up's
    is a skipped step); the rest is phase 5's formula."""
    want = expected_launches(steps, warm_ups, layers)
    n = steps + warm_ups
    if attn_out:
        want["flash_fwd_kernel"] = layers * n
    if mu:
        want["adamw_step_kernel"] = n
    return want


def knobs_fit(seed: int, problems: list) -> dict:
    """15 (b): phase 5's fit with ``mu_dtype=torch.bfloat16``,
    ``remat_policy="attn_out"`` and ``ce_inline_bwd=True``: kernel lane
    against reference lane under phase 5's limits; its launches; the
    first moment bf16; the optimizer's live bytes equal to the plan's to
    the byte; the peak under the plan's total. Returns the launches."""
    from ray_lightning_tpu_torch.parallel.plan import (
        llama_activation_bytes,
        plan_train_memory,
    )
    from ray_lightning_tpu_torch.parallel.strategy import SingleDevice

    cfg, tokens = train_inputs(seed)
    cfg = dataclasses.replace(cfg, remat_policy="attn_out",
                              ce_inline_bwd=True)
    mkw = dict(mu_dtype=torch.bfloat16)
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    live, dtypes = {}, set()

    def inspect(trainer, module):
        live.update(live_bytes(trainer, module))
        dtypes.update(str(st["exp_avg"].dtype)
                      for st in trainer.state.optimizer.state.values())

    probe, wall, peak, _ = train_once(cfg, tokens, seed, inspect=inspect,
                                      module_kw=mkw)
    launches = {k.__name__: k.launches for k in kernels}
    want = knob_launches(TRAIN_STEPS, attn_out=True, mu=True)
    if launches != want:
        problems.append(f"(b) launches {launches} != {want}")
    gc.collect()
    torch.cuda.empty_cache()
    ref, ref_wall, ref_peak, _ = train_reference(cfg, tokens, seed,
                                                 module_kw=mkw)
    d_loss, d_gn, lanes = compare_train(probe.rows, ref.rows)
    problems += [f"(b) {p}" for p in lanes]
    plan = plan_train_memory(
        LlamaModule(cfg, **mkw), SingleDevice(), 1, None,
        activation_bytes_per_device=llama_activation_bytes(cfg, TB, TS),
        device_kind=torch.cuda.get_device_name(0))
    n_elems = plan.params_bytes_per_device // 4
    if dtypes != {"torch.bfloat16"}:
        problems.append(f"(b) exp_avg dtypes {dtypes}")
    if plan.opt_bytes_per_device != live["opt"]:
        problems.append(f"(b) plan optimizer {plan.opt_bytes_per_device} "
                        f"!= live {live['opt']}")
    if plan.params_bytes_per_device != live["params"]:
        problems.append(f"(b) plan params {plan.params_bytes_per_device} "
                        f"!= live {live['params']}")
    if not plan.per_device_total >= peak:
        problems.append(f"(b) plan total {plan.per_device_total} < peak "
                        f"{peak}")
    step_s = statistics.median(b - a for a, b in zip(probe.t[2:],
                                                     probe.t[3:]))
    print(json.dumps(dict(
        phase="knobs_fit", layers=TRAIN_LAYERS, steps=TRAIN_STEPS,
        batch=TB, seq=TS, mu_dtype="bfloat16", remat_policy="attn_out",
        ce_inline_bwd=True, losses=[r[0] for r in probe.rows],
        grad_norms=[r[1] for r in probe.rows],
        ref_losses=[r[0] for r in ref.rows],
        loss_max_abs_diff=d_loss, grad_norm_max_rel_diff=d_gn,
        loss_tol=TRAIN_LOSS_TOL, grad_norm_rtol=TRAIN_GNORM_RTOL,
        flash_fwd_per_step=launches["flash_fwd_kernel"]
        / (TRAIN_STEPS + 1), launches=launches, exp_avg_dtypes=sorted(dtypes),
        live=live, plan=plan_terms(plan), peak=peak,
        opt_terms=dict(exp_avg=2 * n_elems, exp_avg_sq=4 * n_elems,
                       steps=plan.opt_bytes_per_device - 6 * n_elems),
        plan_minus_peak_gib=(plan.per_device_total - peak) / 2**30,
        step_s_p50=step_s, tokens_per_s=TB * TS / step_s, fit_wall_s=wall,
        ref_fit_wall_s=ref_wall, ref_peak=ref_peak)), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def dots_recompute(seed: int, problems: list) -> None:
    """15 (c), first: one forward and backward of phase 5's model (B 2,
    S 2048) without remat, under "nothing" and under "dots", counting
    the projection GEMMs the backward runs (a dispatch mode sees what
    runs, not what the checkpoint's cache hands back) and the flash
    forward's launches in it. "dots" must run no GEMM beyond the unchecked
    backward's; its flash forward runs again (no dot)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from ray_lightning_tpu_torch.models.llama import Llama, init_params_
    from ray_lightning_tpu_torch.ops import remat
    from ray_lightning_tpu_torch.ops.kernels.flash import flash_fwd_kernel

    class Gemms(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in remat.DOTS:
                self.n += 1
            return func(*args, **(kwargs or {}))

    cfg, tokens = train_inputs(seed)
    model = Llama(cfg, device="cuda", param_dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    init_params_(model, gen).requires_grad_(True)
    t = torch.from_numpy(tokens[:TB]).cuda()
    counts = {}
    for name, c in (("no_remat", dataclasses.replace(cfg, remat=False)),
                    ("nothing", cfg),
                    ("dots", dataclasses.replace(cfg, remat_policy="dots"))):
        model.cfg = c
        for layer in model.layers:
            layer.cfg = c
        loss = model(t[:, :-1], targets=t[:, 1:])
        fwd = flash_fwd_kernel.launches
        with Gemms() as gemms:
            loss.backward()
        torch.cuda.synchronize()
        counts[name] = dict(gemms=gemms.n,
                            flash_fwd=flash_fwd_kernel.launches - fwd)
        model.zero_grad(set_to_none=True)
    L = TRAIN_LAYERS
    if not (counts["dots"]["gemms"] == counts["no_remat"]["gemms"]
            < counts["nothing"]["gemms"]
            and counts["dots"]["flash_fwd"] == L
            and counts["nothing"]["flash_fwd"] == L
            and counts["no_remat"]["flash_fwd"] == 0):
        problems.append(f"(c) backward GEMMs and flash forwards {counts}")
    print(json.dumps(dict(phase="knobs_dots_recompute", backward=counts)),
          flush=True)
    del model, loss
    gc.collect()
    torch.cuda.empty_cache()


def short_fits(seed: int, ref_rows, problems: list) -> dict:
    """15 (c), then: phase 5's fit under "dots", and a tied phase 5 model
    under `FSDP` with the bf16 first moment, KNOB_STEPS steps each:
    launches by phase 5's formula (and one AdamW launch a step and
    warm-up for the second); "dots"'s rows within the train limits of
    phase 5's first rows (the same arithmetic, its GEMM outputs kept
    rather than recomputed); the tied model without an ``lm_head``,
    every parameter and first moment a DTensor (FSDP2's shard over a
    one-rank mesh, stepped through its local tensor), the first moment
    bf16, its parameter and optimizer bytes equal to its plan's. Returns
    the launches."""
    import numpy as np
    from torch.distributed.tensor import DTensor

    from ray_lightning_tpu_torch.parallel.plan import plan_train_memory
    from ray_lightning_tpu_torch.parallel.strategy import FSDP

    cfg, tokens = train_inputs(seed)
    toks = tokens[:KNOB_STEPS * TB]
    total = {k.__name__: 0 for k in all_kernels()}
    mkw = dict(mu_dtype=torch.bfloat16)
    for name, c, kw in (
            ("dots", dataclasses.replace(cfg, remat_policy="dots"), {}),
            ("tied", dataclasses.replace(cfg, tie_embeddings=True),
             dict(strategy=FSDP(), module_kw=mkw))):
        kernels = all_kernels()
        for k in kernels:
            k.launches = 0
        info = {}

        def inspect(trainer, module):
            info.update(live_bytes(trainer, module))
            info["lm_head"] = hasattr(module.model, "lm_head")
            states = trainer.state.optimizer.state.values()
            info["dtensors"] = all(isinstance(p, DTensor) for p in
                                   module.params.values()) and all(
                isinstance(st["exp_avg"], DTensor) for st in states)
            info["exp_avg"] = sorted({str(st["exp_avg"].dtype)
                                      for st in states})

        probe, wall, peak, n_params = train_once(c, toks, seed,
                                                 steps=KNOB_STEPS,
                                                 inspect=inspect, **kw)
        launches = {k.__name__: k.launches for k in kernels}
        for k, v in launches.items():
            total[k] += v
        want = knob_launches(KNOB_STEPS, mu="module_kw" in kw)
        if launches != want:
            problems.append(f"(c) {name}: launches {launches} != {want}")
        losses = [r[0] for r in probe.rows]
        if not all(map(np.isfinite, losses)):
            problems.append(f"(c) {name}: losses {losses}")
        row = dict(phase=f"knobs_{name}", steps=KNOB_STEPS, losses=losses,
                   grad_norms=[r[1] for r in probe.rows], peak=peak,
                   params=n_params, live=info, fit_wall_s=wall,
                   launches=launches)
        if name == "dots":
            d_loss, d_gn, lanes = compare_train(probe.rows,
                                                ref_rows[:KNOB_STEPS])
            problems += [f"(c) dots against phase 5: {p}" for p in lanes]
            row.update(loss_max_abs_diff=d_loss, grad_norm_max_rel_diff=d_gn,
                       bitwise_phase5=probe.rows == ref_rows[:KNOB_STEPS])
        else:
            plan = plan_train_memory(LlamaModule(c, **mkw), FSDP(), 1, None)
            if (info["lm_head"] or not info["dtensors"]
                    or info["exp_avg"] != ["torch.bfloat16"]
                    or plan.params_bytes_per_device != info["params"]
                    or plan.opt_bytes_per_device != info["opt"]):
                problems.append(f"(c) tied under FSDP: {info} against the "
                                f"plan's {plan_terms(plan)}")
            row.update(strategy="FSDP", mu_dtype="bfloat16",
                       plan=plan_terms(plan))
        print(json.dumps(row), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return total


#: (d): the example's arguments (the 1B model: Llama-3-8B's state is more
#: than one card holds), its depth, and where it runs (git-ignored;
#: removed after)
EXAMPLE_ARGS = ["--model", "1b", "--seq-len", str(TS), "--batch-size",
                str(TB), "--max-steps", "2", "--mu-bf16", "--remat-policy",
                "attn_out", "--ce-inline-bwd", "--fused-ce", "on"]
EXAMPLE_LAYERS = 16
EXAMPLE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "rlt_logs", "chip_smoke_example")


def example_leg(problems: list) -> dict:
    """15 (d): the Llama example (`ray_lightning_tpu_torch.examples.
    llama_fsdp_example`), the slice's entry point, through its ``main``
    as ``python -m`` calls it, from a scratch directory where it writes
    its checkpoint: `EXAMPLE_ARGS`, in this process under its one-rank
    `ShardedMesh`. It must exit 0 with the summary line's loss finite
    and within 2 of ln V (random weights' cross-entropy), the first
    moment bf16, its launches those of 2 steps and a warm-up of a
    16-layer model under "attn_out" with the bf16 moment, and a
    checkpoint written. Returns the launches."""
    import contextlib
    import io

    from ray_lightning_tpu_torch.examples import llama_fsdp_example as ex

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    shutil.rmtree(EXAMPLE_DIR, ignore_errors=True)
    os.makedirs(EXAMPLE_DIR)
    here, digest = os.getcwd(), os.environ.get("RLT_CKPT_DIGEST")
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        os.chdir(EXAMPLE_DIR)
        # the digest of file sizes, as phases 6 and 8 save
        os.environ["RLT_CKPT_DIGEST"] = "size"
        with contextlib.redirect_stdout(out):
            rc = ex.main(EXAMPLE_ARGS)
        torch.cuda.synchronize()
    finally:
        os.chdir(here)
        if digest is None:
            os.environ.pop("RLT_CKPT_DIGEST", None)
        else:
            os.environ["RLT_CKPT_DIGEST"] = digest
    wall = time.perf_counter() - t0
    ck_dir = os.path.join(EXAMPLE_DIR, "llama_fsdp", "checkpoints")
    ckpts = sorted(os.listdir(ck_dir)) if os.path.isdir(ck_dir) else []
    ck_bytes = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(ck_dir) for f in fs)
    shutil.rmtree(EXAMPLE_DIR, ignore_errors=True)
    launches = {k.__name__: k.launches for k in kernels}
    lines = out.getvalue().strip().splitlines()
    summary = json.loads(lines[-1]) if lines else {}
    vocab = ex.model_config(ex.parser().parse_args(EXAMPLE_ARGS)).vocab_size
    loss = summary.get("loss", math.nan)
    want = knob_launches(2, attn_out=True, mu=True, layers=EXAMPLE_LAYERS)
    if not (rc == 0 and math.isfinite(loss)
            and abs(loss - math.log(vocab)) < 2
            and summary.get("exp_avg_dtype") == "torch.bfloat16"
            and summary.get("steps") == 2 and ckpts):
        problems.append(f"(d) example: rc {rc}, summary {summary}, "
                        f"checkpoints {ckpts}")
    if launches != want:
        problems.append(f"(d) example: launches {launches} != {want}")
    print(json.dumps(dict(phase="knobs_example", args=EXAMPLE_ARGS,
                          summary=summary, checkpoints=ckpts,
                          checkpoint_bytes=ck_bytes,
                          ln_vocab=math.log(vocab), launches=launches,
                          wall_s=wall)), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def knobs_phase(seed: int, ref_rows):
    """Phase 15 (a)-(d); returns the launches of (b), (c) and (d)'s fits
    and (a)'s kernel row."""
    problems = []
    free_card("knobs")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    row = adamw_check(gen)
    total = knobs_fit(seed, problems)
    dots_recompute(seed, problems)
    for k, v in short_fits(seed, ref_rows, problems).items():
        total[k] += v
    for k, v in example_leg(problems).items():
        total[k] += v
    if problems:
        raise AssertionError("phase 15, the Llama path's knobs: "
                             + "; ".join(problems))
    return total, row


# ---- phase 14: elastic training, closed-loop autoscale, trace load ---------
#
# (a) runs inside phase 6 (c), on its step-4 checkpoint; (c) inside
# phase 4, on its model; (d) after phase 11 (c), on its params file. Each
# part's seconds land in PHASE14_S, and the timing line's ``phase14_s`` is
# their sum (taken out of the phases that hold them).

#: (a): tensor ranks (processes sharing the one card over gloo) and one
#: call's limit
ELASTIC_RANKS = 2
ELASTIC_TIMEOUT_S = 600
#: (a) keeps its logs and spans here (git-ignored; removed after)
ELASTIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "rlt_logs", "chip_smoke_elastic")
#: (a)'s ranks start before 6 (c)'s save and wait for this file, which
#: names the checkpoint
GROW_GATE = os.path.join(ELASTIC_DIR, "go")
#: (c): the trace, in `loadgen.WorkloadConfig` units (the class mix and
#: the sampled share are the generator's defaults), and its seed offset
AUTOSCALE_TRACE = dict(n_requests=24, process="mmpp", rate=0.5,
                       burst_rate=4.0, prompt_len_min=128,
                       prompt_len_max=1536, max_new_min=8, max_new_max=32,
                       vocab_size=128256)
AUTOSCALE_SEED = 14
#: (c): best-effort's admission budget (its queue may hold this many)
AUTOSCALE_BE_BUDGET = 1
#: (c)'s run dirs (git-ignored; removed after)
AUTOSCALE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "rlt_logs", "chip_smoke_autoscale")
#: each part's seconds
PHASE14_S = {}


#: an element's positional weight in `piece_digest`: its flat index in
#: the whole value, mod this prime, plus one
DIGEST_PERIOD = 1000003


def piece_digest(t, offset=None, full=None, rows=None,
                 chunk: int = 1 << 24) -> list:
    """``[sum of words, sum of words x (i mod p + 1)]`` mod 2^64 of a
    tensor's bits, on its device, where ``i`` is each element's flat index
    in the whole value (shape ``full``, the tensor's own by default) whose
    piece at ``offset`` the tensor is; ``rows`` names the whole value's
    row of each of the piece's rows (a permuted layout). Every bit
    reaches the first sum and the second places each element, so the
    digests of a value's disjoint pieces sum to the whole value's."""
    x = t.detach().contiguous()
    word = {8: torch.int64, 4: torch.int32, 2: torch.int16,
            1: torch.uint8}[x.element_size()]
    w = x.view(word).reshape(max(1, x.shape[0] if x.dim() else 1), -1)
    full = tuple(full if full is not None else x.shape) or (1,)
    offset = tuple(offset or (0,) * len(full))
    stride = [1] * len(full)
    for d in range(len(full) - 2, -1, -1):
        stride[d] = stride[d + 1] * full[d + 1]
    dev = x.device
    if rows is None:
        rows = torch.arange(offset[0], offset[0] + w.shape[0], device=dev)
    rows = rows.to(device=dev, dtype=torch.int64)
    # the flat index of each element of a piece's row, less the row's
    inner = torch.zeros((), dtype=torch.int64, device=dev)
    for d in range(1, x.dim()):
        inner = inner[..., None] + torch.arange(
            offset[d], offset[d] + x.shape[d], device=dev) * stride[d]
    inner = inner.reshape(-1)
    s0 = torch.zeros((), dtype=torch.int64, device=dev)
    s1 = torch.zeros((), dtype=torch.int64, device=dev)
    per = max(1, chunk // max(1, inner.numel()))
    for i in range(0, w.shape[0], per):
        part = w[i:i + per].to(torch.int64)
        pos = (rows[i:i + per, None] * stride[0] + inner[None, :]) \
            % DIGEST_PERIOD + 1
        s0 += part.sum()
        s1 += (part * pos).sum()
    return [int(s0) % 2**64, int(s1) % 2**64]


def _local(v):
    from torch.distributed.tensor import DTensor

    return v.to_local() if isinstance(v, DTensor) else v


def _piece_at(v):
    """(global offset, shape) of a value's local piece (a whole tensor's
    is itself)."""
    from torch.distributed.tensor import DTensor

    if isinstance(v, DTensor):
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset,
        )

        if any(type(p).__name__ == "_StridedShard" for p in v.placements):
            raise ValueError(f"no global offset for {v.placements}")
        shape, off = compute_local_shape_and_global_offset(
            v.shape, v.device_mesh, v.placements)
        return [int(o) for o in off], [int(s) for s in shape]
    return [0] * v.dim(), list(v.shape)


def digest_pieces(leaves: dict, perms=None) -> dict:
    """``{path: [offset, shape, whole shape, digest]}`` of each leaf's
    local piece; ``perms`` maps a path to its layout's row permutation
    (row ``r`` holds the canonical row ``perm[r]``), so that the digest
    places each element at its canonical index."""
    out = {}
    for p, v in leaves.items():
        off, shape = _piece_at(v)
        perm = (perms or {}).get(p)
        rows = None if perm is None else perm[off[0]:off[0] + shape[0]]
        out[p] = [off, shape, list(v.shape),
                  piece_digest(_local(v), off, v.shape, rows)]
    return out


def combine_pieces(ranks) -> dict:
    """The whole values' digests from the ranks' `digest_pieces`: each
    distinct piece once (a replicated one must digest alike on every
    rank), summed mod 2^64; ``None`` for a leaf whose pieces disagree or
    do not cover it."""
    out = {}
    for p in set().union(*ranks):
        seen = {}
        for pieces in ranks:
            if p in pieces:
                off, shape, full, dg = pieces[p]
                key = (tuple(off), tuple(shape))
                if seen.setdefault(key, dg) != dg:
                    seen = None
                    break
        if seen is None:
            out[p] = None
            continue
        n = sum(math.prod(k[1]) for k in seen)
        whole = math.prod(next(r[p][2] for r in ranks if p in r))
        out[p] = ([sum(d[0] for d in seen.values()) % 2**64,
                   sum(d[1] for d in seen.values()) % 2**64]
                  if n == whole else None)
    return out


def state_leaves(params, osd) -> dict:
    """``{path: value}`` of a state dict pair's tensors: every parameter
    and optimizer tensor (moments and step counts)."""
    out = {f"params/{k}": v for k, v in params.items()}
    for name, st in osd["state"].items():
        for k, v in st.items():
            if torch.is_tensor(v):
                out[f"opt/{name}/{k}"] = v
    return out


def wrapped_pieces(trainer, module) -> dict:
    """`digest_pieces` of the live training state as the wrapped model
    holds it (under the tensor axis the fused rows head-aligned, each
    element digested at its canonical place): no gather."""
    strategy = trainer.strategy
    opt = trainer.state.optimizer
    leaves, perms = {}, {}
    for n, prm in strategy.unwrap(module.model).named_parameters():
        perm = strategy._perm(n)
        st = {k: v for k, v in opt.state.get(prm, {}).items()
              if torch.is_tensor(v)}
        for path, v in [(f"params/{n}", prm),
                        *((f"opt/{n}/{k}", v) for k, v in st.items())]:
            leaves[path] = v
            if perm is not None and v.dim():
                perms[path] = perm
    return digest_pieces(leaves, perms)


def _sched_json(sched) -> dict:
    return {k: (v.tolist() if torch.is_tensor(v) else v)
            for k, v in sched.state_dict().items()}


def save_digests(trainer, checkpoint) -> dict:
    """What a save wrote, for a later restore to be held against: the
    checkpoint's canonical pieces (`digest_pieces`), step and
    scheduler."""
    return dict(step=checkpoint["step"], global_step=trainer.global_step,
                scheduler=_sched_json(trainer.state.scheduler),
                pieces=digest_pieces(state_leaves(checkpoint["params"],
                                                  checkpoint["opt_state"])))


def time_restore(strategy, marks: dict) -> None:
    """Mark when ``strategy`` starts and ends building a restore's target
    and loading what it read (``marks``: name -> perf_counter)."""
    for name in ("restore_target", "load_state_dicts"):
        def timed(*a, _f=getattr(strategy, name), _n=name):
            marks[f"{_n}_start"] = time.perf_counter()
            out = _f(*a)
            torch.cuda.synchronize()
            marks[f"{_n}_end"] = time.perf_counter()
            return out
        setattr(strategy, name, timed)


def setup_split(t0: float, marks: dict, t_fit_start: float) -> dict:
    """A resumed fit's seconds to ``on_fit_start``, split: the build and
    init, the restore target, the read (the reshard span's restore), the
    load into the layout, and the rest."""
    if len(marks) < 4:
        return {}
    return dict(
        build_init_s=marks["restore_target_start"] - t0,
        target_s=marks["restore_target_end"] - marks["restore_target_start"],
        read_s=marks["load_state_dicts_start"] - marks["restore_target_end"],
        load_s=marks["load_state_dicts_end"]
        - marks["load_state_dicts_start"],
        rest_s=t_fit_start - marks["load_state_dicts_end"])


class ElasticProbe(Callback):
    """In a resumed fit (14 (a)'s ranks): before the first step, the
    restored state as ``pieces(trainer, module)`` digests it, with the
    step and the scheduler, and the seconds to there, split
    (`time_restore` marks the strategy's restore); every step's (step,
    loss, grad_norm); the kernels' launches from then on."""

    def __init__(self, pieces, strategy):
        self.pieces = pieces
        self.rec = dict(rows=[])
        self._marks = {}
        time_restore(strategy, self._marks)
        #: the fit's start (set by the caller): the seconds to its
        #: ``on_fit_start`` are the build, the init and the restore
        self.t0 = time.perf_counter()

    def on_fit_start(self, trainer, module):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.rec.update(setup_s=t0 - self.t0,
                        setup_split=setup_split(self.t0, self._marks, t0),
                        restored=dict(
                            pieces=self.pieces(trainer, module),
                            step=trainer.state.step,
                            scheduler=_sched_json(trainer.state.scheduler)),
                        move=trainer.last_reshard)
        torch.cuda.synchronize()
        self.rec["digest_s"] = time.perf_counter() - t0
        for k in all_kernels():
            k.launches = 0

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        self.rec["rows"].append((trainer.global_step, float(metrics["loss"]),
                                 float(metrics["grad_norm"])))

    def on_fit_end(self, trainer, module):
        torch.cuda.synchronize()
        self.rec["launches"] = {k.__name__: k.launches
                                for k in all_kernels()}
        self.rec["peak"] = torch.cuda.max_memory_allocated()


def restore_mismatches(restored, want) -> tuple:
    """The restored state (the ranks' ``restored`` records) against what
    a save wrote (``want``: `save_digests` of its ranks): the leaves
    whose pieces, combined, differ from the saved ones combined, and a
    step or scheduler that differs. Returns (mismatches, leaves
    compared)."""
    got = combine_pieces([r["pieces"] for r in restored])
    ref = combine_pieces([w["pieces"] for w in want])
    bad = sorted(p for p in set(got) | set(ref)
                 if got.get(p) is None or got.get(p) != ref.get(p))
    for r in restored:
        for k in ("step", "scheduler"):
            if any(r[k] != w[k] for w in want):
                bad.append(k)
    return bad, len(ref) + 2


def _read_telemetry(tdir: str, rank: int) -> dict:
    """A rank's reshard spans and its goodput ledger's reshard_s."""
    from ray_lightning_tpu_torch.telemetry.goodput import read_ledgers
    from ray_lightning_tpu_torch.telemetry.spans import read_spans

    spans = [s for p in glob.glob(os.path.join(tdir,
                                               f"rank{rank}.*spans.jsonl"))
             for s in read_spans(p)["spans"] if s["phase"] == "reshard"]
    ledgers = read_ledgers(tdir, rank=rank)
    return dict(reshard_spans=len(spans),
                reshard_span_s=[s["dur"] for s in spans],
                reshard_meta=[s.get("meta") for s in spans],
                reshard_s=[lg["buckets"].get("reshard_s") for lg in ledgers])


def elastic_worker(rank: int, world: int, port: int, seed: int,
                   out: str) -> None:
    """One rank of 14 (a): phase 5's fit resumed from phase 6 (c)'s
    world-1 FSDP checkpoint under ``ShardedMesh(tensor=world)`` in a gloo
    group on the visible card, steps 5-8; writes what its `ElasticProbe`
    recorded to ``out``. Started before 6 (c)'s save, it imports while
    the save runs and waits for GROW_GATE, which names the checkpoint."""
    warm_s = warm_imports()
    import torch.distributed as dist

    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import ShardedMesh

    ckpt = await_gate(GROW_GATE)["ckpt"]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    cfg, tokens = train_inputs(seed)
    strategy = ShardedMesh(tensor=world)
    probe = ElasticProbe(wrapped_pieces, strategy)
    tdir = os.path.join(ELASTIC_DIR, "telemetry_grow")
    module = LlamaModule(cfg, lr=TRAIN_LR, warmup_steps=2,
                         total_steps=TRAIN_STEPS)
    trainer = Trainer(
        strategy=strategy, max_steps=TRAIN_STEPS,
        log_every_n_steps=1, enable_checkpointing=False,
        enable_progress_bar=False, seed=seed, telemetry=tdir,
        callbacks=[probe])
    torch.cuda.reset_peak_memory_stats()
    t0 = probe.t0 = time.perf_counter()
    # both ranks of the tensor group read every row
    trainer.fit(module, DataLoader({"tokens": tokens}, batch_size=TB),
                ckpt_path=ckpt)
    torch.cuda.synchronize()
    with open(out, "w") as f:
        json.dump(dict(rank=rank, fit_wall_s=time.perf_counter() - t0,
                       warm_s=warm_s, backend=dist.get_backend(),
                       mesh=trainer.strategy.mesh_shape,
                       **_read_telemetry(tdir, rank), **probe.rec), f)
    dist.destroy_process_group()


def _reshard_problems(what: str, rec: dict, axes, worlds, steps,
                      ref_rows, want_launches, problems: list):
    """The checks of each of 14 (a)'s ranks: the restore bitwise, the
    move's summary, the reshard span and goodput bucket, the steps, the
    rows within the train limits, the launches by phase 5's formula."""
    if rec["mismatches"] or not rec["leaves"]:
        problems.append(f"{what}: {len(rec['mismatches'])} of "
                        f"{rec['leaves']} restored leaves differ: "
                        f"{rec['mismatches'][:8]}")
    move = rec.get("move") or {}
    if (move.get("changed_axes") != axes
            or (move.get("from_world"), move.get("to_world")) != worlds):
        problems.append(f"{what}: move {move}")
    if rec["reshard_spans"] != 1 or not (rec["reshard_s"]
                                         and rec["reshard_s"][-1] > 0):
        problems.append(f"{what}: {rec['reshard_spans']} reshard span(s), "
                        f"reshard_s {rec['reshard_s']}")
    if [r[0] for r in rec["rows"]] != list(steps):
        problems.append(f"{what}: ran steps {[r[0] for r in rec['rows']]}")
    d_loss, d_gn, rel = compare_train([tuple(r[1:]) for r in rec["rows"]],
                                      ref_rows)
    problems.extend(f"{what} against its reference rows: {p}" for p in rel)
    if rec["launches"] != want_launches:
        problems.append(f"{what}: launches {rec['launches']} != "
                        f"{want_launches}")
    return d_loss, d_gn


def elastic_grow(seed: int, ckpt: str, saved, ref_rows, problems: list,
                 spawned):
    """14 (a): phase 6 (c)'s world-1 FSDP step-4 checkpoint (23.08 GB of
    f32 weights and AdamW moments) resumed by ELASTIC_RANKS processes on
    the card, each a rank of ``ShardedMesh(tensor=2)`` over gloo: every
    restored leaf, as the ranks hold it (head-aligned rows, each element
    digested at its canonical place, no gather), bitwise what 6 (c)'s
    save wrote (``saved``: its `save_digests`, taken by the saving rank),
    the step and scheduler too; the move ["tensor"] world 1 -> 2 with a
    `reshard` span and goodput reshard_s on each rank, steps 5-8 within
    the train limits of ``ref_rows``, launches by phase 5's formula at
    H 16 / Hkv 4 (the ranks ``spawned`` by `elastic_start`). Returns the
    launches."""
    free_card("elastic_grow")
    t0 = open_gate(GROW_GATE, ckpt=ckpt)
    rc, ranks, tails = _reap(spawned, t0)
    wall = time.perf_counter() - t0
    total = {k.__name__: 0 for k in all_kernels()}
    if any(rc) or not all(ranks):
        problems.append("grow ranks failed: " + " | ".join(
            f"rank {r} (rc {c}): {t}" for r, (c, t) in enumerate(
                zip(rc, tails))))
        return total
    bad, n = restore_mismatches([r["restored"] for r in ranks], [saved])
    want = expected_launches(TRAIN_STEPS - RESUME_AT)
    for r in ranks:
        r.update(mismatches=bad, leaves=n)
        d_loss, d_gn = _reshard_problems(
            f"14 (a) rank {r['rank']}", r, ["tensor"], (1, ELASTIC_RANKS),
            range(RESUME_AT + 1, TRAIN_STEPS + 1), ref_rows, want, problems)
        if r["rows"] != ranks[0]["rows"]:
            problems.append(f"14 (a) rank {r['rank']}'s rows differ from "
                            "rank 0's")
        if r["backend"] != "gloo":
            problems.append(f"14 (a) rank {r['rank']}: {r['backend']}")
        for k, v in r["launches"].items():
            total[k] += v
    print(json.dumps(dict(
        phase="elastic_grow", ranks=ELASTIC_RANKS, backend="gloo",
        lane="correctness (every all-reduce crosses the host)",
        checkpoint="phase 6 (c) step 4, FSDP world 1",
        held_against="6 (c)'s step-4 save digests",
        move=ranks[0]["move"], leaves=n, mismatches=len(bad),
        setup_s=[r["setup_s"] for r in ranks],
        setup_split=[r["setup_split"] for r in ranks],
        restore_digest_s=[r["digest_s"] for r in ranks],
        reshard_s=[r["reshard_s"] for r in ranks],
        reshard_span_s=[r["reshard_span_s"] for r in ranks],
        steps=[x[0] for x in ranks[0]["rows"]],
        losses=[x[1] for x in ranks[0]["rows"]],
        grad_norms=[x[2] for x in ranks[0]["rows"]],
        loss_max_abs_diff=d_loss, grad_norm_max_rel_diff=d_gn,
        loss_tol=TRAIN_LOSS_TOL, grad_norm_rtol=TRAIN_GNORM_RTOL,
        peak_gib=[r["peak"] / 2**30 for r in ranks],
        fit_wall_s=[r["fit_wall_s"] for r in ranks], call_wall_s=wall,
        warm_s=[r["warm_s"] for r in ranks],
        launches=[r["launches"] for r in ranks])), flush=True)
    return total


def elastic_start(seed: int) -> list:
    """Start 14 (a)'s ELASTIC_RANKS processes before 6 (c)'s save: they
    import while it runs and wait for GROW_GATE."""
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    os.makedirs(ELASTIC_DIR)
    return _spawn("elastic_worker", f"{seed}, ", "grow", ELASTIC_TIMEOUT_S,
                  ELASTIC_DIR, ELASTIC_RANKS, env={"RLT_CKPT_DIGEST": "size"})


def elastic_phase(seed: int, ckpt: str, saved, ref_rows, spawned) -> dict:
    """14 (a), inside phase 6 (c) on its step-4 checkpoint (``saved``:
    the digests its saving rank took; ``ref_rows``: phase 6 (a)'s rows
    5-8, phase 5's bitwise; ``spawned``: `elastic_start`'s ranks).
    Returns the launches."""
    problems = []
    t0 = time.perf_counter()
    try:
        total = elastic_grow(seed, ckpt, saved, ref_rows, problems, spawned)
    finally:
        shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
        PHASE14_S["elastic"] = time.perf_counter() - t0 \
            + saved["digest_s"]
    if problems:
        raise AssertionError("phase 14 (a): " + "; ".join(problems))
    return total


def autoscale_slo():
    """(c)'s traffic classes: generous latency targets (the watch and the
    report read them; they shed nothing) and best-effort's admission
    budget."""
    from ray_lightning_tpu_torch.serve.scheduler import ClassSLO, SLOConfig

    return SLOConfig(classes={
        "latency_critical": ClassSLO(ttft_p95_s=10.0, tpot_p95_s=5.0),
        "standard": ClassSLO(ttft_p95_s=30.0, tpot_p95_s=10.0),
        "best_effort": ClassSLO(ttft_p95_s=60.0, tpot_p95_s=20.0,
                                queue_budget=AUTOSCALE_BE_BUDGET)})


def _cli_json(argv) -> dict:
    """``python -m ray_lightning_tpu_torch <argv> --json``'s output, run
    through the CLI's own entry point in this process."""
    import contextlib
    import io

    from ray_lightning_tpu_torch.__main__ import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli([*argv, "--json"])
    if rc != 0:
        raise AssertionError(f"{argv}: exit {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _class_stats(meta: dict) -> dict:
    out = {}
    for cls in ("latency_critical", "standard", "best_effort"):
        ms = [m for m in meta.values() if m.get("priority") == cls]
        ttft = sorted(m["ttft_s"] for m in ms if m["finish_reason"] != "shed")
        out[cls] = dict(
            requests=len(ms),
            shed=sum(m["finish_reason"] == "shed" for m in ms),
            ttft_p50_s=statistics.median(ttft) if ttft else None,
            ttft_p95_s=ttft[min(len(ttft) - 1, max(
                0, -(-95 * len(ttft) // 100) - 1))] if ttft else None)
    return out


def autoscale_phase(model, ecfg) -> dict:
    """14 (c): a seeded bursty MMPP trace (AUTOSCALE_TRACE) driven by
    `loadgen.run_trace` through ``ServeDriver(inline, n_replicas=1)``
    under an `AutoscaleController` (the CLI's ramp policy, cooldowns in
    ticks): exactly one scale-up 1 -> 2 and one scale-down 2 -> 1, both
    acted and each with its signal snapshot; every rid completed or shed
    with a typed record, no latency-critical shed; every completed stream
    the same trace's through a fixed one-replica driver (bitwise, or
    parting only under phase 13's margin rule); launches by phase 4's
    formula over both replicas' ticks and chunks; the report's autoscale
    section and the timeline's merge of the ledger. Returns the
    launches."""
    from ray_lightning_tpu_torch.autoscale import (
        AutoscaleController,
        ControllerConfig,
        read_ledger,
    )
    from ray_lightning_tpu_torch.autoscale.cli import _ramp_policy
    from ray_lightning_tpu_torch.loadgen import (
        WorkloadConfig,
        generate_events,
        run_trace,
        to_request,
    )
    from ray_lightning_tpu_torch.serve.driver import (
        ReplicaGroupConfig,
        ServeDriver,
    )

    problems = []
    t_all = time.perf_counter()
    L = model.cfg.n_layers
    wl = WorkloadConfig(seed=AUTOSCALE_SEED, **AUTOSCALE_TRACE)
    events = generate_events(wl)
    span = ecfg.block_size * ecfg.blocks_per_slot
    over = [e.rid for e in events if len(e.prompt) + e.max_new_tokens > span]
    if over:
        problems.append(f"(c) requests past the engine's {span}-token "
                        f"span: {over}")
    shutil.rmtree(AUTOSCALE_DIR, ignore_errors=True)
    slo = autoscale_slo()

    def session(run_dir, autoscale: bool):
        drv = ServeDriver(model.cfg, model, ReplicaGroupConfig(
            n_replicas=1, backend="inline", engine=ecfg, run_dir=run_dir,
            metrics_flush_every_n_ticks=2, slo=slo))
        drv.start()
        ctl = (AutoscaleController(drv, ControllerConfig(
            policy=_ramp_policy(2), signal_window=8)) if autoscale
            else None)
        sim = run_trace(drv, events, controller=ctl, poll_every_ticks=2)
        return drv.stop(), ctl, sim

    run_dir = os.path.join(AUTOSCALE_DIR, "autoscaled")
    (res, ctl, sim), launches, wall = counted(
        lambda: session(run_dir, True), L, problems, "(c)")
    (ref, _, _), ref_launches, ref_wall = counted(
        lambda: session(os.path.join(AUTOSCALE_DIR, "fixed"), False), L,
        problems, "(c) fixed")
    ledger = read_ledger(run_dir)
    acted = [e for e in ledger if e["decision"]["action"] != "hold"]
    moves = [(e["decision"]["action"], e["decision"]["target"],
              e["outcome"].get("ok")) for e in acted]
    if moves != [("scale_up", 2, True), ("scale_down", 1, True)]:
        problems.append(f"(c) scale events {moves}")
    if not all(e["signal"].get("available") for e in acted):
        problems.append("(c) a scale event without its signal snapshot")
    if len(ledger) != ctl.decisions:
        problems.append(f"(c) {len(ledger)} ledger lines for "
                        f"{ctl.decisions} decisions")
    rids = {e.rid for e in events}
    terminal = {r for r, m in res.meta.items()
                if m["finish_reason"] in ("eos", "length", "shed")}
    if terminal != rids:
        problems.append(f"(c) rids without a terminal record: "
                        f"{sorted(rids - terminal)}")
    sheds = sorted(r for r, m in res.meta.items()
                   if m["finish_reason"] == "shed")
    lc_shed = [r for r in sheds
               if res.meta[r]["priority"] == "latency_critical"]
    untyped = [r for r in sheds if not (res.meta[r].get("reason")
                                        and res.meta[r].get(
                                            "retry_after_s", 0) > 0)]
    if lc_shed or untyped:
        problems.append(f"(c) latency-critical shed {lc_shed}, untyped "
                        f"sheds {untyped}")
    both = [to_request(e) for e in events
            if e.rid not in sheds and ref.meta.get(e.rid, {}).get(
                "finish_reason") not in (None, "shed")]
    parted = hold_streams(model, both, res.outputs,
                          {r.rid: ref.outputs[r.rid] for r in both}, "(c)",
                          problems)
    report = _cli_json(["report", run_dir])
    asc = (report.get("serving") or {}).get("autoscale") or {}
    if (asc.get("scale_ups"), asc.get("scale_downs"),
            asc.get("decisions")) != (1, 1, ctl.decisions):
        problems.append(f"(c) report's autoscale section {asc}")
    timeline = _cli_json(["timeline", run_dir])
    merged = [e for e in timeline["events"] if e["source"] == "autoscale"]
    if len(merged) != ctl.decisions:
        problems.append(f"(c) the timeline merged {len(merged)} autoscale "
                        f"events of {ctl.decisions}")
    n_tok = sum(len(v) for v in res.outputs.values())
    print(json.dumps(dict(
        phase="autoscale", layers=L, requests=len(events),
        trace=dict(seed=AUTOSCALE_SEED, **AUTOSCALE_TRACE),
        ticks=sim["ticks"], decisions=ctl.decisions,
        scale_events=[dict(now=e["now"], action=e["decision"]["action"],
                           target=e["decision"]["target"],
                           duration_s=e["duration_s"],
                           pressure=e["signal"].get("pressure"))
                      for e in acted],
        classes=_class_stats(res.meta), shed=sheds,
        shed_fraction=len(sheds) / len(events), parted=parted,
        compared_streams=len(both), new_tokens=n_tok, wall_s=wall,
        decode_tokens_per_s=n_tok / wall,
        fixed=dict(wall_s=ref_wall, shed=sorted(
            r for r, m in ref.meta.items() if m["finish_reason"] == "shed"),
            classes=_class_stats(ref.meta)),
        report_autoscale=asc, timeline_autoscale_events=len(merged),
        launches=launches, fixed_launches=ref_launches,
        phase_wall_s=time.perf_counter() - t_all)), flush=True)
    shutil.rmtree(AUTOSCALE_DIR, ignore_errors=True)
    PHASE14_S["autoscale"] = time.perf_counter() - t_all
    if problems:
        raise AssertionError("phase 14 (c): " + "; ".join(problems))
    return {k: launches[k] + ref_launches[k] for k in launches}


# ---- phase 16: the BASELINE's ResNet and BERT, the examples, the doctor -----

#: 16 (a): the flash kernels at BERT-base's attention in a training step
#: (B 32, S 128, H = Hkv = 12, hd 64, bidirectional), and at a tensor=2
#: rank's 6 heads, timed as phase 3's rows; its S 512 (`max_seq_len`)
#: twin is in FLASH_OWED
BERT_FLASH_CASES = {"bert full": (32, 128, 128, 12, 12, 64, False, 0),
                    # a tensor=2 rank's heads (12 (c)'s BERT leg)
                    "bert tp2": (32, 128, 128, 6, 6, 64, False, 0)}
#: 16 (b): BERT-base's fit: batch, sequence, steps, learning rate (the
#: JAX module's default; at 1e-4 a fit from random weights parts the two
#: lanes' grad norms by up to 31% within 8 steps)
BERT_B, BERT_S, BERT_STEPS, BERT_LR = 32, 128, 8, 2e-5
#: 16 (b): kernel lanes against reference lanes, per step: |delta loss|
#: and |delta grad_norm| / grad_norm; and the classifier logits of the
#: kernel lane against the dense (masked) path on the same weights. Each
#: is 1.5x the largest reading of sound kernels over eight weight-and-data
#: seeds (``--bert-spread 8``, PERF.md)
#: (4.01e-3, 8.62e-2 and 1.59e-2; a BERT-base from random weights takes
#: grad norms from 3 to 60 within 8 steps, and the relative gap is
#: widest where the norm is smallest)
BERT_LOSS_TOL = 6.1e-3
BERT_GNORM_RTOL = 1.3e-1
BERT_LOGIT_TOL = 2.4e-2
#: 16 (b): the first steps, which both lanes take at the seed's own
#: weights (step 0's learning rate is 0, and so is its weight decay):
#: their gaps are the kernels' alone, before AdamW's first update
#: amplifies them. Held at 1.5x these steps' largest reading over the
#: same eight seeds (``--bert-spread 8``, PERF.md: 1.46e-3 and 8.85e-3,
#: the latter again where the norm is smallest, 4.1)
BERT_EARLY = 2
BERT_EARLY_LOSS_TOL = 2.2e-3
BERT_EARLY_GNORM_RTOL = 1.33e-2
#: 16 (c): ResNet-50 (CIFAR stem) batch, steps and learning rate (at 0.1
#: GroupNorm ResNet-50 from its initialisation diverges within 8 steps)
RESNET_B, RESNET_STEPS, RESNET_LR = 128, 8, 0.01
#: 16 (d): the in-process examples through their ``main`` at their smoke
#: sizes on the card, and the line each must end with
EXAMPLES16 = (("mnist_dp_example", ["--smoke-test"], "final val accuracy: "),
              ("cifar_resnet_example", ["--smoke-test", "--prefetch"],
               "val_acc="),
              ("bert_finetune_example", ["--smoke-test"], "val_acc="))
#: where (d)'s examples write (git-ignored; removed after)
EXAMPLES16_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "rlt_logs", "chip_smoke_examples")


def bert_inputs(seed: int):
    """BERT-base at full width (12 layers, dim 768, 12 heads, vocab
    30522), f32 masters, bf16 compute, no dropout; and ``BERT_STEPS``
    batches of `synthetic_sst` rows (seeded) with no ``attention_mask``,
    so attention takes the flash kernels."""
    from ray_lightning_tpu_torch.examples.bert_finetune_example import (
        synthetic_sst)
    from ray_lightning_tpu_torch.models.bert import BertConfig

    cfg = BertConfig.base(max_seq_len=BERT_S, dropout=0.0)
    data = synthetic_sst(BERT_STEPS * BERT_B, BERT_S, cfg.vocab_size, seed)
    del data["attention_mask"]
    return cfg, data


def bert_fit(cfg, data, seed: int, inspect=None):
    """One `Trainer.fit` of `BertClassifierModule` under `SingleDevice`
    (AdamW, warmup 2 of ``BERT_STEPS``; weights from ``seed``): the
    StepProbe, the fit's wall, its peak."""
    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.bert import BertClassifierModule
    from ray_lightning_tpu_torch.parallel.strategy import SingleDevice

    probe = StepProbe()
    module = BertClassifierModule(cfg, num_classes=2, lr=BERT_LR,
                                  warmup_steps=2, total_steps=BERT_STEPS)
    trainer = Trainer(strategy=SingleDevice(), max_steps=BERT_STEPS,
                      log_every_n_steps=1, enable_checkpointing=False,
                      enable_progress_bar=False, seed=seed,
                      callbacks=[probe.callback])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    probe.t.append(t0)
    trainer.fit(module, DataLoader(data, batch_size=BERT_B))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if trainer.global_step != BERT_STEPS:
        raise AssertionError(f"BERT fit ran {trainer.global_step} steps")
    peak = torch.cuda.max_memory_allocated()
    if inspect is not None:
        inspect(module)
    del trainer, module
    gc.collect()
    torch.cuda.empty_cache()
    return probe, wall, peak


def bert_lanes(seed: int):
    """16 (b)'s readings at ``seed``: the kernel-lane fit (its launches),
    the same fit under `dispatch.force_reference` (which must launch no
    kernel), and on the kernel lane's trained weights one batch's logits
    without a mask (the flash kernels) and with an all-ones mask (the
    dense path; its flash launches)."""
    from ray_lightning_tpu_torch.ops import dispatch

    cfg, data = bert_inputs(seed)
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    logits = {}

    def inspect(module):
        batch = {k: torch.from_numpy(v[:BERT_B]).cuda()
                 for k, v in data.items()}
        with torch.no_grad():
            logits["flash"] = module._forward(module.params, batch).float()
            before = {k.__name__: k.launches for k in kernels}
            masked = dict(batch, attention_mask=torch.ones_like(
                batch["input_ids"]))
            logits["dense"] = module._forward(module.params, masked).float()
            logits["dense_launches"] = {
                k.__name__: k.launches - before[k.__name__]
                for k in kernels if k.launches != before[k.__name__]}

    probe, wall, peak = bert_fit(cfg, data, seed, inspect)
    launches = {k.__name__: k.launches for k in kernels}
    for k in kernels:
        k.launches = 0
    with dispatch.force_reference():
        ref, ref_wall, ref_peak = bert_fit(cfg, data, seed)
    ref_launched = {k.__name__: k.launches for k in kernels if k.launches}
    gaps, problems = compare_bert(probe.rows, ref.rows)
    d_logit = (logits["flash"] - logits["dense"]).abs().max().item()
    return dict(cfg=cfg, probe=probe, wall=wall, peak=peak, ref=ref,
                ref_wall=ref_wall, ref_peak=ref_peak, launches=launches,
                ref_launched=ref_launched, gaps=gaps, problems=problems,
                d_logit=d_logit, dense_launches=logits["dense_launches"])


def compare_bert(rows, ref_rows):
    """16 (b)'s kernel lane against its reference lane, per step: {name:
    (gap, limit)} of |delta loss| and |delta grad_norm| / grad_norm over
    the first ``BERT_EARLY`` steps and over the whole fit, and the
    problems (a gap over its limit, or a lane cut short)."""
    def gap(col, n):
        pairs = list(zip(rows, ref_rows))[:n]
        if col == 0:
            return max(abs(a[0] - b[0]) for a, b in pairs)
        return max(abs(a[1] - b[1]) / b[1] for a, b in pairs)

    gaps = {"loss_early": (gap(0, BERT_EARLY), BERT_EARLY_LOSS_TOL),
            "grad_norm_rel_early": (gap(1, BERT_EARLY),
                                    BERT_EARLY_GNORM_RTOL),
            "loss": (gap(0, len(rows)), BERT_LOSS_TOL),
            "grad_norm_rel": (gap(1, len(rows)), BERT_GNORM_RTOL)}
    problems = [f"{name} differs by {got:.4g} > {tol}"
                for name, (got, tol) in gaps.items() if not got <= tol]
    if len(rows) != len(ref_rows):
        problems.append(f"{len(rows)} steps against {len(ref_rows)}")
    return gaps, problems


def bert_spread(seeds):
    """16 (b)'s lane comparison at each of ``seeds`` (weights and rows):
    the spread BERT_LOSS_TOL, BERT_GNORM_RTOL and BERT_LOGIT_TOL are set
    from."""
    readings = []
    for seed in seeds:
        r = bert_lanes(seed)
        row = dict(phase="bert_spread", seed=seed,
                   **{k: v[0] for k, v in r["gaps"].items()},
                   logits=r["d_logit"],
                   losses=[x[0] for x in r["probe"].rows],
                   ref_losses=[x[0] for x in r["ref"].rows],
                   grad_norms=[x[1] for x in r["probe"].rows],
                   ref_grad_norms=[x[1] for x in r["ref"].rows])
        print(json.dumps(row), flush=True)
        readings.append(row)
    print(json.dumps(dict(phase="bert_spread_summary", seeds=list(seeds),
                          **{k: max(r[k] for r in readings) for k in (
                              *r["gaps"], "logits")})), flush=True)


def bert_phase(seed: int, problems: list) -> dict:
    """16 (b): BERT-base's kernel lane (12 flash forwards, 12 dK/dV and
    12 dQ a step and a warm-up) against its reference lane within the
    BERT limits, the masked batch on the dense path; returns the kernel
    lane's launches and its logits forward's."""
    import numpy as np

    r = bert_lanes(seed)
    L, n = r["cfg"].n_layers, BERT_STEPS + 1
    want = {k.__name__: 0 for k in all_kernels()}
    # the fit's steps and warm-up, then the unmasked logits forward
    want.update(flash_fwd_kernel=L * n + L, flash_bwd_dkv_kernel=L * n,
                flash_bwd_dq_kernel=L * n)
    if r["launches"] != want:
        problems.append(f"(b) launches {r['launches']} != {want}")
    if r["ref_launched"]:
        problems.append(f"(b) reference lane launched {r['ref_launched']}")
    if r["dense_launches"]:
        problems.append(f"(b) the masked batch launched "
                        f"{r['dense_launches']}")
    losses = [x[0] for x in r["probe"].rows]
    if not all(map(np.isfinite, losses)):
        problems.append(f"(b) losses {losses}")
    problems += [f"(b) {p}" for p in r["problems"]]
    if not r["d_logit"] <= BERT_LOGIT_TOL:
        problems.append(f"(b) logits, flash vs dense, differ by "
                        f"{r['d_logit']:.4g} > {BERT_LOGIT_TOL}")
    # 12 (c)'s tensor=2 lane against this kernel lane, step for step
    tp_gaps = None
    if not TP_BERT:
        problems.append("(b) 12 (c)'s BERT tensor lane left no rows")
    else:
        tp_gaps, tp_problems = compare_bert(
            TP_BERT["rows"], r["probe"].rows[:len(TP_BERT["rows"])])
        problems += [f"(b) tensor lane: {p}" for p in tp_problems]
    t = r["probe"].t
    step_s = statistics.median(b - a for a, b in zip(t[2:], t[3:]))
    rt = r["ref"].t
    ref_step_s = statistics.median(b - a for a, b in zip(rt[2:], rt[3:]))
    print(json.dumps(dict(
        phase="bert", layers=L, dim=r["cfg"].dim, heads=r["cfg"].n_heads,
        vocab=r["cfg"].vocab_size, batch=BERT_B, seq=BERT_S,
        steps=BERT_STEPS, losses=losses,
        grad_norms=[x[1] for x in r["probe"].rows],
        ref_losses=[x[0] for x in r["ref"].rows],
        gaps=r["gaps"], logits_max_abs_diff=r["d_logit"],
        logit_tol=BERT_LOGIT_TOL,
        step_ms_p50=step_s * 1e3, tokens_per_s=BERT_B * BERT_S / step_s,
        peak_gib=r["peak"] / 2**30, fit_wall_s=r["wall"],
        ref_step_ms_p50=ref_step_s * 1e3, ref_peak_gib=r["ref_peak"] / 2**30,
        launches=r["launches"], masked_launches=r["dense_launches"],
        tensor_lane=dict(mesh={"tensor": TP_RANKS},
                         losses=[x[0] for x in TP_BERT.get("rows", [])],
                         grad_norms=[x[1] for x in TP_BERT.get("rows", [])],
                         gaps=tp_gaps))), flush=True)
    return r["launches"]


def resnet_phase(seed: int, problems: list) -> dict:
    """16 (c): ResNet-50 with the CIFAR stem (`ResNetModule("resnet50")`,
    bf16, GroupNorm, nesterov SGD with the clip), ``RESNET_STEPS`` steps
    at ``RESNET_B`` on seeded 32x32x3 images: a finite, falling loss and
    no launch of the seven kernels (convolutions and GroupNorm are
    library calls, as in JAX)."""
    import numpy as np

    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.resnet import ResNetModule
    from ray_lightning_tpu_torch.parallel.strategy import SingleDevice

    rng = np.random.default_rng(seed)
    n = RESNET_B * RESNET_STEPS
    y = rng.integers(0, 10, n).astype(np.int32)
    base = rng.standard_normal((10, 1, 1, 3)).astype(np.float32) * 3
    x = base[y] + 0.3 * rng.standard_normal((n, 32, 32, 3)).astype(
        np.float32)
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    probe = StepProbe()
    module = ResNetModule("resnet50", num_classes=10, lr=RESNET_LR,
                          total_steps=RESNET_STEPS)
    trainer = Trainer(strategy=SingleDevice(), max_steps=RESNET_STEPS,
                      log_every_n_steps=1, enable_checkpointing=False,
                      enable_progress_bar=False, seed=seed,
                      callbacks=[probe.callback])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    probe.t.append(t0)
    trainer.fit(module, DataLoader({"x": x, "y": y}, batch_size=RESNET_B))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_params = module.num_params()
    del trainer, module
    launches = {k.__name__: k.launches for k in kernels}
    losses = [r[0] for r in probe.rows]
    if not (len(losses) == RESNET_STEPS and all(map(np.isfinite, losses))
            and losses[-1] < losses[0]):
        problems.append(f"(c) ResNet-50 losses {losses}")
    if any(launches.values()):
        problems.append(f"(c) ResNet-50 launched {launches}")
    step_s = statistics.median(b - a for a, b in zip(probe.t[2:],
                                                     probe.t[3:]))
    print(json.dumps(dict(
        phase="resnet", variant="resnet50", cifar_stem=True,
        params=n_params, batch=RESNET_B, steps=RESNET_STEPS, losses=losses,
        grad_norms=[r[1] for r in probe.rows], step_ms_p50=step_s * 1e3,
        images_per_s=RESNET_B / step_s,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30, fit_wall_s=wall,
        launches=launches)), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def examples_phase(problems: list) -> dict:
    """16 (d): each of EXAMPLES16 through its ``main`` with ``--device
    cuda`` (the default) at its smoke size, in a scratch directory: exit
    0 and its JAX twin's final line; the CIFAR one on the native batcher.
    Returns the launches."""
    import contextlib
    import importlib
    import io

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    here = os.getcwd()
    rows = []
    for name, argv, last in EXAMPLES16:
        ex = importlib.import_module(f"ray_lightning_tpu_torch.examples."
                                     f"{name}")
        shutil.rmtree(EXAMPLES16_DIR, ignore_errors=True)
        os.makedirs(EXAMPLES16_DIR)
        out = io.StringIO()
        t0 = time.perf_counter()
        try:
            os.chdir(EXAMPLES16_DIR)
            with contextlib.redirect_stdout(out):
                rc = ex.main(argv)
            torch.cuda.synchronize()
        finally:
            os.chdir(here)
        lines = out.getvalue().strip().splitlines()
        row = dict(example=name, argv=argv, rc=rc,
                   last=lines[-1] if lines else None,
                   wall_s=time.perf_counter() - t0)
        if name == "cifar_resnet_example":
            row["summary"] = json.loads(lines[-2])
            if not row["summary"]["native_batches"]:
                problems.append(f"(e) the native batcher did not make "
                                f"{name}'s batches: {row}")
        if rc != 0 or not (lines and lines[-1].startswith(last)):
            problems.append(f"(d) {name}: rc {rc}, last line {row['last']}")
        rows.append(row)
    shutil.rmtree(EXAMPLES16_DIR, ignore_errors=True)
    launches = {k.__name__: k.launches for k in kernels}
    print(json.dumps(dict(phase="examples", rows=rows, launches=launches)),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def doctor_check(problems: list) -> None:
    """16 (e): ``python -m ray_lightning_tpu_torch --json`` (its ``main``,
    in this process) names the card and its memory."""
    import contextlib
    import io

    from ray_lightning_tpu_torch.__main__ import main as cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli(["--json"])
    info = json.loads(out.getvalue().strip().splitlines()[-1])
    dev = (info.get("devices") or [{}])[0]
    total = torch.cuda.get_device_properties(0).total_memory
    if not (rc == 0 and info.get("device_count") == torch.cuda.device_count()
            and dev.get("name") == torch.cuda.get_device_name(0)
            and dev.get("total_memory_bytes") == total
            and dev.get("capability") == "9.0"):
        problems.append(f"(e) doctor: rc {rc}, {info}")
    print(json.dumps(dict(phase="doctor", rc=rc, info=info)), flush=True)


def baseline_phase(seed: int, gen: torch.Generator):
    """Phase 16: (a) the flash kernels at BERT's shape, (b) BERT-base,
    (c) ResNet-50, (d) the in-process examples, (e) the doctor and the
    native batcher. Returns (a)'s kernel rows, the launches of (b)-(d)
    and each part's seconds."""
    problems, walls = [], {}
    t0 = time.perf_counter()
    rows = check_flash(gen, BERT_FLASH_CASES)
    LEGS_S["bert_tp2_flash"] = next(r["case_s"] for r in rows
                                    if r["shape"]["case"] == "bert tp2")
    walls["a"] = time.perf_counter() - t0
    free_card("bert")
    total = bert_phase(seed, problems)
    walls["b"] = time.perf_counter() - t0 - walls["a"]
    for k, v in resnet_phase(seed, problems).items():
        total[k] += v
    walls["c"] = time.perf_counter() - t0 - walls["a"] - walls["b"]
    for k, v in examples_phase(problems).items():
        total[k] += v
    walls["d"] = time.perf_counter() - t0 - sum(walls.values())
    doctor_check(problems)
    walls["e"] = time.perf_counter() - t0 - sum(walls.values())
    print(json.dumps(dict(phase="baseline_timing", wall_s=walls)),
          flush=True)
    if problems:
        raise AssertionError("phase 16, the BASELINE's models and the "
                             "examples: " + "; ".join(problems))
    return rows, total, walls


# ---- phase 17: the sequence, pipeline and expert axes ---------------------
#
# Two gloo ranks share the card (NCCL refuses two ranks on one card), as
# in phases 12 (c), 13 (c) and 14 (a). A two-rank probe first says which
# of gloo's c10d calls carry CUDA tensors; then one two-rank group runs
# (b) ring and Ulysses attention at Llama-3-8B's width, (c) phase 5's fit
# under ShardedMesh(seq=2), (d) under ShardedMesh(pipe=2) and (e) the MoE
# classifier under ShardedMesh(expert=2) against its one-rank fit.

AXES_RANKS = 2
AXES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "rlt_logs", "chip_smoke_axes")
AXES_TIMEOUT_S = 420
PROBE_TIMEOUT_S = 60
#: phase 17's processes start during phase 16 and import there (and pay
#: their first flash call); this file appearing lets them go on to the
#: process group
AXES_GATE = os.path.join(AXES_DIR, "go")
#: (b): Llama-3-8B's attention at its max_seq_len, two ranks of 4096
RING_B, RING_S = 1, 8192
#: (c)-(d): phase 5's fit, this many steps
AXES_STEPS = 2
#: (e): the MoE classifier's data (the JAX test's), global batch, steps,
#: and how far its expert-parallel rows may sit from its one-rank rows
#: (f32 both: the reductions' order alone differs)
MOE_ROWS, MOE_BATCH, MOE_STEPS, MOE_RTOL = 256, 64, 4, 1e-4


def probe_worker(rank: int, world: int, port: int, out: str) -> None:
    """One rank of 17 (a): which c10d calls of a gloo group carry CUDA
    tensors between two processes on the card. Each answer is written to
    ``out`` as it comes; `batch_isend_irecv` goes last, since gloo's
    point-to-point may hand a device pointer to its transport and kill
    the process."""
    import datetime

    import torch.distributed as dist

    await_gate(AXES_GATE)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=30))
    res = {}

    def record(key, value):
        res[key] = value
        with open(out, "w") as f:
            json.dump(res, f)

    dev = torch.device("cuda")
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    x = torch.arange(8, dtype=torch.float32, device=dev) + 100 * rank
    y = torch.empty_like(x)
    dist.all_to_all_single(y, x)
    want = torch.cat([torch.arange(4) + 4 * rank + 100 * s
                      for s in range(world)]).float()
    record("all_to_all_even", bool(torch.equal(y.cpu(), want)))
    # neighbour-only splits: the ring's rotation on gloo's all-to-all
    ins, outs = [0] * world, [0] * world
    ins[nxt], outs[prv] = 5, 5
    x5 = torch.full((5,), float(rank), device=dev)
    y5 = torch.empty(5, device=dev)
    dist.all_to_all_single(y5, x5, outs, ins)
    record("all_to_all_neighbour",
           bool(torch.equal(y5.cpu(), torch.full((5,), float(prv)))))
    record("batch_isend_irecv", "started")
    z = torch.empty(5, device=dev)
    for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x5, nxt),
                                     dist.P2POp(dist.irecv, z, prv)]):
        w.wait()
    record("batch_isend_irecv",
           bool(torch.equal(z.cpu(), torch.full((5,), float(prv)))))
    dist.destroy_process_group()


def ring_lane(seed: int) -> dict:
    """17 (b) on this rank: ring and Ulysses attention over the two-rank
    ``seq`` axis at B 1, S 8192 (4096 a rank), H 32, Hkv 8, hd 128,
    causal, bf16. O, dQ, dK and dV of the ring's kernel lane against the
    same ring through the kernels' plain versions (its lane under
    `force_reference`; held as phase 17's flash rows are, `truth_ratio`
    with an f64 reference) and against the one-device flash kernels on
    the whole sequence;
    Ulysses' against the latter; forward and backward ms by CUDA events
    (medians of 3), the host seconds a rank waited for its rotations, and
    the wall seconds of each part of the lane (``parts_s``)."""
    import contextlib

    from torch.distributed.device_mesh import init_device_mesh

    from ray_lightning_tpu_torch.ops import dispatch
    from ray_lightning_tpu_torch.ops.kernels import flash as F
    from ray_lightning_tpu_torch.ops.ring_attention import ring_attention
    from ray_lightning_tpu_torch.ops.ulysses import ulysses_attention
    from ray_lightning_tpu_torch.parallel import comm

    parts, t_part = {}, [time.perf_counter()]

    def part(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    mesh = init_device_mesh("cuda", (AXES_RANKS,), mesh_dim_names=("seq",))
    r, n = mesh["seq"].get_local_rank(), AXES_RANKS
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                device="cuda").to(torch.bfloat16)
    q, k, v = rn(RING_B, RING_S, TH, HD), rn(RING_B, RING_S, THKV, HD), \
        rn(RING_B, RING_S, THKV, HD)
    do = rn(RING_B, RING_S, TH, HD)
    cut = RING_S // n
    part("setup")

    def chunk(t):
        return t[:, r * cut:(r + 1) * cut].contiguous()

    def run(fn, reference=False, timing=None):
        qs, ks, vs = (chunk(t).requires_grad_() for t in (q, k, v))
        ctx = (dispatch.force_reference() if reference
               else contextlib.nullcontext())
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        with ctx:
            ev[0].record()
            o = fn(qs, ks, vs, mesh, causal=True)
            ev[1].record()
            o.backward(chunk(do))
            ev[2].record()
        torch.cuda.synchronize()
        if timing is not None:
            timing.append((ev[0].elapsed_time(ev[1]),
                           ev[1].elapsed_time(ev[2])))
        return [t.detach() for t in (o, qs.grad, ks.grad, vs.grad)]

    # the one-device kernels on the whole sequence, this rank's rows
    qf, kf, vf = (t.clone().requires_grad_() for t in (q, k, v))
    of = F.flash_attention_kernel(qf, kf, vf, causal=True)
    part("one_device_fwd")
    of.backward(do)
    whole = [chunk(t.detach()) for t in (of, qf.grad, kf.grad, vf.grad)]
    del qf, kf, vf, of
    part("one_device_bwd")
    names = ("o", "dq", "dk", "dv")
    # the f64 reference, this rank's rows: the plain lane is held as
    # phase 17's flash rows are (`truth_ratio`, TRUTH_HELD)
    ref = {n: chunk(t) for n, t in f64_attention(q, k, v, do, True).items()}
    torch.cuda.empty_cache()
    part("f64")
    out = {}
    for kind, fn in (("ring", ring_attention),
                     ("ulysses", ulysses_attention)):
        kernels = all_kernels()
        for kk in kernels:
            kk.launches = 0
        got = run(fn)
        launches = {kk.__name__: kk.launches for kk in kernels}
        part(kind)
        shares = {}
        against = {"whole": whole}
        if kind == "ring":
            against["plain"] = run(fn, reference=True)
            part("ring_plain")
        for lane, want in against.items():
            for name, a, b in zip(names, got, want):
                dims = (-1,) if name == "o" else SLAB
                err, share = (truth_ratio(a, b, ref[name], dims)
                              if lane == "plain"
                              else tolerance_ratio(a, b, dims))
                shares[f"{name} vs {lane}"] = (err, share)
        del against
        part(f"{kind}_shares")
        times = []
        for _ in range(3):
            for key in comm.SHIFT_STATS:
                comm.SHIFT_STATS[key] = 0
            run(fn, timing=times)
        stats = dict(comm.SHIFT_STATS)
        part(f"{kind}_timed")
        fwd = statistics.median(t[0] for t in times)
        bwd = statistics.median(t[1] for t in times)
        out[kind] = dict(shares=shares, launches=launches, fwd_ms=fwd,
                         bwd_ms=bwd, shifts=stats["calls"],
                         shift_bytes=stats["bytes"],
                         wait_ms=stats["wait_s"] * 1e3,
                         wait_share=stats["wait_s"] * 1e3 / (fwd + bwd))
        del got
        gc.collect()
        torch.cuda.empty_cache()
    out["parts_s"] = parts
    return out


def axes_fit(seed: int, strategy, cfg_kw: dict) -> dict:
    """(c) and (d) on this rank: phase 5's fit for AXES_STEPS steps under
    ``strategy`` with ``cfg_kw`` on the config: its rows, step time, the
    seconds its gradients' reductions took, its peak and launches."""
    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.core.trainer import Trainer

    cfg, tokens = train_inputs(seed)
    cfg = dataclasses.replace(cfg, **cfg_kw)
    probe = StepProbe()
    reduce_s = []
    finish = strategy.finish_grads

    def timed_finish(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        finish(*a, **kw)
        torch.cuda.synchronize()
        if kw.get("reduce", True):
            reduce_s.append(time.perf_counter() - t0)

    strategy.finish_grads = timed_finish

    class Zero(Callback):
        def on_fit_start(self, trainer, module):
            for kk in all_kernels():
                kk.launches = 0

    module = LlamaModule(cfg, lr=TRAIN_LR, warmup_steps=2,
                         total_steps=TRAIN_STEPS)
    trainer = Trainer(strategy=strategy, max_steps=AXES_STEPS,
                      log_every_n_steps=1, enable_checkpointing=False,
                      enable_progress_bar=False, seed=seed,
                      callbacks=[Zero(), probe.callback])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    probe.t.append(t0)
    # every rank reads every row: seq and pipe ranks share the batch
    trainer.fit(module, DataLoader({"tokens": tokens[:AXES_STEPS * TB]},
                                   batch_size=TB))
    torch.cuda.synchronize()
    rec = dict(rows=probe.rows, fit_wall_s=time.perf_counter() - t0,
               step_s=[b - a for a, b in zip(probe.t[1:], probe.t[2:])],
               first_step_s=probe.first_step_s(), reduce_s=reduce_s,
               peak=torch.cuda.max_memory_allocated(),
               mesh=trainer.strategy.mesh_shape,
               init_path=trainer.init_path,
               launches={kk.__name__: kk.launches for kk in all_kernels()},
               params=sum(p.numel() for p in module.params.values()))
    del trainer, module
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def moe_data(seed: int):
    """(e)'s rows: the JAX MoE test's separable classes, 32 features."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y = rng.integers(0, 4, MOE_ROWS).astype(np.int64)
    centers = rng.standard_normal((4, 32)).astype(np.float32) * 3
    x = centers[y] + rng.standard_normal((MOE_ROWS, 32)).astype(np.float32)
    return {"x": x, "y": y}


def moe_lane(seed: int, rank: int) -> dict:
    """(e) on this rank: `MoEClassifierModule` at its JAX defaults under
    ``ShardedMesh(expert=2)`` (each rank two of the four experts and half
    of each global batch), then under ``ShardedMesh(tensor=2)`` (each rank
    half of every expert's gate and up columns and all of each global
    batch), then on rank 0 the same module's one-rank fit over the same
    global batches."""
    import numpy as np

    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.moe import MoEClassifierModule
    from ray_lightning_tpu_torch.parallel.strategy import (
        ShardedMesh,
        SingleDevice,
    )

    data = moe_data(seed)
    half = MOE_ROWS // AXES_RANKS
    per = MOE_BATCH // AXES_RANKS

    def fit(strategy, loader):
        probe = StepProbe()
        module = MoEClassifierModule(in_features=32)
        trainer = Trainer(strategy=strategy, max_steps=MOE_STEPS,
                          log_every_n_steps=1, enable_checkpointing=False,
                          enable_progress_bar=False, seed=seed,
                          callbacks=[probe.callback])
        trainer.fit(module, loader)
        w = dict(trainer.strategy.unwrap(module.model).named_parameters())[
            "moe.w_gate_up"]
        return probe.rows, tuple((w.to_local() if hasattr(w, "to_local")
                                  else w).shape)

    strategy = ShardedMesh(expert=AXES_RANKS)
    mine = {k: v[rank * half:(rank + 1) * half] for k, v in data.items()}
    rows, local = fit(strategy, DataLoader(mine, batch_size=per))
    out = dict(rows=rows, local_experts=local[0])
    # the global batches in the expert lane's order, whole
    order = np.concatenate([
        np.r_[s * per:(s + 1) * per] + r * half
        for s in range(MOE_STEPS) for r in range(AXES_RANKS)])
    one = {k: v[order] for k, v in data.items()}
    t0 = time.perf_counter()
    out["tp_rows"], local = fit(ShardedMesh(tensor=AXES_RANKS),
                                DataLoader(one, batch_size=MOE_BATCH))
    out["tp_s"] = time.perf_counter() - t0
    out["tp_local_columns"] = local[2]
    if rank == 0:
        out["one_rank_rows"], _ = fit(SingleDevice(),
                                      DataLoader(one, batch_size=MOE_BATCH))
    return out


def warm_process() -> dict:
    """A fresh process's one-time costs of the card, paid before phase
    17's gate opens (while the phase before runs): the CUDA context, the
    flash kernels' libraries, one small flash forward and backward.
    Their launches are not counted (every lane zeroes the counts).
    Returns each part's seconds."""
    from ray_lightning_tpu_torch.ops import build
    from ray_lightning_tpu_torch.ops.kernels import flash as F

    parts, t0 = {}, time.perf_counter()

    def part(name):
        nonlocal t0
        torch.cuda.synchronize()
        parts[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    x = torch.randn(1, 128, 2, HD, device="cuda").to(torch.bfloat16)
    part("cuda")
    for name in ("flash_fwd", "flash_bwd"):
        build.load(name)
    part("load")
    q, k, v = (x.clone().requires_grad_() for _ in range(3))
    o = F.flash_attention_kernel(q, k, v, causal=True)
    part("fwd")
    o.backward(x)
    part("bwd")
    return parts


def axes_worker(rank: int, world: int, port: int, seed: int,
                out: str) -> None:
    """One rank of 17 (b)-(e) in a gloo group on the visible card; writes
    each lane's record to ``out``."""
    import torch.distributed as dist

    from ray_lightning_tpu_torch.parallel.strategy import ShardedMesh

    warm = dict(imports=warm_imports(), **warm_process())
    await_gate(AXES_GATE)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    rec = {"rank": rank, "backend": dist.get_backend(), "warm_s": warm}
    t0 = time.perf_counter()
    rec["ring"] = ring_lane(seed)
    rec["ring_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["seq_fit"] = axes_fit(seed, ShardedMesh(seq=world),
                              dict(seq_parallel=True))
    rec["seq_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["pipe_fit"] = axes_fit(seed, ShardedMesh(pipe=world),
                               dict(pipeline_microbatches=2))
    rec["pipe_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["moe"] = moe_lane(seed, rank)
    rec["moe_s"] = time.perf_counter() - t0
    with open(out, "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def axes_start(seed: int) -> tuple:
    """Start phase 17's processes, the probe's and the lanes', which
    import and then wait for `axes_phase` to open their gate."""
    shutil.rmtree(AXES_DIR, ignore_errors=True)
    os.makedirs(AXES_DIR)
    return (_spawn("probe_worker", "", "probe", PROBE_TIMEOUT_S, AXES_DIR,
                   AXES_RANKS),
            _spawn("axes_worker", f"{seed}, ", "axes", AXES_TIMEOUT_S,
                   AXES_DIR, AXES_RANKS))


def axes_phase(ref_rows, spawned) -> dict:
    """Phase 17 on the processes `axes_start` started: the probe (a)
    beside the lanes (b)-(e) of one two-rank gloo group on the card; (c)
    and (d) within the train limits of phase 5's rows, (b) within the
    flash tolerances, (e) within MOE_RTOL of its one-rank fit. Returns
    the kernels' launches, both ranks together."""
    problems = []
    probe, lanes = spawned
    free_card("axes")
    t0 = open_gate(AXES_GATE)
    prc, pres, ptails = _reap(probe, t0)
    answers = {}
    for key in ("all_to_all_even", "all_to_all_neighbour",
                "batch_isend_irecv"):
        vals = [p.get(key) if p else None for p in pres]
        answers[key] = (vals[0] if all(v is True for v in vals)
                        or all(v is False for v in vals)
                        else f"no ({vals}, rc {prc})")
    print(json.dumps(dict(phase="axes_probe", backend="gloo",
                          tensors="cuda", carries=answers,
                          shift_route_under_gloo_cuda="all_to_all",
                          wall_s=time.perf_counter() - t0)), flush=True)
    if answers["all_to_all_neighbour"] is not True:
        problems.append(f"gloo's all_to_all_single does not carry CUDA "
                        f"tensors to a neighbour: {answers}; {ptails}")
    rc, ranks, tails = _reap(lanes, t0)
    wall = time.perf_counter() - t0
    total = {k.__name__: 0 for k in all_kernels()}
    if any(rc) or not all(ranks):
        problems.append(f"axes ranks failed (rc {rc}): " + " | ".join(tails))
        raise AssertionError("phase 17: " + "; ".join(problems))
    for r in ranks:
        for lane in ("ring", "ulysses"):
            bad = {k: v for k, v in r["ring"][lane]["shares"].items()
                   if not v[1] <= 1.0}
            if bad:
                problems.append(f"17 (b) rank {r['rank']} {lane}: out of "
                                f"tolerance {bad}")
            for k, v in r["ring"][lane]["launches"].items():
                total[k] += v
        # the ring: rank r's causal forward runs r + 1 visible blocks
        want_fwd = r["rank"] + 1
        got = r["ring"]["ring"]["launches"]
        if (got["flash_fwd_kernel"], got["flash_bwd_dkv_kernel"],
                got["flash_bwd_dq_kernel"]) != (want_fwd,) * 3:
            problems.append(f"17 (b) rank {r['rank']} ring launches {got}")
        for lane in ("seq_fit", "pipe_fit"):
            fit = r[lane]
            d_loss, d_gn, rel = compare_train(fit["rows"],
                                              ref_rows[:AXES_STEPS])
            fit.update(loss_max_abs_diff=d_loss,
                       grad_norm_max_rel_diff=d_gn)
            problems.extend(f"17 {lane} rank {r['rank']} against phase 5: "
                            f"{p}" for p in rel)
            if fit["rows"] != ranks[0][lane]["rows"]:
                problems.append(f"17 {lane}: rank {r['rank']}'s rows differ "
                                "from rank 0's")
            for k, v in fit["launches"].items():
                total[k] += v
        if r["backend"] != "gloo":
            problems.append(f"17 rank {r['rank']}: {r['backend']}")
    moe = ranks[0]["moe"]
    for r in ranks:
        if r["moe"]["rows"] != moe["rows"] or r["moe"]["local_experts"] != 2:
            problems.append(f"17 (e) rank {r['rank']}: rows "
                            f"{r['moe']['rows']}, "
                            f"{r['moe']['local_experts']} experts")
    def rel(rows):
        return max(abs(a - b) / abs(b) for x, y in zip(
            rows, moe["one_rank_rows"]) for a, b in zip(x, y))

    moe_rel, tp_rel = rel(moe["rows"]), rel(moe["tp_rows"])
    if not moe_rel <= MOE_RTOL:
        problems.append(f"17 (e): expert-parallel rows {moe['rows']} vs "
                        f"one-rank {moe['one_rank_rows']}")
    if not tp_rel <= MOE_RTOL or len(moe["tp_rows"]) != MOE_STEPS:
        problems.append(f"17 (e): tensor-parallel rows {moe['tp_rows']} vs "
                        f"one-rank {moe['one_rank_rows']}")
    for r in ranks:
        # 128 hidden columns a rank: half of gate and half of up
        if (r["moe"]["tp_rows"] != moe["tp_rows"]
                or r["moe"]["tp_local_columns"] != 128):
            problems.append(f"17 (e) tensor rank {r['rank']}: rows "
                            f"{r['moe']['tp_rows']}, "
                            f"{r['moe']['tp_local_columns']} columns")
    LEGS_S["moe_tp"] = max(r["moe"]["tp_s"] for r in ranks)
    print(json.dumps(dict(
        phase="axes", ranks=AXES_RANKS, backend="gloo",
        lane="correctness (every collective crosses the host)",
        ring={r["rank"]: r["ring"] for r in ranks},
        ring_shape=dict(B=RING_B, S=RING_S, H=TH, Hkv=THKV, hd=HD,
                        causal=True, a_rank=RING_S // AXES_RANKS),
        seq_fit={r["rank"]: r["seq_fit"] for r in ranks},
        pipe_fit={r["rank"]: r["pipe_fit"] for r in ranks},
        moe=dict(rows=moe["rows"], one_rank_rows=moe["one_rank_rows"],
                 max_rel_diff=moe_rel, rtol=MOE_RTOL,
                 tensor_rows=moe["tp_rows"], tensor_max_rel_diff=tp_rel,
                 tensor_s=[r["moe"]["tp_s"] for r in ranks]),
        loss_tol=TRAIN_LOSS_TOL, grad_norm_rtol=TRAIN_GNORM_RTOL,
        lane_s={k: [r[f"{k}_s"] for r in ranks]
                for k in ("ring", "seq", "pipe", "moe")},
        warm_s={r["rank"]: r["warm_s"] for r in ranks},
        call_wall_s=wall)), flush=True)
    if problems:
        raise AssertionError("phase 17: " + "; ".join(problems))
    shutil.rmtree(AXES_DIR, ignore_errors=True)
    return total


# ---- phase 18: the analysis layer ---------------------------------------
#
# The lock-order watcher is armed from the script's first lines (above),
# so every `san_lock` of phases 1-17 in this process is the watcher's.

#: (c): armed acquire/release pairs timed against a plain lock's
LOCK_PAIRS = 100_000


def _held_too_long(f) -> dict:
    """An RLT705 finding of the watcher as (lock, seconds held, site)."""
    import re

    held = re.search(r"held for ([0-9.]+)s", f.message)
    site = re.search(r"acquired at (.+)$", f.message)
    return dict(lock=f.symbol, held_s=float(held.group(1)) if held else None,
                site=site.group(1) if site else None)


def analysis_phase() -> None:
    """Phase 18: (a) the verdict of the lock-order watcher over this
    process's whole run: no lock-order cycle, or the run fails; the
    order graph's locks and edges printed, and every lock held past
    RLT_LOCKWATCH_MAX_HOLD_S with its seconds and site (a reading); (b)
    after that verdict, two fresh lock names taken in opposite nestings
    on this thread must be reported as a cycle naming both (the arming
    held); (c) the host microseconds of an armed acquire/release pair
    against a plain lock's, LOCK_PAIRS pairs each; (d) ``python -m
    ray_lightning_tpu_torch lint`` in this process over the port package
    (threadcheck on, the default gate), on a machine with no JAX: it
    must exit 0; its seconds and counts by severity."""
    import contextlib
    import io
    import threading

    from ray_lightning_tpu_torch.__main__ import main as cli
    from ray_lightning_tpu_torch.analysis import lockwatch

    problems, parts = [], {}
    t0 = time.perf_counter()
    # (a) the verdict over phases 1-17
    cycles = lockwatch.lockwatch_cycles()
    edges = lockwatch.lockwatch_order()
    held = [_held_too_long(f) for f in lockwatch.lockwatch_findings()
            if f.rule == "RLT705"]
    print(json.dumps(dict(
        phase="lockwatch", armed=lockwatch.lockwatch_armed(),
        max_hold_s=os.environ.get("RLT_LOCKWATCH_MAX_HOLD_S"),
        cycles=[list(c) for c in cycles],
        locks=sorted({n for e in edges for n in e[:2]}),
        edges=[dict(held=h, then=a, at=site) for h, a, site in edges],
        held_too_long=held)), flush=True)
    if cycles:
        problems.append("lock-order cycles observed: " + "; ".join(
            f.format() for f in lockwatch.lockwatch_findings()
            if f.rule == "RLT702"))
    parts["a"] = time.perf_counter() - t0

    # (b) the arming held: a planted inversion is reported
    t0 = time.perf_counter()
    first, second = "chip_smoke.liveness.first", "chip_smoke.liveness.second"
    a, b = lockwatch.san_lock(first), lockwatch.san_lock(second)
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    seen = [f for f in lockwatch.lockwatch_findings() if f.rule == "RLT702"
            and first in f.message and second in f.message]
    caught = (isinstance(a, lockwatch._SanLock) and len(seen) == 1
              and len(lockwatch.lockwatch_cycles()) == len(cycles) + 1)
    if not caught:
        problems.append(f"the watcher missed a planted inversion of {first} "
                        f"and {second} (armed: {lockwatch.lockwatch_armed()})")
    parts["b"] = time.perf_counter() - t0

    # (c) what arming costs a lock
    t0 = time.perf_counter()

    def pair_us(lock) -> float:
        t = time.perf_counter()
        for _ in range(LOCK_PAIRS):
            with lock:
                pass
        return (time.perf_counter() - t) / LOCK_PAIRS * 1e6

    armed_us = pair_us(lockwatch.san_lock("chip_smoke.overhead"))
    plain_us = pair_us(threading.Lock())
    parts["c"] = time.perf_counter() - t0

    # (d) lint, here where there is no JAX
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli(["lint", "--json"])
    lint_s = time.perf_counter() - t0
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    if rc != 0 or not report["ok"]:
        problems.append(f"lint exited {rc}: " + "; ".join(
            f"{f['rule']} {f.get('file')}:{f.get('line')}"
            for f in report["findings"]))
    parts["d"] = lint_s
    jax_absent = sys.modules.get("jax") is None
    print(json.dumps(dict(
        phase="analysis", liveness_cycle_reported=caught,
        lock_pair_us=dict(armed=armed_us, plain=plain_us,
                          pairs=LOCK_PAIRS),
        lint=dict(rc=rc, seconds=lint_s, files=report["files"],
                  counts=report["counts"], fail_on=report["fail_on"],
                  jax_imported=not jax_absent),
        card=nvidia_smi(), parts_s=parts)), flush=True)
    if problems:
        raise AssertionError("analysis: " + "; ".join(problems))


# ---- phase 19: the graph walks ------------------------------------------
#
# Every hand-written kernel is an ``rltt`` operator with a Meta
# implementation; tracecheck runs the trainer's own step, and the decode
# audit the engine's own step, on fake CUDA tensors.

#: 19 (d): the trace CLI in a process of its own with JAX blocked and no
#: card visible (the trace touches none), started early: it imports and
#: traces while other phases run
TRACE_CLI_CODE = ("import sys; sys.modules['jax'] = None; "
                  "from ray_lightning_tpu_torch.__main__ import main; "
                  "sys.exit(main(['trace', 'llama3-8b', '--topo', "
                  "'h100-8', '--json']))")
TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "rlt_logs", "chip_smoke_trace")
#: 19 (b): the traced peak within this share of phase 5's measured peak
TRACE_PEAK_RTOL = 0.10
#: 19 (a): host microseconds are taken over this many calls
OP_HOST_CALLS = 200


def trace_cli_start() -> dict:
    """Start 19 (d)'s ``trace llama3-8b --topo h100-8 --json``."""
    os.makedirs(TRACE_DIR, exist_ok=True)
    out = open(os.path.join(TRACE_DIR, "stdout.json"), "w")
    err = open(os.path.join(TRACE_DIR, "stderr.txt"), "w")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-c", TRACE_CLI_CODE], stdout=out, stderr=err,
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env)
    return dict(proc=proc, out=out, err=err, t0=time.perf_counter())


def _same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return all(_same(x, y) for x, y in zip(a, b)) and len(a) == len(b)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def ops_check(gen: torch.Generator, problems: list) -> list:
    """19 (a): each ``rltt`` operator at phase 1's and phase 3's shapes
    against its wrapper on the same inputs: bitwise equal, its launch
    counter up by one a call, and both calls' host microseconds."""
    from ray_lightning_tpu_torch.ops.kernels import adamw as A
    from ray_lightning_tpu_torch.ops.kernels import flash as F
    from ray_lightning_tpu_torch.ops.kernels import paged_attention as PA
    from ray_lightning_tpu_torch.ops.kernels import paged_prefill as PP
    from ray_lightning_tpu_torch.ops.kernels import rmsnorm as R

    inp = KernelInputs(gen)
    dargs, dkw = inp.decode(DECODE_LENGTHS, [0] * C)
    pargs, pkw = inp.prefill(PREFILL_POS[-1], [0])
    fc = FlashCase(gen, TB, TS, TS, TH, THKV, HD, True, 0)
    scale = HD ** -0.5
    bwd = (fc.q, fc.k, fc.v, fc.do, fc.lse, fc.delta, True, 0, scale)
    x = inp.randn(4096, 4096)
    w = torch.randn(4096, generator=gen, device="cuda")

    shapes = [(4096, 4096), (4096,), (1024, 4096)]

    def adamw_state():
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED + 19)
        mk = [torch.randn(s, generator=g, device="cuda") for s in shapes]
        return ([t.clone() for t in mk],
                [torch.randn(s, generator=g, device="cuda") * 1e-2
                 for s in shapes],
                [(torch.randn(s, generator=g, device="cuda") * 1e-3)
                 .to(torch.bfloat16) for s in shapes],
                [torch.rand(s, generator=g, device="cuda") * 1e-6
                 for s in shapes],
                [torch.full((), 3.0, device="cuda") for _ in shapes],
                torch.full((), 1e-4, device="cuda"), None,
                0.9, 0.95, 1e-8, 0.1)

    def adamw_run(fn):
        st = adamw_state()
        fn(*st)
        return st[0] + st[2] + st[3] + st[4]

    cases = [
        ("paged_decode", PA.paged_attention_kernel,
         lambda: PA.paged_attention_kernel(*dargs, **dkw),
         lambda: PA.paged_attention_op(*dargs, **dkw)),
        ("paged_prefill", PP.paged_prefill_kernel,
         lambda: PP.paged_prefill_kernel(*pargs, **pkw),
         lambda: PP.paged_prefill_op(*pargs, **pkw)),
        ("rms_norm", R.rms_norm_kernel,
         lambda: R.rms_norm_kernel(x, w, 1e-5),
         lambda: R.rms_norm_op(x, w, 1e-5)),
        ("flash_fwd", F.flash_fwd_kernel,
         lambda: F.flash_fwd_kernel(fc.q, fc.k, fc.v, True, 0, scale),
         lambda: F.flash_fwd_op(fc.q, fc.k, fc.v, True, 0, scale)),
        ("flash_bwd_dkv", F.flash_bwd_dkv_kernel,
         lambda: F.flash_bwd_dkv_kernel(*bwd),
         lambda: F.flash_bwd_dkv_op(*bwd)),
        ("flash_bwd_dq", F.flash_bwd_dq_kernel,
         lambda: F.flash_bwd_dq_kernel(*bwd),
         lambda: F.flash_bwd_dq_op(*bwd)),
        ("adamw_step", A.adamw_step_kernel,
         lambda: adamw_run(A.adamw_step_kernel),
         lambda: adamw_run(A.adamw_step_op)),
    ]
    rows = []
    for name, wrapper, direct, op in cases:
        want = direct()
        before = wrapper.launches
        got = op()
        torch.cuda.synchronize()
        counted = wrapper.launches - before
        bitwise = _same(got, want)
        if not bitwise:
            problems.append(f"{name}: the operator differs from its wrapper")
        if counted != 1:
            problems.append(f"{name}: one operator call counted {counted} "
                            "launches")
        row = dict(op=name, bitwise=bitwise, launches_per_call=counted)
        if name != "adamw_step":
            row["op_host_us"] = host_us(op, OP_HOST_CALLS)
            row["wrapper_host_us"] = host_us(direct, OP_HOST_CALLS)
        rows.append(row)
    return rows


def graph_phase(train_live: dict, train_step_s: float, trace_cli: dict
                ) -> None:
    """Phase 19: (a) `ops_check`; (b) `analysis.tracecheck.audit_step`
    of phase 5's step (Llama-3-8B width, 4 layers, B 2, S 2048,
    `SingleDevice`, the kernel lane) on fake CUDA tensors: its kernel list
    names the flash forward, dK/dV, dQ and RMSNorm operators, its traced
    peak is within TRACE_PEAK_RTOL of phase 5's `max_memory_allocated`,
    and its modelled step is printed beside phase 5's measured step (the
    drift, a reading); (c) `serve.audit.audit_decode_step` at phase 4's
    engine, both lanes: the kernel lane runs the paged decode, paged
    prefill and RMSNorm operators and is clean of RLT307/308, the
    reference lane flags both; (d) the trace CLI's process (started
    before phase 16) exits 0 with a report."""
    from ray_lightning_tpu_torch.analysis.tracecheck import audit_step
    from ray_lightning_tpu_torch.models.llama import LlamaModule
    from ray_lightning_tpu_torch.parallel.strategy import SingleDevice
    from ray_lightning_tpu_torch.serve.audit import audit_decode_step
    from ray_lightning_tpu_torch.telemetry.report import (
        build_drift,
        prediction_of,
    )

    import torch.distributed as dist

    # an in-process fit under a group strategy (15 (c)-(d), 16's
    # examples) leaves its one-rank NCCL group live: a Trainer does not
    # tear its strategy down. The trace refuses a live real group, so
    # the phase ends it first
    if dist.is_available() and dist.is_initialized():
        log(f"phase 19: ending the live {dist.get_backend()} group of "
            f"world {dist.get_world_size()} before the trace")
        dist.destroy_process_group()
    problems, parts = [], {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 19)
    t0 = time.perf_counter()
    op_rows = ops_check(gen, problems)
    parts["a"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()

    # (b) phase 5's step, traced
    t0 = time.perf_counter()
    cfg, tokens = train_inputs(SEED)
    report = audit_step(
        LlamaModule(cfg, lr=TRAIN_LR, warmup_steps=2,
                    total_steps=TRAIN_STEPS), SingleDevice(),
        {"tokens": tokens[:TB]}, topology="h100-1", device="cuda",
        label="phase 5's step")
    parts["b"] = time.perf_counter() - t0
    want = {"rltt.flash_fwd", "rltt.flash_bwd_dkv", "rltt.flash_bwd_dq",
            "rltt.rms_norm"}
    if not want <= set(report.kernels):
        problems.append(f"(b) the traced step ran {report.kernels}, not "
                        f"every one of {sorted(want)}")
    peak_ratio = report.peak_hbm_bytes / train_live["peak"]
    if abs(peak_ratio - 1) > TRACE_PEAK_RTOL:
        problems.append(f"(b) traced peak {report.peak_hbm_bytes} bytes is "
                        f"{peak_ratio:.3f}x phase 5's measured "
                        f"{train_live['peak']}")
    timeline = {"step_stats": {"p50_s": train_step_s,
                               "mean_s": train_step_s, "steps": 1}}
    drift = build_drift(prediction_of(report, "phase 5's step", "h100-1"),
                        timeline)

    # (c) phase 4's engine
    t0 = time.perf_counter()
    lanes = {}
    for lane, fused in (("kernel", True), ("reference", False)):
        r = audit_decode_step(serve_config(SERVE_LAYERS), engine_config(),
                              topology="h100-1", fused=fused,
                              device="cuda", numerics=False,
                              label=f"phase 4 {lane} lane")
        lanes[lane] = dict(kernels=r.kernels, peak_bytes=r.peak_hbm_bytes,
                           rules=sorted({f.rule for f in r.findings}))
    parts["c"] = time.perf_counter() - t0
    kern, ref = lanes["kernel"], lanes["reference"]
    for k in ("rltt.paged_decode", "rltt.paged_prefill", "rltt.rms_norm"):
        if k not in kern["kernels"]:
            problems.append(f"(c) the kernel lane ran no {k}: "
                            f"{kern['kernels']}")
    if {"RLT307", "RLT308"} & set(kern["rules"]):
        problems.append(f"(c) the kernel lane fired {kern['rules']}")
    if not {"RLT307", "RLT308"} <= set(ref["rules"]):
        problems.append(f"(c) the reference lane fired {ref['rules']}")

    # (d) the CLI's process
    t0 = time.perf_counter()
    proc = trace_cli["proc"]
    try:
        rc = proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    trace_cli["out"].close()
    trace_cli["err"].close()
    cli_s = time.perf_counter() - trace_cli["t0"]
    parts["d_wait"] = time.perf_counter() - t0
    with open(os.path.join(TRACE_DIR, "stdout.json")) as f:
        lines = f.read().strip().splitlines()
    cli = json.loads(lines[-1]) if lines else {}
    ag = sum(c["count"] for c in cli.get("collectives", ())
             if c["kind"] == "all_gather")
    rs = sum(c["count"] for c in cli.get("collectives", ())
             if c["kind"] == "reduce_scatter")
    if rc != 0 or not cli.get("kernels"):
        with open(os.path.join(TRACE_DIR, "stderr.txt")) as f:
            tail = f.read()[-2000:]
        problems.append(f"(d) trace CLI exited {rc}: {tail}")
    print(json.dumps(dict(
        phase="graph", ops=op_rows,
        train_trace=dict(kernels=report.kernels,
                         peak_bytes=report.peak_hbm_bytes,
                         measured_peak_bytes=train_live["peak"],
                         peak_ratio=peak_ratio,
                         params_bytes=report.params_bytes_per_device,
                         opt_bytes=report.opt_bytes_per_device,
                         flops=report.flops, compute_us=report.compute_us,
                         predicted_step_us=report.step_us,
                         measured_step_us=train_step_s * 1e6,
                         drift=dict(ratio=drift.get("step_time_ratio"),
                                    verdict=drift["verdict"],
                                    flags=drift["flags"]),
                         findings=[f.rule for f in report.findings]),
        decode_audit=lanes,
        trace_cli=dict(rc=rc, seconds=cli_s, all_gathers=ag,
                       reduce_scatters=rs, kernels=cli.get("kernels"),
                       peak_bytes=cli.get("peak_hbm_bytes"),
                       params_bytes=cli.get("params_bytes_per_device"),
                       findings=[f["rule"] for f in
                                 cli.get("findings", ())]),
        card=nvidia_smi(), parts_s=parts)), flush=True)
    if problems:
        raise AssertionError("graph: " + "; ".join(problems))


SOURCES = ["paged_attention", "paged_prefill", "flash_fwd", "flash_bwd",
           "rmsnorm", "adamw"]


def all_kernels():
    """Every kernel wrapper with a launch counter."""
    from ray_lightning_tpu_torch.ops.kernels import flash
    from ray_lightning_tpu_torch.ops.kernels.adamw import adamw_step_kernel
    from ray_lightning_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_kernel)
    from ray_lightning_tpu_torch.ops.kernels.paged_prefill import (
        paged_prefill_kernel)
    from ray_lightning_tpu_torch.ops.kernels.rmsnorm import rms_norm_kernel

    return (paged_attention_kernel, paged_prefill_kernel, rms_norm_kernel,
            flash.flash_fwd_kernel, flash.flash_bwd_dkv_kernel,
            flash.flash_bwd_dq_kernel, adamw_step_kernel)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=SERVE_LAYERS,
                    help="the serve phase's model depth (32 = the full "
                         "Llama-3-8B)")
    ap.add_argument("--train-spread", type=int, default=0, metavar="N",
                    help="only build, then run the train lanes' comparison "
                         "at seeds 0..N-1 and print each seed's readings")
    ap.add_argument("--ab-old", metavar="CSRC",
                    help="only build, then time the decode and RMSNorm "
                         "(and the dQ and prefill) in turns with an old "
                         "build of the sources in CSRC")
    ap.add_argument("--bert-spread", type=int, default=0, metavar="N",
                    help="only build, then run phase 16 (b)'s BERT lanes' "
                         "comparison at seeds 0..N-1 and print each "
                         "seed's readings")
    ap.add_argument("--axes-only", action="store_true",
                    help="only build, check the flash kernels at phase "
                         "17's shapes, run phase 5's fit for its rows and "
                         "then phase 17")
    ap.add_argument("--profile-sessions", type=int, default=0, metavar="N",
                    help="only count, in N fresh processes, the device "
                         "events of each of their profiler sessions, then "
                         "the lost kernel events of two-step windows of "
                         "phase 5's fit after other profiled sessions")
    args = ap.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        return 1
    from ray_lightning_tpu_torch.ops import build

    print(nvidia_smi(), flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    if args.profile_sessions:
        profile_sessions(args.profile_sessions)
        build.build_all(SOURCES)
        profile_windows()
        return 0
    # 9d. the matmul probe beside the card's spec-sheet peak
    t_probe = time.perf_counter()
    probe_line()
    t_probe = time.perf_counter() - t_probe

    # 2. build
    t0 = time.perf_counter()
    build.build_all(SOURCES)
    for name, text in build.build_logs.items():
        log(f"--- nvcc {name} ---\n{text}")
    print(json.dumps(dict(phase="build", sources=SOURCES,
                          nvcc_s=time.perf_counter() - t0)), flush=True)
    if args.train_spread:
        train_spread(range(args.train_spread))
        return 0
    if args.bert_spread:
        bert_spread(range(args.bert_spread))
        return 0
    if args.ab_old:
        ab_phase(args.ab_old)
        return 0
    if args.axes_only:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        check_flash_owed(gen, only=("ring block causal", "ring block full",
                                    "ulysses 2"))
        spawned = axes_start(SEED)
        _, train_rows, _, _ = train_phase(SEED)
        t0 = time.perf_counter()
        axes_phase(train_rows, spawned)
        print(json.dumps(dict(phase="timing", phase17_s=time.perf_counter()
                              - t0)), flush=True)
        return 0

    # each phase's wall seconds, printed before the kernels' summary
    walls, t_phase = {}, time.perf_counter()

    def lap(name):
        nonlocal t_phase
        now = time.perf_counter()
        walls[name] = now - t_phase
        t_phase = now
        # a phase stops what it starts: name the one that did not
        left = descendants()
        if left:
            log(f"chip_smoke: after phase {name}, processes still "
                f"running: {left}")

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = check_kernels(gen) + check_flash(gen)
    check_owed(gen)
    check_flash_owed(gen)
    check_rms_norm_grad(gen)
    lap("kernels")

    # 4. serving at full width, through the kernel lanes (and 9b: the
    # same requests with live metrics)
    serve_launches, t_9b, t_11ab, t_13 = serve_phase(SEED, args.layers)
    lap("serve")
    walls["serve"] -= t_9b + t_11ab + t_13 + PHASE14_S["autoscale"]

    # 11 (c). process replicas on the card, one SIGKILL'd and replayed;
    # 13 (c): a tensor-parallel replica on the same params file
    gc.collect()
    torch.cuda.empty_cache()
    proc_launches, t_13c = driver_process_phase(SEED)
    for k, v in proc_launches.items():
        serve_launches[k] += v
    lap("driver_process")
    walls["driver_process"] -= t_13c + PHASE14_S["process_scale_up"]

    # 5. training at full width, 4 layers deep
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, train_rows, train_step_s, train_live = train_phase(SEED)
    lap("train")

    # 9a. the same fit with the span recorder and a profile window
    tel_launches = telemetry_train(SEED, train_rows, train_step_s)
    lap("telemetry_train")

    # 10a. the default (prefetched, warm-started) lane beside the
    # synchronous one
    hot_launches = hot_loop_sync(SEED, train_rows)
    lap("hot_loop_sync")

    # 12. the planner against the card's memory (phase 5's fit; the
    # planned batch) and the tensor axis in two processes on the card
    plan_launches = planner_phase(SEED, train_rows, train_live)
    lap("planner")

    # 15. the Llama path's knobs: the AdamW kernel with a bf16 first
    # moment, phase 5's fit under mu_dtype + "attn_out" + the inline CE,
    # a "dots" fit, a tied fit under FSDP and the Llama example
    knob_launches, adamw_row = knobs_phase(SEED, train_rows)
    rows.append(adamw_row)
    lap("knobs")

    # 17's processes start here and import while phase 16 runs; so does
    # 19 (d)'s, which imports and traces on one core meanwhile
    axes_spawned = axes_start(SEED)
    trace_cli = trace_cli_start()

    # 16. the BASELINE's ResNet and BERT: the flash kernels at BERT's
    # shape, BERT-base's lanes, ResNet-50, the in-process examples, the
    # doctor and the native batcher
    bert_rows, base_launches, base_walls = baseline_phase(SEED, gen)
    rows += bert_rows
    lap("baseline")

    # 17. the sequence, pipeline and expert axes: the gloo probe, ring and
    # Ulysses at Llama-3-8B's attention width, phase 5's fit under
    # seq=2 and pipe=2, the MoE classifier under expert=2, all as two
    # gloo ranks on the card
    axes_launches = axes_phase(train_rows, axes_spawned)
    lap("axes")

    # 6. training across processes: fit_distributed under FSDP,
    # DataParallel in this process, a checkpoint (resumed by 14 (a) and 8
    # (a)), and the MNIST train/load/predict matrix
    dist_launches, dist_ckpt = dist_phase(SEED, train_rows)
    lap("dist")
    walls["dist"] -= PHASE14_S["elastic"]

    # 7. the sweep: Llama-3-8B trials under ASHA, each in its own process
    # on the card, and the reference's Tune example over fit_distributed
    sweep_launches = sweep_phase(SEED, train_rows)
    lap("sweep")

    # 8. resilience: a SIGKILL'd FSDP fit resumed under the supervisor,
    # the trainguard's skip, preemption / stall / corruption recovered,
    # the SDC digest on the card
    res_launches = resilience_phase(SEED, train_rows, dist_ckpt)
    lap("resilience")

    # 10c. the perf CLI on the card
    hot_loop_perf()
    lap("hot_loop_perf")

    # 4b. phase 4's serving window under the profiler (see serve_profile)
    serve_profile(SEED, args.layers)
    lap("serve_profile")

    # 18. the analysis layer: the lock-order verdict over the whole run, a
    # planted inversion, the watcher's cost a lock, and `lint` here
    analysis_phase()
    lap("analysis")

    # 19. the graph walks: every kernel as an rltt operator, phase 5's step
    # and phase 4's engine traced on fake CUDA tensors, the trace CLI
    graph_phase(train_live, train_step_s, trace_cli)
    lap("graph")
    shutil.rmtree(TEL_DIR, ignore_errors=True)
    walls["telemetry_serve"] = t_9b
    walls["driver_inline_generate"] = t_11ab
    walls["rest_of_serving"] = t_13 + t_13c
    walls["probe"] = t_probe
    walls.update({f"phase14_{k}": v for k, v in PHASE14_S.items()})
    print(json.dumps(dict(
        phase="timing", wall_s=walls,
        # 9c's share is inside "resilience" (its rows carry the timeline
        # CLI's seconds)
        phase9_s=t_9b + t_probe + walls["telemetry_train"],
        # (b) is 6 (a): its wall is inside "dist"
        phase10_s=sum(walls[k] for k in ("hot_loop_sync",
                                         "hot_loop_perf")),
        phase11_s=t_11ab + walls["driver_process"],
        # (d)'s share is inside phases 6-8 and 10 (b)
        phase12_s=walls["planner"],
        phase13_s=walls["rest_of_serving"],
        # (a) inside phase 6 (c), (c) inside phase 4, (d) after
        # 11 (c); 8 (a)'s refused grow costs no time
        phase14_s=sum(PHASE14_S.values()),
        phase15_s=walls["knobs"],
        phase16_s=walls["baseline"], phase16_parts_s=base_walls,
        phase17_s=walls["axes"],
        phase18_s=walls["analysis"],
        phase19_s=walls["graph"],
        # slice 17's legs: 12 (c)'s BERT fit (inside phase12_s), 16
        # (a)'s H 6 flash row (inside phase16_s), 17 (e)'s tensor=2 fit
        # (inside phase17_s)
        slice17_legs_s=LEGS_S,
        since_import_s=time.time() - IMPORTED_AT)), flush=True)
    left = stop_descendants("at the end of the run")
    if left:
        raise AssertionError(f"processes outlived their phases: {left}")

    # each kernel's launches on the paths that run it
    launches = {k: serve_launches.get(k, 0) + train_launches[k]
                + tel_launches[k] + dist_launches[k] + sweep_launches[k]
                + res_launches.get(k, 0) + hot_launches[k]
                + plan_launches[k] + knob_launches[k] + base_launches[k]
                + axes_launches[k]
                for k in train_launches}
    meta = {
        "paged_decode": ("paged_attention_kernel", "cuda",
                         "ray_lightning_tpu_torch/ops/csrc/paged_attention.cu",
                         "ray_lightning_tpu/ops/pallas/paged_attention.py:76"),
        "paged_prefill": ("paged_prefill_kernel", "cuda",
                          "ray_lightning_tpu_torch/ops/csrc/paged_prefill.cu",
                          "ray_lightning_tpu/ops/pallas/paged_prefill.py:104"),
        "rms_norm": ("rms_norm_kernel", "cuda",
                     "ray_lightning_tpu_torch/ops/csrc/rmsnorm.cu",
                     "ray_lightning_tpu/ops/pallas/rmsnorm.py:20"),
        "flash_fwd": ("flash_fwd_kernel", "cuda",
                      "ray_lightning_tpu_torch/ops/csrc/flash_fwd.cu",
                      "ray_lightning_tpu/ops/pallas/flash.py:73"),
        "flash_bwd_dkv": ("flash_bwd_dkv_kernel", "cuda",
                          "ray_lightning_tpu_torch/ops/csrc/flash_bwd.cu",
                          "ray_lightning_tpu/ops/pallas/flash.py:166"),
        "flash_bwd_dq": ("flash_bwd_dq_kernel", "cuda",
                         "ray_lightning_tpu_torch/ops/csrc/flash_bwd.cu",
                         "ray_lightning_tpu/ops/pallas/flash.py:221"),
        # replaces no Pallas kernel (note below)
        "adamw_step": ("adamw_step_kernel", "cuda",
                       "ray_lightning_tpu_torch/ops/csrc/adamw.cu", None),
    }
    notes = {"adamw_step": "replaces no Pallas kernel: the JAX package's "
             "update is optax adamw(mu_dtype=), fused by XLA "
             "(ray_lightning_tpu/models/llama.py LlamaModule."
             "configure_optimizers); no torch optimizer computes the "
             "update from the f32 moment before storing it in bf16"}
    summary = []
    for name, (fn, route, source, replaces) in meta.items():
        mine = [r for r in rows if r["kernel"] == name]
        # decode ragged; prefill B 1 at 3968; RMSNorm N 4 (the decode's,
        # f32 gains); flash: the training step's shape (the first case)
        main_shape = mine[0] if name != "paged_prefill" else next(
            r for r in mine if r["shape"]["B"] == 1
            and r["shape"]["pos"] == PREFILL_POS[-1])
        summary.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=launches[fn],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=main_shape["kernel_ms"], plain_ms=main_shape["plain_ms"],
            bound_ms=main_shape["bound_ms"],
            bound_by=main_shape["bound_by"],
            library_ms=main_shape["library_ms"],
            **({"note": notes[name]} if name in notes else {})))
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    import signal

    # a SIGTERM (a time limit) unwinds through the finally like a failure
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        rc = main()
    finally:
        stop_descendants("as the script exits")
    sys.exit(rc)
