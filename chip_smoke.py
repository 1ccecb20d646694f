#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.
It drives ``llm_fine_tune_distributed_tpu_torch`` (never JAX) phase by phase
and stops with a non-zero exit at the first failure:

1. the card's name and power limit, torch and CUDA versions;
2. builds the port's CUDA kernels from ``csrc/`` with nvcc, one process per
   source, all at once, and fails if the ptxas report kept beside each
   library (built now or before) is missing a tensor-core flash kernel, the
   w8a8 kernel or any of the 32 paged decode instantiations, or shows one
   spilling registers;
3. holds the paged decode kernel against its plain PyTorch version on the
   card, at SmolLM3-3B's attention shapes (ragged, the main path's live
   rows, 8 full rows, one row of 4096), and times both with CUDA events
   beside the byte bound;
4. serves SmolLM3-3B at full width (random bf16 weights from a seed) over
   HTTP from an int8 block-paged KV pool: one request, then 4 concurrent
   ones; every decode step must go through the kernel;
5. one full-width decode step in f32 through ``forward``, with the kernel
   and with its plain version, to a relative logit bound;
6. where a decode step's time goes at the main path's occupancy
   (``torch.profiler`` over a few steps, device kernels grouped by name);
7. holds the flash-attention forward, dq and dk/dv kernels to their plain
   versions (f32: the CUDA-core kernels, to the JAX package's bands; bf16:
   the tensor-core kernels within 2x the error of
   ``scaled_dot_product_attention`` in bf16 of an f32 truth, over the whole
   tensor and row by row, at d 128 and 64, ragged and packed segments; planted
   dq and dk/dv faults must fail the row rule), has the kernels count the
   tile pairs they compute against ``flash_tile_pairs``, and times them
   beside SDPA at the training shapes, with and without pairs to skip; then
   holds and times the bf16 kernels the same way at tensor=2's local heads
   (hq 8 over hkv 2);
8. trains SmolLM3-3B at full width (random weights from a seed) for 3
   optimizer steps through ``SFTTrainer`` with the reference recipe: every
   attention must go through the flash kernels, frozen leaves stay
   bit-equal, the losses stay within 0.5% of the recorded ones,
   ``best_model/`` loads back; then profiles one microbatch, which must show
   the tensor-core flash kernels by name; the kernels count the tile pairs
   they compute on every training microbatch's own padding, and one
   microbatch runs again with every token marked real (nothing to skip);
9. one full-width f32 microbatch through the loss function, with the
   kernels and with their plain versions: the loss and every gradient;
10. holds the w8a8 int8 matmul kernel on K-major codes bitwise against its
   plain version at the frozen trunk's projection shapes (M = 8192) and
   ragged ones (K off the 128-byte step and off 16 included), and times it
   beside ``torch._int_mm`` on the same codes and a bf16 ``torch.matmul``;
   then bitwise and timed at one trunk layer's tensor=2 local shapes (N / 2
   column-parallel in bf16, K / 2 row-parallel in f32);
11. trains SmolLM3-3B as in phase 8 with ``frozen_compute="int8"``: layers
   0-33 run every projection through the w8a8 kernel under no_grad, the
   last two layers through the flash kernels; launches as derived, the
   trunk's codes K-major and bit-unchanged, peak memory at most 28.5 GB,
   ``best_model/`` holds the decoded trunk;
12. one full-width f32 microbatch with the int8 trunk, the w8a8 kernel
   against its plain version (plain attention in both): loss and gradients;
13. (after phase 6, on phase 4's weights cast to f32) dense-cache greedy
   generation of one ~1.43k-token prompt: ``Generator.generate_ids`` for 9
   tokens, and ``forward`` over an ``init_cache`` buffer step by step, each
   step's logits within 1e-4 x max|logit| of a no-cache ``forward`` over the
   prompt and the tokens so far; the paged engine (bf16-layout pool) on the
   same prompt must give the same tokens wherever the top-2 logit margin
   exceeds twice that bound;
14. (after phase 9, once phase 8's trainer is freed) asks phase 8's
   ``best_model/`` the question through ``cli.ask_main`` (greedy, 32 new
   tokens), in bf16 and with ``--quantize int8``: both answer, and the int8
   weights take at most 3.4 GB on the card; then profiles a decode step of
   phase 4's random weights as phase 6 does, serves them after
   ``maybe_quantize(..., "int8")`` from an int8 KV pool as phase 4 does
   (launches == 36 x decode steps) and profiles a step again;
15. (right after phase 4, on its generator) phase 4's traffic through
   ``build_server(engine="continuous")`` (a dense 8 x 4096 cache) and
   ``engine="window"``: HTTP 200, each request's greedy tokens equal a solo
   run's up to the first step whose top-2 margin is within rounding (twice
   the solo step's measured difference from a no-cache forward, at least
   phase 13's f32 rule), ``/v1/stats`` and ``/metrics`` counting the tokens
   and requests served, no paged decode launch; then one question through
   ``POST /v1/stream`` on ``continuous`` and on ``paged`` with an int8 pool,
   its deltas equal to the ``/v1/generate`` answer and the paged one's
   launches 36 x its decode steps;
16. (right after phase 15, on its generator) speculation, K = 4, through the
   server: (a) ``--engine continuous --speculative 4`` with prompt lookup,
   phase 15's traffic with ``"speculative": 4``, then one repetitive
   question; (b) the same on ``--engine paged --quantize-kv int8`` (no paged
   decode launch: a verify of K+1 positions takes the dequantizing gather,
   as in JAX; the blocks in use back to the prefix cache's after the
   requests); (c) continuous with the target's own parameter dict as the
   draft (a dense 8 x 4096 draft cache, acceptance at least 0.9); every
   request's tokens held to its solo run by phase 15's margin rule (16b
   adds twice the int8 pool's measured logit error); (e) one plain and one
   speculative continuous tick profiled by kernel name, and spec ticks (prompt
   lookup, self-draft) run under ``torch.cuda.set_sync_debug_mode("error")``
   but for the one transfer of their tokens; (d) (beside phase 14) the ask
   CLI with ``--speculative 4``, then with ``--draft-dir`` phase 8's
   ``best_model/``: the answer's tokens equal the plain ask's, or the solo
   run's by the margin rule;
17. (right after 16d) the golden eval: ``run_golden_eval`` over the
   reference's five questions (greedy, 32 new tokens) on the random base
   phase 8 started from (its seed, made in memory) and on phase 14's bf16
   generator of phase 8's ``best_model/``, ``compare_golden``, every tuned
   answer against ``Generator.chat`` token for token, then
   ``python -m ...eval_golden`` once in tuned-only mode (its report parses
   and holds five answers);
18. (right after phase 16, on phase 4's generator) overload control through
   HTTP, the decode steps held at a gate (a wrapper of the generator) so the
   arrivals are scripted without sleeps: (a) paged int8, a depth-1 queue and
   both slots busy: a burst gets 429s with a whole Retry-After and the
   taxonomy's body; (b) continuous: ``deadline_ms`` expiring in the queue
   (504, no tokens) and mid-decode (504, the tokens so far held to the solo
   run by phase 15's margin rule); (c) an interactive arrival preempts a
   best_effort victim on continuous and on paged int8 (a pool that holds
   only the two: the arrival finds no free block), the victim's final tokens
   held to its solo run, the paged resume reusing its banked blocks and the
   paged decode launches 36 x decode steps across preemption and resume;
   (d) brownout on ``continuous --speculative 4``: the stages the pressure
   passes through, no drafts asked from stage 1, best_effort shed at stage
   3; (e) one injected fatal tick failure: ``/healthz`` answers 503 with
   ``circuit_state`` "fatal" and the terminal error, the request in flight
   a 500 with its body;
19. (right after phase 18, on phase 4's generator) supervision: (a) the
   paged int8 engine restarts in-process after a decode tick fails: both
   requests in flight get 503 ``engine_restarting`` with Retry-After, the
   new generation's tokens are held to the solo runs by the margin rule,
   paged decode launches are 36 x decode steps across the crash and the
   restart, ``memory_allocated`` after it is within 1 MiB of its value
   before the fault, and the restart's time beyond its backoff is printed;
   (b) the same on ``continuous --speculative 4`` with a failing spec tick;
   (c) ``--circuit-threshold 2``: the second failure opens the circuit
   (``/healthz`` 503 "open", ``circuit_open`` refusals, a flight artifact
   holding crash, restart, circuit_open); (d) a drain through
   ``control["begin_drain"]``: the request in flight finishes with 200, a
   new one gets 503 ``draining``, ``run_server`` returns; (e) a
   ``StepWatchdog(1.0, "abort")`` trips 0 times over a normal request and
   once when a decode tick is slowed by 2 s. Phases 8 and 11 train with
   the step watchdog armed and must report 0 trips;
20. (right after phase 19, on phase 4's generator) serving observability
   on a paged int8 server with ``--trace-log``, ``--profile-dir``, a 0.2 s
   metric ring and a 10 ms inter-token objective: (a) phase 4's 4
   concurrent requests with ``"trace": true``: each trace holds received,
   queued, admitted, the prefill (chunks, then the final one), first_token
   and completed in time order, the trace log 4 lines of those requests
   (32 tokens, no error), paged decode launches 36 x decode steps; (b)
   ``/v1/slo``: inter_token_p99 breached on both windows (burn > 1),
   ttft_p99 compliant (4 events < ``min_events``), one ``slo_breach`` in
   ``/v1/flight``; ``/v1/history?metric=tokens_served`` non-decreasing up to
   ``/v1/stats``'s count; (c) ``/v1/capacity``: the report of a fleet of
   one, the snapshot's mean decode tick equal to the histogram's, a
   positive sustainable tokens/s; (d) ``weight_bytes`` and
   ``kv_pool_bytes`` equal to the tensors' bytes, the MFU and HBM-bandwidth
   gauges in (0, 1), unclamped at most 1, the bandwidth one giving back
   the summed bytes of every timed decode tick over their summed time to
   1e-6 (and again on a continuous server); (e) ``POST /v1/profile`` while
   a 128-token request decodes: 200, then 409 inside the window,
   ``profile_start`` and ``profile_stop`` in ``/v1/flight``, a Chrome trace
   holding ``paged_decode_kernel`` a positive multiple of 36 times, and
   the request decoding on after the stop, with the stop's hold of the
   tick lock and the request's largest inter-token gap printed; (f)
   ``/v1/lineage`` and the window engine's ``/v1/slo`` answer the JAX 404s;
21. (in a process of its own, ``--fleet-only``, beside phases 16-20, on
   phase 4's weights made there again) the host KV tier, live
   migration and the engine fleet, on paged int8 replicas at phase 4's
   geometry: (a) the 5 full blocks of a ~1.43k-token prompt spilled to a
   1 GiB host tier (pinned) and restored into fresh rows 5 times, bitwise
   equal, 9,438,336 bytes per entry, spill and restore timed by CUDA events
   and by wall time with the sync; (b) one engine with a pool of exactly
   one request's blocks: another prompt evicts the first one's 5 blocks
   into the tier and the re-ask restores them (>= 5 hits, 1280 tokens
   reused, the same tokens), its TTFT beside the same re-ask with the tier
   cleared; (c) a fleet of two replicas over the one generator and one tier:
   a 32-token stream migrated (``migrate_slot``) after its second token
   finishes on the sibling, held to its solo run by phase 15's margin rule
   plus twice the int8 pool's logit error, completed on exactly one
   replica, launches 36 x the decode steps of both; (f) on that fleet, a
   decode failure restarts one replica while the other decodes: the
   sibling's tokens held the same way, launches exact, merge tickets zero;
   (d) ``--replicas 2 --replica-roles prefill,decode --host-tier-mb 1024``
   over HTTP: every request handed off, no decode step on the prefill
   replica, every paged decode launch on the decode one; (e) ``--replicas 2
   --routing prefix --max-replicas 3 --migrate-on-retire``: a repeat lands
   on the replica holding its prefix, ``/v1/stats`` has the JAX fleet keys
   but ``compile``, ``/metrics`` a replica sample of every counter, and
   ``POST /v1/fleet/scale`` 3 -> 2 gives ``memory_allocated`` back within
   1 MiB, then -> 1 under a live stream, which completes.
22. (in a process of its own, ``--adapters-only``, beside phases 16-20, on
   phase 4's weights made there again) multi-tenant LoRA
   serving: three PEFT adapters (r 16, alpha 8, the seven projections, B
   non-zero, from ``torch.Generator`` seeds) written by the port's
   ``save_lora_adapter``; (c) a registry of 3 slots: ``memory_allocated``
   growth within 1% of the pools' bytes, each adapter's hot-load wall
   time (the third evicting an idle one) and a rebuild's; each tenant held
   to its adapter folded into the weights exactly (f32) at the first two
   steps: the pooled view within phase 13's f32 rule in f32 and within
   twice the merged bf16 model's own error in bf16, the engine's own path
   (``paged_prefill_final``, then one ``paged_step`` with both tenants'
   rows, over the int8 pool) within that plus the int8 floor, its first
   token too, and the same path on the other tenant's slot (its logits and
   its first token), a pooled delta
   1.5x too large and the base model all outside those bounds; (a) on a
   paged int8 server at phase 4's geometry with ``--adapter-dir`` and
   ``--max-adapters 3``, t1, t2, a base request and a sampled neighbour
   stepped into one decode batch (decode held at a gate): each tenant's
   first token within its bound of the exact merge's top logit, and its
   tokens held to its ``merge_lora`` solo run and the base request's to its
   solo run by phase 15's margin rule plus the int8 and bf16 floors; (b)
   paged decode launches == 36 x decode steps; (d) phase 6's
   decode step at 4 live rows, base-only and with the rows on t1/t2,
   profiled; (e) over HTTP with ``--adapter-capacity 1``: an unknown
   adapter 404 with the known list, a third tenant 429 ``adapter_pool_full``
   and a tenant over its quota 429 ``tenant_quota``; (f) a decode failure
   mid-request: 503, the pools rebuilt bit for bit, t1's first token on
   both generations within its bound of the exact merge's top logit and its
   tokens held to its solo run; (g) on (f)'s server, t1's blocks of
   phase 4's shared system prompt cached: t2 and a base request reuse none
   of them, t1 reuses its own (one hit).
23. (after phase 17, on phase 8's output: its final trainable-only
   checkpoint and publish, which phase 8 writes after its timed steps, and
   ``best_model/``) live deployment: (a) a fresh ``SFTTrainer`` with
   ``resume_from_checkpoint="latest"`` restores step 3, the trainable
   leaves and both AdamW moments bit for bit against phase 8's own,
   the frozen fingerprint verified, and a base with one frozen leaf's rows
   reversed is refused (``FingerprintMismatch``); a synchronous save is
   timed beside phase 8's background one; (b) a paged int8 server at phase
   4's geometry over the seed-42 random base (the trainer's frozen leaves)
   with ``--publish-watch-dir``: ``POST /v1/deploy`` swaps step 3 in while
   a 128-token stream is in flight (it finishes on the old weights, held
   to the base's solo run by the margin rule), the replaced leaves freed
   (weak references) and ``memory_allocated`` across each apply within 1
   MiB per swapped leaf, two answers equal a fresh server on ``best_model/`` token
   for token, a worse ``eval_loss`` and another base's fingerprint refused
   (flight events, generation unmoved), ``POST /v1/deploy/rollback`` gives
   the pre-swap tokens back, paged decode launches 36 x decode steps; (c)
   ``--replicas 2 --canary-window-s 3``: a clean rolling swap, then a
   republish whose canary requests fail (a prefill fault each) rejected
   with replica 1 never swapped, a rollback, and ``/v1/lineage`` showing
   the deploy, the rejection and the rollback with the manifest's run_id.
   The watcher's load and fingerprint seconds, the apply and rollback ms,
   the stream's largest gap and the save, publish and resume numbers are
   printed with the card.
24. (after phase 12) the fine-tuning recipes, each phase 8's recipe
   (SmolLM3-3B at full width from seed 42, byte-chatml, 3 optimizer steps
   of 8 x 4 x 1024, one eval) through ``SFTTrainer`` or ``DPOTrainer``,
   frozen leaves bit-unchanged, trainable ones moved and the flash
   launches as derived: (a) ``packing=True`` over 480 rows: the occupancy,
   samples and real tokens/s beside phase 8's, the kernels' own tile-pair
   count equal to ``flash_tile_pairs`` on the packed rows (many segments
   each) and the share skipped, one packed f32 microbatch kernels against
   plain (phase 9's bands); (b) LoRA r 16 on the 7 projections
   (30,228,480 trainable): the first loss phase 8's (B = 0), ``adapter/``
   and ``best_model/`` = the merged state, its logits and the adapted
   forward's against the base plus the adapter in f32 (phase 22a's rule);
   (c) QLoRA (NF4, block 64, double quant): the NF4 share of the frozen
   bytes, the quantization's seconds, the peak below 24b's by at least half
   the block linears' bf16 less NF4 bytes, the first loss within 2% of
   24b's, the export's dequantize-and-merge seconds; (d) DPO on LoRA at 4
   pairs per microbatch, SmolLM3-3B cut to ``RECIPE_DPO_LAYERS``: the first
   loss ln 2, the ``rewards_*`` and ``eval_rewards_accuracy``, launches 3 x
   layers forwards per microbatch (the policy, its replay, the reference); (e) ``ask --quantize nf4`` on 24b's
   ``best_model/`` (load seconds, weight bytes below phase 14's int8), and a
   paged int8 server over phase 4's weights in NF4, cut to their first 4
   layers (``NF4_SERVE_LAYERS``), on phase 4's traffic, tokens held by the
   margin rule to the same weights dequantized to bf16, paged decode
   launches 4 x decode steps; the engine's own path (the
   prefill and one paged step of the 4 prompts) within the int8 floor +
   twice the bf16 rounding of the f32 forward over the dequantized weights,
   and the same path with the nibbles swapped in pairs or each block's
   absmax read from the block before outside that bound.
25. (checked after phase 24) data-parallel training across processes: (a)
   phase 8's recipe through ``python -m llm_fine_tune_distributed_tpu_torch.cli``
   in a process of its own (started before 24d, beside 24d-e and 25b's
   world-1 run) under a PyTorchJob's env for one worker (``RANK=0``,
   ``WORLD_SIZE=1``, ``MASTER_ADDR``/``MASTER_PORT``), so the trainer takes
   its data-parallel path over NCCL: the first loss bit for bit phase 8's,
   the later ones within 0.5%, the step time, samples/s/card and peak
   beside phase 8's, and the gradient all-reduce's ms per step by CUDA
   events; (b) two ranks on the one card over gloo (a group this script
   makes, which the trainer takes as it is; started after phase 9, they run
   beside phases 14-23), ``data=1, fsdp=2`` (ZeRO-3: every sharded leaf,
   trainable and frozen, held as the rank's slice, a block's leaves
   gathered as it runs, the gradients reduce-scattered), the heartbeat on,
   at full width and 4 layers in f32, 2 steps, against one process at world
   1 with the same global batch and peak lr: the losses within 1e-5
   relative and the updated leaves within 1e-4 of each leaf's max, each
   rank's leaves and AdamW moments half the world-1 run's for the sharded
   leaves (tensor bytes exactly; ``memory_allocated`` after the trainer's
   init within 1% of world 1's less what the rank does not hold, and its
   peak up to the moments within its slices and one whole leaf: the model
   is taken one leaf at a time), the flash launches per
   rank as derived, every desync check passed and a divergence planted on
   rank 1 caught on both ranks, then a silent rank 1 (its heartbeats
   stopped) seen by rank 0's detector within its timeout and both ranks
   stopped at the same step boundary; (c) then the same two ranks free that
   trainer and train at ``tensor=2`` (Megatron: each rank its heads, MLP
   columns and vocab rows, the flash kernels on hq 8 over hkv 2, the
   vocab-parallel loss) on the same model, rows, global batch and peak lr
   in f32, held to (b)'s world-1 run (losses 1e-5, leaves 1e-4), every
   sliced leaf exactly half its whole's bytes and the norms whole, the
   tensor group's collectives and the flash launches per rank as derived,
   a desync planted on a norm on rank 1 caught, and an int8-trunk case at
   ``tensor=2`` (bf16, trunk layers 0-1, w8a8 at local shapes, the row
   scale max-reduced over the group) held to a world-1 run of its own here
   within ``TP_INT8_LOSS_REL_TOL``, w8a8 launches 2 x 7 per forward. Gloo goes
   through the host: its seconds are printed as the cost of a correctness
   phase, not of data or tensor parallelism. Every child is waited for at
   most about 3x its measured
   time (``CHILD_BOUND_S``, one table for every child of this script):
   past it every child of the phase is killed, the tails of their output
   printed and ``check failed: phase 25b: ...`` raised.
26. (started right after phase 4, checked right after phase 15, on phase
   4's weights) tensor-parallel serving: phase 4's weights written as a
   checkpoint with the port's codec and both jobs started (they load while
   phase 15 runs; each one's traffic runs while the other waits, its four
   concurrent requests started in phase 4's admission order 50 ms apart),
   then (a) ``llm_fine_tune_distributed_tpu_torch.infer.server``'s ``main`` with
   ``--tp 1 --engine paged --quantize-kv int8`` at phase 4's geometry in a
   process of its own under a PyTorchJob's env for one worker, so the
   forward issues its collectives over NCCL at world 1: phase 4's traffic,
   its tokens bit for bit phase 4's in whatever order its requests were
   admitted (a block a request is given starts from K/V scale zero), the
   tick and tokens/s beside phase 4's,
   paged decode launches 36 x decode steps, 74 collectives per decode step
   and their ms per step by CUDA events; (b) ``--tp 2`` in two ranks on the
   one card over gloo (a group the ranks make first, which the server takes
   as it is), bf16, phase 4's traffic: rank 0 serves, rank 1 follows;
   tokens held to the solo runs by phase 15's margin rule plus twice the
   int8 pool's logit error (an all-reduce changes the summation order),
   rank 1's tokens equal to rank 0's, each rank's weights
   (``memory_allocated``) half the matrices plus the whole norms, its pool
   exactly half 26a's, launches 36 x decode steps on each rank, then a
   fault planted in rank 1: it exits non-zero and rank 0's ``/healthz``
   answers 503; before the server, the two ranks hold the logits of a
   prefill and one paged int8 step of a 4-layer f32 model at full width to
   one process's within ``TP_F32_LOGIT_REL_TOL``; (c) here, the paged decode
   kernel against its plain version at the ranks' local head shapes (tp 2:
   8 query heads over 2 kv heads; tp 4: 4 over 1), timed at tp 2's live
   shape beside the bound. Gloo's collectives go through the host: 26b's
   tick is a correctness phase's, never a cost of tensor parallelism. Also
   before the server, 26b's ranks serve 24e's weights as ``--quantize nf4
   --tp 2`` does (quantized whole, then sliced): each rank's NF4 leaves
   equal to the whole model's slice, 32 greedy tokens through an int8 pool
   against one process's: the logits within ``TP_NF4_LOGIT_REL_TOL`` of
   max|logit| at every step of the same context, the tokens by the margin
   rule bounded by twice one process's distance from the f32 forward over
   the dequantized weights (its int8 pool's error inside it); paged decode
   launches 4 x 31.

Times (``time_ms``) are CUDA-event medians after an L2 flush and a spin
kernel of ``SPIN_MS``, calibrated on the card in phase 1. Its last four
lines are JSON: the seconds of each phase (``{"phase_seconds": {...},
"phases_beside_children": {...}}``: the time up to each phase line goes to
that line's phase; the second names, for each phase that shared the card
with a child process of this script, those children: its timings are not a
baseline), a summary of
the run, ``{"kernels": [...]}`` (one entry per kernel of the paths) and
``{"ok": true, "device": {...}}``.
Without a GPU it exits non-zero before printing either.

``python3 chip_smoke.py --flash-ab DIR [DIR ...]`` times instead the paged
decode, flash and w8a8 kernels of one or more checkouts of this repo with
this script's ``time_ms``, for an A/B of two commits within one call: each
DIR (the root of a checkout, for example the parent's ``git archive``
unpacked under ``build/``) runs in a process of its own, in the order given (parent,
change, change, parent), builds its own ``csrc/`` and times its
``paged_decode_attention`` at phase 3's live, full and single shapes, its
``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` and SDPA at phase 7's
shape, with the spin and without it (how earlier records were timed), the
flash kernels again with every row one segment (nothing to skip), and its
``w8a8_matmul`` over one trunk layer's 7 projections at M = 8192 on codes
made by its own ``parallel.freeze.quantize_trunk_int8``. One JSON line per
checkout; the last line lists them all.

``python3 chip_smoke.py --fleet-only`` runs phase 21 alone: it builds the
paged decode kernel, loads phase 4's weights, serves phase 4 (the record
21b, 21d and 21e compare with), makes phase 15's solo runs of its 4
questions, and runs 21a-21f; its last line is a JSON summary, not the
contract line.

``python3 chip_smoke.py --adapters-only`` runs phase 22 alone: it builds the
paged decode kernel, loads phase 4's weights, makes phase 15's solo runs of
its 4 questions and runs 22a-22g; its last line is a JSON summary.

``python3 chip_smoke.py --deploy-only`` runs phase 23 alone: it builds the
flash and paged decode kernels, trains phase 8 (its final checkpoint and
publish) and runs 23a-23c; its last line is a JSON summary.

``python3 chip_smoke.py --recipes-only`` runs phase 24 alone: it builds the
flash and paged decode kernels, trains phase 8 (the record 24a-24c compare
with) and runs 24a-24e; its last line is a JSON summary.

``python3 chip_smoke.py --distributed-only`` runs phase 25 alone: it builds
the flash and w8a8 kernels, trains phase 8 (the record 25a compares with)
and runs 25b and 25c (in the same two ranks), then 25a beside 25b's world-1
run and 25c's world-1 int8 run; its last line is a JSON summary.

``python3 chip_smoke.py --tp-only`` runs phase 26 alone: it builds the paged
decode kernel, loads phase 4's weights, serves phase 4 (the record 26a
compares with), makes phase 15's solo runs of its 4 questions and runs
26a-26c; its last line is a JSON summary.

``python3 chip_smoke.py --capture-check N [PUSH]`` runs phase 20e's
profile capture N times on one phase-20 server and prints, per capture,
whether its trace holds whole ticks (a multiple of 36 paged decode
kernels); PUSH sets the tiny kernels the capture launches before each stop
(default ``ProfilerCapture.PUSH_LAUNCHES``; 0 turns them off).

``python3 chip_smoke.py --serve-ab DIR [DIR ...]`` runs instead phase 4 (a
warm-up request, then the 4 concurrent ones, on a paged int8 server over
seed-0 bf16 weights) with this script's ``serve_phase`` on each checkout's
port, each in a process of its own that builds its own paged decode
kernel, in the order given (parent, change, change, parent): its mean
decode tick, tokens/s and TTFT, one JSON line per checkout, then all of
them.
"""

from __future__ import annotations

import atexit
import json
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
import weakref

import numpy as np
import torch

DEVICE = "cuda"
# SmolLM3-3B serving geometry of the smoke (the server's defaults)
SLOTS, KV_BUF_LEN, KV_BLOCK_LEN, PREFILL_CHUNK, PROMPT_BUCKET = 8, 4096, 256, 512, 64
MAX_NEW_TOKENS = 32
BATCH_WINDOW_MS = 10.0  # phase 15's window engine (the server's default)
QUESTIONS = (
    "How do I purify water from a stream?",
    "What knot should I use to tie a tarp to a tree?",
    "How can I tell if my car's coolant is low?",
    "What are the steps to treat a minor burn?",
)
WARMUP_QUESTION = "How many cups are in a gallon?"
# phase 16: a question whose prompt repeats itself, for prompt lookup
REPETITIVE_QUESTION = " ".join(["Boil the water for one full minute before you drink it."] * 6)
SPEC_K = 4  # phase 16's draft depth
SELF_DRAFT_MIN_ACCEPTANCE = 0.9
# tolerances of the kernel against its plain version: in f32 both differ
# only in summation order; in bf16 both compute in f32 and round once, so
# they differ by at most one bf16 ulp, which is at most 2**-7 of the value
# (atol covers values near zero)
F32_TOL = 1e-5
BF16_ATOL, BF16_RTOL = 1e-5, 2.0**-7
TOLERANCE = f"f32 max|d| <= {F32_TOL}; bf16 |d| <= {BF16_ATOL} + 2**-7 x |plain|"
# full-width f32 decode step, kernel against plain: relative to max |logit|
LOGIT_REL_TOL = 1e-4
# phase 13: tokens after the prefill's first; phase 14: the int8 weights' cap
DENSE_STEPS = 8
INT8_WEIGHT_BYTES_MAX = 3.4e9
# what the paged decode kernel is, for the kernels line
PAGED_DESIGN = ("each row's positions split over thread blocks (grid split x kv head x row, "
                "split 64-256 positions from host shapes), 16-byte cp.async K/V tiles through a "
                "3-stage ring, codes to f32 by byte_perm, f32 softmax and p.V on CUDA cores, "
                "last-block merge of the splits' (m, l, acc) by an atomic ticket; one launch "
                "per call")
TIMING_REPS = 25
SPIN_MS = 1.0  # the spin before each timed launch: longer than a wrapper's host work
_SPIN: dict = {}  # torch.cuda._sleep cycles for SPIN_MS on this card, and their measured ms

# Published peaks of the H100 SXM5 (NVIDIA data sheet, dense): HBM3
# bytes/s, bf16 tensor-core flop/s, f32 (non-tensor) flop/s.
H100_SXM_PEAKS = (3.35e12, 989e12, 67e12)


def _peaks(name: str):
    """The bound's peaks, for the card this port is measured on."""
    if "H100" not in name or "HBM3" not in name:
        raise RuntimeError(f"no peak rates for {name!r}: bound_ms is defined for the "
                           "H100 SXM (e.g. 'NVIDIA H100 80GB HBM3')")
    return H100_SXM_PEAKS


_T0 = time.monotonic()
# seconds per phase: the time up to each stamp goes to the stamp's phase (the
# work a phase prints about comes before its line: model inits, loads and
# kernel builds included)
PHASE_SECONDS: dict = {}
_LAST_STAMP = [_T0]
PHASE_SPANS: list = []  # (phase, start, end) of the time each stamp took
CHILD_SPANS: list = []  # [label, start, end or None] of each child process


def phase(n: int, msg: str) -> None:
    now = time.monotonic()
    PHASE_SECONDS[n] = PHASE_SECONDS.get(n, 0.0) + now - _LAST_STAMP[0]
    PHASE_SPANS.append((n, _LAST_STAMP[0], now))
    _LAST_STAMP[0] = now
    print(f"[phase {n} +{now - _T0:.1f}s] {msg}", flush=True)


def phase_seconds() -> dict:
    """{phase: seconds} so far, in phase order (they sum to the time of the
    last stamp)."""
    return {n: round(PHASE_SECONDS[n], 1) for n in sorted(PHASE_SECONDS)}


def phases_beside_children() -> dict:
    """{phase: the child processes (``spawn_child``) alive during any of
    its time}: those phases' timings were taken on a card and a host that
    another process shared, so no later run may take them as a baseline
    (their checks hold all the same: none is a timing check)."""
    out: dict = {}
    for n, start, end in PHASE_SPANS:
        for label, c_start, c_end in CHILD_SPANS:
            if c_start < end and (c_end is None or c_end > start):
                out.setdefault(n, set()).add(label)
    return {n: sorted(out[n]) for n in sorted(out)}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


# ---------------------------------------------------------------------------
# kernel cases and timing
# ---------------------------------------------------------------------------


def _pools(num_blocks, L, hkv, d, gen):
    k = torch.randint(-127, 128, (num_blocks, L, hkv, d), generator=gen, device=DEVICE, dtype=torch.int8)
    v = torch.randint(-127, 128, (num_blocks, L, hkv, d), generator=gen, device=DEVICE, dtype=torch.int8)
    ks = torch.rand(num_blocks, hkv, generator=gen, device=DEVICE) * 2 + 0.05
    vs = torch.rand(num_blocks, hkv, generator=gen, device=DEVICE) * 2 + 0.05
    for t in (k, v, ks, vs):
        t[0] = 0  # the null block: zero codes, zero scale
    return k, v, ks, vs


def _tables(lengths, nb, L, shared_prefix_blocks, num_blocks, dead_rows):
    """Null-padded tables; rows share their first ``shared_prefix_blocks``
    blocks as the prefix cache maps them; dead rows get all-null tables, as
    the engine gives them."""
    tables = torch.zeros(len(lengths), nb, dtype=torch.int32)
    free = (torch.randperm(num_blocks - 1, generator=torch.Generator().manual_seed(1)) + 1).tolist()
    prefix = [free.pop() for _ in range(shared_prefix_blocks)]
    for r, n in enumerate(lengths):
        if r in dead_rows:
            continue
        used = -(-n // L)
        ids = prefix[: min(used, shared_prefix_blocks)]
        ids += [free.pop() for _ in range(used - len(ids))]
        tables[r, :used] = torch.tensor(ids, dtype=torch.int32)
    return tables.to(DEVICE)


def make_case(lengths, nb, dtype, *, shared_prefix_blocks=0, dead_rows=(), hq=16, hkv=4,
              d=128, L=KV_BLOCK_LEN, num_blocks=154, seed=0):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    k, v, ks, vs = _pools(num_blocks, L, hkv, d, gen)
    tables = _tables(lengths, nb, L, shared_prefix_blocks, num_blocks, dead_rows)
    q = torch.randn(len(lengths), 1, hq, d, generator=gen, device=DEVICE).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
    return (q, k, v, ks, vs, tables), lens


def bound(args, lens, peaks):
    """Least time for the work these inputs need: each touched block read
    once (K and V codes and scales), q, tables, lengths read and the output
    written once; operations 4*d per (position, query head)."""
    q, k, _, _, _, tables = args
    _, L, hkv, d = k.shape
    hq = q.shape[2]
    touched = set()
    for row, n in zip(tables.tolist(), lens.tolist()):
        touched.update(row[: min(-(-n // L), len(row))])
    nbytes = (len(touched) * (L * hkv * d * 2 + hkv * 4 * 2)
              + 2 * q.numel() * q.element_size() + tables.numel() * 4 + lens.numel() * 4)
    flops = sum(lens.tolist()) * hq * d * 4
    mem_rate, bf16_rate, f32_rate = peaks
    t_bytes = nbytes / mem_rate
    t_ops = flops / (bf16_rate if q.dtype == torch.bfloat16 else f32_rate)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def _event_ms(fn, reps=5):
    """Median CUDA-event time of ``fn`` alone, in ms."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def calibrate_spin():
    """The ``torch.cuda._sleep`` cycles that keep this card busy SPIN_MS, from
    an event-timed trial of 10**6 cycles (no clock rate is assumed); returns
    (cycles, the chosen spin's own event-timed ms)."""
    trial = 1_000_000
    torch.cuda._sleep(trial)
    trial_ms = _event_ms(lambda: torch.cuda._sleep(trial))
    cycles = int(trial * SPIN_MS / trial_ms)
    _SPIN.update(cycles=cycles, ms=_event_ms(lambda: torch.cuda._sleep(cycles)))
    check(0.5 * SPIN_MS <= _SPIN["ms"] <= 2 * SPIN_MS, f"spin kernel calibration: {_SPIN}")
    return _SPIN["cycles"], _SPIN["ms"]


def time_ms(fn, reps=TIMING_REPS, spin=True):
    """Median of ``reps`` single launches, CUDA events around each, with the
    L2 flushed before each (decode finds the pool cold). With ``spin`` (every
    time this script reports), a spin kernel of SPIN_MS after the flush keeps
    the card busy while the host runs the wrapper's Python and launches, so
    the start event fires just before the first kernel and the time is the
    device's, not the host's. Without it (how earlier records were timed)
    host work beyond the flush's own time lands in the window."""
    if spin and not _SPIN:
        calibrate_spin()
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.int32, device=DEVICE)
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        if spin:
            torch.cuda._sleep(_SPIN["cycles"])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(kernel, plain, args, lens):
    out = kernel(*args, lengths=lens)
    torch.cuda.synchronize()
    ref = plain(*args, lengths=lens)
    diff = (out.float() - ref.float()).abs()
    return out, ref, diff


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def card_info():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def check_close(name, kernel, plain, args, lens, phase_no=3):
    """The kernel against its plain version on the same inputs, to
    ``TOLERANCE``; returns the largest |difference| (printed under
    ``phase_no``)."""
    out, ref, diff = compare(kernel, plain, args, lens)
    check(bool(torch.isfinite(out).all()), f"{name}: kernel output not finite")
    err = diff.max().item()
    if out.dtype == torch.float32:
        check(err <= F32_TOL, f"{name}: f32 kernel vs plain max|d| {err:.3e} > {F32_TOL}")
    else:
        over = (diff > BF16_ATOL + BF16_RTOL * ref.float().abs()).sum().item()
        check(over == 0, f"{name}: bf16 kernel vs plain: {over} elements beyond "
                         f"{BF16_ATOL} + 2**-7 x |plain| (max|d| {err:.3e})")
    phase(phase_no, f"{name} {out.dtype}: max|kernel-plain| {err:.3e}, max|plain| "
                    f"{ref.float().abs().max().item():.3e}")
    return err


def live_lengths(tokenizer_cls, system_prompt):
    """The main path's decode lengths: the 4 concurrent requests' prompts
    (byte-chatml, the default system prompt) halfway through their tokens."""
    tokenizer = tokenizer_cls()
    prompts = [tokenizer.apply_chat_template(
        [{"role": "system", "content": system_prompt}, {"role": "user", "content": q}],
        tokenize=True, add_generation_prompt=True) for q in QUESTIONS]
    return prompts, [len(p) + MAX_NEW_TOKENS // 2 for p in prompts]


def paged_cases(live):
    """{name: (lengths, nb, shared prefix blocks, dead rows)} of the timed
    paged decode shapes."""
    n_live = len(live)
    return {
        # the main path's decode step: live rows mid-generation sharing the
        # system prompt's 5 full blocks, dead rows (length 1) on null tables
        "live": (live + [1] * (SLOTS - n_live),
                 1 << (max(-(-n // KV_BLOCK_LEN) for n in live) - 1).bit_length(),
                 5, range(n_live, SLOTS)),
        "full": ([KV_BUF_LEN] * SLOTS, KV_BUF_LEN // KV_BLOCK_LEN, 0, ()),
        # one request at the longest context: the card is filled by splits alone
        "single": ([KV_BUF_LEN], KV_BUF_LEN // KV_BLOCK_LEN, 0, ()),
    }


def paged_ms(fa, live, spin=True):
    """{case: kernel ms} of ``paged_decode_attention`` at the timed shapes
    (bf16), for ``--flash-ab``."""
    out = {}
    for name, (lengths, nb, shared, dead) in paged_cases(live).items():
        args, lens = make_case(lengths, nb, torch.bfloat16, shared_prefix_blocks=shared,
                               dead_rows=dead, seed=3)
        out[name] = time_ms(lambda: fa.paged_decode_attention(*args, lengths=lens), spin=spin)
    return out


def kernel_phase(fa, peaks, live):
    """Kernel against plain at SmolLM3 shapes; returns the timing record."""
    kernel, plain = fa.paged_decode_attention, fa.paged_decode_attention_reference
    ragged = [1, 255, 256, 257, 1500, 4096, 3000, 777]
    for dtype in (torch.float32, torch.bfloat16):
        args, lens = make_case(ragged, 17, dtype, shared_prefix_blocks=5)
        check_close("ragged b=8 hq=16 hkv=4 d=128 L=256 nb=17", kernel, plain, args, lens)

    record = {}
    for name, (lengths, nb, shared, dead) in paged_cases(live).items():
        f32_args, lens = make_case(lengths, nb, torch.float32, shared_prefix_blocks=shared,
                                   dead_rows=dead, seed=3)
        check_close(name, kernel, plain, f32_args, lens)
        args, lens = make_case(lengths, nb, torch.bfloat16, shared_prefix_blocks=shared,
                               dead_rows=dead, seed=3)
        err = check_close(name, kernel, plain, args, lens)
        ms = time_ms(lambda: kernel(*args, lengths=lens))
        plain_ms = time_ms(lambda: plain(*args, lengths=lens))
        bound_ms, bound_by, nbytes = bound(args, lens, peaks)
        record[name] = {
            "lengths": lengths, "nb": nb, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "share_of_bound": bound_ms / ms,
            "split_len": fa.paged_decode_split_len(
                len(lengths), args[1].shape[2], nb, KV_BLOCK_LEN,
                torch.cuda.get_device_properties(0).multi_processor_count),
        }
        phase(3, f"{name} lengths={lengths} nb={nb}: kernel {ms:.4f} ms, "
                 f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
                 f"{nbytes / 1e6:.2f} MB), {100 * bound_ms / ms:.1f}% of the bound, "
                 f"split {record[name]['split_len']} positions")
    return record


def _hist(engine, name):
    """(sum, count) of one of a slot engine's latency histograms."""
    h = engine.stats.hist[name]
    return h.sum, h.total


def _prometheus_samples(text):
    """A /metrics body parsed line by line: {sample name: value}; fails on a
    line that is neither a TYPE line nor a sample."""
    samples = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            check(len(line.split(" ")) == 4, f"/metrics: bad TYPE line {line!r}")
            continue
        name, _, value = line.rpartition(" ")
        check(bool(name), f"/metrics: bad line {line!r}")
        samples[name] = float(value)
    return samples


def _http(base, path, body=None, timeout=600):
    """(status, body bytes, wall seconds, end time) of one request."""
    req = urllib.request.Request(base + path, data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        status, data = r.status, r.read()
    t1 = time.monotonic()
    return status, data, t1 - t0, t1


class _Serving:
    """``build_server`` on a thread, its engine's ``submit`` and ``stream``
    recording each request's (prompt ids, generated ids), and the prompt
    lengths in the order the paged engine finished their prefills (its
    admission order: a freed int8 block keeps its scale, so the order
    decides which request's K/V a stale scale quantizes); stopped on exit."""

    def __init__(self, server_mod, generator, **kw):
        self.httpd, self.engine = server_mod.build_server(generator, host="127.0.0.1", port=0, **kw)
        self.results = []
        self.prefill_order = []
        self._generator = generator
        final = generator.paged_prefill_final

        def recording_final(*args, **fkw):
            self.prefill_order.append(int(args[5]))  # prompt_len
            return final(*args, **fkw)

        generator.paged_prefill_final = recording_final
        submit_full = self.engine.submit_full

        def recording_submit_full(prompt_ids, gen, seed=0, timeout=None, **kw):
            req = submit_full(prompt_ids, gen, seed=seed, timeout=timeout, **kw)
            self.results.append((list(prompt_ids), list(req.result)))
            return req

        self.engine.submit_full = recording_submit_full
        stream = getattr(self.engine, "stream", None)  # the slot engines

        def recording_stream(prompt_ids, gen, seed=0, timeout=None, **kw):
            tokens, ids = stream(prompt_ids, gen, seed=seed, timeout=timeout, **kw), []
            self.results.append((list(prompt_ids), ids))

            def each():
                try:
                    for tok in tokens:
                        ids.append(tok)
                        yield tok
                finally:
                    tokens.close()

            return each()

        if stream is not None:
            self.engine.stream = recording_stream
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.engine.close()
        self.thread.join(30)
        del self._generator.paged_prefill_final  # the class's method again


def serve_phase(server_mod, fa, generator, phase_no=4, engine="paged", spec=0):
    """The port's HTTP server with one engine: one warm-up request, then the
    4 concurrent ones. ``paged`` (phases 4 and 14) serves from an int8 KV
    pool, and every decode step must go through the kernel; ``continuous``
    and ``window`` (phase 15) run dense caches and must never launch it.
    ``spec`` = K (phase 16): the slot engine runs with ``speculative_k`` K,
    every request asks for ``"speculative": K`` and answers with its block;
    every tick is a verify of K+1 positions, which never takes the paged
    decode kernel; then one repetitive question."""
    kw = dict(engine=engine, slots=SLOTS, kv_buf_len=KV_BUF_LEN, prompt_bucket=PROMPT_BUCKET)
    if engine == "paged":
        kw.update(quantize_kv="int8", kv_block_len=KV_BLOCK_LEN, prefill_chunk=PREFILL_CHUNK)
    elif engine == "window":
        kw.update(max_batch=SLOTS, batch_window_ms=BATCH_WINDOW_MS)
    extra = {}
    if spec:
        kw["speculative_k"] = spec
        extra = {"speculative": spec}
    fa.paged_decode_attention.launches = 0  # count this run's launches only
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with _Serving(server_mod, generator, **kw) as srv:
        torch.cuda.synchronize()
        engine_bytes = torch.cuda.memory_allocated() - before
        eng, base = srv.engine, srv.base
        status, body, _, _ = _http(base, "/healthz")
        check(status == 200 and body == b"ok", "/healthz did not answer 200 ok")
        phase(phase_no, f"{engine}: GET /healthz -> 200 ok")
        warm = _http(base, "/v1/generate", {"question": WARMUP_QUESTION, "greedy": True,
                                            "max_new_tokens": MAX_NEW_TOKENS, **extra})
        check(warm[0] == 200, f"warm-up request: HTTP {warm[0]}")
        slot_engine = engine != "window"
        if slot_engine:
            warm_stats = eng.stats_snapshot()
            warm_hist = {k: _hist(eng, k) for k in ("ttft_s", "decode_tick_s")}
        phase(phase_no, f"{engine}: warm-up request: HTTP 200 in {warm[2]:.3f} s")
        outs = [None] * len(QUESTIONS)

        def post(i):
            outs[i] = _http(base, "/v1/generate", {"question": QUESTIONS[i], "greedy": True,
                                                   "max_new_tokens": MAX_NEW_TOKENS, **extra})

        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(QUESTIONS))]
        window_start = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
            check(not t.is_alive(), "a request did not finish")
        launches = fa.paged_decode_attention.launches
        status, stats_body, _, _ = _http(base, "/v1/stats")
        check(status == 200, f"/v1/stats: HTTP {status}")
        stats = json.loads(stats_body)
        status, metrics_body, _, _ = _http(base, "/metrics")
        check(status == 200, f"/metrics: HTTP {status}")
        samples = _prometheus_samples(metrics_body.decode())
        hist = {k: _hist(eng, k) for k in ("ttft_s", "decode_tick_s")} if slot_engine else {}
        results = list(srv.results)
        prefill_order = list(srv.prefill_order)
        if spec:
            rep = _http(base, "/v1/generate", {"question": REPETITIVE_QUESTION, "greedy": True,
                                               "max_new_tokens": MAX_NEW_TOKENS, **extra})
            check(rep[0] == 200, f"{engine} repetitive question: HTTP {rep[0]}")
            idle = eng.stats_snapshot()
            launches = fa.paged_decode_attention.launches  # the repetitive question's too
            draft_cache_bytes = sum(t.numel() * t.element_size() for e in
                                    (eng._dcache or {"layers": {}})["layers"].values()
                                    for t in e.values())

    for i, o in enumerate(outs):
        check(o is not None and o[0] == 200 and isinstance(json.loads(o[1]).get("answer"), str),
              f"{engine} request {i}: {o}")
    check(len(results) == 1 + len(QUESTIONS), f"{len(results)} requests recorded")
    for prompt, ids in results:
        check(1 <= len(ids) <= MAX_NEW_TOKENS, f"a request generated {len(ids)} tokens")
        check(all(0 <= t < generator.config.vocab_size for t in ids), "token id out of range")
    # the info line carries every string of the snapshot as a label (the JAX
    # schema: a slot engine's adds its circuit's state and its role)
    labels = ",".join(f'{k}="{stats[k]}"' for k in sorted(stats) if isinstance(stats[k], str))
    info = f"serving_info{{{labels}}}"
    check(stats["engine"] == engine and samples.get(info) == 1,
          f"/v1/stats or /metrics does not name the {engine} engine")
    gen_tok = sum(len(r[1]) for r in results[1:])
    window_s = max(o[3] for o in outs) - window_start
    out = {
        "engine": engine,
        "launches": launches,
        "prompt_tokens": [len(r[0]) for r in results],
        "generated_tokens": [len(r[1]) for r in results],
        "results": results,
        "tokens_per_s_concurrent": gen_tok / window_s,
        "window_s": window_s,
        "request_s_concurrent": [o[2] for o in outs],
        "request_s_warmup": warm[2],
        "engine_bytes": engine_bytes,
        "prefill_order": prefill_order,
    }
    layers = generator.config.num_layers
    if not slot_engine:
        check(launches == 0, f"the window engine launched the paged decode kernel {launches} times")
        check(stats["queue_depth"] == 0 and samples["serving_queue_depth"] == 0,
              f"window /v1/stats {stats}")
        phase(phase_no, f"window: 4 concurrent requests: HTTP 200 x4, tokens "
                        f"{out['generated_tokens'][1:]}, paged decode launches 0")
        return out
    served = sum(out["generated_tokens"])
    check(stats["tokens_served"] == served,
          f"/v1/stats tokens_served {stats['tokens_served']} != {served} tokens returned")
    check(stats["requests_completed"] == len(results),
          f"/v1/stats requests_completed {stats['requests_completed']} != {len(results)}")
    check(samples["serving_tokens_served_total"] == stats["tokens_served"],
          f"/metrics serving_tokens_served_total {samples['serving_tokens_served_total']} != "
          f"{stats['tokens_served']}")
    check(stats["decode_steps"] > 0, "no decode step ran")
    if engine == "paged" and not spec:
        check(launches == layers * stats["decode_steps"],
              f"kernel launches {launches} != {layers} layers x {stats['decode_steps']} decode steps")
        check(stats["prefix_hits"] >= 1, "no prefix-cache hit")
    elif engine == "paged":
        check(launches == 0, f"paged decode launched {launches} times over speculative ticks "
                             "(a verify of K+1 positions takes the dequantizing gather)")
        check(stats["prefix_hits"] >= 1, "no prefix-cache hit")
        check(idle["blocks_in_use"] == idle["prefix_cache_blocks"],
              f"blocks in use {idle['blocks_in_use']} after the requests, the prefix cache "
              f"holds {idle['prefix_cache_blocks']}: a request's blocks were not returned")
        out["blocks_in_use_idle"] = idle["blocks_in_use"]
    else:
        check(launches == 0, f"the {engine} engine launched the paged decode kernel {launches} times")
    dec_tok = stats["decode_tokens"] - warm_stats["decode_tokens"]
    dec_s = hist["decode_tick_s"][0] - warm_hist["decode_tick_s"][0]
    ticks = hist["decode_tick_s"][1] - warm_hist["decode_tick_s"][1]
    ttft_n = hist["ttft_s"][1] - warm_hist["ttft_s"][1]
    out.update({
        "decode_steps": stats["decode_steps"],
        "prefix_tokens_reused": stats["prefix_tokens_reused"],
        "tokens_served": stats["tokens_served"],
        "decode_tick_tokens_per_s": dec_tok / dec_s if dec_s > 0 else None,
        "decode_step_ms_mean": 1e3 * hist["decode_tick_s"][0] / hist["decode_tick_s"][1],
        "decode_step_ms_mean_concurrent": 1e3 * dec_s / ticks if ticks else None,
        "ttft_s_warmup": warm_hist["ttft_s"][0],
        "ttft_s_concurrent_mean": (hist["ttft_s"][0] - warm_hist["ttft_s"][0]) / ttft_n,
    })
    phase(phase_no, f"{engine}: 4 concurrent requests: HTTP 200 x4, tokens "
                    f"{out['generated_tokens'][1:]}, prompt tokens {out['prompt_tokens'][1:]}, "
                    f"/v1/stats tokens_served {stats['tokens_served']} == /metrics, "
                    f"requests_completed {stats['requests_completed']}")
    if spec:
        blocks = [json.loads(o[1]).get("speculative") for o in outs]
        check(all(b is not None and 0.0 <= b["acceptance_rate"] <= 1.0 for b in blocks),
              f"{engine}: a response lacks its speculative block: {blocks}")
        check(stats["draft_tokens_accepted"] <= stats["draft_tokens_proposed"],
              f"{engine}: accepted {stats['draft_tokens_accepted']} > proposed")
        out.update({
            "speculative_blocks": blocks,
            "repetitive": json.loads(rep[1]).get("speculative"),
            "draft_tokens_proposed": stats["draft_tokens_proposed"],
            "draft_tokens_accepted": stats["draft_tokens_accepted"],
            "draft_acceptance_rate": stats["draft_acceptance_rate"],
            "mean_tokens_per_step": stats["mean_tokens_per_step"],
            "draft_cache_bytes": draft_cache_bytes,
        })
        check(out["repetitive"] is not None, f"{engine}: the repetitive question has no block")
        phase(phase_no, f"{engine} --speculative {spec}: draft acceptance "
                        f"{stats['draft_acceptance_rate']:.3f} ({stats['draft_tokens_accepted']} of "
                        f"{stats['draft_tokens_proposed']}), {stats['mean_tokens_per_step']:.3f} "
                        f"tokens per step; repetitive question: {out['repetitive']}")
    if engine == "paged":
        out["prefix_hits"] = stats["prefix_hits"]
        out["kv_pool_bytes"] = sum(t.numel() * t.element_size()
                                   for e in eng.pool["layers"].values() for t in e.values())
        phase(phase_no, f"prefix hits {stats['prefix_hits']} ({stats['prefix_tokens_reused']} "
                        f"tokens reused); kernel launches {launches} == {layers} x "
                        f"{stats['decode_steps']} decode steps")
    else:
        out["cache_bytes"] = sum(t.numel() * t.element_size()
                                 for e in eng._cache["layers"].values() for t in e.values())
        phase(phase_no, f"{engine}: paged decode launches 0 over {stats['decode_steps']} decode "
                        f"steps")
    return out


def solo_decode(tf, gen_mod, generator, prompt_ids, n):
    """A request's solo greedy run, as ``generate_ids`` runs it (batch 1,
    the generator's prompt bucket, the default repetition penalty), step by
    step: each step's token, the top-2 margin of its penalized logits and
    its max |logit|, and the logits themselves. The tokens must equal
    ``generate_ids``'s."""
    from llm_fine_tune_distributed_tpu_torch.infer.sampling import (
        GenerationConfig,
        apply_repetition_penalty,
    )

    greedy = GenerationConfig(max_new_tokens=n, do_sample=False)
    config, dtype = generator.config, generator.compute_dtype
    plen = len(prompt_ids)
    bucket = -(-plen // gen_mod._PROMPT_BUCKET) * gen_mod._PROMPT_BUCKET
    cache = tf.init_cache(config, 1, bucket + n, dtype=dtype, device=DEVICE)
    padded = torch.zeros(1, bucket, dtype=torch.long, device=DEVICE)
    padded[0, :plen] = torch.tensor(prompt_ids, device=DEVICE)
    seen = torch.zeros(1, config.vocab_size, dtype=torch.bool, device=DEVICE)
    seen[0, padded[0, :plen]] = True
    lens = torch.tensor([plen], device=DEVICE)
    steps, all_logits, tok = [], [], None
    with torch.no_grad():
        hidden, _ = tf.forward(generator.params, padded, config, cache=cache, cache_pos=0,
                               compute_dtype=dtype, output_hidden=True)
        logits = tf.unembed(generator.params, hidden[:, plen - 1], config, compute_dtype=dtype)
        for t in range(n):
            if t:  # token t reads token t - 1 at position plen + t - 1
                logits = generator._step_logits(tok[:, None], cache, lens + (t - 1))
            pen = apply_repetition_penalty(logits, seen, greedy.repetition_penalty)
            top2 = torch.topk(pen[0], 2).values
            tok = torch.argmax(pen, dim=-1)
            seen[0, tok] = True
            all_logits.append(logits[0])
            steps.append({"token": int(tok), "margin": (top2[0] - top2[1]).item(),
                          "max_abs_logits": logits.abs().max().item()})
    tokens = generator._trim_at_eos([st["token"] for st in steps])
    check(tokens == generator.generate_ids(prompt_ids, greedy),
          "the solo step loop does not reproduce generate_ids")
    return tokens, steps, all_logits


def margin_agreement(tf, generator, label, prompt, got, solo, floor=0.0):
    """Tokens of an engine against the solo run: equal up to the first step
    whose solo top-2 margin is within reach of rounding, where another
    GEMM's order may flip the argmax; a difference at a wider margin fails.
    The bound is phase 13's construction at the run's precision: the larger
    of 2 x 1e-4 x max|logit| (phase 13's f32 rule) and twice the measured
    max|dlogits| between the solo run's cached logits at that step and a
    no-cache forward over the same context (in bf16 the logits' own
    rounding, one ulp = 2**-7 of their magnitude, is above the f32 rule).
    ``floor`` raises the bound where the engine's logits carry another
    error, the int8 KV pool's (phase 16b). Returns (tokens agreeing, the
    check at the first difference or None)."""
    tokens, steps, logits = solo
    for t, (a, b) in enumerate(zip(got, tokens)):
        if a != b:
            ctx = torch.tensor([list(prompt) + tokens[:t]], device=DEVICE)
            with torch.no_grad():
                hidden, _ = tf.forward(generator.params, ctx, generator.config,
                                       compute_dtype=generator.compute_dtype, output_hidden=True)
                plain = tf.unembed(generator.params, hidden[:, -1], generator.config,
                                   compute_dtype=generator.compute_dtype)[0]
            dlogits = (plain - logits[t]).abs().max().item()
            bound = max(2 * LOGIT_REL_TOL * steps[t]["max_abs_logits"], 2 * dlogits, floor)
            at = {"token": t, "got": a, "solo": b, "margin": steps[t]["margin"],
                  "max_abs_dlogits_no_cache": dlogits, "bound": bound}
            check(steps[t]["margin"] <= bound,
                  f"{label}: token {t} is {a}, solo {b}, at a solo top-2 margin "
                  f"{steps[t]['margin']:.3e} > {bound:.3e} (no-cache max|dlogits| {dlogits:.3e})")
            return t, at
    check(len(got) == len(tokens), f"{label}: {len(got)} tokens, solo {len(tokens)}")
    return len(got), None


def _sse(base, body):
    """POST /v1/stream -> (status, [(event, payload)], seconds to the first
    event, seconds to the end)."""
    import http.client

    host, port = base.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=600)
    t0 = time.monotonic()
    first = None
    try:
        conn.request("POST", "/v1/stream", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        check(resp.getheader("Content-Type") == "text/event-stream",
              f"/v1/stream Content-Type {resp.getheader('Content-Type')}")
        raw = b""
        while True:
            piece = resp.read1(65536)
            if not piece:
                break
            if first is None:
                first = time.monotonic() - t0
            raw += piece
    finally:
        conn.close()
    events = []
    for block in raw.decode().split("\n\n"):
        if block:
            lines = block.split("\n")
            name = lines[0][len("event: "):] if lines[0].startswith("event: ") else "message"
            check(lines[-1].startswith("data: "), f"/v1/stream: bad event {block!r}")
            events.append((name, json.loads(lines[-1][len("data: "):])))
    return resp.status, events, first, time.monotonic() - t0


def stream_phase(server_mod, fa, generator, engine):
    """Phase 15c: one greedy question through POST /v1/stream, its deltas
    held to the /v1/generate answer of the same request. Each runs on a
    fresh server: a freed int8 block keeps its scale, so the paged engine's
    tokens depend on its pool's history."""
    kw = dict(engine=engine, slots=SLOTS, kv_buf_len=KV_BUF_LEN, prompt_bucket=PROMPT_BUCKET)
    if engine == "paged":
        kw.update(quantize_kv="int8", kv_block_len=KV_BLOCK_LEN, prefill_chunk=PREFILL_CHUNK)
    body = {"question": QUESTIONS[0], "greedy": True, "max_new_tokens": MAX_NEW_TOKENS}
    with _Serving(server_mod, generator, **kw) as srv:
        status, data, _, _ = _http(srv.base, "/v1/generate", body)
        (_, generated), = srv.results
    check(status == 200, f"{engine} /v1/generate: HTTP {status}")
    answer = json.loads(data)["answer"]
    fa.paged_decode_attention.launches = 0  # count the stream's launches only
    with _Serving(server_mod, generator, **kw) as srv:
        status, events, first_s, total_s = _sse(srv.base, body)
        launches = fa.paged_decode_attention.launches
        stats = srv.engine.stats_snapshot()
        (_, streamed), = srv.results
        ttft_s = _hist(srv.engine, "ttft_s")[0]
    check(streamed == generated, f"{engine}: /v1/stream's tokens {streamed} != /v1/generate's "
                                 f"{generated}")
    check(status == 200, f"{engine} /v1/stream: HTTP {status}")
    check(all(name == "message" for name, _ in events), f"{engine} /v1/stream: {events[-1]}")
    *deltas, done = [payload for _, payload in events]
    check(done == {"done": True, "n_tokens": stats["tokens_served"]},
          f"{engine} /v1/stream: last event {done}, tokens_served {stats['tokens_served']}")
    text = "".join(d["delta"] for d in deltas)
    check(text.strip() == answer,
          f"{engine} /v1/stream deltas {text.strip()!r} != /v1/generate {answer!r}")
    layers = generator.config.num_layers
    want = layers * stats["decode_steps"] if engine == "paged" else 0
    check(launches == want, f"{engine} /v1/stream: {launches} paged decode launches, want {want}")
    steps = f" == {layers} x {stats['decode_steps']} decode steps" if engine == "paged" else ""
    phase(15, f"{engine} /v1/stream: HTTP 200, {done['n_tokens']} tokens == /v1/generate's, "
              f"{len(deltas)} deltas == its answer ({len(answer)} chars), engine TTFT "
              f"{ttft_s:.3f} s, first event {first_s:.3f} s, whole stream {total_s:.3f} s, "
              f"paged decode launches {launches}{steps}")
    return {"deltas": len(deltas), "n_tokens": done["n_tokens"], "answer_chars": len(answer),
            "ttft_s": ttft_s, "first_event_s": first_s, "stream_s": total_s,
            "launches": launches, "decode_steps": stats["decode_steps"]}


def engines_phase(tf, gen_mod, server_mod, fa, generator):
    """Phase 15: phase 4's traffic on the dense engines (continuous, then
    window), their tokens held to solo runs by the margin rule; then
    /v1/stream on continuous and paged."""
    runs = {e: serve_phase(server_mod, fa, generator, phase_no=15, engine=e)
            for e in ("continuous", "window")}
    solo = {}
    for prompt, _ in runs["continuous"]["results"][1:]:
        solo[tuple(prompt)] = solo_decode(tf, gen_mod, generator, prompt, MAX_NEW_TOKENS)
    for engine, rec in runs.items():
        agree, first_diff = [], []
        for i, (prompt, ids) in enumerate(rec["results"][1:]):
            n, at = margin_agreement(tf, generator, f"{engine} request {i}", prompt, ids,
                                     solo[tuple(prompt)])
            agree.append(n)
            first_diff.append(at)
        rec["tokens_agreeing_with_solo"] = agree
        rec["first_difference"] = first_diff
        rec["solo_tokens"] = [len(solo[tuple(p)][0]) for p, _ in rec["results"][1:]]
        phase(15, f"{engine}: tokens equal to the solo run's, per request: {agree} of "
                  f"{rec['solo_tokens']}")
        for i, at in enumerate(first_diff):
            if at:
                phase(15, f"  {engine} request {i}: token {at['token']} differs at a solo top-2 "
                          f"margin {at['margin']:.3e} <= bound {at['bound']:.3e} (no-cache "
                          f"max|dlogits| {at['max_abs_dlogits_no_cache']:.3e})")
    cont, win = runs["continuous"], runs["window"]
    phase(15, f"continuous: {cont['tokens_per_s_concurrent']:.1f} tokens/s over the 4 concurrent "
              f"requests' {cont['window_s']:.3f} s window, TTFT (engine ttft_s) mean "
              f"{cont['ttft_s_concurrent_mean']:.3f} s (warm-up {cont['ttft_s_warmup']:.3f} s), "
              f"mean decode tick {cont['decode_step_ms_mean_concurrent']:.2f} ms, dense cache "
              f"{cont['cache_bytes']} bytes ({cont['cache_bytes'] / 1e9:.3f} GB; memory_allocated "
              f"+{cont['engine_bytes']} at the engine's start)")
    phase(15, f"window: {win['tokens_per_s_concurrent']:.1f} tokens/s over the 4 concurrent "
              f"requests' {win['window_s']:.3f} s window, TTFT (request wall time, the whole "
              f"answer) mean {statistics.mean(win['request_s_concurrent']):.3f} s, decode tick not "
              f"measured (one generate_batch per group)")
    mc = generator.config
    want = (2 * mc.num_layers * SLOTS * KV_BUF_LEN * mc.num_kv_heads * mc.resolved_head_dim
            * torch.finfo(generator.compute_dtype).bits // 8)
    check(cont["cache_bytes"] == want, f"dense cache {cont['cache_bytes']} bytes != {want}")
    check(want <= cont["engine_bytes"] <= want + 2**26,
          f"memory_allocated grew {cont['engine_bytes']} bytes at the engine's start, cache {want}")
    streams = {e: stream_phase(server_mod, fa, generator, e) for e in ("continuous", "paged")}
    tokens = [ids for _, ids in runs["continuous"]["results"][1:]]
    for rec in runs.values():
        rec.pop("results")
    # phase 16 holds its tokens to the same solo runs (popped there)
    return {**runs, "stream": streams, "solo": solo, "continuous_tokens": tokens}


def int8_kv_noise(tf, generator, prompt):
    """max|dlogits| of the last prompt position between a prefill through a
    fresh int8 block pool and the dense solo prefill: the int8 KV pool's own
    error, which phase 16b's margin rule allows beside bf16 rounding."""
    config, dtype = generator.config, generator.compute_dtype
    L = KV_BLOCK_LEN
    nblocks = -(-len(prompt) // L)
    pool = tf.init_paged_cache(config, 1 + nblocks, L, dtype=dtype, kv_quant="int8",
                               device=DEVICE)
    table = torch.arange(1, 1 + nblocks, dtype=torch.int32, device=DEVICE)[None, :]
    ids = torch.tensor([list(prompt)], device=DEVICE)
    with torch.no_grad():
        paged, _ = tf.forward(generator.params, ids, config, cache=pool, cache_pos=0,
                              block_tables=table, compute_dtype=dtype, output_hidden=True)
        dense, _ = tf.forward(generator.params, ids, config, compute_dtype=dtype,
                              output_hidden=True)
        a = tf.unembed(generator.params, paged[:, -1], config, compute_dtype=dtype)
        b = tf.unembed(generator.params, dense[:, -1], config, compute_dtype=dtype)
    return (a - b).abs().max().item()


def hold_to_solo(tf, generator, label, rec, solo, floor=0.0, phase_no=16):
    """Each of a run's 4 requests against its solo run by the margin rule;
    the agreeing counts go into ``rec``."""
    agree, first_diff = [], []
    for i, (prompt, ids) in enumerate(rec["results"][1:]):
        n, at = margin_agreement(tf, generator, f"{label} request {i}", prompt, ids,
                                 solo[tuple(prompt)], floor=floor)
        agree.append(n)
        first_diff.append(at)
    rec["tokens_agreeing_with_solo"] = agree
    rec["first_difference"] = first_diff
    phase(phase_no, f"{label}: tokens equal to the solo run's, per request: {agree} of "
                    f"{[len(solo[tuple(p)][0]) for p, _ in rec['results'][1:]]}")
    for i, at in enumerate(first_diff):
        if at:
            phase(phase_no, f"  {label} request {i}: token {at['token']} differs at a solo top-2 "
                            f"margin {at['margin']:.3e} <= bound {at['bound']:.3e}")


def dense_slots(generator, prompts):
    """A fresh dense 8 x 4096 slot state with the prompts prefilled into
    slots 0..n-1 (greedy): (cache, state, live, each slot's tokens so far)."""
    from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig

    greedy = GenerationConfig(max_new_tokens=MAX_NEW_TOKENS, do_sample=False,
                              speculative_lookup=SPEC_K)
    cache, state = generator.init_slot_state(SLOTS, KV_BUF_LEN)
    ctx = []
    for slot, p in enumerate(prompts):
        bucket = -(-len(p) // PROMPT_BUCKET) * PROMPT_BUCKET
        padded = np.zeros((1, bucket), np.int64)
        padded[0, : len(p)] = p
        first = generator.slot_prefill(cache, state, padded, len(p), slot, greedy, 0)
        ctx.append(list(p) + [first])
    return cache, state, np.arange(SLOTS) < len(prompts), ctx


def lookup_drafts(engine_mod, ctx):
    """Prompt-lookup drafts of the live slots' contexts, as the engine
    proposes them: ``(drafts [SLOTS, K], n_draft [SLOTS])``."""
    drafts = np.zeros((SLOTS, SPEC_K), np.int64)
    n_draft = np.zeros((SLOTS,), np.int64)
    for slot, c in enumerate(ctx):
        found = engine_mod._prompt_lookup(np.asarray(c, np.int64), SPEC_K)
        drafts[slot, : found.size] = found
        n_draft[slot] = found.size
    return drafts, n_draft


def without_syncs(gen_mod, run):
    """``run()`` under ``torch.cuda.set_sync_debug_mode("error")``, but for
    the spec tick's one transfer of its tokens (``_spec_readback``): any
    other synchronizing call in the tick raises."""
    orig = gen_mod.Generator.__dict__["_spec_readback"]

    def guarded(toks, n_emit):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return orig.__func__(toks, n_emit)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    gen_mod.Generator._spec_readback = staticmethod(guarded)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        gen_mod.Generator._spec_readback = orig


def record_rejections(generator):
    """Wrap ``generator``'s spec verify: for every live slot whose run ended
    on a rejected draft, the gap between the verify's penalized logit of
    its own token and of the draft (>= 0), kept on the device. Returns the
    list of (gaps [S], rejected [S]) per tick; ``rejection_gaps`` reads it."""
    verify = generator._spec_verify
    pending = []

    def recording(state, live, drafts, n_draft, logits_all):
        seen = state["seen"].clone()
        toks, n_emit, live_t = verify(state, live, drafts, n_draft, logits_all)
        slots, k1 = toks.shape
        rows = torch.arange(slots, device=toks.device)
        i = (n_emit - 1).clamp(min=0)  # the run's last position
        for j in range(k1 - 1):  # the tokens taken before position i
            seen[rows, toks[:, j].clamp(min=0)] |= (j < i) & (toks[:, j] >= 0)
        logits = logits_all[rows, i]
        pen = state["repetition_penalty"][:, None]
        pen = torch.where(seen, torch.where(logits > 0, logits / pen, logits * pen), logits)
        d = drafts[rows, i.clamp(max=k1 - 2)]
        gap = pen[rows, toks[rows, i].clamp(min=0)] - pen[rows, d]
        pending.append((gap, live_t & (i < n_draft)))
        return toks, n_emit, live_t

    generator._spec_verify = recording
    return pending


def rejection_gaps(pending):
    return [g for gap, rejected in pending for g, r in zip(gap.tolist(), rejected.tolist()) if r]


def self_draft_f32(gen_mod, engine_mod, generator, prompts):
    """Phase 16c in f32 (phase 13's precision): the 4 prompts through a
    continuous engine whose draft is the target, in process. Rounding sits
    at 2**-24, far below the random model's bf16 near-ties, so acceptance
    must reach 0.9 here (1.0 on the CPU)."""
    from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    params = {k: v.float() for k, v in generator.params.items()}
    gen32 = gen_mod.Generator(params, generator.config, generator.tokenizer,
                              compute_dtype=torch.float32, device=DEVICE, draft_params=params,
                              draft_config=generator.config)
    engine = engine_mod.ContinuousBatchingEngine(gen32, slots=SLOTS, buf_len=KV_BUF_LEN,
                                                 prompt_bucket=PROMPT_BUCKET, speculative_k=SPEC_K)
    cfg = GenerationConfig(max_new_tokens=MAX_NEW_TOKENS, do_sample=False,
                           speculative_lookup=SPEC_K)
    try:
        done = [None] * len(prompts)
        threads = [threading.Thread(target=lambda i=i: done.__setitem__(
            i, engine.submit_full(prompts[i], cfg, timeout=600))) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
            check(not t.is_alive(), "an f32 self-draft request did not finish")
        stats = engine.stats_snapshot()
    finally:
        engine.close()
    rate = stats["draft_acceptance_rate"]
    check(all(r is not None and len(r.result) >= 1 for r in done), "f32 self-draft: no answer")
    check(rate >= SELF_DRAFT_MIN_ACCEPTANCE,
          f"f32 self-draft acceptance {rate:.3f} < {SELF_DRAFT_MIN_ACCEPTANCE}")
    phase(16, f"16c in f32: self-draft acceptance {rate:.3f} ({stats['draft_tokens_accepted']} of "
              f"{stats['draft_tokens_proposed']}), {stats['mean_tokens_per_step']:.3f} tokens per "
              f"step (limit {SELF_DRAFT_MIN_ACCEPTANCE})")
    del engine, gen32, params
    gc_cuda()
    return {k: stats[k] for k in ("draft_tokens_proposed", "draft_tokens_accepted",
                                  "draft_acceptance_rate", "mean_tokens_per_step",
                                  "decode_steps")}


def spec_phase(tf, gen_mod, engine_mod, server_mod, fa, generator, engines, served, prompts):
    """Phase 16: speculation (K = 4) through the server on phase 4's
    weights and traffic: (a) continuous with prompt lookup, (b) paged over
    an int8 pool, (c) continuous with the target as its own draft; each
    request's tokens held to its solo run by phase 15's margin rule; then
    (e) one plain and one speculative continuous tick profiled, and spec
    ticks run with every synchronizing call but the tokens' transfer an
    error."""
    solo = engines.pop("solo")
    plain_tokens = engines.pop("continuous_tokens")
    out = {"seconds": {}}
    t0 = time.monotonic()

    def lap(name):
        nonlocal t0
        out["seconds"][name] = time.monotonic() - t0
        phase(16, f"16{name} took {out['seconds'][name]:.1f} s")
        t0 = time.monotonic()

    rec = serve_phase(server_mod, fa, generator, phase_no=16, engine="continuous", spec=SPEC_K)
    hold_to_solo(tf, generator, "16a continuous --speculative 4", rec, solo)
    rec["tokens_agreeing_with_phase_15"] = [
        next((t for t, (a, b) in enumerate(zip(ids, want)) if a != b), min(len(ids), len(want)))
        for (_, ids), want in zip(rec["results"][1:], plain_tokens)]
    out["continuous"] = rec
    lap("a")

    noise = int8_kv_noise(tf, generator, prompts[0])
    rec = serve_phase(server_mod, fa, generator, phase_no=16, engine="paged", spec=SPEC_K)
    rec["int8_kv_max_abs_dlogits"] = noise
    hold_to_solo(tf, generator, "16b paged int8 --speculative 4", rec, solo, floor=2 * noise)
    phase4 = {tuple(p): ids for p, ids in served["results"][1:]}
    held = {"results": [(None, None)] + [(p, phase4[tuple(p)]) for p, _ in rec["results"][1:]]}
    hold_to_solo(tf, generator, "16b phase 4's own tokens (paged int8, plain)", held, solo,
                 floor=2 * noise)
    rec["phase_4_tokens_agreeing_with_solo"] = held["tokens_agreeing_with_solo"]
    rec["tokens_agreeing_with_phase_4"] = [
        next((t for t, (a, b) in enumerate(zip(ids, phase4[tuple(p)])) if a != b),
             min(len(ids), len(phase4[tuple(p)])))
        for p, ids in rec["results"][1:]]
    phase(16, f"16b: int8 KV max|dlogits| at the prompt's last position {noise:.3e} (bound floor "
              f"{2 * noise:.3e}); tokens equal to phase 4's: {rec['tokens_agreeing_with_phase_4']}")
    out["paged_int8"] = rec
    lap("b")

    self_gen = gen_mod.Generator(generator.params, generator.config, generator.tokenizer,
                                 compute_dtype=generator.compute_dtype, device=DEVICE,
                                 draft_params=generator.params, draft_config=generator.config)
    check(self_gen.draft_params is self_gen.params and all(
        self_gen.params[k] is generator.params[k] for k in generator.params),
        "the self-draft holds a second copy of the weights")
    pending = record_rejections(self_gen)
    rec = serve_phase(server_mod, fa, self_gen, phase_no=16, engine="continuous", spec=SPEC_K)
    rejected = rejection_gaps(pending)
    del self_gen._spec_verify  # the class's own again
    hold_to_solo(tf, generator, "16c continuous self-draft", rec, solo)
    mc = generator.config
    want = (2 * mc.num_layers * SLOTS * KV_BUF_LEN * mc.num_kv_heads * mc.resolved_head_dim
            * torch.finfo(generator.compute_dtype).bits // 8)
    check(rec["draft_cache_bytes"] == want,
          f"draft cache {rec['draft_cache_bytes']} bytes != {want} (dense 8 x 4096 bf16)")
    # a draft equal to the target disagrees with the verify only where bf16
    # rounding can flip the argmax: every rejected draft must sit within
    # the margin rule's bound (the largest phase 15 and 16a-c measured) of
    # the verify's choice
    bounds = [at["bound"] for r in (engines["continuous"], out["continuous"], rec)
              for at in r["first_difference"] if at]
    gap_bound = max(bounds) if bounds else 0.0
    rec["rejected_drafts"] = len(rejected)
    rec["largest_rejection_gap"] = max(rejected, default=0.0)
    rec["rejection_gap_bound"] = gap_bound
    check(rec["largest_rejection_gap"] <= gap_bound,
          f"a self-draft was rejected where the verify preferred its own token by "
          f"{rec['largest_rejection_gap']:.3e} > the margin rule's {gap_bound:.3e}")
    phase(16, f"16c: {len(rejected)} rejected self-drafts (acceptance "
              f"{rec['draft_acceptance_rate']:.3f}), each where the verify's penalized logit of its "
              f"own token exceeds the draft's by at most {rec['largest_rejection_gap']:.3e} "
              f"(bound {gap_bound:.3e}: bf16 near-ties)")
    out["self_draft"] = rec
    out["self_draft_f32"] = self_draft_f32(gen_mod, engine_mod, generator, prompts)
    lap("c")
    for name in ("continuous", "paged_int8", "self_draft"):
        r = out[name]
        r.pop("results")
        phase(16, f"{name}: {r['tokens_per_s_concurrent']:.1f} tokens/s over the 4 concurrent "
                  f"requests' {r['window_s']:.3f} s window, engine TTFT mean "
                  f"{r['ttft_s_concurrent_mean']:.3f} s (warm-up {r['ttft_s_warmup']:.3f} s), "
                  f"mean decode tick {r['decode_step_ms_mean_concurrent']:.2f} ms, draft "
                  f"acceptance {r['draft_acceptance_rate']:.3f}, {r['mean_tokens_per_step']:.3f} "
                  f"tokens per step, repetitive question {r['repetitive']}"
                  + (f", draft cache {r['draft_cache_bytes']} bytes" if r["draft_cache_bytes"]
                     else ""))

    # (e) one plain and one speculative tick at 4 live rows of 8, profiled
    cache0, state0, live, _ = dense_slots(generator, prompts)
    plain = profile_ticks(lambda: generator.slot_step(cache0, state0, live), 5)
    cache, state, live, ctx = dense_slots(generator, prompts)

    def spec_tick():
        drafts, n_draft = lookup_drafts(engine_mod, ctx)
        toks, n_emit = generator.spec_slot_step(cache, state, live, drafts, n_draft)
        for slot in range(len(ctx)):
            ctx[slot] += toks[slot, : n_emit[slot]].tolist()
        return n_emit

    spec = profile_ticks(spec_tick, 5)
    emitted = spec_tick()[: len(prompts)]
    # host time spreads between calls: time both again in turns, spec then
    # plain, on the states already warm
    for name, rec, tick in (("speculative", spec, spec_tick),
                            ("plain", plain, lambda: generator.slot_step(cache0, state0, live))):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(5):
            tick()
        torch.cuda.synchronize()
        rec["step_ms_again"] = (time.monotonic() - t0) * 1e3 / 5
    del cache, state, cache0, state0
    for name, r in (("plain", plain), ("speculative", spec)):
        phase(16, f"16e {name} continuous tick at {len(prompts)} live rows of {SLOTS}: "
                  f"{r['step_ms']:.2f} ms, again {r['step_ms_again']:.2f} ms "
                  f"({r['profiled_step_ms']:.2f} ms profiled), device busy "
                  f"{100 * (r['device_busy_share'] or 0):.1f}%, {r['device_kernels_per_step']:.0f} "
                  f"device kernels and {r['device_ms_per_step']:.3f} ms of device time per tick")
        for row in r["top_kernels"]:
            phase(16, f"  {row['ms_per_step']:8.3f} ms/tick  {row['calls_per_step']:6.1f} calls  "
                      f"{row['name']}")
    out["tick_profile"] = {"plain": plain, "speculative": spec,
                           "tokens_per_tick_last": emitted.tolist()}

    # spec ticks with every synchronizing call but the transfer an error
    synced = {}
    cache, state, live, ctx = dense_slots(generator, prompts)
    drafts, n_draft = lookup_drafts(engine_mod, ctx)
    synced["dense_lookup"] = without_syncs(
        gen_mod, lambda: generator.spec_slot_step(cache, state, live, drafts, n_draft))[1]
    del cache, state
    cache, state, live, ctx = dense_slots(self_gen, prompts)
    dcache = self_gen.init_draft_slot_cache(SLOTS, KV_BUF_LEN)
    for slot, c in enumerate(ctx):
        padded = np.zeros((1, -(-(len(c) - 1) // PROMPT_BUCKET) * PROMPT_BUCKET), np.int64)
        padded[0, : len(c) - 1] = c[:-1]
        self_gen.draft_slot_prefill(dcache, padded, slot)
    window = np.zeros((SLOTS, SPEC_K + 1), np.int64)
    start = np.zeros((SLOTS,), np.int64)
    for slot, c in enumerate(ctx):
        start[slot] = len(c) - 1 - SPEC_K
        window[slot] = c[start[slot]:]
    n_draft = np.where(live, SPEC_K, 0)
    synced["dense_self_draft"] = without_syncs(gen_mod, lambda: self_gen.spec_slot_step(
        cache, state, live, self_gen.draft_slot_step(dcache, state, window, start), n_draft))[1]
    del cache, state, dcache
    pool, state, live, tables, _, ctx = paged_slots(generator, prompts, 5)
    drafts, n_draft = lookup_drafts(engine_mod, ctx)
    synced["paged_int8_lookup"] = without_syncs(
        gen_mod, lambda: generator.spec_paged_step(pool, state, live, tables, drafts, n_draft))[1]
    del pool, state
    synced = {k: v.tolist() for k, v in synced.items()}
    live_rows = len(prompts)
    check(all(1 <= n <= SPEC_K + 1 for v in synced.values() for n in v[:live_rows])
          and not any(n for v in synced.values() for n in v[live_rows:]),
          f"a spec tick emitted {synced}: each live slot 1..K+1 tokens, a dead one none")
    phase(16, f"spec ticks under set_sync_debug_mode('error') but for the tokens' transfer: "
              f"tokens per slot {synced}")
    out["sync_free_ticks"] = synced
    del self_gen
    gc_cuda()
    lap("e")
    return out


def f32_step_phase(tf, fa, params_bf16, config, prompt_ids):
    """One full-width decode step in f32 through ``forward``: the kernel
    against its plain version on the same prefilled int8 pool."""
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    params = {k: v.float() for k, v in params_bf16.items()}
    plen = len(prompt_ids)
    L = KV_BLOCK_LEN
    nblocks = -(-(plen + 1) // L)
    pool = tf.init_paged_cache(config, 1 + nblocks, L, kv_quant="int8", device=DEVICE)
    table = torch.arange(1, 1 + nblocks, dtype=torch.int32, device=DEVICE)[None, :]
    ids = torch.tensor([prompt_ids], dtype=torch.long, device=DEVICE)
    with torch.no_grad():
        logits, _ = tf.forward(params, ids, config, cache=pool, cache_pos=0,
                               block_tables=table, compute_dtype=torch.float32)
        nxt = logits[:, -1].argmax(-1)[:, None]
        pos = torch.tensor([plen], dtype=torch.long, device=DEVICE)
        out = {}
        for name, fn in (("kernel", fa.paged_decode_attention),
                         ("plain", fa.paged_decode_attention_reference)):
            step_pool = {"layers": {i: {n: t.clone() for n, t in e.items()}
                                    for i, e in pool["layers"].items()}}
            out[name], _ = tf.forward(params, nxt, config, cache=step_pool, cache_pos=pos,
                                      block_tables=table, compute_dtype=torch.float32,
                                      decode_attention=fn)
    torch.cuda.synchronize()
    a, b = out["kernel"], out["plain"]
    check(bool(torch.isfinite(a).all()), "f32 decode logits not finite")
    check(a.shape == (1, 1, config.vocab_size), f"logits shape {tuple(a.shape)}")
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    check(err <= LOGIT_REL_TOL * scale,
          f"f32 decode step: max|dlogits| {err:.3e} > {LOGIT_REL_TOL} x max|logits| {scale:.3e}")
    phase(5, f"f32 decode step after a {plen}-token prefill: max|dlogits| {err:.3e} "
             f"(bound {LOGIT_REL_TOL * scale:.3e} = {LOGIT_REL_TOL} x {scale:.3e})")
    del params
    return {"max_abs_dlogits": err, "max_abs_logits": scale, "prompt_tokens": plen}


def _device_events(prof):
    """(name, start_us, end_us) of every device-side event of a profile."""
    out = []
    for e in prof.events():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def paged_slots(generator, prompts, steps, view=None, adapter_idx=None):
    """A fresh int8 pool of the main path's geometry with the prompts
    prefilled into slots 0..n-1 (greedy), blocks for ``steps`` + 2 more
    positions each: (pool, state, live, tables at the nb bucket, nb, each
    slot's tokens so far). ``view`` (an adapter registry's pooled
    parameters) and ``adapter_idx`` (a pool slot per prompt) put each
    prompt on its adapter."""
    from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig

    L = KV_BLOCK_LEN
    table_blocks = -(-(KV_BUF_LEN + PROMPT_BUCKET) // L)
    num_blocks = 1 + (SLOTS + 1) * table_blocks
    pool, state = generator.init_paged_state(SLOTS, num_blocks, L, kv_quant="int8")
    if view is not None:
        state["params"] = view
    table = np.zeros((SLOTS, table_blocks), np.int32)
    greedy = GenerationConfig(max_new_tokens=MAX_NEW_TOKENS, do_sample=False)
    nxt = 1
    ctx = []
    for slot, p in enumerate(prompts):
        bucket = -(-len(p) // PROMPT_BUCKET) * PROMPT_BUCKET
        need = -(-(bucket + steps + 2) // L)
        table[slot, :need] = np.arange(nxt, nxt + need)
        nxt += need
        padded = np.zeros((1, bucket), np.int64)
        padded[0, : len(p)] = p
        seen = np.zeros((1, generator.config.vocab_size), bool)
        seen[0, p] = True
        first = generator.paged_prefill_final(pool, state, table[slot: slot + 1], padded, 0,
                                              len(p), seen, slot, greedy, 0,
                                              *([adapter_idx[slot]] if adapter_idx else []))
        ctx.append(list(p) + [first])
    live = np.arange(SLOTS) < len(prompts)
    in_use = max(-(-(len(p) + steps + 2) // L) for p in prompts)
    nb = 1 << (in_use - 1).bit_length()
    tables = np.ascontiguousarray(np.where(live[:, None], table, 0)[:, :nb])
    return pool, state, live, tables, nb, ctx


def profile_phase(generator, prompts, steps=5, phase_no=6):
    """Decode steps at the main path's occupancy (the prompts prefilled into
    slots 0..n-1 of a fresh int8 pool, the other slots dead), timed with a
    synchronize around them and then profiled: device time by kernel name
    and the device's busy share of the wall time."""
    pool, state, live, tables, nb, _ = paged_slots(generator, prompts, steps)
    result = {"steps": steps, "live_rows": len(prompts), "nb": nb,
              **profile_ticks(lambda: generator.paged_step(pool, state, live, tables), steps)}
    phase(phase_no, f"decode step at {len(prompts)} live rows, nb={nb}: {result['step_ms']:.2f} ms "
             f"({result['profiled_step_ms']:.2f} ms profiled), device busy "
             f"{100 * (result['device_busy_share'] or 0):.1f}%, "
             f"{result['device_kernels_per_step']:.0f} device kernels per step, "
             f"{result['device_ms_per_step']:.3f} ms of device time per step")
    for row in result["top_kernels"]:
        phase(phase_no, f"  {row['ms_per_step']:8.3f} ms/step  {row['calls_per_step']:6.1f} calls  {row['name']}")
    if not result["device_kernels_per_step"]:
        phase(phase_no, "the profiler recorded no device events")
    return result


def profile_ticks(tick, steps):
    """``tick()`` twice to warm up, ``steps`` times timed with a
    synchronize around them, then ``steps`` times under ``torch.profiler``:
    device time by kernel name and the device's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        tick()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        tick()
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) * 1e3 / steps
    # the device's activity alone: every number here is read from device
    # events, and the host's op events only cost their processing
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            tick()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    events = _device_events(prof)
    by_name: dict = {}
    for name, a, b in events:
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + (b - a), n + 1)
    busy = 0.0
    end = None
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "step_ms": step_ms,
        "profiled_step_ms": wall_us / 1e3 / steps,
        "device_busy_share": busy / wall_us if events else None,
        "device_kernels_per_step": len(events) / steps,
        "device_ms_per_step": sum(b - a for _, a, b in events) / 1e3 / steps,
        "top_kernels": [
            {"name": name[:90], "ms_per_step": tot / 1e3 / steps, "calls_per_step": n / steps}
            for name, (tot, n) in top
        ],
    }


def dense_phase(tf, gen_mod, engine_mod, params_bf16, config, tokenizer, prompt_ids):
    """Phase 13: dense-cache greedy generation at full width in f32, held
    step by step against a no-cache forward and token by token against the
    paged engine on a bf16-layout pool."""
    from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    params = {k: v.float() for k, v in params_bf16.items()}
    greedy = GenerationConfig(max_new_tokens=DENSE_STEPS + 1, do_sample=False,
                              repetition_penalty=1.0)
    generator = gen_mod.Generator(params, config, tokenizer, compute_dtype=torch.float32,
                                  eos_token_ids=[], device=DEVICE)
    t0 = time.monotonic()
    dense = generator.generate_ids(prompt_ids, greedy)
    dense_s = time.monotonic() - t0
    check(len(dense) == DENSE_STEPS + 1, f"generate_ids gave {len(dense)} tokens")

    plen = len(prompt_ids)
    bucket = -(-plen // gen_mod._PROMPT_BUCKET) * gen_mod._PROMPT_BUCKET
    cache = tf.init_cache(config, 1, bucket + DENSE_STEPS + 1, dtype=torch.float32, device=DEVICE)
    padded = torch.zeros(1, bucket, dtype=torch.long, device=DEVICE)
    padded[0, :plen] = torch.tensor(prompt_ids, device=DEVICE)

    def last_logits(hidden, at):
        return tf.unembed(params, hidden[:, at], config, compute_dtype=torch.float32)[0]

    steps = []
    with torch.no_grad():
        hidden, _ = tf.forward(params, padded, config, cache=cache, cache_pos=0,
                               compute_dtype=torch.float32, output_hidden=True)
        cached = last_logits(hidden, plen - 1)
        for t in range(DENSE_STEPS + 1):
            if t:  # token t reads token t - 1 at position plen + t - 1
                tok = torch.tensor([[dense[t - 1]]], device=DEVICE)
                hidden, _ = tf.forward(params, tok, config, cache=cache, cache_pos=plen + t - 1,
                                       compute_dtype=torch.float32, output_hidden=True)
                cached = last_logits(hidden, -1)
            full = torch.tensor([list(prompt_ids) + dense[:t]], device=DEVICE)
            hidden, _ = tf.forward(params, full, config, compute_dtype=torch.float32,
                                   output_hidden=True)
            plain = last_logits(hidden, -1)
            top2 = torch.topk(cached, 2).values
            steps.append({"max_abs_dlogits": (cached - plain).abs().max().item(),
                          "max_abs_logits": plain.abs().max().item(),
                          "margin": (top2[0] - top2[1]).item(),
                          "argmax": int(cached.argmax())})
    for t, st in enumerate(steps):
        bound = LOGIT_REL_TOL * st["max_abs_logits"]
        check(st["max_abs_dlogits"] <= bound,
              f"dense step {t}: max|dlogits| {st['max_abs_dlogits']:.3e} > {bound:.3e}")
        check(st["argmax"] == dense[t], f"dense step {t}: argmax {st['argmax']} != {dense[t]}")
    phase(13, f"dense cache, f32, {plen}-token prompt: {DENSE_STEPS} decode steps, max|dlogits| "
              f"vs a no-cache forward {max(st['max_abs_dlogits'] for st in steps):.3e} (bound "
              f"{LOGIT_REL_TOL} x max|logit|, at least "
              f"{min(LOGIT_REL_TOL * st['max_abs_logits'] for st in steps):.3e}); "
              f"generate_ids {dense_s:.3f} s for {len(dense)} tokens")

    engine = engine_mod.PagedContinuousBatchingEngine(
        generator, slots=1, buf_len=2048, prompt_bucket=PROMPT_BUCKET, block_len=KV_BLOCK_LEN,
        prefill_chunk=PREFILL_CHUNK, kv_quant="none")
    try:
        paged = engine.submit(prompt_ids, greedy, timeout=600)
    finally:
        engine.close()
    agree = 0
    for t, (a, b) in enumerate(zip(dense, paged)):
        if a != b:  # the contexts differ from here on
            bound = 2 * LOGIT_REL_TOL * steps[t]["max_abs_logits"]
            check(steps[t]["margin"] <= bound,
                  f"step {t}: dense token {a} != paged {b} at top-2 margin "
                  f"{steps[t]['margin']:.3e} > {bound:.3e}")
            break
        agree += 1
    check(len(paged) == len(dense), f"paged engine gave {len(paged)} tokens")
    margin = min(st["margin"] for st in steps[:agree + 1])  # the steps compared
    phase(13, f"paged engine (f32, bf16-layout pool): {agree} of {len(dense)} tokens equal the "
              f"dense path's; smallest top-2 logit margin {margin:.3e}")
    del params, generator, cache
    return {"prompt_tokens": plen, "tokens": dense, "paged_tokens": paged,
            "tokens_agreeing": agree, "smallest_margin": margin, "steps": steps,
            "generate_ids_s": dense_s}


ASK_PATTERNS = {
    "load": r"Loaded in (\S+) s: (\d+) bytes of weights on .* memory_allocated \+(\d+) bytes",
    "answer": r"^Answer: (.*)$",
    "rate": r"^\[ask\] (\d+) tokens in (\S+) s \((\S+) tokens/s\)",
}


def ask_phase(cli_mod, model_dir):
    """Phase 14a: ``cli.ask_main`` on phase 8's ``best_model/``, greedy, in
    bf16 and with ``--quantize int8``; its output is echoed and parsed."""
    import contextlib
    import io
    import re

    out = {}
    for quantize in ("none", "int8"):
        argv = ["--model-dir", model_dir, "--greedy", "--max-new-tokens", str(MAX_NEW_TOKENS),
                "--quantize", quantize, QUESTIONS[0]]
        buf = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            rc = cli_mod.ask_main(argv)
        wall = time.monotonic() - t0
        text = buf.getvalue()
        for line in text.splitlines():
            phase(14, f"  | {line}")
        check(rc == 0, f"ask_main --quantize {quantize} returned {rc}")
        found = {k: re.search(p, text, re.M) for k, p in ASK_PATTERNS.items()}
        check(all(found.values()), f"ask_main --quantize {quantize}: output lacks "
                                   f"{[k for k, m in found.items() if not m]}")
        load_s, weight_bytes, allocated = found["load"].groups()
        tokens, gen_s, rate = found["rate"].groups()
        out[quantize] = {"load_s": float(load_s), "weight_bytes": int(weight_bytes),
                         "memory_allocated_bytes": int(allocated), "tokens": int(tokens),
                         "generate_s": float(gen_s), "tokens_per_s": float(rate),
                         "wall_s": wall, "answer": found["answer"].group(1)}
        gc_cuda()
        r = out[quantize]
        phase(14, f"ask --quantize {quantize}: load {r['load_s']:.3f} s, weights on the card "
                  f"{r['memory_allocated_bytes'] / 1e9:.3f} GB (memory_allocated; tensors "
                  f"{r['weight_bytes'] / 1e9:.3f} GB), {r['tokens']} tokens in "
                  f"{r['generate_s']:.3f} s ({r['tokens_per_s']:.2f} tokens/s), wall to the "
                  f"answer {wall:.3f} s")
    check(out["int8"]["memory_allocated_bytes"] <= INT8_WEIGHT_BYTES_MAX,
          f"int8 weights take {out['int8']['memory_allocated_bytes']} bytes > "
          f"{INT8_WEIGHT_BYTES_MAX:.3g}")
    return out


def ask_spec_phase(cli_mod, tf, gen_mod, model_dir, recorded, plain_generator):
    """Phase 16d: ``cli.ask_main`` on phase 8's ``best_model/`` with
    ``--speculative 4`` (prompt lookup), then with ``--draft-dir`` the same
    directory (a self-draft). ``recorded`` holds the (prompt, token ids) of
    every ``Generator.generate_ids`` call, phase 14's bf16 ask first, whose
    Generator is ``plain_generator``; each speculative answer's tokens are
    held to it, and where they differ, to the solo run by phase 15's margin
    rule."""
    import contextlib
    import io
    import re

    t_start = time.monotonic()
    plain_prompt, plain_ids = recorded[0]
    out = {}
    for label, extra in (("lookup", []), ("draft_dir", ["--draft-dir", model_dir])):
        n = len(recorded)
        argv = ["--model-dir", model_dir, "--greedy", "--max-new-tokens", str(MAX_NEW_TOKENS),
                "--speculative", str(SPEC_K)] + extra + [QUESTIONS[0]]
        buf = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            rc = cli_mod.ask_main(argv)
        wall = time.monotonic() - t0
        text = buf.getvalue()
        for line in text.splitlines():
            phase(16, f"  | {line}")
        check(rc == 0, f"ask_main --speculative ({label}) returned {rc}")
        ((prompt, ids),) = recorded[n:]
        check(prompt == plain_prompt, "the speculative ask built another prompt")
        rate = re.search(ASK_PATTERNS["rate"], text, re.M)
        spec = re.search(r"^\[speculative\] (\d+) sequential forwards, draft acceptance (\d+)%",
                         text, re.M)
        check(rate is not None and spec is not None, f"ask --speculative ({label}): output lacks "
                                                     "its [ask] or [speculative] line")
        out[label] = {"tokens": int(rate.group(1)), "generate_s": float(rate.group(2)),
                      "tokens_per_s": float(rate.group(3)), "wall_s": wall,
                      "sequential_forwards": int(spec.group(1)),
                      "acceptance_percent": int(spec.group(2)), "ids": ids}
        gc_cuda()
    solo = None
    for label, r in out.items():
        ids = r.pop("ids")
        agree = next((t for t, (a, b) in enumerate(zip(ids, plain_ids)) if a != b), None)
        if agree is None and len(ids) == len(plain_ids):
            r["tokens_agreeing_with_plain"] = len(ids)
        else:  # a difference: hold both to the solo run of the same weights
            if solo is None:
                solo = solo_decode(tf, gen_mod, plain_generator, plain_prompt, MAX_NEW_TOKENS)
                margin_agreement(tf, plain_generator, "16d plain ask", plain_prompt, plain_ids,
                                 solo)
            r["tokens_agreeing_with_solo"], r["first_difference"] = margin_agreement(
                tf, plain_generator, f"16d ask --speculative ({label})", plain_prompt, ids, solo)
            r["tokens_agreeing_with_plain"] = agree if agree is not None else min(
                len(ids), len(plain_ids))
        phase(16, f"16d ask --speculative {SPEC_K} ({label}): {r['tokens']} tokens in "
                  f"{r['generate_s']:.3f} s ({r['tokens_per_s']:.2f} tokens/s), wall to the answer "
                  f"{r['wall_s']:.3f} s, {r['sequential_forwards']} sequential forwards, draft "
                  f"acceptance {r['acceptance_percent']}%, tokens equal to the plain ask's "
                  f"{r['tokens_agreeing_with_plain']} of {len(plain_ids)}")
    out["seconds"] = time.monotonic() - t_start
    phase(16, f"16d took {out['seconds']:.1f} s")
    return out


def gc_cuda():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def int8_weights_serve_phase(tf, gen_mod, server_mod, fa, config, tokenizer, prompts):
    """Phase 14b: phase 4's random weights profiled as in phase 6 (the bf16
    baseline at this point of the run), then as weight-only int8 served
    from an int8 KV pool as in phase 4 and profiled again."""
    from llm_fine_tune_distributed_tpu_torch.ops.int8 import maybe_quantize

    before = torch.cuda.memory_allocated()
    params = tf.init_params(config, seed=0, device=DEVICE, dtype=torch.bfloat16)
    generator = gen_mod.Generator(params, config, tokenizer, compute_dtype=torch.bfloat16,
                                  device=DEVICE)
    profiled_bf16 = profile_phase(generator, prompts, phase_no=14)
    del generator  # its dict holds the bf16 kernels that quantizing drops
    maybe_quantize(params, "int8")
    torch.cuda.synchronize()
    weight_bytes = torch.cuda.memory_allocated() - before
    phase(14, f"smollm3_3b random weights, weight-only int8: {weight_bytes / 1e9:.3f} GB on the "
              f"card (memory_allocated)")
    generator = gen_mod.Generator(params, config, tokenizer, compute_dtype=torch.bfloat16,
                                  device=DEVICE)
    served = serve_phase(server_mod, fa, generator, phase_no=14)
    served["weight_bytes"] = weight_bytes
    phase(14, f"int8 weights: {served['tokens_per_s_concurrent']:.1f} tokens/s over the 4 "
              f"concurrent requests' {served['window_s']:.3f} s window, mean decode step "
              f"{served['decode_step_ms_mean']:.2f} ms, TTFT warm-up {served['ttft_s_warmup']:.3f} s, "
              f"concurrent mean {served['ttft_s_concurrent_mean']:.3f} s")
    profiled = profile_phase(generator, prompts, phase_no=14)
    del generator, params
    gc_cuda()
    return served, profiled, profiled_bf16


# ---------------------------------------------------------------------------
# phase 17: the golden eval; phase 18: overload control through HTTP
# ---------------------------------------------------------------------------

# phase 17's new tokens per answer (cut from 32 to keep the smoke within its
# time budget; every check compares runs at the same count)
GOLDEN_MAX_NEW = 16
OVERLOAD_SYSTEM_PROMPT = "Be brief."  # phase 18's short prompts: one KV block each
OVERLOAD_SLOTS = 2


def golden_phase(tf, gen_mod, tuned, best_model, config, tokenizer, recorded):
    """Phase 17: ``run_golden_eval`` over the reference's five questions
    (greedy, ``GOLDEN_MAX_NEW`` new tokens) on the random base that phase 8 started from
    (the trainer's seed, made in memory; asked with ``enable_thinking=False``
    as the reference asks the original model) and on phase 8's
    ``best_model/`` (phase 14's bf16 generator), then ``compare_golden``;
    every tuned answer against ``Generator.chat`` on the same question,
    token for token (``recorded`` holds the (prompt, token ids) of every
    ``generate_ids`` call, phase 14's recording); then the CLI once in
    tuned-only mode."""
    import os
    import tempfile

    from llm_fine_tune_distributed_tpu_torch import eval_golden
    from llm_fine_tune_distributed_tpu_torch.config import TrainConfig
    from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT
    from llm_fine_tune_distributed_tpu_torch.infer.golden import (
        GOLDEN_QUESTIONS,
        compare_golden,
        run_golden_eval,
    )
    from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig

    out = {"seconds": {}}
    t0 = time.monotonic()
    params = tf.init_params(config, seed=TrainConfig().seed, device=DEVICE, dtype=torch.float32)
    params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    base = gen_mod.Generator(params, config, tokenizer, compute_dtype=torch.bfloat16,
                             device=DEVICE)
    torch.cuda.synchronize()
    out["seconds"]["base_init"] = time.monotonic() - t0
    answers = {}
    for name, gen, kw in (("original", base, {"template_kwargs": {"enable_thinking": False}}),
                          ("tuned", tuned, {})):
        t0 = time.monotonic()
        first_call = len(recorded)
        answers[name] = run_golden_eval(gen, max_new_tokens=GOLDEN_MAX_NEW, **kw)
        golden_ids = recorded[first_call:]
        out["seconds"][name] = time.monotonic() - t0
        phase(17, f"{name}: {len(answers[name])} answers in {out['seconds'][name]:.2f} s, tokens "
                  f"per answer {[a.n_tokens for a in answers[name]]}")
    del base, params
    report = compare_golden(answers["tuned"], answers["original"])
    check(report["n_questions"] == len(GOLDEN_QUESTIONS) == 5,
          f"golden report has {report['n_questions']} rows")
    phase(17, f"compare_golden: {report['n_answers_differ']}/{report['n_questions']} answers "
              "differ between best_model/ and its random base")
    greedy = GenerationConfig(max_new_tokens=GOLDEN_MAX_NEW, do_sample=False)
    check(len(golden_ids) == len(answers["tuned"]), f"{len(golden_ids)} generate_ids calls in "
                                                    "the tuned golden run, want 5")
    t0 = time.monotonic()
    for a, (prompt, ids) in zip(answers["tuned"], golden_ids):
        messages = [{"role": "system", "content": WILDERNESS_EXPERT_SYSTEM_PROMPT},
                    {"role": "user", "content": a.question}]
        chat = tuned.chat(messages, greedy)
        chat_prompt, chat_ids = recorded[-1]
        check(chat_prompt == prompt and chat_ids == ids and chat == a.answer,
              f"golden answer to {a.question!r}: {len(ids)} tokens {a.answer!r}, Generator.chat's "
              f"{len(chat_ids)} tokens {chat!r}")
    out["seconds"]["chat_check"] = time.monotonic() - t0
    phase(17, f"each tuned answer equals Generator.chat on the same question, token for token "
              f"({out['seconds']['chat_check']:.2f} s)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_golden_") as tmp:
        path = os.path.join(tmp, "golden_report.json")
        t0 = time.monotonic()
        rc = eval_golden.main(["--tuned-dir", best_model, "--max-new-tokens",
                               str(GOLDEN_MAX_NEW), "--report", path])
        out["seconds"]["cli"] = time.monotonic() - t0
        check(rc == 0, f"eval_golden returned {rc}")
        with open(path) as f:
            cli = json.load(f)
    check(cli["mode"] == "tuned-only" and len(cli["answers"]) == 5
          and [a["question"] for a in cli["answers"]] == GOLDEN_QUESTIONS,
          f"eval_golden report: {cli}")
    same = [c["answer"] == a.answer for c, a in zip(cli["answers"], answers["tuned"])]
    phase(17, f"python -m ...eval_golden --tuned-dir best_model/ (tuned-only): report parses, 5 "
              f"answers, {sum(same)} equal to the in-memory run's, {out['seconds']['cli']:.2f} s "
              "with the load")
    gc_cuda()
    out.update({"n_answers_differ": report["n_answers_differ"],
                "tokens_per_answer": {k: [a.n_tokens for a in v] for k, v in answers.items()},
                "cli_answers_equal_in_memory": sum(same)})
    return out


class _Held:
    """A Generator whose decode steps (plain and speculative, dense and
    paged) park at a gate until the smoke lets them through, so that phase
    18 scripts concurrent arrivals without sleeping to order them.
    ``fail_next`` makes the next step raise instead (phase 18e)."""

    STEPS = ("slot_step", "spec_slot_step", "paged_step", "spec_paged_step")

    def __init__(self, generator):
        self._gen = generator
        self._permits = threading.Semaphore(0)
        self._open = threading.Event()
        self._parked = threading.Event()
        self.fail_next = None

    def __getattr__(self, name):
        attr = getattr(self._gen, name)
        if name not in self.STEPS:
            return attr

        def step(*a):
            if self.fail_next is not None:
                err, self.fail_next = self.fail_next, None
                raise err
            if not self._open.is_set():
                self._parked.set()
                self._permits.acquire()
            return attr(*a)

        return step

    def park(self):
        """Return once the engine's worker waits at the gate."""
        check(self._parked.wait(300), "the engine's worker never reached the gate")
        self._parked.clear()

    def step(self, n=1):
        """Let ``n`` decode steps through, one by one."""
        for _ in range(n):
            self._permits.release()
            self.park()

    def open(self):
        self._open.set()
        for _ in range(256):
            self._permits.release()

    def close(self):
        """Hold the steps again (only while the engine is idle)."""
        self._permits = threading.Semaphore(0)
        self._open.clear()


def _request(base, path, body=None):
    """(status, headers, body bytes) of one request; an HTTP error status is
    returned, not raised."""
    import http.client

    host, port = base.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=600)
    try:
        conn.request("GET" if body is None else "POST", path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _post_async(base, path, body):
    """POST on a thread; the returned callable joins it and gives
    (status, headers, body)."""
    out = []
    t = threading.Thread(target=lambda: out.append(_request(base, path, body)), daemon=True)
    t.start()

    def join():
        t.join(600)
        check(not t.is_alive() and bool(out), f"{path}: the request hung")
        return out[0]

    return join


def _wait_for(cond, what, timeout=300):
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.002)


def _short_body(question, max_new, **extra):
    return {"question": question, "system_prompt": OVERLOAD_SYSTEM_PROMPT, "greedy": True,
            "max_new_tokens": max_new, **extra}


def _prompt_ids(generator, body):
    from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT

    return generator.encode_chat([
        {"role": "system", "content": body.get("system_prompt", WILDERNESS_EXPERT_SYSTEM_PROMPT)},
        {"role": "user", "content": body["question"]}])


def _taxonomy(label, status, headers, raw, want_status, kind, retry=True):
    """A shed's response: its status, the ``{"error": {...}}`` body of
    ``error_payload`` and, for a retryable shed, Retry-After as the hint
    rounded up to a positive whole second. Returns the error dict."""
    import math

    check(status == want_status, f"{label}: HTTP {status}, want {want_status}: {raw[:300]!r}")
    check(headers.get("Content-Type") == "application/json", f"{label}: {headers}")
    error = json.loads(raw)["error"]
    check(error["kind"] == kind, f"{label}: error kind {error['kind']}, want {kind}")
    if retry:
        hint = error["retry_after_s"]
        want = str(max(1, math.ceil(hint)))
        check(headers.get("Retry-After") == want and int(want) >= 1,
              f"{label}: Retry-After {headers.get('Retry-After')}, want {want} (hint {hint})")
    return error


def _paged_kw(**kw):
    return dict(engine="paged", quantize_kv="int8", kv_buf_len=KV_BUF_LEN,
                kv_block_len=KV_BLOCK_LEN, prefill_chunk=PREFILL_CHUNK,
                prompt_bucket=PROMPT_BUCKET, **kw)


def overload_queue_cap(server_mod, fa, generator):
    """18a: the paged int8 engine with ``max_queue_depth=1`` and both slots
    busy: a burst of 3 generates and 1 stream gets 429s."""
    held = _Held(generator)
    fa.paged_decode_attention.launches = 0
    with _Serving(server_mod, held, **_paged_kw(slots=OVERLOAD_SLOTS, max_queue_depth=1)) as srv:
        eng, base = srv.engine, srv.base
        occupants = [_post_async(base, "/v1/generate", _short_body(QUESTIONS[0], 16))]
        held.park()
        occupants.append(_post_async(base, "/v1/generate", _short_body(QUESTIONS[1], 16)))
        _wait_for(lambda: eng.queue_depth == 1, "the second occupant to queue")
        held.step()  # admits it; both slots are busy from here on
        occupants.append(_post_async(base, "/v1/generate", _short_body(QUESTIONS[2], 16)))
        _wait_for(lambda: eng.queue_depth == 1, "the waiter to queue")
        hints = []
        for i, path in enumerate(("/v1/generate", "/v1/generate", "/v1/generate", "/v1/stream")):
            status, headers, raw = _request(base, path, _short_body(QUESTIONS[3], 16))
            error = _taxonomy(f"18a burst {i}", status, headers, raw, 429, "queue_overflow")
            check(error["tier"] == "interactive" and error["retryable"],
                  f"18a burst {i}: {error}")
            hints.append((error["retry_after_s"], headers["Retry-After"]))
        held.open()
        statuses = [join()[0] for join in occupants]
        stats = eng.stats_snapshot()
        launches = fa.paged_decode_attention.launches
    check(statuses == [200, 200, 200], f"18a: occupants and waiter answered {statuses}")
    check(stats["requests_shed_overflow"] == 4 and
          stats["requests_shed_by_tier"] == {"interactive": 4, "batch": 0, "best_effort": 0},
          f"18a: requests_shed_overflow {stats['requests_shed_overflow']}, by tier "
          f"{stats['requests_shed_by_tier']}")
    layers = generator.config.num_layers
    check(launches == layers * stats["decode_steps"],
          f"18a: {launches} paged decode launches, want {layers} x {stats['decode_steps']}")
    phase(18, f"18a paged int8, max_queue_depth 1, both slots busy: burst of 4 -> 429 x4 "
              f"(Retry-After hint s, header: {hints}), requests_shed_overflow 4; occupants and "
              f"waiter 200; paged decode launches {launches} == {layers} x "
              f"{stats['decode_steps']} decode steps")
    return {"retry_after": hints, "launches": launches, "decode_steps": stats["decode_steps"]}


def overload_deadlines(tf, gen_mod, server_mod, generator):
    """18b: ``deadline_ms`` on the dense engine, one slot: expiry in the
    queue (504, no tokens), then mid-decode (504 with the tokens so far,
    held to the solo greedy run by phase 15's margin rule)."""
    held = _Held(generator)
    with _Serving(server_mod, held, engine="continuous", slots=1, kv_buf_len=KV_BUF_LEN,
                  prompt_bucket=PROMPT_BUCKET) as srv:
        eng, base = srv.engine, srv.base
        occupant = _post_async(base, "/v1/generate", _short_body(QUESTIONS[0], 16))
        held.park()
        queued = _post_async(base, "/v1/generate",
                             _short_body(QUESTIONS[1], 16, deadline_ms=100))
        _wait_for(lambda: eng.queue_depth == 1, "the deadline request to queue")
        queued_by = time.monotonic()
        time.sleep(max(0.0, queued_by + 0.15 - time.monotonic()))  # its 100 ms pass in the queue
        held.open()
        status, headers, raw = queued()
        q_err = _taxonomy("18b queued", status, headers, raw, 504, "deadline_exceeded",
                          retry=False)
        check(q_err["tokens_generated"] == 0 and q_err["partial_tokens"] == [],
              f"18b queued: {q_err}")
        check(occupant()[0] == 200, "18b: the occupant failed")
        held.close()  # the engine is idle
        body = _short_body(QUESTIONS[2], 200, deadline_ms=1500)
        t0 = time.monotonic()
        mid = _post_async(base, "/v1/generate", body)
        held.park()
        held.step(4)
        time.sleep(max(0.0, t0 + 1.55 - time.monotonic()))
        held.open()
        status, headers, raw = mid()
        stats = eng.stats_snapshot()
    m_err = _taxonomy("18b mid-decode", status, headers, raw, 504, "deadline_exceeded",
                      retry=False)
    partial = m_err["partial_tokens"]
    check(len(partial) == 5 == m_err["tokens_generated"],
          f"18b mid-decode: {m_err['tokens_generated']} tokens, want 5 (prefill + 4 steps)")
    prompt = _prompt_ids(generator, body)
    solo = solo_decode(tf, gen_mod, generator, prompt, len(partial))
    agree, at = margin_agreement(tf, generator, "18b mid-decode", prompt, partial, solo)
    check(stats["requests_shed_deadline"] == 1 and stats["requests_shed_deadline_decode"] == 1
          and stats["wasted_tokens_by_reason"]["deadline"] == 5,
          f"18b: shed counters {stats['requests_shed_deadline']}, "
          f"{stats['requests_shed_deadline_decode']}, waste {stats['wasted_tokens_by_reason']}")
    phase(18, f"18b continuous: deadline_ms 100 expired in the queue -> 504 with 0 tokens; "
              f"deadline_ms 1500 expired mid-decode -> 504 with {len(partial)} tokens, "
              f"{agree} of them equal to the solo greedy run"
              + (f" (then a top-2 margin {at['margin']:.3e} within {at['bound']:.3e})" if at else ""))
    return {"mid_decode_tokens": len(partial), "agreeing": agree}


def _paged_blocks(plen, max_new):
    """Blocks the paged engine reserves for a request with nothing cached
    (its ``_plan``): the budget's end or the last prefill chunk's pad end."""
    C, B, L = PREFILL_CHUNK, PROMPT_BUCKET, KV_BLOCK_LEN
    nchunks = -(-plen // C)
    last = plen - (nchunks - 1) * C
    write_end = (nchunks - 1) * C + -(-last // B) * B
    return -(-max(min(plen + max_new, KV_BUF_LEN), write_end) // L)


def overload_preemption(tf, gen_mod, server_mod, fa, generator, engine):
    """18c: two slots busy (an interactive occupant, a best_effort victim);
    an interactive arrival preempts the victim after its third token. On
    paged int8 the pool holds exactly the two, so the arrival also finds no
    free block; the victim's full context blocks are banked in the prefix
    cache and its resume reuses them. The victim's final tokens are held to
    its uninterrupted solo run by phase 15's margin rule (paged: plus twice
    the int8 pool's measured logit error); paged decode launches are counted
    across the preemption and the resume."""
    import functools

    from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT

    occupant = _short_body(QUESTIONS[0], MAX_NEW_TOKENS)
    victim = {"question": QUESTIONS[1], "greedy": True, "max_new_tokens": MAX_NEW_TOKENS,
              "priority": "best_effort"}  # the wilderness system prompt: ~1.4k tokens
    arrival = _short_body(QUESTIONS[2], 8, priority="interactive")
    prompts = {name: _prompt_ids(generator, body)
               for name, body in (("occupant", occupant), ("victim", victim), ("arrival", arrival))}
    kw = dict(engine="continuous", slots=OVERLOAD_SLOTS, kv_buf_len=KV_BUF_LEN,
              prompt_bucket=PROMPT_BUCKET)
    paged_cls = server_mod.PagedContinuousBatchingEngine
    if engine == "paged":
        kw = _paged_kw(slots=OVERLOAD_SLOTS)
        need = {name: _paged_blocks(len(p), body["max_new_tokens"])
                for (name, p), body in zip(prompts.items(), (occupant, victim, arrival))}
        num_blocks = 1 + need["occupant"] + need["victim"]  # the null block and the two
        server_mod.PagedContinuousBatchingEngine = functools.partial(paged_cls,
                                                                     num_blocks=num_blocks)
    held = _Held(generator)
    fa.paged_decode_attention.launches = 0
    try:
        srv = _Serving(server_mod, held, **kw)
    finally:
        server_mod.PagedContinuousBatchingEngine = paged_cls
    with srv:
        eng, base = srv.engine, srv.base
        joins = {"occupant": _post_async(base, "/v1/generate", occupant)}
        held.park()
        joins["victim"] = _post_async(base, "/v1/generate", victim)
        _wait_for(lambda: eng.queue_depth == 1, "the victim to queue")
        held.step()  # admitted (paged: its prompt prefills one chunk per tick)
        while eng.live_slots < 2:
            held.step()
        held.step()  # the victim's second token
        free_blocks = eng._allocator.free_count if engine == "paged" else None
        joins["arrival"] = _post_async(base, "/v1/generate", arrival)
        _wait_for(lambda: eng.queue_depth == 1, "the arrival to queue")
        held.step()  # the victim's third token, then the arrival preempts it
        before = eng.stats_snapshot()
        held.open()
        statuses = {name: join()[0] for name, join in joins.items()}
        stats = eng.stats_snapshot()
        launches = fa.paged_decode_attention.launches
        results = {name: ids for p, ids in srv.results
                   for name, q in prompts.items() if p == q}
    check(statuses == {"occupant": 200, "victim": 200, "arrival": 200}, f"18c {engine}: {statuses}")
    check(before["preemptions"] == 1 == stats["preemptions"],
          f"18c {engine}: preemptions {before['preemptions']} at the arrival, "
          f"{stats['preemptions']} at the end")
    got = results["victim"]
    check(len(got) == MAX_NEW_TOKENS, f"18c {engine}: the victim got {len(got)} tokens")
    floor = 2 * int8_kv_noise(tf, generator, prompts["victim"]) if engine == "paged" else 0.0
    solo = solo_decode(tf, gen_mod, generator, prompts["victim"], MAX_NEW_TOKENS)
    agree, at = margin_agreement(tf, generator, f"18c {engine} victim", prompts["victim"], got,
                                 solo, floor=floor)
    rec = {"agreeing": agree, "first_difference": at, "preemptions": stats["preemptions"],
           "decode_steps": stats["decode_steps"]}
    msg = (f"18c {engine}: the interactive arrival preempted the best_effort victim after 3 "
           f"tokens; its {len(got)} tokens after the resume: {agree} equal to the solo run"
           + (f" (then a top-2 margin {at['margin']:.3e} within {at['bound']:.3e})" if at else ""))
    if engine == "paged":
        reused = stats["prefix_tokens_reused"] - before["prefix_tokens_reused"]
        banked = (len(prompts["victim"]) + 3 - 1) // KV_BLOCK_LEN * KV_BLOCK_LEN
        layers = generator.config.num_layers
        check(free_blocks == 0 < need["arrival"],
              f"18c paged: {free_blocks} free blocks at the arrival, it needs {need['arrival']}")
        check(reused >= banked > 0,
              f"18c paged: the resume reused {reused} prefix tokens, {banked} were banked")
        check(launches == layers * stats["decode_steps"],
              f"18c paged: {launches} paged decode launches, want {layers} x "
              f"{stats['decode_steps']} decode steps")
        rec.update({"num_blocks": num_blocks, "blocks_needed": need, "free_at_arrival": free_blocks,
                    "prefix_tokens_reused_by_resume": reused, "banked_tokens": banked,
                    "launches": launches})
        msg += (f"; pool {num_blocks} blocks, {free_blocks} free at the arrival (it needs "
                f"{need['arrival']}); the resume reused {reused} banked prefix tokens; paged decode "
                f"launches {launches} == {layers} x {stats['decode_steps']} decode steps across "
                "the preemption and the resume")
    phase(18, msg)
    return rec


def overload_brownout(engine_mod, server_mod, generator):
    """18d: ``--engine continuous --speculative 4``, 8 slots, a 1 s drain
    budget: with the service-time EWMA at its 1 s seed the pressure is the
    backlog over 8. Repetitive speculative requests (32 new tokens: no
    request can finish in the ticks before stage 3, at most K + 1 = 5
    tokens a tick) are admitted one step
    apart until all 8 slots are busy (stages 1, 2 and 3 at a backlog of 6, 7
    and 8); from stage 1 no slot asks for drafts (prompt lookup is not even
    called); at stage 3 a best_effort request is a 429 and an interactive
    one is queued; then the gate opens, and a last request drives the stage
    back to 0."""
    held = _Held(generator)
    lookups = [0]
    prompt_lookup = engine_mod._prompt_lookup

    def counting_lookup(ctx, k):
        lookups[0] += 1
        return prompt_lookup(ctx, k)

    engine_mod._prompt_lookup = counting_lookup
    try:
        return _brownout_run(server_mod, held, lookups)
    finally:
        engine_mod._prompt_lookup = prompt_lookup


def _brownout_run(server_mod, held, lookups):
    slots = 8
    spec = {"speculative": SPEC_K}
    with _Serving(server_mod, held, engine="continuous", slots=slots, kv_buf_len=KV_BUF_LEN,
                  prompt_bucket=PROMPT_BUCKET, speculative_k=SPEC_K, brownout_drain_s=1.0) as srv:
        eng, base = srv.engine, srv.base
        trail = [eng.brownout_stage]
        update = eng._update_brownout

        def recording_update():
            update()
            if eng.brownout_stage != trail[-1]:
                trail.append(eng.brownout_stage)

        eng._update_brownout = recording_update
        body = _short_body(REPETITIVE_QUESTION, 32, **spec)
        joins = [_post_async(base, "/v1/generate", body)]
        held.park()
        held.step()
        check(lookups[0] > 0, "18d: no slot asked for drafts at stage 0")
        looked_at, proposed_at, stages = None, None, []
        for i in range(1, slots):
            joins.append(_post_async(base, "/v1/generate", body))
            _wait_for(lambda: eng.queue_depth == 1, "a request to queue")
            held.step()
            stages.append(eng.brownout_stage)
            if looked_at is None and eng.brownout_stage >= 1:
                looked_at = lookups[0]
                proposed_at = eng.stats_snapshot()["draft_tokens_proposed"]
        check(eng.live_slots == slots and eng.brownout_stage == 3,
              f"18d: {eng.live_slots} live slots at stage {eng.brownout_stage}, want {slots} at 3")
        held.step(2)  # two more ticks at stage 3
        proposed_3 = eng.stats_snapshot()["draft_tokens_proposed"]
        check(looked_at is not None and lookups[0] == looked_at and proposed_3 == proposed_at,
              f"18d: prompt lookups {looked_at} and drafts {proposed_at} when stage 1 began, "
              f"{lookups[0]} and {proposed_3} at stage 3")
        status, headers, raw = _request(base, "/v1/generate", {**body, "priority": "best_effort"})
        shed = _taxonomy("18d best_effort at stage 3", status, headers, raw, 429, "brownout_shed")
        check(shed["tier"] == "best_effort", f"18d: {shed}")
        joins.append(_post_async(base, "/v1/generate", {**body, "priority": "interactive"}))
        _wait_for(lambda: eng.queue_depth == 1, "the interactive request to queue")
        held.open()
        statuses = [join()[0] for join in joins]
        check(statuses == [200] * (slots + 1), f"18d: statuses {statuses}")
        # one more request drives the EWMAs down
        status, _, _ = _request(base, "/v1/generate", {**body, "max_new_tokens": 16})
        stats = eng.stats_snapshot()
    check(status == 200 and eng.brownout_stage == 0,
          f"18d: stage {eng.brownout_stage} after the last request (HTTP {status})")
    check(lookups[0] > looked_at, "18d: no slot asked for drafts after the stage fell")
    check(stats["requests_shed_by_tier"] == {"interactive": 0, "batch": 0, "best_effort": 1},
          f"18d: sheds by tier {stats['requests_shed_by_tier']}")
    phase(18, f"18d continuous --speculative {SPEC_K}, brownout_drain_s 1: stage after each "
              f"admission {stages}, stages passed {trail}; prompt lookups {looked_at} and drafts "
              f"proposed {proposed_at} when stage 1 began, unchanged at stage 3, "
              f"{lookups[0]} and {stats['draft_tokens_proposed']} at the end (stage 0); at stage "
              "3 best_effort -> 429 brownout_shed, interactive served")
    return {"stages_by_admission": stages, "trail": trail, "lookups_at_stage_1": looked_at,
            "draft_tokens_proposed": stats["draft_tokens_proposed"]}


def overload_repair(server_mod, generator):
    """18e: one fatal tick failure (a class no restart can help, here
    ``NotImplementedError``; a retryable one restarts the engine, phase 19)
    injected into a started engine (continuous and paged int8): the request
    in flight gets a 500 with the ``engine_fatal`` body, ``/healthz``
    answers 503 with ``circuit_state`` "fatal" and the terminal error, and a
    later request is refused with the same body."""
    out = {}
    for engine in ("continuous", "paged"):
        held = _Held(generator)
        held.open()
        kw = (_paged_kw(slots=OVERLOAD_SLOTS) if engine == "paged" else
              dict(engine=engine, slots=OVERLOAD_SLOTS, kv_buf_len=KV_BUF_LEN,
                   prompt_bucket=PROMPT_BUCKET))
        with _Serving(server_mod, held, **kw) as srv:
            check(_request(srv.base, "/healthz")[::2] == (200, b"ok"), f"18e {engine}: /healthz")
            held.fail_next = NotImplementedError("injected fatal tick failure")
            status, headers, raw = _request(srv.base, "/v1/generate", _short_body(QUESTIONS[0], 8))
            error = _taxonomy(f"18e {engine} in flight", status, headers, raw, 500,
                              "engine_fatal", retry=False)
            h_status, _, h_raw = _request(srv.base, "/healthz")
            health = json.loads(h_raw)
            later = _request(srv.base, "/v1/stream", _short_body(QUESTIONS[1], 8))
        check(h_status == 503 and health == {"status": "unhealthy", "circuit_state": "fatal",
                                             "error": error},
              f"18e {engine}: /healthz {h_status} {health}")
        check(later[0] == 500 and json.loads(later[2]) == {"error": error},
              f"18e {engine}: a later stream got {later[0]} {later[2][:200]!r}")
        out[engine] = {"healthz": h_status, "error": error}
        phase(18, f"18e {engine}: injected fatal tick failure -> in-flight request HTTP 500 "
                  f"{error['kind']}; /healthz 503 circuit_state fatal; later /v1/stream refused "
                  "with the same body before any event")
    return out


def overload_phase(tf, gen_mod, engine_mod, server_mod, fa, generator):
    """Phase 18 (after phase 16, on phase 4's generator): overload control
    through HTTP on the paged int8 and the dense engines."""
    out, seconds = {}, {}
    subphases = (
        ("a", lambda: overload_queue_cap(server_mod, fa, generator)),
        ("b", lambda: overload_deadlines(tf, gen_mod, server_mod, generator)),
        ("c_continuous", lambda: overload_preemption(tf, gen_mod, server_mod, fa, generator,
                                                     "continuous")),
        ("c_paged", lambda: overload_preemption(tf, gen_mod, server_mod, fa, generator, "paged")),
        ("d", lambda: overload_brownout(engine_mod, server_mod, generator)),
        ("e", lambda: overload_repair(server_mod, generator)),
    )
    for name, run in subphases:
        t0 = time.monotonic()
        out[name] = run()
        seconds[name] = time.monotonic() - t0
        phase(18, f"18{name} took {seconds[name]:.1f} s")
        gc_cuda()
    out["seconds"] = seconds
    return out


# ---------------------------------------------------------------------------
# phase 19: supervision (restart, circuit, drain, watchdog)
# ---------------------------------------------------------------------------

RESTART_BACKOFF_S = 0.05
RESTART_MEMORY_SLACK = 1 << 20  # bytes: memory_allocated after a restart vs before the fault
DRAIN_TIMEOUT_S = 60
WATCHDOG_TIMEOUT_S = 1.0  # 19e: far above a decode tick, below the 2 s delay it must catch


def _restart_marks(eng):
    """Time a restart: ``failed`` when the failure reaches ``_recover``,
    ``built`` when the new generation's ``_startup`` has returned (and its
    allocations have run), ``startup_s`` the rebuild alone."""
    marks = {}
    recover, startup = eng._recover, eng._startup

    def timed_recover(cause):
        marks.setdefault("failed", time.monotonic())
        return recover(cause)

    def timed_startup():
        t0 = time.monotonic()
        startup()
        torch.cuda.synchronize()
        marks["startup_s"] = time.monotonic() - t0
        marks["built"] = time.monotonic()

    eng._recover, eng._startup = timed_recover, timed_startup
    return marks


def _all_ok(label, responses):
    statuses = [r[0] for r in responses]
    check(statuses == [200] * len(responses), f"{label}: statuses {statuses}")


def supervision_restart(tf, gen_mod, server_mod, fa, generator):
    """19a: the paged int8 engine with 2 slots and a 0.05 s backoff. Two
    32-token greedy requests on the fresh engine (held to their solo runs by
    the margin rule, plus twice the int8 pool's logit error), the same two
    again with a decode failure armed 8 ticks ahead (both 503
    ``engine_restarting`` with Retry-After), then the same two on
    generation 1: held to their solo runs the same way, and compared with
    the first run (predicted equal: both ran on a fresh pool). Paged decode
    launches == 36 x decode steps across the crash and the restart;
    ``memory_allocated`` after the restart within 1 MiB of its value before
    the fault; the merge tickets zero."""
    bodies = [_short_body(QUESTIONS[i], MAX_NEW_TOKENS) for i in range(2)]
    prompts = [_prompt_ids(generator, b) for b in bodies]
    solos = [solo_decode(tf, gen_mod, generator, p, MAX_NEW_TOKENS) for p in prompts]
    floor = 2 * max(int8_kv_noise(tf, generator, p) for p in prompts)
    fa.paged_decode_attention.launches = 0
    with _Serving(server_mod, generator, **_paged_kw(slots=OVERLOAD_SLOTS,
                                                     restart_backoff_s=RESTART_BACKOFF_S)) as srv:
        eng, base = srv.engine, srv.base
        marks = _restart_marks(eng)

        def both():
            joins = [_post_async(base, "/v1/generate", b) for b in bodies]
            return [join() for join in joins]

        _all_ok("19a generation 0", both())
        first = {tuple(p): ids for p, ids in srv.results}
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        crash_at = eng._decode_index + 8  # both requests decoding by then
        eng.faults.fail_decode_at(crash_at)
        errors = []
        for i, (status, headers, raw) in enumerate(both()):
            error = _taxonomy(f"19a crashed request {i}", status, headers, raw, 503,
                              "engine_restarting")
            check(error["retryable"] and error["generation"] == 0, f"19a: {error}")
            errors.append({"retry_after_s": error["retry_after_s"],
                           "retry_after": headers["Retry-After"]})
        _wait_for(lambda: "built" in marks and eng.stats_snapshot()["engine_generation"] == 1,
                  "the restart")
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        tickets_zero = all(not bool(t.any()) for t in fa._TICKETS.values())
        _all_ok("19a generation 1", both())
        stats = eng.stats_snapshot()
        launches = fa.paged_decode_attention.launches
        after = {tuple(p): ids for p, ids in srv.results[2:]}
    check(stats["engine_generation"] == 1 and stats["engine_restarts"] == 1
          and stats["circuit_state"] == "closed", f"19a: generation {stats['engine_generation']}, "
          f"restarts {stats['engine_restarts']}, circuit {stats['circuit_state']}")
    check(abs(mem_after - mem_before) <= RESTART_MEMORY_SLACK,
          f"19a: memory_allocated {mem_before} before the fault, {mem_after} after the restart")
    check(tickets_zero, "19a: a paged decode merge ticket is not zero after the restart")
    layers = generator.config.num_layers
    check(launches == layers * stats["decode_steps"],
          f"19a: {launches} paged decode launches, want {layers} x {stats['decode_steps']}")
    agree = {}
    for run, got in (("generation 0", first), ("generation 1", after)):
        agree[run] = [margin_agreement(tf, generator, f"19a {run} request {i}", p, got[tuple(p)],
                                       solo, floor=floor)[0]
                      for i, (p, solo) in enumerate(zip(prompts, solos))]
    equal_first = [first[tuple(p)] == after[tuple(p)] for p in prompts]
    restart_s = marks["built"] - marks["failed"]
    rec = {"crash_at_decode_tick": crash_at, "retry_after": errors, "launches": launches,
           "decode_steps": stats["decode_steps"], "memory_before_fault": mem_before,
           "memory_after_restart": mem_after, "restart_s": restart_s,
           "restart_less_backoff_s": restart_s - RESTART_BACKOFF_S,
           "startup_s": marks["startup_s"], "tokens_agreeing_with_solo": agree,
           "generation_1_equals_generation_0": equal_first, "int8_floor": floor}
    phase(19, f"19a paged int8, 2 slots: decode tick {crash_at} failed -> both requests HTTP 503 "
              f"engine_restarting (Retry-After {[e['retry_after'] for e in errors]}); generation 1 "
              f"after {restart_s * 1e3:.1f} ms, {rec['restart_less_backoff_s'] * 1e3:.1f} ms of it "
              f"beyond the {RESTART_BACKOFF_S} s backoff (the pool rebuild "
              f"{marks['startup_s'] * 1e3:.1f} ms); memory_allocated {mem_before} before the fault, "
              f"{mem_after} after the restart (diff {mem_after - mem_before}); merge tickets zero")
    phase(19, f"19a tokens equal to the solo runs' (margin rule, int8 floor {floor:.3e}): "
              f"{agree} of {MAX_NEW_TOKENS}; generation 1 == generation 0 per request: {equal_first}; "
              f"paged decode launches {launches} == {layers} x {stats['decode_steps']} decode steps "
              "across the crash and the restart")
    return rec


def supervision_spec(tf, gen_mod, server_mod, generator):
    """19b: ``--engine continuous --speculative 4``: a request asking for
    speculation, then the same with the next (fused draft-verify) tick
    failing: 503 ``engine_restarting``; generation 1 serves it again. Both
    answers held to the solo run by the margin rule."""
    body = _short_body(QUESTIONS[2], MAX_NEW_TOKENS, speculative=SPEC_K)
    prompt = _prompt_ids(generator, body)
    solo = solo_decode(tf, gen_mod, generator, prompt, MAX_NEW_TOKENS)
    with _Serving(server_mod, generator, engine="continuous", slots=OVERLOAD_SLOTS,
                  kv_buf_len=KV_BUF_LEN, prompt_bucket=PROMPT_BUCKET, speculative_k=SPEC_K,
                  restart_backoff_s=RESTART_BACKOFF_S) as srv:
        eng, base = srv.engine, srv.base
        check(_request(base, "/v1/generate", body)[0] == 200, "19b: the first request failed")
        eng.faults.fail_decode_next(1)
        status, headers, raw = _request(base, "/v1/generate", body)
        _taxonomy("19b crashed spec request", status, headers, raw, 503, "engine_restarting")
        _wait_for(lambda: eng.stats_snapshot()["engine_generation"] == 1, "the restart")
        check(_request(base, "/v1/generate", body)[0] == 200, "19b: generation 1 failed")
        kinds = [e["kind"] for e in eng.recorder.events()]
        results = [ids for _, ids in srv.results]
    check(eng._spec_k == SPEC_K and "crash" in kinds and "restart" in kinds, f"19b: {kinds[-8:]}")
    agree = [margin_agreement(tf, generator, f"19b generation {g}", prompt, ids, solo)[0]
             for g, ids in enumerate(results)]
    phase(19, f"19b continuous --speculative {SPEC_K}: a spec tick failed -> HTTP 503 "
              f"engine_restarting; generation 1 served it again; tokens equal to the solo run's "
              f"(margin rule) {agree} of {MAX_NEW_TOKENS}; generation 1 == generation 0: "
              f"{results[0] == results[1]}")
    return {"tokens_agreeing_with_solo": agree, "equal": results[0] == results[1]}


def supervision_circuit(server_mod, generator):
    """19c: ``--circuit-threshold 2`` and a temporary ``--flight-dir``: the
    first failure restarts, the second opens the circuit; ``/healthz``
    answers 503 with ``circuit_state`` "open", a later request gets
    ``circuit_open``, and the circuit-open artifact holds the crash, the
    restart and the circuit opening in that order."""
    import os
    import shutil
    import tempfile

    flight_dir = tempfile.mkdtemp(prefix="chip_smoke_flight_")
    body = _short_body(QUESTIONS[1], 8)
    try:
        with _Serving(server_mod, generator, engine="continuous", slots=OVERLOAD_SLOTS,
                      kv_buf_len=KV_BUF_LEN, prompt_bucket=PROMPT_BUCKET,
                      restart_backoff_s=RESTART_BACKOFF_S, circuit_threshold=2,
                      flight_dir=flight_dir) as srv:
            eng, base = srv.engine, srv.base
            eng.faults.fail_decode_next(2)
            _taxonomy("19c first failure", *_request(base, "/v1/generate", body), 503,
                      "engine_restarting")
            error = _taxonomy("19c second failure", *_request(base, "/v1/generate", body), 503,
                              "circuit_open", retry=False)
            h_status, _, h_raw = _request(base, "/healthz")
            later = _request(base, "/v1/generate", body)
        health = json.loads(h_raw)
        check(h_status == 503 and health == {"status": "unhealthy", "circuit_state": "open",
                                             "error": error}, f"19c: /healthz {h_status} {health}")
        check(later[0] == 503 and json.loads(later[2]) == {"error": error},
              f"19c: a later request got {later[0]} {later[2][:200]!r}")
        dumps = sorted(os.listdir(flight_dir))
        opened = [d for d in dumps if d.startswith("flight_circuit_open")]
        check(len(opened) == 1 and len(dumps) == 2, f"19c: flight artifacts {dumps}")
        with open(os.path.join(flight_dir, opened[0])) as f:
            kinds = [e["kind"] for e in json.load(f)["events"]]
    finally:
        shutil.rmtree(flight_dir, ignore_errors=True)
    order = [k for k in kinds if k in ("crash", "restart", "circuit_open")]
    check(order == ["crash", "restart", "crash", "circuit_open"], f"19c: lifecycle events {order}")
    phase(19, f"19c continuous, circuit_threshold 2: restart, then circuit open (HTTP 503 "
              f"circuit_open); /healthz 503 circuit_state open; later request refused; artifacts "
              f"{dumps}, the circuit-open one holding {order}")
    return {"artifacts": dumps, "lifecycle": order}


def supervision_drain(tf, gen_mod, server_mod, generator):
    """19d: an in-process server (``build_server(control=...)`` served by
    ``run_server``) drains through ``control["begin_drain"]`` while a
    64-token request is held in flight at the gate: ``/healthz`` answers
    503 draining with Retry-After, a new request 503 ``draining``; the held
    request then returns 200 with its tokens (held to its solo run by the
    margin rule), and ``run_server`` returns within the drain timeout."""
    held = _Held(generator)
    control = {}
    httpd, eng = server_mod.build_server(held, host="127.0.0.1", port=0, engine="continuous",
                                         slots=OVERLOAD_SLOTS, kv_buf_len=KV_BUF_LEN,
                                         prompt_bucket=PROMPT_BUCKET,
                                         drain_timeout_s=DRAIN_TIMEOUT_S, control=control)
    got = []
    submit_full = eng.submit_full

    def recording(prompt_ids, gen, seed=0, timeout=None, **kw):
        req = submit_full(prompt_ids, gen, seed=seed, timeout=timeout, **kw)
        got.append(list(req.result))
        return req

    eng.submit_full = recording
    serving = threading.Thread(target=server_mod.run_server, args=(httpd, eng), daemon=True)
    serving.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    body = _short_body(QUESTIONS[3], 64)
    try:
        inflight = _post_async(base, "/v1/generate", body)
        held.park()
        t0 = time.monotonic()
        control["begin_drain"]()  # what SIGTERM calls
        h_status, h_headers, h_raw = _request(base, "/healthz")
        check(h_status == 503 and json.loads(h_raw) == {"status": "draining"}
              and h_headers.get("Retry-After") == str(DRAIN_TIMEOUT_S),
              f"19d: /healthz {h_status} {h_headers.get('Retry-After')} {h_raw!r}")
        _taxonomy("19d request during the drain", *_request(base, "/v1/generate",
                                                             _short_body(QUESTIONS[0], 8)),
                  503, "draining")
        held.open()
        status = inflight()[0]
        serving.join(DRAIN_TIMEOUT_S)
        drain_s = time.monotonic() - t0
        check(not serving.is_alive(), f"19d: run_server did not return within {DRAIN_TIMEOUT_S} s")
    finally:
        held.open()
        if serving.is_alive():
            httpd.shutdown()
            serving.join(30)
    check(status == 200 and len(got) == 1, f"19d: the request in flight got HTTP {status}")
    prompt = _prompt_ids(generator, body)
    solo = solo_decode(tf, gen_mod, generator, prompt, 64)
    agree, _ = margin_agreement(tf, generator, "19d drained request", prompt, got[0], solo)
    phase(19, f"19d drain: /healthz 503 draining (Retry-After {DRAIN_TIMEOUT_S}), a new request "
              f"503 draining; the request in flight 200 with {len(got[0])} tokens, {agree} equal "
              f"to the solo run's; run_server returned {drain_s:.2f} s after begin_drain")
    return {"drain_s": drain_s, "tokens": len(got[0]), "agreeing": agree}


def supervision_watchdog(engine_mod, generator):
    """19e: ``StepWatchdog(1.0, "abort", on_trip=...)`` on a continuous
    engine: no trip over a normal 32-token request, exactly one when one
    decode tick is slowed by 2 s (``faults.delay_decode_next(1, 2.0)``)."""
    from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
    from llm_fine_tune_distributed_tpu_torch.runtime.watchdog import StepWatchdog

    fired = []
    wd = StepWatchdog(WATCHDOG_TIMEOUT_S, "abort", on_trip=lambda: fired.append(1),
                      start_paused=True)
    eng = engine_mod.ContinuousBatchingEngine(generator, slots=OVERLOAD_SLOTS, buf_len=KV_BUF_LEN,
                                              prompt_bucket=PROMPT_BUCKET, watchdog=wd)
    prompt = _prompt_ids(generator, _short_body(QUESTIONS[0], MAX_NEW_TOKENS))
    greedy = GenerationConfig(max_new_tokens=MAX_NEW_TOKENS, do_sample=False)
    try:
        eng.submit(prompt, greedy, timeout=600)
        normal = wd.trips
        eng.faults.delay_decode_next(1, 2.0)
        t0 = time.monotonic()
        eng.submit(prompt, greedy, timeout=600)
        slowed_s = time.monotonic() - t0
        delayed = wd.trips
    finally:
        eng.close()
        wd.stop()
    check(normal == 0 and delayed == 1 and fired == [1],
          f"19e: trips {normal} over the normal run, {delayed} under the 2 s delay, hook {fired}")
    phase(19, f"19e StepWatchdog({WATCHDOG_TIMEOUT_S}, abort): 0 trips over a normal "
              f"{MAX_NEW_TOKENS}-token request, 1 (the on_trip hook once) when a decode tick "
              f"slept 2 s (that request took {slowed_s:.2f} s)")
    return {"trips_normal": normal, "trips_delayed": delayed, "slowed_request_s": slowed_s}


def supervision_phase(tf, gen_mod, engine_mod, server_mod, fa, generator):
    """Phase 19 (right after phase 18, on phase 4's generator): in-process
    restart, the circuit, the drain and the watchdog."""
    out, seconds = {}, {}
    subphases = (
        ("a", lambda: supervision_restart(tf, gen_mod, server_mod, fa, generator)),
        ("b", lambda: supervision_spec(tf, gen_mod, server_mod, generator)),
        ("c", lambda: supervision_circuit(server_mod, generator)),
        ("d", lambda: supervision_drain(tf, gen_mod, server_mod, generator)),
        ("e", lambda: supervision_watchdog(engine_mod, generator)),
    )
    for name, run in subphases:
        t0 = time.monotonic()
        out[name] = run()
        seconds[name] = time.monotonic() - t0
        phase(19, f"19{name} took {seconds[name]:.1f} s")
        gc_cuda()
    out["seconds"] = seconds
    phase(19, f"phase 19 took {sum(seconds.values()):.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 20: serving observability (traces, SLOs, history, capacity, gauges,
# on-demand profiler capture)
# ---------------------------------------------------------------------------

OBSERVE_SAMPLE_S = 0.2  # --slo-sample-interval-s
OBSERVE_INTER_TOKEN_S = 0.01  # --slo-inter-token-p99-s: far under a decode tick, so it breaches
PROFILE_S = 2.0  # POST /v1/profile's duration
PROFILED_TOKENS = 128  # 20e's request: it decodes well past the capture's stop
TRACE_SPANS = ("received", "queued", "admitted", "prefill", "first_token", "completed")
# phase 20d's prediction (arithmetic from SmolLM3-3B's shapes and phase 4's
# and 15's ticks): (MFU, HBM-bandwidth utilization)
OBSERVE_PREDICTED = {"paged": (3e-4, 0.024), "continuous": (5e-4, 0.04)}


def _observe_kw(engine):
    kw = dict(engine=engine, slots=SLOTS, kv_buf_len=KV_BUF_LEN, prompt_bucket=PROMPT_BUCKET,
              slo_sample_interval_s=OBSERVE_SAMPLE_S)
    if engine == "paged":
        kw.update(quantize_kv="int8", kv_block_len=KV_BLOCK_LEN, prefill_chunk=PREFILL_CHUNK)
    return kw


def _concurrent(base, extra=None):
    """Phase 4's 4 concurrent greedy requests: their parsed answers."""
    joins = [_post_async(base, "/v1/generate", {"question": q, "greedy": True,
                                               "max_new_tokens": MAX_NEW_TOKENS, **(extra or {})})
             for q in QUESTIONS]
    out = []
    for i, join in enumerate(joins):
        status, _, raw = join()
        check(status == 200, f"phase 20 request {i}: HTTP {status} {raw[:200]!r}")
        out.append(json.loads(raw))
    return out


def _get_json(base, path):
    status, _, raw = _request(base, path)
    return status, json.loads(raw)


def _trace_order(label, trace):
    """The JAX spans of a served request, in time order: received, queued,
    admitted, the prefill (chunks, then the final one), first_token,
    completed."""
    spans = [e["span"] for e in trace["events"]]
    times = [e["t_s"] for e in trace["events"]]
    check(times == sorted(times), f"{label}: trace times out of order: {trace['events']}")
    core = [s for s in spans if s != "prefill_chunk"]
    check(core == list(TRACE_SPANS), f"{label}: trace spans {spans}")
    chunks = [i for i, s in enumerate(spans) if s == "prefill_chunk"]
    check(all(spans.index("admitted") < i < spans.index("prefill") for i in chunks),
          f"{label}: a prefill chunk outside admission..prefill: {spans}")
    return spans


def _storage_bytes(tensors):
    """Bytes of the distinct storages under ``tensors``."""
    seen = {}
    for t in tensors:
        s = t.untyped_storage()
        seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


def observe_gauges(label, eng, stats, generator, peaks):
    """20d on one engine: the memory gauges against the tensors themselves,
    and the MFU and HBM-bandwidth gauges in (0, 1), unclamped at most 1,
    the bandwidth one giving back the bytes of every timed decode tick over
    their summed time (the ``decode_tick_s`` histogram's count and sum)."""
    from llm_fine_tune_distributed_tpu_torch.observe import profiler

    weights = _storage_bytes(generator.params.values())
    check(stats["weight_bytes"] == weights,
          f"{label}: weight_bytes {stats['weight_bytes']} != {weights} (the parameters' storages)")
    layers = eng._cache["layers"].values()
    kv = sum(t.nbytes for e in layers for n, t in e.items() if n in ("k", "v"))
    scales = sum(t.nbytes for e in layers for n, t in e.items() if n.endswith("_scale"))
    check(stats["kv_pool_bytes"] == kv, f"{label}: kv_pool_bytes {stats['kv_pool_bytes']} != {kv}")
    report = stats["device_memory_report"]
    check(report["kv_scale_bytes"] == scales and report["weight_bytes"] == weights,
          f"{label}: device_memory_report {report}, scales {scales}")
    check(stats["role"] == "mixed", f"{label}: role {stats.get('role')!r}")
    snap = eng.stats_snapshot()  # the gauges beside the cost and the ticks they divide
    ticks, seconds, flops, nbytes = eng.decode_cost()
    _, hist_ticks, tick_sum = eng.stats.hist["decode_tick_s"]._state()
    check(ticks == hist_ticks and abs(seconds - tick_sum) <= 1e-9 * tick_sum,
          f"{label}: the work sums cover {ticks} ticks in {seconds} s, decode_tick_s "
          f"{hist_ticks} in {tick_sum} s")
    mean_tick = seconds / ticks
    peak_flops, peak_bw = profiler.device_peak_specs()
    check((peak_flops, peak_bw) == (peaks[1], peaks[0]),
          f"device_peak_specs {peak_flops, peak_bw} != the bound's peaks {peaks}")
    mfu, bw = snap["model_flops_utilization"], snap["hbm_bandwidth_utilization"]
    check(stats["model_flops_utilization"] == mfu and stats["hbm_bandwidth_utilization"] == bw,
          f"{label}: /v1/stats gauges {stats['model_flops_utilization']}, "
          f"{stats['hbm_bandwidth_utilization']} != the engine's {mfu}, {bw}")
    raw_mfu, raw_bw = flops / (seconds * peak_flops), nbytes / (seconds * peak_bw)
    check(0.0 < mfu < 1.0 and 0.0 < bw < 1.0, f"{label}: MFU {mfu}, HBM {bw} outside (0, 1)")
    check(raw_mfu <= 1.0 and raw_bw <= 1.0,
          f"{label}: unclamped MFU {raw_mfu}, HBM {raw_bw} above 1: the cost count is wrong")
    back = bw * peak_bw * seconds
    check(abs(back - nbytes) <= 1e-6 * nbytes,
          f"{label}: HBM gauge x peak x summed tick time = {back} != the ticks' bytes {nbytes}")
    queries = eng._decode_work.sums[1]
    want_mfu, want_bw = OBSERVE_PREDICTED[label]
    phase(20, f"20d {label}: weight_bytes {weights} == the parameters' storages, kv_pool_bytes "
              f"{kv} (+ {scales} B of scales) == the pool's; {ticks} timed decode ticks, "
              f"{queries / ticks:.2f} live rows per tick, per tick {flops / ticks / 1e9:.3f} GFLOP "
              f"and {nbytes / ticks / 1e9:.4f} GB in {1e3 * mean_tick:.2f} ms; MFU {mfu:.3e} "
              f"(predicted {want_mfu:.0e}), HBM bandwidth {bw:.4f} (predicted {want_bw}); "
              f"unclamped {raw_mfu:.3e}, {raw_bw:.4f}")
    return {"weight_bytes": weights, "kv_pool_bytes": kv, "kv_scale_bytes": scales,
            "decode_ticks": ticks, "rows_per_tick": queries / ticks,
            "decode_flops_per_tick": flops / ticks, "decode_bytes_per_tick": nbytes / ticks,
            "mean_decode_tick_ms": 1e3 * mean_tick, "model_flops_utilization": mfu,
            "hbm_bandwidth_utilization": bw, "predicted": [want_mfu, want_bw]}


def observe_traces_slo_capacity(server_mod, fa, generator, tmp, peaks):
    """20a-c, d on paged int8 and e: one paged int8 server with the trace
    log, the profile directory, a 0.2 s ring and a 10 ms inter-token
    objective."""
    import os

    from llm_fine_tune_distributed_tpu_torch.observe import capacity

    trace_log = os.path.join(tmp, "traces.jsonl")
    profile_dir = os.path.join(tmp, "profiles")
    kw = dict(_observe_kw("paged"), trace_log=trace_log, profile_dir=profile_dir,
              slo_inter_token_p99_s=OBSERVE_INTER_TOKEN_S)
    out = {}
    t0 = time.monotonic()
    with _Serving(server_mod, generator, **kw) as srv:
        built_s = time.monotonic() - t0  # the profiler's warm-up included
        base, eng = srv.base, srv.engine
        fa.paged_decode_attention.launches = 0  # this drive's launches only
        answers = _concurrent(base, {"trace": True})
        launches = fa.paged_decode_attention.launches
        _, stats = _get_json(base, "/v1/stats")
        # (a) the traces, the trace log, the launches
        spans = [_trace_order(f"request {i}", a["trace"]) for i, a in enumerate(answers)]
        with open(trace_log) as f:
            records = [json.loads(line) for line in f]
        ids = sorted(a["trace"]["request_id"] for a in answers)
        check(sorted(r["request_id"] for r in records) == ids,
              f"trace log ids {[r['request_id'] for r in records]} != the responses' {ids}")
        check(all(r["generated_tokens"] == MAX_NEW_TOKENS and r["error"] is None for r in records),
              f"trace log records: {[(r['generated_tokens'], r['error']) for r in records]}")
        layers = generator.config.num_layers
        check(launches == layers * stats["decode_steps"],
              f"paged decode launches {launches} != {layers} x {stats['decode_steps']} decode steps")
        ttft_in_trace = [next(e["t_s"] for e in a["trace"]["events"] if e["span"] == "first_token")
                         for a in answers]
        out["a"] = {"spans": spans, "trace_log_records": len(records), "launches": launches,
                    "decode_steps": stats["decode_steps"], "trace_ttft_s": ttft_in_trace,
                    "server_built_s": built_s}
        phase(20, f"20a: server built in {built_s:.1f} s (the profiler's warm-up included); "
                  f"4 traced requests, spans {spans[0]} (chunks per request "
                  f"{[s.count('prefill_chunk') for s in spans]}), trace-log lines {len(records)} "
                  f"== the 4 request ids, 32 tokens each, no error; paged decode launches "
                  f"{launches} == {layers} x {stats['decode_steps']} decode steps")
        # (b) the SLO report, the breach event, the history
        _, slo = _get_json(base, "/v1/slo")
        itl, ttft = slo["objectives"]["inter_token_p99"], slo["objectives"]["ttft_p99"]
        check(not itl["compliant"] and all(w["burn_rate"] > 1.0 for w in itl["windows"].values()),
              f"inter_token_p99 should breach on both windows: {itl}")
        check(ttft["compliant"], f"ttft_p99 should stay compliant (4 events < min_events): {ttft}")
        _, flight = _get_json(base, "/v1/flight?limit=1024")
        breaches = [e for e in flight["events"] if e["kind"] == "slo_breach"]
        check([e["objective"] for e in breaches] == ["inter_token_p99"],
              f"slo_breach events {breaches}")

        def history():
            return _get_json(base, "/v1/history?metric=tokens_served")[1]["samples"]

        # the worker samples once more when it goes idle: wait for that sample
        _wait_for(lambda: history()[-1]["value"] == stats["tokens_served"],
                  "the metric ring's idle sample", timeout=30)
        values = [p["value"] for p in history()]
        check(values == sorted(values), f"tokens_served history decreases: {values}")
        out["b"] = {"inter_token_p99": itl, "ttft_p99": ttft, "breaches": breaches,
                    "history_values": values}
        phase(20, f"20b: inter_token_p99 breached, burn rates "
                  f"{ {k: w['burn_rate'] for k, w in itl['windows'].items()} } over "
                  f"{ {k: w['events'] for k, w in itl['windows'].items()} } gaps; ttft_p99 "
                  f"compliant ({ttft['windows']['fast']['events']} events < 8); one slo_breach "
                  f"event; tokens_served history {len(values)} samples, non-decreasing, last "
                  f"{values[-1]} == /v1/stats")
        # (c) the capacity report of a fleet of one
        _, cap = _get_json(base, "/v1/capacity")
        snap = eng.capacity_snapshot()
        _, ticks, tick_sum = eng.stats.hist["decode_tick_s"]._state()
        check(snap["mean_decode_tick_s"] == tick_sum / ticks,
              f"mean_decode_tick_s {snap['mean_decode_tick_s']} != the histogram's "
              f"{tick_sum / ticks}")
        want = capacity.SaturationModel().sustainable_tokens_per_s(
            slots=snap["slots"], mean_decode_tick_s=snap["mean_decode_tick_s"],
            mean_tokens_per_step=snap["mean_tokens_per_step"],
            live_slots_mean=snap["live_slots_mean"], mfu=snap["model_flops_utilization"],
            hbm_bw_util=snap["hbm_bandwidth_utilization"])
        per_replica = cap["capacity"]["per_replica_tokens_per_s"]
        check(per_replica > 0.0 and abs(per_replica - want) <= 1e-9 * want,
              f"sustainable tokens/s {per_replica} (the model from the snapshot: {want})")
        check(cap["autoscale"] == "off" and cap["decisions"] == [] and cap["replicas"] == 1,
              f"/v1/capacity {cap}")
        out["c"] = {"keys": sorted(cap), "per_replica_tokens_per_s": per_replica,
                    "mean_decode_tick_s": snap["mean_decode_tick_s"],
                    "recommended_replicas": cap["recommended_replicas"],
                    "demand_tokens_per_s": cap["current_load"]["demand_tokens_per_s"]}
        phase(20, f"20c: /v1/capacity keys {sorted(cap)}; mean decode tick "
                  f"{1e3 * snap['mean_decode_tick_s']:.2f} ms == the histogram's; sustainable "
                  f"{per_replica:.1f} tokens/s per replica, recommended replicas "
                  f"{cap['recommended_replicas']}")
        out["d"] = observe_gauges("paged", eng, stats, generator, peaks)
        out["e"] = observe_profile(base, eng, fa, layers)
        # (f) lineage needs hot-swap: the JAX 404
        status, body = _get_json(base, "/v1/lineage")
        check(status == 404 and body == {"error": server_mod._LINEAGE_404},
              f"/v1/lineage: {status} {body}")
    return out


def observe_profile(base, eng, fa, layers):
    """20e: POST /v1/profile while one 128-token request decodes: 200, then
    409 inside the window; after the stop the Chrome trace holds
    ``paged_decode_kernel`` a positive multiple of 36 times (the capture
    starts and stops between ticks), and the flight recorder holds
    profile_start then profile_stop. The request still decodes after the
    stop released the tick lock; its largest inter-token gaps (between its
    ticks in the flight recorder) across the start and across the stop are
    printed beside the times the capture held the tick lock."""
    import os

    join = _post_async(base, "/v1/generate", {"question": QUESTIONS[0], "greedy": True,
                                              "max_new_tokens": PROFILED_TOKENS})
    start = eng.stats.values(("decode_steps",))["decode_steps"]
    _wait_for(lambda: eng.stats.values(("decode_steps",))["decode_steps"] > start,
              "the profiled request's first decode tick", timeout=60)
    t0 = time.monotonic()
    posted = t0 - eng.recorder._t0  # on the flight recorder's clock
    status, _, raw = _request(base, "/v1/profile", {"duration_s": PROFILE_S})
    check(status == 200, f"POST /v1/profile: HTTP {status} {raw!r}")
    trace_dir = json.loads(raw)["trace_dir"]
    status, _, raw = _request(base, "/v1/profile", {"duration_s": PROFILE_S})
    check(status == 409, f"a second POST /v1/profile inside the window: HTTP {status} {raw!r}")

    def stopped():
        return [e for e in _get_json(base, "/v1/flight?limit=1024")[1]["events"]
                if e["kind"] in ("profile_start", "profile_stop")]

    _wait_for(lambda: any(e["kind"] == "profile_stop" for e in stopped()),
              "profile_stop: the capture never stopped", timeout=120)
    stop_s = time.monotonic() - t0
    check(join()[0] == 200, "the profiled request failed")
    marks = stopped()
    check([e["kind"] for e in marks] == ["profile_start", "profile_stop"],
          f"flight profile events {marks}")
    check("error" not in marks[1], f"the capture's stop failed: {marks[1]}")
    # the request's ticks from the last one before the POST on; the stop
    # released the lock export_ms before profile_stop was recorded
    begin, end = marks
    events = _get_json(base, "/v1/flight?limit=1024")[1]["events"]
    released = end["t_s"] - end["export_ms"] / 1e3
    ticks = [e["t_s"] for e in events if e["kind"] == "tick"]
    ticks = ticks[max(0, sum(t < posted for t in ticks) - 1):]
    check(ticks[0] < posted and ticks[-1] > released,
          f"the profiled request did not decode across the capture: ticks "
          f"{ticks[:3]}...{ticks[-3:]}, POST at {posted}, lock released at {released}")
    gaps = [(a, b - a) for a, b in zip(ticks, ticks[1:])]
    start_gap_ms = 1e3 * max(g for a, g in gaps if a < begin["t_s"])  # across the start
    stop_gap_ms = 1e3 * max(g for a, g in gaps if a >= begin["t_s"])  # across the stop
    median_gap_ms = 1e3 * sorted(g for _, g in gaps)[len(gaps) // 2]
    path = os.path.join(trace_dir, "trace.json")
    check(os.path.exists(path), f"no Chrome trace at {path}")
    size = os.path.getsize(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    paged = [e for e in kernels if "paged_decode_kernel" in e.get("name", "")]
    cpu_ops = [e for e in events if e.get("cat") == "cpu_op"]
    check(paged and len(paged) % layers == 0,
          f"the capture holds {len(paged)} paged_decode_kernel events of {len(kernels)} kernels: "
          f"not a positive multiple of {layers}")
    os.remove(path)
    phase(20, f"20e: POST /v1/profile -> 200 {trace_dir}, a second -> 409; profile_stop "
              f"{stop_s:.2f} s after the POST (profile_start, profile_stop in /v1/flight): "
              f"started holding the tick lock "
              f"{begin['lock_held_ms']:.1f} ms, stopped holding it {end['lock_held_ms']:.1f} ms, "
              f"exported in {end['export_ms']:.1f} ms; the request's largest inter-token gap "
              f"{start_gap_ms:.1f} ms across the start, {stop_gap_ms:.1f} ms across the stop "
              f"(median {median_gap_ms:.1f} ms, {len(ticks)} ticks, "
              f"{sum(t > released for t in ticks)} after the stop); trace.json "
              f"{size / 1e6:.1f} MB: {len(kernels)} kernel events, paged_decode_kernel "
              f"{len(paged)} = {layers} x {len(paged) // layers} ticks, {len(cpu_ops)} CPU ops")
    return {"trace_bytes": size, "kernel_events": len(kernels), "paged_events": len(paged),
            "ticks_captured": len(paged) // layers, "cpu_ops": len(cpu_ops), "stop_s": stop_s,
            "start_lock_held_ms": begin["lock_held_ms"],
            "stop_lock_held_ms": end["lock_held_ms"], "export_ms": end["export_ms"],
            "start_gap_ms": start_gap_ms, "stop_gap_ms": stop_gap_ms,
            "median_inter_token_gap_ms": median_gap_ms}


def observability_phase(server_mod, fa, generator, peaks):
    """Phase 20 (right after phase 19, on phase 4's generator): request
    traces and the trace log, the SLO report and history, the capacity
    report, the memory and utilization gauges on paged int8 and continuous,
    an on-demand profile, and the 404s of what is not ported."""
    import tempfile

    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_observe_") as tmp:
        out = observe_traces_slo_capacity(server_mod, fa, generator, tmp, peaks)
    gc_cuda()
    with _Serving(server_mod, generator, **_observe_kw("continuous")) as srv:
        fa.paged_decode_attention.launches = 0
        _concurrent(srv.base)
        check(fa.paged_decode_attention.launches == 0, "the continuous engine launched paged decode")
        _, stats = _get_json(srv.base, "/v1/stats")
        out["d_continuous"] = observe_gauges("continuous", srv.engine, stats, generator, peaks)
    with _Serving(server_mod, generator, engine="window", max_batch=SLOTS) as srv:
        status, body = _get_json(srv.base, "/v1/slo")
        check(status == 404 and body == {"error": server_mod._NEEDS_SLOT_ENGINE["/v1/slo"]},
              f"window /v1/slo: {status} {body}")
    phase(20, "20f: /v1/lineage (paged) and /v1/slo (window) answer the JAX 404 bodies")
    gc_cuda()
    out["seconds"] = time.monotonic() - t0
    phase(20, f"phase 20 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 21: the host KV tier, live migration and the engine fleet
# ---------------------------------------------------------------------------

FLEET_TIER_MB = 1024  # the shared host tier of 21b-21f (113 SmolLM3-3B int8 blocks)
FLEET_STREAM_TOKENS = 32  # 21c's migrated stream
SIBLING_TOKENS = 64  # 21f's live sibling, 21e's stream under the scale-down
TIER_REPS = 5  # 21a's timed round trips
# the JAX fleet snapshot's keys beyond an engine's (tests/test_metrics_schema.py)
FLEET_EXTRA_KEYS = {
    "replicas", "routing", "healthy_replicas", "available_replicas", "per_replica",
    "replicas_retired", "requests_routed_prefix_affinity", "requests_routed_adapter_affinity",
    "requests_routed_least_loaded", "requests_routed_round_robin", "requests_failed_over",
    "requests_rerouted_overflow", "requests_shed_fleet_saturated", "requests_shed_fleet_brownout",
    "tokens_by_role",
}


def _tier_block_bytes(config):
    """One int8 block's host entry: every layer's K and V codes and their
    f32 scales (SmolLM3-3B: 9,437,184 + 1,152 bytes)."""
    hkv, d = config.num_kv_heads, config.resolved_head_dim
    return config.num_layers * 2 * (KV_BLOCK_LEN * hkv * d + hkv * 4)


def _paged_engine(engine_mod, generator, tier, **kw):
    """A paged int8 engine at phase 4's geometry over the shared tier."""
    return engine_mod.PagedContinuousBatchingEngine(
        generator, **{"slots": SLOTS, "buf_len": KV_BUF_LEN, "prompt_bucket": PROMPT_BUCKET,
                      "block_len": KV_BLOCK_LEN, "prefill_chunk": PREFILL_CHUNK,
                      "kv_quant": "int8", "host_tier": tier, **kw})


def _greedy_cfg(n):
    from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig

    return GenerationConfig(max_new_tokens=n, do_sample=False)


def _ttft(req):
    return req.first_token_t - req.enqueued_at


def fleet_tier_round_trip(engine_mod, paged_mod, generator):
    """21a: the 5 full blocks of a ~1.43k-token prompt through
    ``_spill_to_tier`` (gather, pinned copies, the sync before the tier
    publishes them) and back into fresh rows, TIER_REPS times: bitwise equal
    codes and scales, 9,438,336 bytes per entry."""
    prompt = _prompt_ids(generator, {"question": QUESTIONS[0]})
    eng = _paged_engine(engine_mod, generator, paged_mod.HostBlockTier(FLEET_TIER_MB << 20))
    bids = []
    try:
        eng.submit(prompt, _greedy_cfg(8), timeout=600)
        keys = eng._prefix.block_keys(prompt)
        bids = eng._prefix.match(keys, limit=len(keys))
        check(len(bids) == len(keys) == 5, f"21a: {len(bids)} cached blocks, want 5")
        orig = [[a.clone() for a in rows] for rows in eng._gather_blocks(bids)]
        times = {"spill_events_ms": [], "spill_wall_ms": [], "restore_events_ms": [],
                 "restore_wall_ms": []}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(TIER_REPS):
            eng._host_tier.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            eng._spill_to_tier(list(zip(keys, bids)))  # returns once the copies completed
            end.record()
            times["spill_wall_ms"].append(1e3 * (time.perf_counter() - t0))
            end.synchronize()
            times["spill_events_ms"].append(start.elapsed_time(end))
            entries = [eng._host_tier.get(k) for k in keys]
            check(all(e is not None and all(a.is_pinned() for a in e) for e in entries),
                  "21a: a tier entry is missing or not in pinned memory")
            fresh = eng._allocator.alloc(len(keys))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            eng._scatter_blocks(fresh, entries)
            end.record()
            torch.cuda.synchronize()
            times["restore_wall_ms"].append(1e3 * (time.perf_counter() - t0))
            times["restore_events_ms"].append(start.elapsed_time(end))
            back = eng._gather_blocks(fresh)
            check(all(b.dtype == o.dtype and torch.equal(b, o)
                      for b_rows, o_rows in zip(back, orig) for b, o in zip(b_rows, o_rows)),
                  "21a: a restored block differs from the spilled one")
            for bid in fresh:
                eng._allocator.free(bid)
        parts = _spill_parts(eng, bids)
        entry_bytes = [sum(a.nbytes for a in e) for e in entries]
        want = _tier_block_bytes(generator.config)
        check(entry_bytes == [want] * 5, f"21a: entry bytes {entry_bytes}, want {want} each")
        snap = eng.stats_snapshot()
        check(snap["prefix_blocks_spilled"] == 5 * TIER_REPS
              and snap["prefix_blocks_discarded"] == 0,
              f"21a: spilled {snap['prefix_blocks_spilled']}, discarded "
              f"{snap['prefix_blocks_discarded']}")
    finally:
        for bid in bids:
            eng._allocator.free(bid)
        eng.close()
    moved = sum(entry_bytes)
    rec = {"blocks": 5, "entry_bytes": want, "bytes_per_direction": moved,
           **{k: statistics.median(v) for k, v in times.items()}, "all": times, **parts}
    for d in ("spill", "restore"):
        rec[f"{d}_gb_s_events"] = moved / rec[f"{d}_events_ms"] / 1e6
        rec[f"{d}_gb_s_wall"] = moved / rec[f"{d}_wall_ms"] / 1e6
    phase(21, f"21a round trip of 5 blocks ({moved / 1e6:.1f} MB, {want} B each), bitwise equal "
              f"x{TIER_REPS}: spill {rec['spill_events_ms']:.3f} ms by events "
              f"({rec['spill_gb_s_events']:.1f} GB/s), {rec['spill_wall_ms']:.3f} ms wall with its "
              f"sync ({rec['spill_gb_s_wall']:.1f} GB/s); restore "
              f"{rec['restore_events_ms']:.3f} ms "
              f"by events ({rec['restore_gb_s_events']:.1f} GB/s), {rec['restore_wall_ms']:.3f} ms "
              f"wall synced ({rec['restore_gb_s_wall']:.1f} GB/s) (medians)")
    phase(21, f"21a the spill's parts by events: the gather into one byte row per block "
              f"(index_select of {parts['leaves']} leaves, cat) {parts['gather_ms']:.3f} ms, the 5 "
              f"copies into pinned memory {parts['d2h_ms']:.3f} ms "
              f"({moved / parts['d2h_ms'] / 1e6:.1f} GB/s) (medians of {TIER_REPS})")
    return rec


def _spill_parts(eng, bids):
    """The two parts of a spill, timed apart by CUDA events (medians of
    TIER_REPS): the device gather of ``bids``'s rows into one byte row per
    block, and the copies of those rows into pinned host buffers."""
    from llm_fine_tune_distributed_tpu_torch.infer.generate import pool_leaves

    leaves = pool_leaves(eng.pool)
    ids = torch.tensor(bids, dtype=torch.long, device=DEVICE)
    start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    gather, d2h = [], []
    for _ in range(TIER_REPS):
        host = [torch.empty(sum(leaf[0].nbytes for leaf in leaves), dtype=torch.uint8,
                            pin_memory=True) for _ in bids]
        torch.cuda.synchronize()
        start.record()
        packed = torch.cat([leaf.index_select(0, ids).view(torch.uint8).reshape(len(bids), -1)
                            for leaf in leaves], dim=1)
        mid.record()
        for i, buf in enumerate(host):
            buf.copy_(packed[i], non_blocking=True)
        end.record()
        end.synchronize()
        gather.append(start.elapsed_time(mid))
        d2h.append(mid.elapsed_time(end))
    return {"leaves": len(leaves), "gather_ms": statistics.median(gather),
            "d2h_ms": statistics.median(d2h)}


def fleet_tier_restore(tf, engine_mod, paged_mod, generator, served, solo, floor):
    """21b: one paged int8 engine over a pool of exactly one request's
    blocks and the tier. Prompt A, then prompt B (another system prompt, no
    block in common) evicts A's 5 cached blocks into the tier; A again
    restores them (>= 5 hits, 1280 tokens reused); then B again (evicting A
    once more), the tier cleared, and A a third time with a full prefill:
    the two re-asks' TTFT in one call. Every run of A is held to A's solo
    run by phase 15's margin rule plus twice the int8 pool's logit error,
    and whether the re-asks equal the first run token for token is printed:
    the pool holds no block B did not write, and a freed int8 block keeps
    its scale (in both packages), so a re-ask's tail is quantized under
    another scale than the first run's."""
    from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT
    from llm_fine_tune_distributed_tpu_torch.infer.routing import prefix_block_keys

    a = _prompt_ids(generator, {"question": QUESTIONS[0]})
    b = _prompt_ids(generator, {"question": QUESTIONS[0],
                                "system_prompt": WILDERNESS_EXPERT_SYSTEM_PROMPT.swapcase()})
    need = max(_paged_blocks(len(p), MAX_NEW_TOKENS) for p in (a, b))
    check(not set(prefix_block_keys(a, KV_BLOCK_LEN)) & set(prefix_block_keys(b, KV_BLOCK_LEN)),
          "21b: prompts A and B share a block")
    eng = _paged_engine(engine_mod, generator, paged_mod.HostBlockTier(FLEET_TIER_MB << 20),
                        num_blocks=1 + need)
    g = _greedy_cfg(MAX_NEW_TOKENS)
    try:
        first = eng.submit_full(a, g, timeout=600)
        eng.submit(b, g, timeout=600)
        before = eng.stats_snapshot()
        check(before["prefix_blocks_spilled"] >= 5,
              f"21b: B spilled {before['prefix_blocks_spilled']} of A's blocks, want 5")
        restored = eng.submit_full(a, g, timeout=600)
        after = eng.stats_snapshot()
        eng.submit(b, g, timeout=600)
        eng._host_tier.clear()
        cleared = eng.submit_full(a, g, timeout=600)
        last = eng.stats_snapshot()
    finally:
        eng.close()
    hits = after["host_tier_restore_hits"] - before["host_tier_restore_hits"]
    reused = after["prefix_tokens_reused"] - before["prefix_tokens_reused"]
    check(hits >= 5, f"21b: the re-ask restored {hits} blocks, want >= 5")
    check(reused == 5 * KV_BLOCK_LEN,
          f"21b: the re-ask reused {reused} tokens, want {5 * KV_BLOCK_LEN}")
    agree = [margin_agreement(tf, generator, f"21b {label}", a, req.result, solo[tuple(a)],
                              floor=floor)[0]
             for label, req in (("first ask", first), ("restored re-ask", restored),
                                ("cleared re-ask", cleared))]
    equal = [restored.result == first.result, cleared.result == first.result]
    rec = {"pool_blocks": need, "restore_hits": hits, "tokens_reused": reused,
           "tokens_agreeing_with_solo": agree, "reasks_equal_to_first": equal,
           "spilled": last["prefix_blocks_spilled"], "discarded": last["prefix_blocks_discarded"],
           "misses": last["host_tier_restore_misses"], "ttft_first_s": _ttft(first),
           "ttft_restored_s": _ttft(restored), "ttft_cleared_s": _ttft(cleared),
           "phase4_ttft_s_concurrent_mean": served["ttft_s_concurrent_mean"]}
    phase(21, f"21b pool of {need} blocks: B evicted A's 5 blocks into the tier; the re-ask "
              f"restored {hits} blocks ({reused} tokens reused); tokens equal to the solo run's "
              f"(first, restored, cleared): {agree}, re-asks == the first run: {equal}; TTFT "
              f"{rec['ttft_restored_s']:.3f} s restored vs {rec['ttft_cleared_s']:.3f} s with the "
              f"tier cleared (first ask {rec['ttft_first_s']:.3f} s; phase 4's concurrent mean "
              f"{rec['phase4_ttft_s_concurrent_mean']:.3f} s)")
    return rec


def fleet_migration(tf, gen_mod, engine_mod, paged_mod, fleet_mod, fa, generator, floor):
    """21c: a fleet of two paged int8 replicas over the one generator and
    one tier, ``migrate_on_retire``. A 32-token greedy stream, and
    ``migrate_slot`` of its replica after its second token: the same
    iterator finishes on the sibling, which restores the spilled blocks.
    Tokens held to the solo run by the margin rule (plus the int8 floor),
    ``slots_migrated`` 1 on the target, the request completed on exactly one
    replica, paged decode launches 36 x the decode steps of both. Returns the
    fleet (21f runs on it) and the record."""
    tier = paged_mod.HostBlockTier(FLEET_TIER_MB << 20)
    fleet = fleet_mod.EngineFleet([_paged_engine(engine_mod, generator, tier) for _ in range(2)],
                                  routing="prefix", migrate_on_retire=True)
    prompt = _prompt_ids(generator, {"question": QUESTIONS[1]})
    solo = solo_decode(tf, gen_mod, generator, prompt, FLEET_STREAM_TOKENS)
    fa.paged_decode_attention.launches = 0  # the migrated stream's launches only
    stream = fleet.stream(prompt, _greedy_cfg(FLEET_STREAM_TOKENS), timeout=600)
    tokens = [next(stream), next(stream)]
    src = next(rid for rid, rep in fleet.replica_items() if rep.live_slots > 0)
    t0 = time.monotonic()
    moved = fleet.migrate_slot(src)
    call_s = time.monotonic() - t0
    banked = len(stream._req.preempted_tokens)  # every token the source emitted
    while len(tokens) <= banked:  # the queued ones, then the target's first
        tokens.append(next(stream))
    next_token_s = time.monotonic() - t0
    tokens.extend(stream)
    launches = fa.paged_decode_attention.launches
    snaps = {rid: rep.stats_snapshot() for rid, rep in fleet.replica_items()}
    tgt = next(rid for rid in snaps if rid != src)
    layers = generator.config.num_layers
    steps = sum(s["decode_steps"] for s in snaps.values())
    check(moved == 1 and snaps[tgt]["slots_migrated"] == 1,
          f"21c: moved {moved}, target slots_migrated {snaps[tgt]['slots_migrated']}")
    check(sorted(s["requests_completed"] for s in snaps.values()) == [0, 1]
          and snaps[tgt]["requests_completed"] == 1,
          f"21c: completed {[s['requests_completed'] for s in snaps.values()]}")
    check(snaps[tgt]["host_tier_restore_hits"] >= 5,
          f"21c: the target restored {snaps[tgt]['host_tier_restore_hits']} blocks, want >= 5")
    check(launches == layers * steps, f"21c: {launches} paged decode launches, want {layers} x "
                                      f"{steps} decode steps over both replicas")
    agree, at = margin_agreement(tf, generator, "21c migrated stream", prompt, tokens, solo,
                                 floor=floor)
    rec = {"source": src, "target": tgt, "banked_tokens": banked, "call_s": call_s,
           "call_to_next_token_s": next_token_s, "launches": launches, "decode_steps": steps,
           "restore_hits": snaps[tgt]["host_tier_restore_hits"],
           "spilled": snaps[src]["prefix_blocks_spilled"], "tokens_agreeing_with_solo": agree,
           "first_difference": at}
    phase(21, f"21c migrate_slot({src}) after {banked} tokens: the stream finished on replica "
              f"{tgt} ({rec['restore_hits']} blocks restored, {rec['spilled']} spilled); call "
              f"{call_s * 1e3:.1f} ms, call to the target's first token "
              f"{next_token_s * 1e3:.1f} ms; "
              f"tokens equal to the solo run's: {agree} of {FLEET_STREAM_TOKENS}; paged decode "
              f"launches {launches} == {layers} x {steps} decode steps over both replicas")
    return fleet, rec


def fleet_restart_beside_sibling(tf, gen_mod, fa, fleet, generator, floor):
    """21f: on 21c's fleet, replica 0 decodes one request and replica 1
    another; a decode failure injected into replica 0 restarts it (its
    request: ``RetryableEngineError``; its restart zeroes the merge tickets
    of the stream both share) while replica 1 decodes on: its tokens held to
    the solo run, launches 36 x the decode steps of both, tickets zero."""
    from llm_fine_tune_distributed_tpu_torch.infer.errors import RetryableEngineError

    rep_a, rep_b = fleet.replicas
    prompts = [_prompt_ids(generator, {"question": q}) for q in QUESTIONS[2:4]]
    solo = solo_decode(tf, gen_mod, generator, prompts[1], SIBLING_TOKENS)
    steps0 = sum(r.stats_snapshot()["decode_steps"] for r in (rep_a, rep_b))
    fa.paged_decode_attention.launches = 0
    outcome = []

    def ask_a():
        try:
            rep_a.submit(prompts[0], _greedy_cfg(SIBLING_TOKENS), timeout=600)
            outcome.append("ok")
        except RetryableEngineError as e:
            outcome.append(type(e).__name__)

    stream = rep_b.stream(prompts[1], _greedy_cfg(SIBLING_TOKENS), timeout=600)
    tokens = [next(stream)]
    t = threading.Thread(target=ask_a, daemon=True)
    t.start()
    _wait_for(lambda: rep_a.live_slots > 0 and rep_b.live_slots > 0, "both replicas decoding")
    rep_a.faults.fail_decode_next(1)
    tokens.extend(stream)
    t.join(600)
    _wait_for(lambda: rep_a.stats_snapshot()["engine_generation"] == 1, "replica 0's restart")
    launches = fa.paged_decode_attention.launches
    steps = sum(r.stats_snapshot()["decode_steps"] for r in (rep_a, rep_b)) - steps0
    tickets_zero = all(not bool(x.any()) for x in fa._TICKETS.values())
    layers = generator.config.num_layers
    check(outcome == ["RetryableEngineError"], f"21f: replica 0's request: {outcome}")
    check(launches == layers * steps, f"21f: {launches} paged decode launches, want {layers} x "
                                      f"{steps}")
    check(tickets_zero, "21f: a paged decode merge ticket is not zero")
    agree, at = margin_agreement(tf, generator, "21f sibling's stream", prompts[1], tokens, solo,
                                 floor=floor)
    again = rep_a.submit(prompts[0], _greedy_cfg(8), timeout=600)
    check(len(again) == 8, "21f: replica 0 does not serve after its restart")
    rec = {"launches": launches, "decode_steps": steps, "sibling_tokens_agreeing_with_solo": agree,
           "first_difference": at, "restarted_generation": 1}
    phase(21, f"21f replica 0 restarted (503 engine_restarting to its request) while replica 1 "
              f"decoded: replica 1's tokens equal to the solo run's: {agree} of "
              f"{SIBLING_TOKENS}; paged decode launches {launches} == {layers} x {steps}; "
              "merge tickets zero; replica 0 serves again")
    return rec


def _fleet_kw(**kw):
    return _paged_kw(slots=SLOTS, flight_dir=None, autoscale="off", **kw)


def _fleet_traffic(srv):
    """A warm-up request, then phase 4's 4 concurrent ones, on a fleet
    server: (results of the 4, their window, the merged histograms' TTFT
    mean over the 4, warm-up stats, stats after)."""
    eng, base = srv.engine, srv.base
    warm = _http(base, "/v1/generate", {"question": WARMUP_QUESTION, "greedy": True,
                                        "max_new_tokens": MAX_NEW_TOKENS})
    check(warm[0] == 200, f"fleet warm-up: HTTP {warm[0]}")
    h0 = eng.merged_histograms()["ttft_s"]
    ttft0 = (h0.sum, h0.total)
    warm_stats = eng.stats_snapshot()
    t0 = time.monotonic()
    joins = [_post_async(base, "/v1/generate", {"question": q, "greedy": True,
                                               "max_new_tokens": MAX_NEW_TOKENS})
             for q in QUESTIONS]
    for i, join in enumerate(joins):
        status, _, raw = join()
        check(status == 200, f"fleet request {i}: HTTP {status} {raw[:200]!r}")
    window_s = time.monotonic() - t0
    h1 = eng.merged_histograms()["ttft_s"]
    results = list(srv.results[1:])
    gen_tok = sum(len(ids) for _, ids in results)
    return {"results": results, "window_s": window_s, "tokens_per_s": gen_tok / window_s,
            "ttft_s_mean": (h1.sum - ttft0[0]) / (h1.total - ttft0[1]),
            "warm_stats": warm_stats, "stats": eng.stats_snapshot()}


def _hold_fleet_tokens(tf, generator, label, results, solo, floor):
    agree = []
    for i, (prompt, ids) in enumerate(results):
        agree.append(margin_agreement(tf, generator, f"{label} request {i}", prompt, ids,
                                      solo[tuple(prompt)], floor=floor)[0])
    return agree


def fleet_disaggregated(tf, server_mod, fa, generator, served, solo, floor):
    """21d: ``--replicas 2 --replica-roles prefill,decode --host-tier-mb
    1024``, phase 4's traffic: every request handed off (warm-up + 4), no
    decode step on the prefill replica, every paged decode launch on the
    decode replica (36 x its decode steps), tokens held to the solo runs."""
    fa.paged_decode_attention.launches = 0
    with _Serving(server_mod, generator, **_fleet_kw(replicas=2, replica_roles="prefill,decode",
                                                     host_tier_mb=FLEET_TIER_MB)) as srv:
        out = _fleet_traffic(srv)
        launches = fa.paged_decode_attention.launches
    stats = out["stats"]
    pre, dec = stats["per_replica"]["0"], stats["per_replica"]["1"]
    layers = generator.config.num_layers
    check((pre["role"], dec["role"], stats["role"]) == ("prefill", "decode", "disaggregated"),
          f"21d roles {pre['role']}, {dec['role']}, fleet {stats['role']}")
    check(stats["requests_handed_off"] == 5 and pre["requests_handoff_failed"] == 0,
          f"21d: handed off {stats['requests_handed_off']} (want 5: the warm-up and 4), failed "
          f"{pre['requests_handoff_failed']}")
    check(pre["decode_steps"] == 0 and pre["requests_completed"] == 0,
          f"21d: the prefill replica ran {pre['decode_steps']} decode steps")
    check(dec["requests_completed"] == 5 and dec["slots_migrated"] == 5,
          f"21d: the decode replica completed {dec['requests_completed']}")
    check(launches == layers * dec["decode_steps"],
          f"21d: {launches} paged decode launches, want {layers} x {dec['decode_steps']}")
    agree = _hold_fleet_tokens(tf, generator, "21d", out["results"], solo, floor)
    phase4 = {tuple(p): ids for p, ids in served["results"][1:]}
    same = [ids == phase4.get(tuple(p)) for p, ids in out["results"]]
    rec = {"launches": launches, "decode_steps_decode_replica": dec["decode_steps"],
           "handed_off": stats["requests_handed_off"],
           "restore_hits": dec["host_tier_restore_hits"],
           "tokens_per_s": out["tokens_per_s"], "window_s": out["window_s"],
           "ttft_s_mean": out["ttft_s_mean"], "tokens_agreeing_with_solo": agree,
           "tokens_equal_to_phase_4": same,
           "phase4_tokens_per_s": served["tokens_per_s_concurrent"],
           "phase4_ttft_s_mean": served["ttft_s_concurrent_mean"]}
    phase(21, f"21d prefill,decode: 5 requests handed off, 0 decode steps on the prefill replica, "
              f"paged decode launches {launches} == {layers} x {dec['decode_steps']} on the decode "
              f"replica ({rec['restore_hits']} blocks restored there); tokens equal to the solo "
              f"runs': {agree}, to phase 4's: {same}; {out['tokens_per_s']:.1f} tokens/s and TTFT "
              f"mean {out['ttft_s_mean']:.3f} s vs phase 4's {rec['phase4_tokens_per_s']:.1f} and "
              f"{rec['phase4_ttft_s_mean']:.3f} s")
    return rec


def _replica_samples(text, counters, rids):
    """Counter names without a ``replica="i"`` sample for some replica."""
    missing = []
    for key in counters:
        for rid in rids:
            if not re.search(rf'^serving_{key}_total\{{replica="{rid}"\}} ', text, re.M):
                missing.append((key, rid))
    return missing


def fleet_serving_and_scale(tf, server_mod, fa, metrics_mod, generator, served, solo, floor):
    """21e: ``--replicas 2 --routing prefix --max-replicas 3
    --migrate-on-retire --host-tier-mb 1024 --autoscale off``, phase 4's
    traffic, then a repeat of one prompt: it lands on a replica holding its
    prefix. ``/v1/stats`` has the JAX fleet keys but ``compile``,
    ``/metrics`` a ``replica="i"`` sample per replica for every counter.
    ``POST /v1/fleet/scale`` to 3 then 2, idle: ``memory_allocated`` back
    within 1 MiB. Then a 64-token stream of a prompt no replica holds (one
    short request first, so the router's rotation places the stream on
    replica 1) and ``POST /v1/fleet/scale`` to 3, then to 1 under it: the
    retirement migrates the stream to replica 0, and it completes;
    ``memory_allocated`` then one replica below two, within 1 MiB."""
    from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT
    from llm_fine_tune_distributed_tpu_torch.infer.routing import prefix_block_keys

    kw = _fleet_kw(replicas=2, max_replicas=3, migrate_on_retire=True, host_tier_mb=FLEET_TIER_MB)
    fa.paged_decode_attention.launches = 0

    def scale(base, n):
        status, _, raw = _request(base, "/v1/fleet/scale", {"replicas": n})
        check(status == 200 and json.loads(raw) == {"replicas": n},
              f"21e scale to {n}: {status} {raw!r}")

    def idle_memory():
        gc_cuda()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    with _Serving(server_mod, generator, **kw) as srv:
        eng, base = srv.engine, srv.base
        out = _fleet_traffic(srv)
        repeat = _prompt_ids(generator, {"question": QUESTIONS[0]})
        keys = prefix_block_keys(repeat, KV_BLOCK_LEN)
        homes = {rid for rid, rep in eng.replica_items() if rep.prefix_match_len(keys) > 0}
        hits0 = {rid: rep.stats_snapshot()["prefix_hits"] for rid, rep in eng.replica_items()}
        status, _, _, _ = _http(base, "/v1/generate", {"question": QUESTIONS[0], "greedy": True,
                                                       "max_new_tokens": MAX_NEW_TOKENS})
        check(status == 200, f"21e repeat: HTTP {status}")
        rose = {rid for rid, rep in eng.replica_items()
                if rep.stats_snapshot()["prefix_hits"] > hits0[rid]}
        check(len(rose) == 1 and rose <= homes, f"21e: the repeat hit {rose}, the prefix is on "
                                                f"{homes}")
        status, _, raw = _request(base, "/v1/stats")
        stats = json.loads(raw)
        single = set(eng.replicas[0].stats_snapshot()) - {"prefix_hits"}
        want_keys = single | FLEET_EXTRA_KEYS | {"engine", "device_memory", "device_memory_report"}
        check(set(stats) == want_keys, f"21e /v1/stats keys: extra {set(stats) - want_keys}, "
                                       f"missing {want_keys - set(stats)}")
        status, _, raw = _request(base, "/metrics")
        missing = _replica_samples(raw.decode(), metrics_mod.ServingStats.COUNTERS, ("0", "1"))
        check(status == 200 and not missing, f"21e /metrics lacks replica samples: {missing[:5]}")
        launches = fa.paged_decode_attention.launches
        steps = stats["decode_steps"]
        mem = {2: idle_memory()}
        scale(base, 3)
        mem[3] = idle_memory()
        scale(base, 2)
        mem["2_again"] = idle_memory()
        replica_bytes = mem[3] - mem[2]  # one replica's pool and slot state
        # one short request (no full block: no affinity) so that the stream,
        # the next placement, rotates onto replica 1
        status, _, _, _ = _http(base, "/v1/generate", _short_body(QUESTIONS[3], 4))
        check(status == 200, f"21e short request: HTTP {status}")
        result = {}
        body = {"question": QUESTIONS[2], "greedy": True, "max_new_tokens": SIBLING_TOKENS,
                "system_prompt": WILDERNESS_EXPERT_SYSTEM_PROMPT.swapcase()}
        streamer = threading.Thread(target=lambda: result.update(zip(
            ("status", "events", "first_s", "total_s"), _sse(base, body))), daemon=True)
        streamer.start()
        _wait_for(lambda: any(rep.live_slots for rep in eng.replicas), "the stream's decode")
        on = [rid for rid, rep in eng.replica_items() if rep.live_slots]
        check(on == [1], f"21e: the stream decodes on replicas {on}, want [1]")
        scale(base, 3)
        scale(base, 1)
        streamer.join(600)
        check(not streamer.is_alive(), "21e: the stream hung across the scale-down")
        mem[1] = idle_memory()
        final = eng.stats_snapshot()
    check(abs(mem["2_again"] - mem[2]) <= RESTART_MEMORY_SLACK,
          f"21e: memory_allocated {mem[2]} at 2 replicas, {mem['2_again']} after 3 -> 2")
    check(abs(mem[2] - replica_bytes - mem[1]) <= RESTART_MEMORY_SLACK,
          f"21e: memory_allocated {mem[1]} at 1 replica, want {mem[2]} - one replica's "
          f"{replica_bytes}")
    events = result.get("events") or []
    check(result.get("status") == 200 and events and events[-1][1].get("done") is True
          and events[-1][1]["n_tokens"] >= 1,
          f"21e: the stream across the scale-down ended with {events[-1:] or result}")
    check(final["slots_migrated"] == 1 and final["replicas"] == 1
          and final["replicas_retired"] == 3,
          f"21e: slots_migrated {final['slots_migrated']}, replicas {final['replicas']}, retired "
          f"{final['replicas_retired']}")
    layers = generator.config.num_layers
    check(launches == layers * steps, f"21e: {launches} launches, want {layers} x {steps}")
    agree = _hold_fleet_tokens(tf, generator, "21e", out["results"], solo, floor)
    placed = {rid: s["requests_completed"] for rid, s in out["stats"]["per_replica"].items()}
    rec = {"tokens_per_s": out["tokens_per_s"], "window_s": out["window_s"],
           "ttft_s_mean": out["ttft_s_mean"], "completed_per_replica": placed,
           "repeat_hit": sorted(rose), "prefix_homes": sorted(homes), "launches": launches,
           "decode_steps": steps, "tokens_agreeing_with_solo": agree,
           "memory": {str(k): v for k, v in mem.items()}, "replica_bytes": replica_bytes,
           "stream_tokens": events[-1][1]["n_tokens"], "stream_migrated": final["slots_migrated"],
           "replicas_retired": final["replicas_retired"],
           "phase4_tokens_per_s": served["tokens_per_s_concurrent"]}
    phase(21, f"21e prefix routing over 2 replicas: requests completed per replica {placed}; the "
              f"repeat hit replica {sorted(rose)} (prefix on {sorted(homes)}); /v1/stats has "
              f"the JAX "
              f"fleet keys but compile; /metrics has replica samples of all "
              f"{len(metrics_mod.ServingStats.COUNTERS)} counters; tokens equal to the solo runs': "
              f"{agree}; launches {launches} == {layers} x {steps}")
    phase(21, f"21e scale 2 -> 3 -> 2 idle: memory_allocated {mem[2]} -> {mem[3]} -> "
              f"{mem['2_again']} (diff {mem['2_again'] - mem[2]}); a {SIBLING_TOKENS}-token "
              f"stream on replica 1 through 3 -> 1: migrated to replica 0 and completed "
              f"({rec['stream_tokens']} tokens); memory_allocated {mem[1]} = {mem[2]} - one "
              f"replica's {replica_bytes} {mem[1] - (mem[2] - replica_bytes):+d}; "
              f"{out['tokens_per_s']:.1f} tokens/s over 2 replicas vs phase 4's "
              f"{served['tokens_per_s_concurrent']:.1f} on one (a record, not a claim)")
    return rec


def fleet_phase(tf, gen_mod, engine_mod, server_mod, fa, generator, served, solo):
    """Phase 21 (right after phase 20, on phase 4's generator): the host KV
    tier, live migration and the engine fleet, 21a-21f. ``solo``: phase
    15's solo runs of phase 4's 4 questions."""
    from llm_fine_tune_distributed_tpu_torch.infer import fleet as fleet_mod
    from llm_fine_tune_distributed_tpu_torch.infer import paged as paged_mod
    from llm_fine_tune_distributed_tpu_torch.observe import metrics as metrics_mod

    t0 = time.monotonic()
    prompts = [_prompt_ids(generator, {"question": q}) for q in QUESTIONS]
    floor = 2 * max(int8_kv_noise(tf, generator, p) for p in prompts)
    out = {"int8_floor": floor, "a": fleet_tier_round_trip(engine_mod, paged_mod, generator)}
    gc_cuda()
    out["b"] = fleet_tier_restore(tf, engine_mod, paged_mod, generator, served, solo, floor)
    gc_cuda()
    fleet, out["c"] = fleet_migration(tf, gen_mod, engine_mod, paged_mod, fleet_mod, fa,
                                      generator, floor)
    try:
        out["f"] = fleet_restart_beside_sibling(tf, gen_mod, fa, fleet, generator, floor)
    finally:
        fleet.close()
    del fleet
    gc_cuda()
    out["d"] = fleet_disaggregated(tf, server_mod, fa, generator, served, solo, floor)
    gc_cuda()
    out["e"] = fleet_serving_and_scale(tf, server_mod, fa, metrics_mod, generator, served, solo,
                                       floor)
    gc_cuda()
    out["seconds"] = time.monotonic() - t0
    phase(21, f"phase 21 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 22: multi-tenant LoRA serving
# ---------------------------------------------------------------------------

# the reference's adapter recipe: r 16, alpha 8 on the seven projections
ADAPTER_RANK, ADAPTER_ALPHA = 16, 8.0
ADAPTER_B_STD = 0.05  # B non-zero (a fresh LoRA has B = 0: no delta at all)
ADAPTER_SEEDS = {"t1": 1001, "t2": 1002, "t3": 1003}
MAX_ADAPTERS = 3  # slot 0 and two tenants: a third tenant's load evicts an idle one
ADAPTER_PROFILE_STEPS = 2
ADAPTER_FAULT_SCALE = 1.5  # 22a's planted fault: the pooled delta this many times too large
ADAPTER_RESTART_TOKENS = 16  # 22f's requests: three of them, one across the restart
# the caching allocator's rounding of the 756 pool tensors (and the unsplit
# rest of a segment it hands out whole), as a share of the pools' bytes
ADAPTER_MEMORY_SLACK = 0.01


def make_adapters(lora_mod, generator, root):
    """Three PEFT adapters for phase 4's model (``ADAPTER_SEEDS``, a
    ``torch.Generator`` each): A uniform in +-sqrt(3 / in), B normal at
    ``ADAPTER_B_STD``, on every target kernel, written by the port's
    ``save_lora_adapter``. Returns the file size of one."""
    for name, seed in ADAPTER_SEEDS.items():
        g = torch.Generator(device="cpu").manual_seed(seed)
        leaves = {}
        for pname, kernel in generator.params.items():
            module, _, leaf = pname.rpartition(".")
            if leaf != "kernel" or module.rpartition(".")[2] not in lora_mod.LORA_TARGET_MODULES:
                continue
            d_in, d_out = kernel.shape
            bound = (3.0 / d_in) ** 0.5
            leaves[module + ".lora_a"] = (torch.rand(d_in, ADAPTER_RANK, generator=g) * 2 - 1) * bound
            leaves[module + ".lora_b"] = torch.randn(ADAPTER_RANK, d_out, generator=g) * ADAPTER_B_STD
            leaves[module + ".lora_scale"] = torch.tensor(ADAPTER_ALPHA / ADAPTER_RANK)
        lora_mod.save_lora_adapter(leaves, f"{root}/{name}", lora_mod.LoraConfig(
            lora_rank=ADAPTER_RANK, lora_alpha=ADAPTER_ALPHA))
    return _file_bytes(f"{root}/t1/adapter_model.safetensors")


def _file_bytes(path):
    import os

    return os.path.getsize(path)


def _pool_tensors(reg):
    return [t for name, t in reg.params.items() if name.endswith("_pool")]


def adapter_pools_and_loads(adapters_mod, generator, root):
    """22c: a registry of ``MAX_ADAPTERS`` slots over phase 4's weights:
    ``memory_allocated`` growth against the pools' bytes (within 1%), then
    the hot-load of each adapter (wall, synchronized: the file read, the
    validation, the padding and the 756 slot writes), the third evicting the
    least recently used idle one, and a rebuild of the two residents (the
    writes alone). Returns the record and the registry, t1 and t2 pinned
    (22a and 22d read their pools)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    reg = adapters_mod.AdapterRegistry(generator.params, root, max_adapters=MAX_ADAPTERS)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    pool_bytes = reg.pool_bytes()
    check(pool_bytes <= grown <= pool_bytes * (1 + ADAPTER_MEMORY_SLACK),
          f"22c: memory_allocated grew {grown} B for {pool_bytes} B of pools")
    slot_bytes = sum(t[0].nbytes for t in _pool_tensors(reg) if t.dim() == 3)
    loads = {}
    for name in ("t1", "t2", "t3"):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        reg.acquire(name)
        torch.cuda.synchronize()
        loads[name] = (time.monotonic() - t0) * 1e3
        reg.release(name)
    check(sorted(reg.resident()) == ["t2", "t3"] and not reg.is_resident("t1"),
          f"22c: resident {reg.resident()} after loading t3 into a pool of two tenants")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    reg.rebuild()
    torch.cuda.synchronize()
    rebuild_ms = (time.monotonic() - t0) * 1e3
    for name in ("t1", "t2"):  # pinned for 22a and 22d: t1 evicts t3
        reg.acquire(name)
    rec = {"pool_bytes": pool_bytes, "memory_allocated_growth": grown, "slot_bytes": slot_bytes,
           "load_ms": loads, "rebuild_ms_two_adapters": rebuild_ms,
           "adapter_file_bytes": _file_bytes(f"{root}/t1/adapter_model.safetensors")}
    phase(22, f"22c registry of {MAX_ADAPTERS} slots: memory_allocated +{grown} B for "
              f"{pool_bytes} B of f32 pools ({slot_bytes} B per slot); hot-load of one "
              f"{rec['adapter_file_bytes'] / 1e6:.1f} MB adapter {loads['t1']:.1f} ms (t2 "
              f"{loads['t2']:.1f}, t3 evicting t1 {loads['t3']:.1f}); a rebuild of the two "
              f"residents' slots {rebuild_ms:.1f} ms")
    return rec, reg


def exact_merged(lora_mod, generator, path):
    """The adapter at ``path`` folded into phase 4's weights exactly: each
    target kernel ``W + scale * A @ B`` in f32 on the card (the other
    leaves shared), the reference that phase 22 holds every adapted path
    to."""
    adapted = lora_mod.load_lora_adapter(generator.params, path)
    exact = dict(generator.params)
    for name, a in adapted.items():
        module, _, leaf = name.rpartition(".")
        if leaf == "lora_a":
            delta = (a.float() @ adapted[module + ".lora_b"].float()) * adapted[module + ".lora_scale"]
            exact[module + ".kernel"] = generator.params[module + ".kernel"].float() + delta
    return adapted, exact


def _last_logits(tf, generator, params, ids, n, dtype, **kw):
    """Logits [n, vocab] (f32) of the last ``n`` positions of one dense
    no-cache forward over ``ids`` [1, s]."""
    with torch.no_grad():
        hidden, _ = tf.forward(params, ids, generator.config, compute_dtype=dtype,
                               output_hidden=True, **kw)
        return tf.unembed(params, hidden[0, -n:], generator.config, compute_dtype=dtype).float()


class _RecordingUnembed:
    """The logits that the Generator's own ``unembed`` returns, in call
    order, while the block runs (the prefill and decode steps return only
    tokens)."""

    def __init__(self, gen_mod):
        self._mod, self._plain, self.logits = gen_mod, gen_mod.unembed, []

    def __enter__(self):
        def record(*a, **kw):
            out = self._plain(*a, **kw)
            self.logits.append(out.float().clone())
            return out

        self._mod.unembed = record
        return self.logits

    def __exit__(self, *exc):
        self._mod.unembed = self._plain


def engine_path(gen_mod, generator, prompts, label, view=None, slots=None):
    """The engine's own path for one row per prompt: ``paged_prefill_final``
    of each prompt through a fresh int8 pool (on its adapter slot, with an
    adapter registry's pooled ``view`` in the slot state), then one
    ``paged_step`` with all rows in the batch (the pooled delta beside the
    paged decode kernel). ``view`` alone runs the slot state on other
    weights. Returns, per row, (its context: the prompt and the first
    token, its step-0 logits, its step-1 logits)."""
    with _RecordingUnembed(gen_mod) as seen:
        pool, state, live, tables, _, ctx = paged_slots(generator, prompts, 1, view=view,
                                                        adapter_idx=slots)
        generator.paged_step(pool, state, live, tables)
    check(len(seen) == len(prompts) + 1, f"{label}: {len(seen)} unembed calls on the engine path")
    del pool, state
    return [(ctx[i], seen[i][0], seen[-1][i]) for i in range(len(prompts))]


def _first_token_gap(truth0, prompt, token):
    """How far below the top the penalized exact logit of ``token`` is at
    the first step (the repetition penalty over the prompt, as greedy
    decoding applies it)."""
    from llm_fine_tune_distributed_tpu_torch.infer.sampling import (
        GenerationConfig,
        apply_repetition_penalty,
    )

    seen = torch.zeros(1, truth0.shape[-1], dtype=torch.bool, device=truth0.device)
    seen[0, list(prompt)] = True
    pen = apply_repetition_penalty(truth0[None], seen,
                                   GenerationConfig(max_new_tokens=1).repetition_penalty)[0]
    return (pen.max() - pen[token]).item()


def check_first_token(refs, name, prompt, token, label):
    """A served tenant's first token: its exact merged logit within the
    tenant's bound of the top one."""
    ref = refs[name]
    gap = _first_token_gap(ref["truth0"], prompt, token)
    check(gap <= ref["floor"], f"{label}: first token {token} is {gap:.3e} below the exact "
                               f"merged model's top logit, bound {ref['floor']:.3e}")
    return gap


def tenant_refs(tf, gen_mod, lora_mod, generator, reg, root, prompts, floor_i8):
    """Each tenant held to its adapter folded into the weights exactly (f32,
    ``exact_merged``), at the prompt's last position and at the next step.
    The bf16 bound is the merged bf16 model's own error against that
    reference, twice (``rounding``), beside the int8 pool's floor; nothing
    of the pooled path sets it. In f32 the pooled view equals the exact
    merge within phase 13's f32 rule; in bf16 within ``rounding``. The
    engine's own path (``engine_path``: the prefill and one decode
    step of both tenants' rows in one batch, over the int8 pool) is within
    ``rounding`` + the int8 floor at both steps, its first token too; the
    same path with the slots swapped (its logits and its first token), the
    pooled delta ``ADAPTER_FAULT_SCALE`` times too large, and the base model
    are all outside their bound. Each
    tenant's merged bf16 solo run (phase 15's solo loop) is what 22a holds
    its served tokens to, with ``floor`` = the int8 floor + ``rounding``."""
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    names = list(prompts)
    slots = [reg.slot_of(n) for n in names]
    rows = [prompts[n] for n in names]
    engine = engine_path(gen_mod, generator, rows, "22a", reg.params, slots)
    swapped = engine_path(gen_mod, generator, rows, "22a", reg.params, slots[::-1])
    fault = {k: (v * ADAPTER_FAULT_SCALE if k.endswith("lora_scale_pool") else v)
             for k, v in reg.params.items()}
    refs = {}
    config, dtype = generator.config, generator.compute_dtype
    for i, name in enumerate(names):
        prompt = prompts[name]
        adapted, exact = exact_merged(lora_mod, generator, f"{root}/{name}")
        merged = gen_mod.Generator(lora_mod.merge_lora(adapted), config, generator.tokenizer,
                                   compute_dtype=dtype, device=DEVICE)
        del adapted
        ctx, step0, step1 = engine[i]
        ids = torch.tensor([ctx], device=DEVICE)  # the prompt and the engine's first token
        idx = torch.tensor([slots[i]], device=DEVICE)
        truth = _last_logits(tf, generator, exact, ids, 2, torch.float32)
        del exact
        gc_cuda()
        got = {
            "pooled_f32": _last_logits(tf, generator, reg.params, ids, 2, torch.float32,
                                       adapter_idx=idx),
            "merged": _last_logits(tf, generator, merged.params, ids, 2, dtype),
            "pooled": _last_logits(tf, generator, reg.params, ids, 2, dtype, adapter_idx=idx),
            "fault": _last_logits(tf, generator, fault, ids, 2, dtype, adapter_idx=idx),
            "base": _last_logits(tf, generator, generator.params, ids, 2, dtype),
            "engine": torch.stack([step0, step1]),
            # step 0 only: its step 1 fed the swapped run's own first token
            "swapped": swapped[i][1][None],
        }
        err = {k: (v - truth[: len(v)]).abs().max().item() for k, v in got.items()}
        rounding = 2 * err["merged"]
        floor = floor_i8 + rounding
        f32_bound = 2 * LOGIT_REL_TOL * truth.abs().max().item()
        check(err["pooled_f32"] <= f32_bound,
              f"22a {name}: f32 pooled view {err['pooled_f32']:.3e} off the exact merge, "
              f"bound {f32_bound:.3e}")
        check(err["pooled"] <= rounding,
              f"22a {name}: bf16 pooled view {err['pooled']:.3e} off the exact merge, bound "
              f"{rounding:.3e} (twice the merged bf16 model's own)")
        check(err["engine"] <= floor,
              f"22a {name}: the engine path's logits {err['engine']:.3e} off the exact merge, "
              f"bound {floor:.3e}")
        for key, what, bound in (("fault", f"a pooled delta {ADAPTER_FAULT_SCALE}x too large",
                                  rounding),
                                 ("swapped", "the engine path on the other tenant's slot", floor),
                                 ("base", "the base model", floor)):
            check(err[key] > bound, f"22a {name}: {what} is only {err[key]:.3e} off the exact "
                                    f"merge, within the bound {bound:.3e} that must refuse it")
        first_gap = _first_token_gap(truth[0], prompt, ctx[-1])
        check(first_gap <= floor, f"22a {name}: the engine path's first token is {first_gap:.3e} "
                                  f"below the exact top logit, bound {floor:.3e}")
        swapped_gap = _first_token_gap(truth[0], prompt, swapped[i][0][-1])
        check(swapped_gap > floor, f"22a {name}: on the other tenant's slot the engine path's "
                                   f"first token is only {swapped_gap:.3e} below the exact top "
                                   f"logit, within the bound {floor:.3e} that must refuse it")
        solo = solo_decode(tf, gen_mod, merged, prompt, MAX_NEW_TOKENS)
        refs[name] = {"generator": merged, "solo": solo, "floor": floor, "truth0": truth[0],
                      "rounding": rounding, "max_abs_err": err, "f32_bound": f32_bound,
                      "engine_first_token_gap": first_gap,
                      "swapped_first_token_gap": swapped_gap}
        phase(22, f"22a {name}: max|dlogits| against the exact merge (f32), first two steps: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
                  + f"; bounds f32 {f32_bound:.3e}, bf16 {rounding:.3e}, with the int8 floor "
                    f"{floor:.3e}; first token {first_gap:.3e} below the top (swapped slot "
                    f"{swapped_gap:.3e})")
    del fault
    return refs


def _hold_tenant(tf, refs, name, prompt, tokens, label, n=MAX_NEW_TOKENS):
    """A tenant's tokens against the first ``n`` steps of its merged-solo
    run, by the margin rule with the tenant's floor."""
    ref = refs[name]
    solo = tuple(part[:n] for part in ref["solo"])
    return margin_agreement(tf, ref["generator"], label, prompt, tokens, solo,
                            floor=ref["floor"])


def adapter_cobatch(tf, server_mod, fa, generator, root, refs, solo, floor_i8):
    """22a/22b: a paged int8 server at phase 4's geometry with
    ``--adapter-dir`` and ``--max-adapters 3``: t1 decodes (its steps held at
    a gate), then t2, a base request and a sampled neighbour arrive and are
    stepped in until all four rows decode in one tick. Each tenant's tokens
    held to its merged-solo run and the base request's to its solo run by
    the margin rule; paged decode launches == 36 x decode steps."""
    bodies = [
        {"question": QUESTIONS[0], "greedy": True, "max_new_tokens": MAX_NEW_TOKENS,
         "adapter": "t1"},
        {"question": QUESTIONS[1], "greedy": True, "max_new_tokens": MAX_NEW_TOKENS,
         "adapter": "t2"},
        {"question": QUESTIONS[2], "greedy": True, "max_new_tokens": MAX_NEW_TOKENS},
        {"question": QUESTIONS[3], "greedy": False, "temperature": 1.0, "seed": 11,
         "max_new_tokens": MAX_NEW_TOKENS},
    ]
    prompts = [_prompt_ids(generator, b) for b in bodies]
    held = _Held(generator)
    fa.paged_decode_attention.launches = 0  # this run's launches only
    with _Serving(server_mod, held, **_paged_kw(slots=SLOTS, adapter_dir=root,
                                                max_adapters=MAX_ADAPTERS)) as srv:
        eng = srv.engine
        joins = [_post_async(srv.base, "/v1/generate", bodies[0])]
        held.park()  # t1 decodes; the others arrive into its batch
        joins += [_post_async(srv.base, "/v1/generate", b) for b in bodies[1:]]
        _wait_for(lambda: eng.queue_depth + len(eng._prefills) + eng.live_slots == len(bodies),
                  "the other three requests' arrival")
        for _ in range(64):  # one prefill chunk and one decode step at a time
            if eng.live_slots == len(bodies):
                break
            held.step()
        held.open()
        responses = [join() for join in joins]
        stats = eng.stats_snapshot()
        launches = fa.paged_decode_attention.launches
        live_max = max((e.get("live", 0) for e in eng.recorder.events() if e["kind"] == "tick"),
                       default=0)
        got = {tuple(p): ids for p, ids in srv.results}
    _all_ok("22a", responses)
    layers = generator.config.num_layers
    check(launches == layers * stats["decode_steps"],
          f"22b: {launches} paged decode launches, want {layers} x {stats['decode_steps']}")
    check(live_max == len(bodies), f"22a: at most {live_max} rows decoded together, want 4")
    check(stats["per_tenant"].get("t1", {}).get("requests") == 1
          and stats["per_tenant"].get("t2", {}).get("tokens") == len(got[tuple(prompts[1])])
          and stats["adapters_resident"] == 2 and stats["adapter_loads"] == 2,
          f"22a: per_tenant {stats['per_tenant']}, resident {stats['adapters_resident']}, "
          f"loads {stats['adapter_loads']}")
    agree, first_gap = {}, {}
    for name, prompt in (("t1", prompts[0]), ("t2", prompts[1])):
        first_gap[name] = check_first_token(refs, name, prompt, got[tuple(prompt)][0],
                                            f"22a {name}")
        agree[name] = _hold_tenant(tf, refs, name, prompt, got[tuple(prompt)], f"22a {name}")
    agree["base"] = margin_agreement(tf, generator, "22a base", prompts[2], got[tuple(prompts[2])],
                                     solo[tuple(prompts[2])], floor=floor_i8)
    sampled = got[tuple(prompts[3])]
    check(1 <= len(sampled) <= MAX_NEW_TOKENS
          and all(0 <= t < generator.config.vocab_size for t in sampled),
          f"22a: the sampled neighbour's tokens {sampled}")
    rec = {"launches": launches, "decode_steps": stats["decode_steps"], "live_rows_max": live_max,
           "tokens_agreeing_with_solo": {k: v[0] for k, v in agree.items()},
           "first_difference": {k: v[1] for k, v in agree.items()},
           "first_token_gap": first_gap,
           "per_tenant": stats["per_tenant"], "decode_step_ms_mean":
           1e3 * _hist(eng, "decode_tick_s")[0] / max(1, _hist(eng, "decode_tick_s")[1])}
    phase(22, f"22a t1, t2, a base request and a sampled neighbour co-batched ({live_max} rows in "
              f"one tick): tokens equal to the solo runs' {rec['tokens_agreeing_with_solo']} of "
              f"{MAX_NEW_TOKENS}; each tenant's first token below the exact merge's top logit "
              f"by {first_gap}; mean decode tick {rec['decode_step_ms_mean']:.2f} ms")
    phase(22, f"22b paged decode launches {launches} == {layers} x {stats['decode_steps']} decode "
              "steps")
    return rec


def adapter_tick_profile(generator, reg, prompts):
    """22d: phase 6's decode step at 4 live rows of 8, base-only, then with
    the rows on t1, t2, t1, t2 (the registry's pooled view): wall and
    device time, kernels per tick, busy share, top kernels."""
    pool, state, live, tables, nb, _ = paged_slots(generator, prompts, 2 * ADAPTER_PROFILE_STEPS)

    def tick():
        generator.paged_step(pool, state, live, tables)

    base = profile_ticks(tick, ADAPTER_PROFILE_STEPS)
    state["params"] = reg.params
    state["adapter_idx"][: len(prompts)] = [reg.slot_of(n) for n in ("t1", "t2", "t1", "t2")]
    adapted = profile_ticks(tick, ADAPTER_PROFILE_STEPS)
    rec = {"live_rows": len(prompts), "nb": nb, "base": base, "adapters": adapted}
    for label, r in (("base-only", base), ("adapters live", adapted)):
        phase(22, f"22d decode tick at {len(prompts)} live rows, nb={nb}, {label}: "
                  f"{r['step_ms']:.2f} ms ({r['profiled_step_ms']:.2f} ms profiled), "
                  f"{r['device_ms_per_step']:.3f} ms of device time, "
                  f"{r['device_kernels_per_step']:.0f} kernels per tick, busy "
                  f"{100 * (r['device_busy_share'] or 0):.1f}%")
        for row in r["top_kernels"][:6]:
            phase(22, f"  {row['ms_per_step']:8.3f} ms/tick  {row['calls_per_step']:6.1f} calls  "
                      f"{row['name']}")
    return rec


def adapter_http_refusals(server_mod, generator, root):
    """22e: ``--max-adapters 3 --adapter-capacity 1``, decode held at a gate
    while t1 decodes and t2 waits (both pinned at admission): an unknown
    adapter 404 with the known list, t3 429 ``adapter_pool_full`` and t1
    again 429 ``tenant_quota``, each with Retry-After; then both finish."""
    held = _Held(generator)
    with _Serving(server_mod, held, **_paged_kw(slots=OVERLOAD_SLOTS, adapter_dir=root,
                                                max_adapters=MAX_ADAPTERS,
                                                adapter_capacity=1)) as srv:
        eng, base = srv.engine, srv.base
        occupants = [_post_async(base, "/v1/generate",
                                 _short_body(QUESTIONS[0], 8, adapter="t1"))]
        held.park()
        occupants.append(_post_async(base, "/v1/generate",
                                     _short_body(QUESTIONS[1], 8, adapter="t2")))
        _wait_for(lambda: eng.queue_depth + eng.live_slots >= 2, "t2's admission")
        status, headers, raw = _request(base, "/v1/generate",
                                        _short_body(QUESTIONS[2], 8, adapter="ghost"))
        unknown = _taxonomy("22e unknown adapter", status, headers, raw, 404, "unknown_adapter",
                            retry=False)
        check(unknown["known_adapters"] == sorted(ADAPTER_SEEDS), f"22e: {unknown}")
        status, headers, raw = _request(base, "/v1/generate",
                                        _short_body(QUESTIONS[2], 8, adapter="t3"))
        full = _taxonomy("22e full pool", status, headers, raw, 429, "adapter_pool_full")
        status, headers, raw = _request(base, "/v1/generate",
                                        _short_body(QUESTIONS[3], 8, adapter="t1"))
        quota = _taxonomy("22e tenant quota", status, headers, raw, 429, "tenant_quota")
        held.open()
        statuses = [join()[0] for join in occupants]
        stats = eng.stats_snapshot()
    check(statuses == [200, 200], f"22e: the pinned tenants answered {statuses}")
    check(stats["requests_shed_tenant_quota"] == 1, f"22e: {stats['requests_shed_tenant_quota']}")
    rec = {"unknown": unknown["kind"], "pool_full_retry_after_s": full["retry_after_s"],
           "quota_retry_after_s": quota["retry_after_s"]}
    phase(22, f"22e over HTTP: unknown adapter 404 with known {unknown['known_adapters']}; t3 429 "
              f"adapter_pool_full (Retry-After hint {full['retry_after_s']:.2f} s); t1 over its "
              f"quota 429 tenant_quota ({quota['retry_after_s']:.2f} s); both pinned tenants 200")
    return rec


def adapter_restart_and_prefix_keys(tf, server_mod, generator, root, refs):
    """22f, then 22g on the same paged int8 server with adapters. 22f: t1's
    request on the fresh engine, the same again with a decode failure armed
    (503 ``engine_restarting``), then again on generation 1: the rebuild
    writes the resident pools back bit for bit, and both answers are held
    to t1's merged-solo run (and compared: both ran on a fresh pool). 22g:
    phase 4's questions share their ~1.43k-token system prompt (5 full
    256-token blocks), and t1's last request left its blocks in the new
    generation's prefix cache: t2, then a base request, reuse none of them
    (the keys are salted with the adapter's name), t1 reuses its own."""
    body = {"question": QUESTIONS[0], "greedy": True, "max_new_tokens": ADAPTER_RESTART_TOKENS,
            "adapter": "t1"}
    prompt = _prompt_ids(generator, body)
    order = (("t2", QUESTIONS[1]), (None, QUESTIONS[3]), ("t1", QUESTIONS[2]))
    with _Serving(server_mod, generator, **_paged_kw(slots=OVERLOAD_SLOTS, adapter_dir=root,
                                                     max_adapters=MAX_ADAPTERS,
                                                     restart_backoff_s=RESTART_BACKOFF_S)) as srv:
        eng, base = srv.engine, srv.base
        marks = _restart_marks(eng)
        check(_request(base, "/v1/generate", body)[0] == 200, "22f: generation 0")
        first = srv.results[-1][1]
        reg = eng._mt
        pools = [t.clone() for t in _pool_tensors(reg)]
        slot = reg.slot_of("t1")
        eng.faults.fail_decode_at(eng._decode_index + 4)  # mid-request: 16 tokens
        status, headers, raw = _request(base, "/v1/generate", body)
        _taxonomy("22f crashed request", status, headers, raw, 503, "engine_restarting")
        _wait_for(lambda: "built" in marks and eng.stats_snapshot()["engine_generation"] == 1,
                  "the restart")
        same_pools = all(torch.equal(a, b) for a, b in zip(pools, _pool_tensors(reg)))
        del pools
        check(_request(base, "/v1/generate", body)[0] == 200, "22f: generation 1")
        after = srv.results[-1][1]
        refcount, resident_slot = reg.refcount("t1"), reg.slot_of("t1")
        reused, hits0 = [], eng.stats_snapshot()
        before, hits0 = hits0["prefix_tokens_reused"], hits0["prefix_hits"]
        for adapter, question in order:
            req = {"question": question, "greedy": True, "max_new_tokens": 8}
            if adapter:
                req["adapter"] = adapter
            check(_request(base, "/v1/generate", req)[0] == 200, f"22g {adapter} request")
            now = eng.stats_snapshot()["prefix_tokens_reused"]
            reused.append(now - before)
            before = now
        hits = eng.stats_snapshot()["prefix_hits"] - hits0
    check(same_pools and resident_slot == slot and refcount == 0,
          f"22f: pools equal after the rebuild {same_pools}, slot {resident_slot} (was {slot}), "
          f"refcount {refcount}")
    runs = (("generation 0", first), ("generation 1", after))
    gaps = [check_first_token(refs, "t1", prompt, got[0], f"22f {run}") for run, got in runs]
    agree = [_hold_tenant(tf, refs, "t1", prompt, got, f"22f {run}", ADAPTER_RESTART_TOKENS)[0]
             for run, got in runs]
    f = {"pools_equal_after_rebuild": same_pools, "tokens_agreeing_with_solo": agree,
         "first_token_gap": gaps,
         "generation_1_equals_generation_0": first == after,
         "restart_s": marks["built"] - marks["failed"]}
    phase(22, f"22f t1 across a restart: 503 engine_restarting, generation 1 after "
              f"{f['restart_s'] * 1e3:.1f} ms with the pools rebuilt bit for bit (slot {slot}); "
              f"tokens equal to the merged-solo run's {agree} of {ADAPTER_RESTART_TOKENS}, the first "
              f"below the exact merge's top logit by {gaps}; generation 1 == generation 0: "
              f"{first == after}")
    full = len(prompt) // KV_BLOCK_LEN
    check(reused[0] == reused[1] == 0 and reused[2] >= 5 * KV_BLOCK_LEN and hits == 1,
          f"22g: prompt tokens reused per request {reused}, prefix hits {hits}")
    phase(22, f"22g shared system prompt ({full} full blocks, t1's in the cache): tokens reused "
              f"t2 {reused[0]}, base {reused[1]}, t1 {reused[2]}; prefix hits {hits}")
    return f, {"reused": reused, "prefix_hits": hits}


def adapter_phase(tf, gen_mod, server_mod, fa, generator, solo):
    """Phase 22 (right after phase 21, on phase 4's generator): multi-tenant
    LoRA serving, 22a-22g. ``solo``: phase 15's solo runs of phase 4's 4
    questions."""
    import tempfile

    from llm_fine_tune_distributed_tpu_torch.infer import adapters as adapters_mod
    from llm_fine_tune_distributed_tpu_torch.parallel import lora as lora_mod

    t0 = time.monotonic()
    laps = {}

    def lap(name):
        laps[name] = time.monotonic() - t0 - sum(laps.values())

    prompts = [_prompt_ids(generator, {"question": q}) for q in QUESTIONS]
    floor_i8 = 2 * max(int8_kv_noise(tf, generator, p) for p in prompts)
    out = {"int8_floor": floor_i8, "seconds_by_part": laps}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_adapters_") as root:
        make_adapters(lora_mod, generator, root)
        lap("adapters made")
        out["c"], reg = adapter_pools_and_loads(adapters_mod, generator, root)
        lap("c")
        refs = tenant_refs(tf, gen_mod, lora_mod, generator, reg, root,
                           {"t1": prompts[0], "t2": prompts[1]}, floor_i8)
        out["tenants"] = {name: {k: v for k, v in ref.items() if k in (
            "max_abs_err", "rounding", "floor", "f32_bound", "engine_first_token_gap",
            "swapped_first_token_gap")} for name, ref in refs.items()}
        lap("merged-solo refs")
        out["a"] = adapter_cobatch(tf, server_mod, fa, generator, root, refs, solo, floor_i8)
        lap("a, b")
        out["d"] = adapter_tick_profile(generator, reg, prompts)
        lap("d")
        del reg
        gc_cuda()
        out["e"] = adapter_http_refusals(server_mod, generator, root)
        lap("e")
        out["f"], out["g"] = adapter_restart_and_prefix_keys(tf, server_mod, generator, root,
                                                             refs)
        lap("f, g")
        del refs
    gc_cuda()
    out["seconds"] = time.monotonic() - t0
    phase(22, f"phase 22 took {out['seconds']:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in laps.items()))
    return out


# ---------------------------------------------------------------------------
# phase 7: the flash-attention kernels against their plain versions
# ---------------------------------------------------------------------------

# the training smoke's attention shapes: SmolLM3-3B heads at seq 1024, one
# microbatch of 8 rows with ragged lengths, and one packed case
FLASH_SHAPE = dict(b=8, s=1024, hq=16, hkv=4, d=128)
FLASH_LENGTHS = (1024, 1000, 700, 513, 512, 300, 129, 1)
# f32 inputs (the CUDA-core kernels): the JAX package's own bands
# (tests/test_flash_attention.py), kernel against plain on the same inputs
FLASH_F32_TOL = {"o": 2e-5, "lse": 2e-5, "dq": 5e-5, "dk": 5e-5, "dv": 5e-5}
# bf16 inputs: the tensor-core kernels take P and dS as bf16 operands, so
# they are held as FlashAttention's own tests hold theirs: the max error
# against an f32 truth (the plain version on the inputs upcast) within 2x
# that of SDPA in bf16 on the same inputs, plus 1e-5. LSE's scores are exact
# bf16 products summed in f32, so only the order of the sum differs.
FLASH_SDPA_FACTOR, FLASH_SDPA_ATOL, FLASH_LSE_TOL = 2.0, 1e-5, 1e-4
# The same rule row by row (a row: the d entries of one position and head),
# so that small rows (dk/dv of late keys, O and dq of short segments) are held to
# their own scale: max|kernel - truth| over the row <= 2 x SDPA's in that row
# + half a bf16 ulp of the row's largest |truth| + 1e-5.
FLASH_ROW_HALF_ULP = 2.0**-8
# planted faults that the row rule must fail (bf16, ragged, d 128): dk/dv
# with the diagonal pair of one key tile dropped, dk without one query
# head's share; dq with the diagonal pair of one query tile dropped, and dq
# without one key tile's share
FLASH_FAULT_TILE, FLASH_FAULT_HEAD, FLASH_FAULT_KEY_TILE = 12, 1, 3
FLASH_TOLERANCE = ("bf16 tensor cores (flash_fwd, flash_bwd_dq, flash_bwd_dkv): O, dq, dk, dv "
                   "max|kernel - f32 truth| <= 2 x SDPA bf16's + 1e-5 over the tensor, and per row <= "
                   "2 x SDPA's in the row + 2**-8 x the row's max|truth| + 1e-5; LSE <= 1e-4; f32 "
                   "(CUDA cores): max|kernel - plain| <= 2e-5 (O, LSE), 5e-5 (dq, dk, dv)")
FLASH_DESIGN = {
    "flash_fwd": ("flash_fwd_tc_kernel", "bf16 mma.sync m16n8k16, cp.async ring, segment-aware "
                                         "tile skipping; f32: CUDA-core flash_fwd_kernel"),
    "flash_bwd_dq": ("flash_bwd_dq_tc_kernel", "bf16 mma.sync m16n8k16 (S, dP, dS K), cp.async "
                                               "ring, segment-aware tile skipping; f32: CUDA-core "
                                               "flash_bwd_dq_kernel"),
    "flash_bwd_dkv": ("flash_bwd_dkv_tc_kernel", "bf16 mma.sync m16n8k16, cp.async ring, "
                                                 "segment-aware tile skipping; f32: CUDA-core "
                                                 "flash_bwd_dkv_kernel"),
}


def flash_segments_case(kind, b, s):
    """int32 [b, s] segments: "ragged" is the right-padding mask of
    FLASH_LENGTHS; "packed" gives each row a few packed segments (ids
    1, 2, ...) and a pad tail (0)."""
    seg = torch.zeros(b, s, dtype=torch.int32)
    gen = torch.Generator().manual_seed(7)
    for r in range(b):
        if kind == "ragged":
            seg[r, : FLASH_LENGTHS[r % len(FLASH_LENGTHS)]] = 1
        else:
            pos, sid = 0, 1
            end = s - int(torch.randint(0, s // 4, (1,), generator=gen))
            while pos < end:
                n = int(torch.randint(1, s // 3, (1,), generator=gen))
                seg[r, pos: min(pos + n, end)] = sid
                pos, sid = pos + n, sid + 1
    return seg.to(DEVICE)


def flash_inputs(dtype, seed=0, b=None, d=None, heads=None):
    shape = dict(FLASH_SHAPE, **({"b": b} if b else {}), **({"d": d} if d else {}),
                 **(dict(zip(("hq", "hkv"), heads)) if heads else {}))
    b, s, hq, hkv, d = (shape[k] for k in ("b", "s", "hq", "hkv", "d"))
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    q = torch.randn(b, s, hq, d, generator=gen, device=DEVICE).to(dtype)
    k = torch.randn(b, s, hkv, d, generator=gen, device=DEVICE).to(dtype)
    v = torch.randn(b, s, hkv, d, generator=gen, device=DEVICE).to(dtype)
    do = torch.randn(b, s, hq, d, generator=gen, device=DEVICE).to(dtype)
    return q, k, v, do


def visible_pairs(seg):
    """(query, key) pairs the mask lets through: sum over rows and queries
    of the keys at or before the query with its segment id."""
    total = 0
    for row in seg.tolist():
        counts: dict = {}
        for sid in row:
            counts[sid] = counts.get(sid, 0) + 1
            total += counts[sid]
    return total


def flash_bounds(q, k, seg, peaks):
    """{kernel: (bound_ms, bound_by)} for this run's inputs: flops 4d per
    visible pair and query head for the forward (q k^T and p V), 6d for dq
    (q k^T, dO V^T, ds K), 8d for dk/dv (those and ds^T q, p^T dO); bytes
    each input read once and each output written once."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    e = q.element_size()
    pairs = visible_pairs(seg) * hq
    qb, kvb, segb, statb = b * s * hq * d * e, b * s * hkv * d * e, b * s * 4, b * hq * s * 4
    mem_rate, bf16_rate, f32_rate = peaks
    rate = bf16_rate if q.dtype == torch.bfloat16 else f32_rate
    work = {
        "flash_fwd": (4 * d * pairs, qb + 2 * kvb + segb + qb + statb),
        "flash_bwd_dq": (6 * d * pairs, 2 * qb + 2 * kvb + segb + 2 * statb + qb),
        "flash_bwd_dkv": (8 * d * pairs, 2 * qb + 2 * kvb + segb + 2 * statb + 2 * kvb),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / rate, nbytes / mem_rate
        out[name] = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
                     flops, nbytes)
    return out


def sdpa_bf16(q, k, v, do, seg):
    """The bf16 yardstick, never called by the port: O, dq and dk/dv (summed
    over each kv head's query group) of ``scaled_dot_product_attention`` in
    bf16 with the same boolean mask, in the port's layout, as f32."""
    import torch.nn.functional as F

    b, s, hq, d = q.shape
    hkv = k.shape[2]
    groups = hq // hkv
    causal = torch.ones(s, s, dtype=torch.bool, device=DEVICE).tril()
    mask = (causal & (seg[:, :, None] == seg[:, None, :]))[:, None]
    qh = q.transpose(1, 2).detach().requires_grad_()
    kh = k.transpose(1, 2).repeat_interleave(groups, dim=1).detach().requires_grad_()
    vh = v.transpose(1, 2).repeat_interleave(groups, dim=1).detach().requires_grad_()
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    gq, gk, gv = torch.autograd.grad(out, (qh, kh, vh), do.transpose(1, 2))
    fold = lambda x: x.float().reshape(b, hkv, groups, s, d).sum(2).transpose(1, 2)  # noqa: E731
    return out.detach().transpose(1, 2).float(), gq.transpose(1, 2).float(), fold(gk), fold(gv)


def row_rule(got, truth, sdpa):
    """The SDPA-relative rule row by row (rows: the last dim): (rows beyond
    their limit, rows, the largest max|got - truth| / limit of a row)."""
    err = (got.float() - truth).abs().amax(-1)
    limit = (FLASH_SDPA_FACTOR * (sdpa - truth).abs().amax(-1)
             + FLASH_ROW_HALF_ULP * truth.abs().amax(-1) + FLASH_SDPA_ATOL)
    return int((err > limit).sum()), err.numel(), float((err / limit).max())


def fault_caught(fault, name, faulty, truth, sdpa, label):
    """The row rule on one planted fault of output ``name``: a record; fails
    unless at least one row is over its limit."""
    over, rows, worst = row_rule(faulty, truth, sdpa)
    whole = (faulty - truth).abs().max().item()
    whole_limit = FLASH_SDPA_FACTOR * (sdpa - truth).abs().max().item() + FLASH_SDPA_ATOL
    check(over > 0, f"flash {label}: the row rule passes the planted fault '{fault}' on {name}")
    phase(7, f"{label} planted fault '{fault}' on {name}: the row rule fails it ({over} of "
             f"{rows} rows over, worst {worst:.1f}x its limit); the whole-tensor rule "
             f"{'fails' if whole > whole_limit else 'passes'} it ({whole:.3e} vs {whole_limit:.3e})")
    return {"rows_over": over, "rows": rows, "worst_row_ratio": worst,
            "whole_tensor_rule_fails": whole > whole_limit}


def planted_faults(fa, inputs32, seg, lse32, o32, truth, got, sdpa, label):
    """Faults that the row rule must fail, made from the kernels' own outputs
    plus the exact change a fault makes to the f32 truth. dk/dv: (1) the
    diagonal pair of key tile FLASH_FAULT_TILE dropped (dk, dv of its keys
    lose the queries of the same tile: their dO zeroed in the truth), (2) dk
    without query head FLASH_FAULT_HEAD's share. dq: (3) the diagonal pair of
    query tile FLASH_FAULT_TILE dropped and (4) the share of key tile
    FLASH_FAULT_KEY_TILE dropped (that key tile's K zeroed in the truth,
    whose LSE and delta are given: its keys then add nothing to dq, and no
    other key's term changes; (3) keeps the change on the tile's own query
    rows only). Returns {kernel: [one record per fault]}; fails unless the
    row rule catches each."""
    q32, k32, v32, do32 = inputs32
    tile_of = lambda t: slice(t * fa.FLASH_TILE, (t + 1) * fa.FLASH_TILE)  # noqa: E731
    tile = tile_of(FLASH_FAULT_TILE)
    drop_tile = do32.clone()
    drop_tile[:, tile] = 0
    drop_head = do32.clone()
    drop_head[:, :, FLASH_FAULT_HEAD] = 0
    out = {"flash_bwd_dkv": [], "flash_bwd_dq": []}
    for fault, do_f, names in (
            (f"diagonal pair of key tile {FLASH_FAULT_TILE} dropped", drop_tile, ("dk", "dv")),
            (f"query head {FLASH_FAULT_HEAD}'s share of dk dropped", drop_head, ("dk",))):
        changed = dict(zip(("dk", "dv"), fa.flash_bwd_dkv_reference(
            q32, k32, v32, seg, lse32, fa.flash_delta(o32, do_f), do_f)))
        rec = {"fault": fault, "outputs": list(names)}
        for name in names:
            shift = changed[name] - truth[name]
            if "tile" in fault:  # only the tile's own keys lose the pair
                keep = torch.zeros_like(shift)
                keep[:, tile] = shift[:, tile]
                shift = keep
            rec[name] = fault_caught(fault, name, got[name].float() + shift, truth[name],
                                     sdpa[name], label)
        out["flash_bwd_dkv"].append(rec)
    delta32 = fa.flash_delta(o32, do32)
    for fault, t, own_rows in (
            (f"diagonal pair of query tile {FLASH_FAULT_TILE} dropped", FLASH_FAULT_TILE, True),
            (f"key tile {FLASH_FAULT_KEY_TILE}'s share of dq dropped", FLASH_FAULT_KEY_TILE, False)):
        k_drop = k32.clone()
        k_drop[:, tile_of(t)] = 0
        shift = fa.flash_bwd_dq_reference(q32, k_drop, v32, seg, lse32, delta32, do32) - truth["dq"]
        if own_rows:  # only the tile's own queries lose the pair
            keep = torch.zeros_like(shift)
            keep[:, tile_of(t)] = shift[:, tile_of(t)]
            shift = keep
        out["flash_bwd_dq"].append({"fault": fault, "outputs": ["dq"], "dq": fault_caught(
            fault, "dq", got["dq"].float() + shift, truth["dq"], sdpa["dq"], label)})
    return out


def flash_check(fa, dtype, kind, d=None, faults=None, heads=None):
    """The flash kernels on one case; returns {output: max|d|}. f32: each
    kernel against its plain version on the same inputs (the backward kernels
    get the plain forward's LSE and delta), within FLASH_F32_TOL. bf16: the
    chain the training path runs (the kernels' own LSE and delta), O, LSE,
    dq, dk and dv against the f32 truth by the SDPA-relative rule over the
    whole tensor and row by row; at the ragged d-128 case the planted faults
    are added to ``faults`` ({kernel: [records]}). ``heads``: (hq, hkv) in
    place of FLASH_SHAPE's."""
    q, k, v, do = flash_inputs(dtype, seed=1 if kind == "packed" else 0, d=d, heads=heads)
    seg = flash_segments_case(kind, q.shape[0], q.shape[1])
    label = f"{kind} {str(dtype).split('.')[-1]} d={q.shape[-1]}" + (
        f" hq={heads[0]} hkv={heads[1]}" if heads else "")
    errs = {}
    if dtype == torch.float32:
        o, lse = fa.flash_fwd(q, k, v, seg)
        o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, seg)
        delta = fa.flash_delta(o_ref, do)
        dq = fa.flash_bwd_dq(q, k, v, seg, lse_ref, delta, do)
        dk, dv = fa.flash_bwd_dkv(q, k, v, seg, lse_ref, delta, do)
        torch.cuda.synchronize()
        dq_ref = fa.flash_bwd_dq_reference(q, k, v, seg, lse_ref, delta, do)
        dk_ref, dv_ref = fa.flash_bwd_dkv_reference(q, k, v, seg, lse_ref, delta, do)
        for name, got, ref in (("o", o, o_ref), ("lse", lse, lse_ref), ("dq", dq, dq_ref),
                               ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
            check(bool(torch.isfinite(got).all()), f"flash {label} {name}: not finite")
            err = (got - ref).abs().max().item()
            check(err <= FLASH_F32_TOL[name], f"flash {label} {name}: max|kernel-plain| {err:.3e} > "
                                              f"{FLASH_F32_TOL[name]}")
            errs[name] = err
            phase(7, f"{label} {name}: max|kernel-plain| {err:.3e}, max|plain| "
                     f"{ref.abs().max().item():.3e}")
        return errs
    o, lse = fa.flash_fwd(q, k, v, seg)
    delta = fa.flash_delta(o, do)
    dq = fa.flash_bwd_dq(q, k, v, seg, lse, delta, do)
    dk, dv = fa.flash_bwd_dkv(q, k, v, seg, lse, delta, do)
    torch.cuda.synchronize()
    for name, got in (("o", o), ("lse", lse), ("dq", dq), ("dk", dk), ("dv", dv)):
        check(bool(torch.isfinite(got).all()), f"flash {label} {name}: not finite")
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    o32, lse32 = fa.flash_attention_fwd_reference(q32, k32, v32, seg)
    delta32 = fa.flash_delta(o32, do32)
    dq32 = fa.flash_bwd_dq_reference(q32, k32, v32, seg, lse32, delta32, do32)
    dk32, dv32 = fa.flash_bwd_dkv_reference(q32, k32, v32, seg, lse32, delta32, do32)
    del delta32
    errs["lse"] = (lse - lse32).abs().max().item()
    check(errs["lse"] <= FLASH_LSE_TOL, f"flash {label} lse: max|kernel - f32 truth| {errs['lse']:.3e} "
                                        f"> {FLASH_LSE_TOL}")
    phase(7, f"{label} lse: max|kernel - f32 truth| {errs['lse']:.3e} (limit {FLASH_LSE_TOL})")
    sdpa = dict(zip(("o", "dq", "dk", "dv"), sdpa_bf16(q, k, v, do, seg)))
    truth = {"o": o32, "dq": dq32, "dk": dk32, "dv": dv32}
    got = {"o": o, "dq": dq, "dk": dk, "dv": dv}
    for name in ("o", "dq", "dk", "dv"):
        err = (got[name].float() - truth[name]).abs().max().item()
        ref_err = (sdpa[name] - truth[name]).abs().max().item()
        limit = FLASH_SDPA_FACTOR * ref_err + FLASH_SDPA_ATOL
        check(err <= limit, f"flash {label} {name}: max|kernel - f32 truth| {err:.3e} > "
                            f"{FLASH_SDPA_FACTOR} x SDPA's {ref_err:.3e} + {FLASH_SDPA_ATOL}")
        over, rows, worst = row_rule(got[name], truth[name], sdpa[name])
        check(over == 0, f"flash {label} {name}: {over} of {rows} rows beyond 2 x SDPA's error in the "
                         f"row + 2**-8 x the row's max|truth| + 1e-5 (worst {worst:.2f}x the limit)")
        errs[name] = err
        errs[f"{name}_sdpa"] = ref_err
        errs[f"{name}_worst_row_ratio"] = worst
        phase(7, f"{label} {name}: max|kernel - f32 truth| {err:.3e}, SDPA bf16 {ref_err:.3e} "
                 f"({err / ref_err:.2f}x; limit {limit:.3e}), max|truth| "
                 f"{truth[name].abs().max().item():.3e}; per row at most {worst:.2f}x the row limit")
    if faults is not None and kind == "ragged" and q.shape[-1] == FLASH_SHAPE["d"] and not heads:
        faults.update(planted_faults(fa, (q32, k32, v32, do32), seg, lse32, o32, truth, got, sdpa,
                                     label))
    return errs


def sdpa_times(q, k, v, do, seg, spin=True):
    """The library yardstick, never called by the port:
    ``scaled_dot_product_attention`` with the same boolean mask, forward and
    (under autograd) its backward, on head-major copies of the inputs
    (``spin``: as in ``time_ms``)."""
    import torch.nn.functional as F

    groups = q.shape[2] // k.shape[2]
    s = q.shape[1]
    causal = torch.ones(s, s, dtype=torch.bool, device=DEVICE).tril()
    mask = (causal & (seg[:, :, None] == seg[:, None, :]))[:, None]
    qh = q.transpose(1, 2).contiguous().requires_grad_()
    kh = k.transpose(1, 2).repeat_interleave(groups, dim=1).contiguous().requires_grad_()
    vh = v.transpose(1, 2).repeat_interleave(groups, dim=1).contiguous().requires_grad_()
    doh = do.transpose(1, 2).contiguous()
    with torch.no_grad():
        fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask), spin=spin)
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True),
                     spin=spin)
    return fwd_ms, bwd_ms


def count_tile_visits(fa, q, k, v, do, seg):
    """{kernel: int32 [b, n, n]}: the tile pairs the bf16 forward, dq and
    dk/dv kernels compute on these inputs, counted by the kernels themselves
    (one per query head and pair), and ``flash_tile_pairs``' prediction of
    the same count; fails unless they agree pair by pair."""
    b, s, hq = q.shape[:3]
    n = -(-s // fa.FLASH_TILE)
    visits = {name: torch.zeros(b, n, n, dtype=torch.int32, device=DEVICE)
              for name in FLASH_DESIGN}
    o, lse = fa.flash_fwd(q, k, v, seg, tile_visits=visits["flash_fwd"])
    delta = fa.flash_delta(o, do)
    fa.flash_bwd_dq(q, k, v, seg, lse, delta, do, tile_visits=visits["flash_bwd_dq"])
    fa.flash_bwd_dkv(q, k, v, seg, lse, delta, do, tile_visits=visits["flash_bwd_dkv"])
    predicted = fa.flash_tile_pairs(seg).to(torch.int32) * hq
    for name, counted in visits.items():
        wrong = int((counted != predicted).sum())
        check(wrong == 0, f"{name}: the kernel's own tile-pair count differs from flash_tile_pairs at "
                          f"{wrong} of {counted.numel()} (row, query tile, key tile)")
    return {**visits, "predicted": predicted}


def flash_kernel_phase(fa, peaks):
    """Phase 7: correctness in f32 (d 128) and bf16 (d 128 and 64) on ragged
    and packed segments with planted faults, the tile pairs the kernels
    compute (their own count), then times at the training smoke's shapes in
    bf16 (ragged), and again with every row one segment (the causal pairs
    only: nothing for the segment rule to skip)."""
    errs = {torch.float32: {}, torch.bfloat16: {}}
    faults: dict = {}
    cases = [(torch.float32, kind, None) for kind in ("ragged", "packed")]
    cases += [(torch.bfloat16, kind, d) for d in (128, 64) for kind in ("ragged", "packed")]
    for dtype, kind, d in cases:
        for name, err in flash_check(fa, dtype, kind, d, faults).items():
            errs[dtype][name] = max(errs[dtype].get(name, 0.0), err)
    q, k, v, do = flash_inputs(torch.bfloat16)
    b, s, hq = q.shape[:3]
    seg = flash_segments_case("ragged", b, s)
    n = -(-s // fa.FLASH_TILE)
    counted = count_tile_visits(fa, q, k, v, do, seg)
    visited = {name: int(counted[name].sum()) for name in FLASH_DESIGN}
    causal = b * n * (n + 1) // 2 * hq
    phase(7, f"tile pairs computed (ragged, b={b}, {hq} query heads), counted by the kernels: "
             + ", ".join(f"{FLASH_DESIGN[name][0]} {visited[name]}" for name in FLASH_DESIGN)
             + f" of {causal} under the causal limit ({100 * visited['flash_fwd'] / causal:.1f}%); "
             f"flash_tile_pairs predicts {int(counted['predicted'].sum())}, equal pair by pair")
    o, lse = fa.flash_fwd(q, k, v, seg)
    delta = fa.flash_delta(o, do)
    one = torch.ones_like(seg)  # every row one segment: the causal pairs only
    o1, lse1 = fa.flash_fwd(q, k, v, one)
    delta1 = fa.flash_delta(o1, do)
    no_skip = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, one),
               "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, one, lse1, delta1, do),
               "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, one, lse1, delta1, do)}
    timed = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, seg),
                      lambda: fa.flash_attention_fwd_reference(q, k, v, seg)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, seg, lse, delta, do),
                         lambda: fa.flash_bwd_dq_reference(q, k, v, seg, lse, delta, do)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, seg, lse, delta, do),
                          lambda: fa.flash_bwd_dkv_reference(q, k, v, seg, lse, delta, do)),
    }
    bounds = flash_bounds(q, k, seg, peaks)
    sdpa_fwd_ms, sdpa_bwd_ms = sdpa_times(q, k, v, do, seg)
    smem = fa.flash_tc_smem_bytes(q.shape[-1], q.shape[1])
    phase(7, f"shared memory per block at d={q.shape[-1]} s={q.shape[1]}: "
             + ", ".join(f"{FLASH_DESIGN[name][0]} {smem[name]} B" for name in FLASH_DESIGN))
    record = {}
    for name, (kernel, plain) in timed.items():
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        bound_ms, bound_by, flops, nbytes = bounds[name]
        library_ms = sdpa_fwd_ms if name == "flash_fwd" else sdpa_bwd_ms
        outputs = {"flash_fwd": ("o", "lse"), "flash_bwd_dq": ("dq",),
                   "flash_bwd_dkv": ("dk", "dv")}[name]
        err = {dtype: max(e[o] for o in outputs) for dtype, e in errs.items()}
        tflops = flops / (ms * 1e-3) / 1e12
        record[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library_ms,
                        "max_abs_err": err[torch.bfloat16], "max_abs_err_f32": err[torch.float32],
                        "flops": flops, "bytes": nbytes, "tflops_on_visible_pairs": tflops,
                        "fraction_of_bound": bound_ms / ms}
        one_ms = time_ms(no_skip[name])
        record[name].update({"smem_bytes_per_block": smem[name],
                             "tile_pairs_visited": visited[name],
                             "tile_pairs_predicted": int(counted["predicted"].sum()),
                             "tile_pairs_causal": causal,
                             "ms_one_segment_per_row": one_ms,
                             "max_abs_err_sdpa_bf16": max(errs[torch.bfloat16][f"{o}_sdpa"]
                                                          for o in outputs if o != "lse"),
                             "worst_row_ratio": max(errs[torch.bfloat16][f"{o}_worst_row_ratio"]
                                                    for o in outputs if o != "lse"),
                             **({"planted_faults": faults[name]} if name in faults else {})})
        phase(7, f"{name}: {ms:.3f} ms on the ragged rows ({visited[name]} tile pairs) vs "
                 f"{one_ms:.3f} ms with every row one segment ({causal}, nothing to skip)")
        phase(7, f"{name} bf16 b=8 s=1024 hq=16 hkv=4 d=128 ragged: kernel {ms:.3f} ms "
                 f"({tflops:.1f} TFLOP/s on the visible pairs, {100 * bound_ms / ms:.1f}% of the "
                 f"bound), plain {plain_ms:.3f} ms, SDPA "
                 f"{'forward' if name == 'flash_fwd' else 'backward'} {library_ms:.3f} ms, bound "
                 f"{bound_ms:.4f} ms ({bound_by}, {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), "
                 f"{ms / library_ms:.2f}x SDPA")
    return record


# one rank's heads of SmolLM3-3B at tensor=2 (25c's local shape)
FLASH_TP_HEADS = (FLASH_SHAPE["hq"] // 2, FLASH_SHAPE["hkv"] // 2)


def flash_tp_local_phase(fa, peaks):
    """Phase 7 at tensor=2's local heads (b 8, s 1024, hq 8, hkv 2, d 128,
    ragged): the bf16 tensor-core forward, dq and dk/dv held by phase 7's
    SDPA-relative rule, whole and row by row, then timed beside their plain
    versions, the bound and SDPA. Returns {kernel: record}."""
    errs = flash_check(fa, torch.bfloat16, "ragged", heads=FLASH_TP_HEADS)
    q, k, v, do = flash_inputs(torch.bfloat16, heads=FLASH_TP_HEADS)
    seg = flash_segments_case("ragged", q.shape[0], q.shape[1])
    o, lse = fa.flash_fwd(q, k, v, seg)
    delta = fa.flash_delta(o, do)
    timed = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, seg),
                      lambda: fa.flash_attention_fwd_reference(q, k, v, seg)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, seg, lse, delta, do),
                         lambda: fa.flash_bwd_dq_reference(q, k, v, seg, lse, delta, do)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, seg, lse, delta, do),
                          lambda: fa.flash_bwd_dkv_reference(q, k, v, seg, lse, delta, do)),
    }
    bounds = flash_bounds(q, k, seg, peaks)
    sdpa_fwd_ms, sdpa_bwd_ms = sdpa_times(q, k, v, do, seg)
    record = {}
    for name, (kernel, plain) in timed.items():
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        bound_ms, bound_by, flops, nbytes = bounds[name]
        library_ms = sdpa_fwd_ms if name == "flash_fwd" else sdpa_bwd_ms
        outputs = {"flash_fwd": ("o", "lse"), "flash_bwd_dq": ("dq",),
                   "flash_bwd_dkv": ("dk", "dv")}[name]
        record[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms, "max_abs_err": max(errs[o] for o in outputs),
                        "shape": {**FLASH_SHAPE, "hq": FLASH_TP_HEADS[0], "hkv": FLASH_TP_HEADS[1]},
                        "fraction_of_bound": bound_ms / ms}
        phase(7, f"{name} bf16 b=8 s=1024 hq={FLASH_TP_HEADS[0]} hkv={FLASH_TP_HEADS[1]} d=128 "
                 f"ragged (tensor=2's local heads): kernel {ms:.3f} ms ({100 * bound_ms / ms:.1f}% "
                 f"of the bound), plain {plain_ms:.3f} ms, SDPA "
                 f"{'forward' if name == 'flash_fwd' else 'backward'} {library_ms:.3f} ms, bound "
                 f"{bound_ms:.4f} ms ({bound_by}, {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
    return record


# ---------------------------------------------------------------------------
# phases 8-9: SFT training of SmolLM3-3B through the port's trainer
# ---------------------------------------------------------------------------

TRAIN_ROWS = 120  # -> 108 train rows, 12 validation rows, 3 steps of 32
# losses at steps 1-3 and the eval loss of phases 8 and 11 as the CUDA-core
# flash kernels gave them (H100, the same seeds and data); the tensor-core
# kernels round P and dS to bf16, and must stay within 0.5% of these
RECORDED_LOSSES = {8: ([12.327, 11.561, 11.072], 10.772), 11: ([12.331, 11.684, 11.246], 10.986)}
LOSS_RECORDED_REL_TOL = 5e-3
# phase 11's peak memory at the last step (28.03 GB with N-major codes): K-major
# codes must come with no second copy of the trunk
INT8_TRUNK_PEAK_BYTES = 28.5e9
TRAIN_WATCHDOG_S = 60.0  # phases 8 and 11 train with the step watchdog armed; no step is near it
TRAIN_PROMPT = "You are a wilderness survival expert."
# full-width f32 microbatch, kernels against plain versions: the loss to
# 1e-5 relative, each trainable leaf's gradient to 1e-4 of its largest entry
LOSS_REL_TOL, GRAD_REL_TOL = 1e-5, 1e-4


def train_counters(fa, mm):
    return {"flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
            "flash_bwd_dkv": fa.flash_bwd_dkv, "w8a8_matmul": mm.w8a8_matmul}


def train_config(workdir, frozen_compute="bf16", publish=None, **kw):
    """Phases 8, 11 and 24's ``TrainConfig`` over ``workdir`` (its ``data/``
    holds the rows, ``out/`` the artifacts). Each writes a trainable-only
    checkpoint, and phase 8 a publish (``publish`` None: phase 8's plain
    frozen layers publish): ``save_steps`` (500) is above their 3 steps,
    so only the final save (and publish) runs, after the timed steps;
    phase 23a resumes from phase 8's."""
    import os

    from llm_fine_tune_distributed_tpu_torch.config import TrainConfig

    kw = dict(checkpoint_trainable_only=True, **kw)
    if publish is None:
        publish = frozen_compute == "bf16"  # phase 8 publishes, phase 11 does not
    if publish:
        kw["publish_dir"] = os.path.join(workdir, "publish")
    return TrainConfig(model_name="smollm3-3b-random", model_preset="smollm3_3b",
                       tokenizer_path="byte-chatml", data_dir=os.path.join(workdir, "data"),
                       output_dir=os.path.join(workdir, "out"), epochs=1,
                       system_prompt=TRAIN_PROMPT, logging_steps=1, frozen_compute=frozen_compute,
                       watchdog_timeout_s=TRAIN_WATCHDOG_S, **kw)


def train_phase(fa, mm, workdir, frozen_compute="bf16"):
    """The main training path: ``SFTTrainer`` on SmolLM3-3B at full width
    (random weights from a seed), the reference recipe, 3 optimizer steps
    over 120 rows of the repo's dataset; phase 8 with the plain frozen
    layers (and its final trainable-only checkpoint and publish), phase 11
    with ``frozen_compute="int8"``. Returns (record, trainer)."""
    import os

    from llm_fine_tune_distributed_tpu_torch.infer.generate import load_model_dir
    from llm_fine_tune_distributed_tpu_torch.ops.int8 import dequantize_int8
    from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer

    phase_no = 8 if frozen_compute == "bf16" else 11

    data_dir = os.path.join(workdir, "data")
    os.makedirs(data_dir)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                           "final_qa_data_unique.jsonl")) as f:
        lines = [next(f) for _ in range(TRAIN_ROWS)]
    with open(os.path.join(data_dir, "final_qa_data_unique.jsonl"), "w") as f:
        f.writelines(lines)
    out_dir = os.path.join(workdir, "out")
    config = train_config(workdir, frozen_compute)
    t0 = time.monotonic()
    trainer = SFTTrainer(config, device=DEVICE)
    torch.cuda.synchronize()
    mc = trainer.model_config
    trunk = trainer.frozen_boundary
    phase(phase_no, f"SFTTrainer ready in {time.monotonic() - t0:.1f} s: {mc.name}, "
                    f"{trainer.trainable_report}, {trainer.n_train} train / {trainer.n_val} validation "
                    f"rows, {trainer.total_steps} steps, remat "
                    f"{config.resolved_remat_policy(mc)}, frozen_compute {frozen_compute} "
                    f"(trunk: layers [0, {trunk}))")
    frozen_before = {k: v.clone() for k, v in trainer.state.frozen.items()}
    trainable_before = {k: v.detach().clone() for k, v in trainer.state.trainable.items()}
    real_rows = trainer.train_arrays["attention_mask"].sum(axis=1)
    phase(phase_no, f"train rows: {int(real_rows.min())}..{int(real_rows.max())} real tokens of "
                    f"{config.max_seq_length}, {int((real_rows < config.max_seq_length).sum())} of "
                    f"{len(real_rows)} padded")

    counters = train_counters(fa, mm)
    for fn in counters.values():  # count the main path's launches only
        fn.launches = 0
    t0 = time.monotonic()
    summary = trainer.train()
    launches = {name: fn.launches for name, fn in counters.items()}
    phase(phase_no, f"train() returned in {time.monotonic() - t0:.1f} s (artifacts included)")
    watchdog = trainer.watchdog
    check(watchdog is not None and watchdog.trips == 0
          and watchdog._last_step == trainer.total_steps,
          f"the step watchdog ({TRAIN_WATCHDOG_S} s): trips "
          f"{None if watchdog is None else watchdog.trips}")
    phase(phase_no, f"step watchdog ({TRAIN_WATCHDOG_S} s, {watchdog.action}): 0 trips, poked at "
                    f"each of the {trainer.total_steps} steps, paused over the evals")

    history = trainer.metrics.history
    meter = trainer.throughput
    losses = [h["loss"] for h in history]
    grad_norms = [h["grad_norm"] for h in history]
    check(all(np.isfinite(losses)) and all(np.isfinite(grad_norms)), f"non-finite loss {losses}")
    check(np.isfinite(summary["final_eval_loss"]), f"eval loss {summary['final_eval_loss']}")
    for k, v in trainer.state.frozen.items():
        check(torch.equal(v, frozen_before[k]), f"frozen leaf {k} changed")
    for k, v in trainer.state.trainable.items():
        check(not torch.equal(v.detach(), trainable_before[k]), f"trainable leaf {k} did not move")
    n_int8 = sum(k.endswith("_int8") for k in frozen_before)
    phase(phase_no, f"{len(frozen_before)} frozen leaves bit-unchanged ({n_int8} int8 code leaves and "
                    f"their scales among them), {len(trainable_before)} trainable leaves moved")
    if n_int8:  # the layout the w8a8 kernel reads: [in, out] with strides (1, in)
        codes = {k: v for k, v in trainer.state.frozen.items() if k.endswith(".kernel_int8")}
        not_kmajor = [k for k, v in codes.items() if v.stride() != (1, v.shape[0])]
        check(not not_kmajor, f"trunk codes not K-major: {not_kmajor[:3]}")
        phase(phase_no, f"all {len(codes)} trunk code leaves are K-major ([in, out], strides (1, in))")
    del frozen_before, trainable_before

    # launches: the trunk's layers run one forward per microbatch (no
    # backward, no replay), each of its 7 projections through w8a8; the other
    # layers a forward, its remat replay and a backward; every layer one
    # forward per eval batch
    layers, accum, steps = mc.num_layers, config.gradient_accumulation_steps, len(meter.step_s)
    eval_batches = -(-trainer.n_val // (config.eval_batch_size or config.per_device_batch_size))
    evals = 1 + (steps // config.eval_steps if config.eval_steps else 0)
    replays = 1 if config.gradient_checkpointing else 0
    top = layers - trunk
    expected = {
        "flash_fwd": (trunk * accum * steps + top * accum * steps * (1 + replays)
                      + layers * eval_batches * evals),
        "flash_bwd_dq": top * accum * steps,
        "flash_bwd_dkv": top * accum * steps,
        "w8a8_matmul": trunk * 7 * (accum * steps + eval_batches * evals),
    }
    phase(phase_no, f"kernel launches {launches}, derived {expected}: {trunk} trunk layers x {accum} "
                    f"microbatches x {steps} steps + {top} layers x {accum} x {steps} x (1 + {replays} "
                    f"remat replay) forwards + {layers} x {eval_batches} eval batches x {evals} eval(s); "
                    f"backward {top} x {accum} x {steps}; w8a8 {trunk} x 7 projections x ({accum} x "
                    f"{steps} + {eval_batches} x {evals})")
    check(launches == expected, f"launches {launches} != derived {expected}")

    best_dir = os.path.join(out_dir, "best_model")
    for name in ("training_history.json", "training_summary.json"):
        check(os.path.exists(os.path.join(out_dir, name)), f"{name} missing")
    loaded, loaded_config = load_model_dir(best_dir, device=DEVICE)
    check(loaded_config == mc, "best_model/config.json does not give the trained config")
    state = {**trainer.state.trainable, **trainer.state.frozen}
    exported = {k[: -len("_int8")] if k.endswith(".kernel_int8") else k
                for k in state if not k.endswith(".kernel_int8_scale")}
    check(set(loaded) == exported, "best_model/ leaves differ from the trained state")
    for k, v in state.items():
        if k.endswith(".kernel_int8_scale"):
            continue
        if k.endswith(".kernel_int8"):  # the trunk, decoded
            k, v = k[: -len("_int8")], dequantize_int8({"int8": v, "int8_scale": state[k + "_scale"]},
                                                        torch.float32)
        check(torch.equal(loaded[k], v.detach().to(torch.bfloat16)), f"best_model/{k} differs")
    del loaded
    phase(phase_no, f"best_model/ loads through load_model_dir: {len(exported)} leaves equal the trained "
                    f"state in bf16 ({n_int8} of them the decoded int8 trunk)")

    steady = slice(1, None)  # steps 2-3: the first step pays first-use costs
    step_s = meter.step_s[steady]
    step_ms = statistics.median(step_s) * 1e3
    samples_per_s = config.per_device_batch_size * accum * len(step_s) / sum(step_s)
    real_tokens_per_s = sum(meter.step_real_tokens[steady]) / sum(step_s)
    peak = torch.cuda.max_memory_allocated()
    train_peak = history[-1]["device_peak_bytes_in_use"]  # at the last step, before the export
    record = {
        "losses": losses, "grad_norms": grad_norms, "logged_steps": [h["step"] for h in history],
        "eval_loss": summary["final_eval_loss"],
        "eval_loss_answer": trainer._last_eval_answer,
        "step_s": meter.step_s, "step_ms_median_steps_2_3": step_ms,
        "samples_per_s_per_card": samples_per_s, "real_tokens_per_s_per_card": real_tokens_per_s,
        "padded_tokens_per_s_per_card": samples_per_s * config.max_seq_length,
        "max_memory_allocated_bytes": peak, "train_peak_bytes": train_peak,
        "launches": launches, "expected_launches": expected,
        "summary": summary, "watchdog_trips": watchdog.trips,
    }
    phase(phase_no, f"losses {[round(x, 4) for x in losses]} at steps {record['logged_steps']}, "
                    f"grad_norm {[round(x, 4) for x in grad_norms]}, eval_loss "
                    f"{summary['final_eval_loss']:.4f}")
    recorded, recorded_eval = RECORDED_LOSSES[phase_no]
    rel = [abs(a - b) / b for a, b in zip(losses[:3] + [summary["final_eval_loss"]],
                                          recorded + [recorded_eval])]
    record["loss_rel_to_recorded"] = rel
    phase(phase_no, f"losses at steps 1-3 and eval {[round(x, 4) for x in losses[:3]]}, "
                    f"{summary['final_eval_loss']:.4f} vs the CUDA-core kernels' recorded {recorded}, "
                    f"{recorded_eval}: relative {[f'{r:.2e}' for r in rel]}")
    check(len(losses) >= 3 and max(rel) <= LOSS_RECORDED_REL_TOL,
          f"losses {losses[:3]} / eval {summary['final_eval_loss']} beyond {LOSS_RECORDED_REL_TOL} "
          f"of the recorded {recorded} / {recorded_eval}")
    if config.publish_dir:
        saved, published = trainer.last_checkpoint, trainer.last_publish
        check(saved is not None and saved["step"] == steps and saved["trainable_only"],
              f"phase 8's final checkpoint: {saved}")
        check(published is not None and published["step"] == steps,
              f"phase 8's final publish: {published}")
        record["checkpoint"], record["publish"] = saved, published
        phase(phase_no, f"final trainable-only checkpoint (step {saved['step']}, "
                        f"{'async snapshot' if saved['async'] else 'sync'}): "
                        f"{saved['bytes'] / 1e9:.3f} GB, {saved['blocking_s']:.3f} s blocking, "
                        f"{saved['seconds']:.3f} s to written; publish: "
                        f"{published['bytes'] / 1e9:.3f} GB in {published['seconds']:.3f} s "
                        f"({published['write_s']:.3f} s for the weights file)")
    if trunk:
        check(train_peak <= INT8_TRUNK_PEAK_BYTES, f"int8-trunk peak memory {train_peak / 1e9:.2f} GB > "
                                                   f"{INT8_TRUNK_PEAK_BYTES / 1e9} GB")
    phase(phase_no, f"steps 2-3: median step {step_ms:.1f} ms, {samples_per_s:.2f} samples/s/card, "
                    f"{real_tokens_per_s:.0f} real tokens/s/card, max_memory_allocated "
                    f"{peak / 1e9:.2f} GB ({train_peak / 1e9:.2f} GB at the last step, before the export)")
    return record, trainer


def f32_microbatch_phase(trainer, fa, mm, phase_no=None):
    """One full-width microbatch (batch 2, seq 1024) in f32 through the same
    loss function, kernels against plain versions: the loss and every
    trainable leaf's gradient. Phase 9 (no trunk): the flash kernels against
    the plain attention. Phase 12 (the int8 trunk): the w8a8 kernel against
    its plain version, with the plain attention in both runs. Phase 24a: the
    first two packed rows (their segment ids and positions too), as 9."""
    import dataclasses

    from llm_fine_tune_distributed_tpu_torch.ops.attention import attention, attention_plain
    from llm_fine_tune_distributed_tpu_torch.train.step import make_loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    config = dataclasses.replace(trainer.config, compute_dtype="float32")
    mc = trainer.model_config
    trunk = trainer.frozen_boundary
    phase_no = phase_no or (12 if trunk else 9)
    if trunk:
        runs = {"kernel": dict(attention_fn=attention_plain, trunk_matmul=mm.int8_w8a8_matmul),
                "plain": dict(attention_fn=attention_plain, trunk_matmul=mm.int8_w8a8_matmul_plain)}
        counted = {"w8a8_matmul": mm.w8a8_matmul}
    else:
        runs = {"kernel": dict(attention_fn=attention), "plain": dict(attention_fn=attention_plain)}
        counted = {k: v for k, v in train_counters(fa, mm).items() if k != "w8a8_matmul"}
    # int8 codes and their f32 scales stay as they are
    frozen = {k: v.float() if v.is_floating_point() else v for k, v in trainer.state.frozen.items()}
    trainable = {k: v.detach().float().clone().requires_grad_() for k, v in trainer.state.trainable.items()}
    arrays = trainer.train_arrays
    batch = {k: torch.from_numpy(arrays[k][:2]).to(DEVICE)
             for k in ("input_ids", "loss_mask", "attention_mask", "segment_ids", "positions")
             if k in arrays}
    out = {}
    for name, kw in runs.items():
        before = {c: f.launches for c, f in counted.items()}
        loss, _ = make_loss_fn(mc, config, frozen_layers=trunk, **kw)(trainable, frozen, batch)
        grads = torch.autograd.grad(loss, list(trainable.values()))
        torch.cuda.synchronize()
        out[name] = (loss.detach(), grads)
        ran = {c: f.launches - before[c] for c, f in counted.items()}
        check((min(ran.values()) > 0) == (name == "kernel"), f"{name} run launched {ran}")
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    check(bool(torch.isfinite(lk)) and all(bool(torch.isfinite(g).all()) for g in gk),
          "f32 microbatch: non-finite loss or gradient")
    loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
    check(loss_rel <= LOSS_REL_TOL, f"f32 microbatch loss {lk.item()} vs plain {lp.item()}")
    worst = 0.0
    for name, a, b in zip(trainable, gk, gp):
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        check(err <= GRAD_REL_TOL * scale, f"f32 grad {name}: max|d| {err:.3e} > "
                                           f"{GRAD_REL_TOL} x {scale:.3e}")
        worst = max(worst, err / scale)
    bit_equal = bool(torch.equal(lk, lp)) and all(torch.equal(a, b) for a, b in zip(gk, gp))
    packed = ", packed rows" if "segment_ids" in batch else ""
    phase(phase_no, f"f32 microbatch b=2 s=1024 at full width{', int8 trunk' if trunk else ''}{packed}: loss "
                    f"kernel {lk.item():.6f} plain {lp.item():.6f} (rel {loss_rel:.2e}); worst "
                    f"trainable-leaf grad max|d|/max|g| {worst:.2e} over {len(trainable)} leaves; "
                    f"bit-equal: {bit_equal}")
    return {"loss_kernel": lk.item(), "loss_plain": lp.item(), "loss_rel": loss_rel,
            "grad_rel_worst": worst, "bit_equal": bit_equal}


def real_batch_tiles(fa, trainer, phase_no=8):
    """The tile pairs the tensor-core kernels compute on the training rows'
    own segments (phase 8: each row one segment and its padding; 24a: packed
    rows, many segments and a pad tail): every microbatch of the train split
    in order, at the model's attention shapes (random bf16 q/k/v/dO: the
    walk depends on the segments only), counted by the kernels and checked
    pair by pair against ``flash_tile_pairs``."""
    mc = trainer.model_config
    arrays = trainer.train_arrays
    mask = arrays["segment_ids"] if "segment_ids" in arrays else arrays["attention_mask"]
    rows = trainer.config.per_device_batch_size
    s, hq, hkv, d = mask.shape[1], mc.num_heads, mc.num_kv_heads, mc.resolved_head_dim
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    q, do = (torch.randn(rows, s, hq, d, generator=gen, device=DEVICE).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(rows, s, hkv, d, generator=gen, device=DEVICE).to(torch.bfloat16) for _ in range(2))
    n = -(-s // fa.FLASH_TILE)
    visited = causal = 0
    batches = 0
    for r0 in range(0, len(mask), rows):
        seg = torch.from_numpy(mask[r0: r0 + rows]).to(DEVICE, torch.int32)
        m = seg.shape[0]
        counted = count_tile_visits(fa, q[:m], k[:m], v[:m], do[:m], seg)
        visited += int(counted["flash_fwd"].sum())
        causal += m * n * (n + 1) // 2 * hq
        batches += 1
    real = float((mask > 0).sum()) / mask.size
    phase(phase_no, f"tile pairs the kernels computed on the {len(mask)} train rows' own segments "
                    f"({batches} microbatches, {100 * real:.1f}% real tokens, up to "
                    f"{int(mask.max())} segments per row): {visited} of {causal} under the causal "
                    f"limit ({100 * visited / causal:.1f}%, {100 * (1 - visited / causal):.1f}% "
                    "skipped), equal pair by pair to flash_tile_pairs")
    return {"rows": len(mask), "microbatches": batches, "real_token_share": real,
            "tile_pairs_visited": visited, "tile_pairs_causal": causal}


def skipping_ab(loss_fn, trainer, batch, params):
    """One microbatch as the trainer runs it, and the same microbatch with
    every token marked real (the same work except that the segment rule has
    nothing to skip; the loss differs): flash kernels' and all device time
    (one profile each) and wall time (median of 3 unprofiled runs, each
    ended by a synchronize)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, mb in (("own_padding", batch),
                      ("all_real", {**batch, "attention_mask": torch.ones_like(batch["attention_mask"])})):
        def run(mb=mb):
            loss, _ = loss_fn(trainer.state.trainable, trainer.state.frozen, mb)
            torch.autograd.grad(loss, params)
        run()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.monotonic()
            run()
            torch.cuda.synchronize()
            walls.append((time.monotonic() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = _device_events(prof)
        out[label] = {"wall_ms_median": statistics.median(walls), "wall_ms": walls,
                      "flash_ms": sum(b - a for name, a, b in events if "flash_" in name) / 1e3,
                      "device_ms": sum(b - a for _, a, b in events) / 1e3}
    own, allr = out["own_padding"], out["all_real"]
    phase(8, f"segment-aware skipping on this microbatch: flash kernels {own['flash_ms']:.1f} ms vs "
             f"{allr['flash_ms']:.1f} ms with every token marked real, device time "
             f"{own['device_ms']:.1f} vs {allr['device_ms']:.1f} ms, wall (median of 3) "
             f"{own['wall_ms_median']:.1f} vs {allr['wall_ms_median']:.1f} ms")
    return out


def train_profile_phase(trainer, mm, phase_no=None):
    """Where one training microbatch's time goes (forward and backward of
    batch 8 at seq 1024, remat included): ``torch.profiler`` device time by
    kernel name, the flash and w8a8 kernels' shares, the row quantizer's
    share (its calls inside a ``record_function`` range, for this profile
    only: the range's span on the device timeline) and the device's busy
    share. Phase 8 (plain frozen layers), 11 (the int8 trunk), 24b and 24c
    (LoRA and QLoRA)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from llm_fine_tune_distributed_tpu_torch.train.step import make_loss_fn

    trunk = trainer.frozen_boundary
    phase_no = phase_no or (11 if trunk else 8)
    loss_fn = make_loss_fn(trainer.model_config, trainer.config, frozen_layers=trunk)
    quantize = mm.quantize_rows_int8

    def ranged_quantize(x):
        with record_function("quantize_rows_int8"):
            return quantize(x)
    arrays = trainer.train_arrays
    n = trainer.config.per_device_batch_size
    batch = {k: torch.from_numpy(arrays[k][:n]).to(DEVICE)
             for k in ("input_ids", "loss_mask", "attention_mask")}
    params = list(trainer.state.trainable.values())

    def micro():
        loss, _ = loss_fn(trainer.state.trainable, trainer.state.frozen, batch)
        torch.autograd.grad(loss, params)

    micro()
    torch.cuda.synchronize()
    mm.quantize_rows_int8 = ranged_quantize
    # the host's activity only where the row quantizer's range is read (the
    # int8 trunk); every other number is read from device events
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if trunk else [])
    try:
        with profile(activities=activities) as prof:
            t0 = time.monotonic()
            micro()
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
    finally:
        mm.quantize_rows_int8 = quantize
    # the range shows on the device timeline as one annotation per call,
    # spanning its kernels: its time, and not a kernel of its own
    events = _device_events(prof)
    quant_us = sum(b - a for name, a, b in events if name == "quantize_rows_int8")
    events = [e for e in events if e[0] != "quantize_rows_int8"]
    by_name: dict = {}
    for name, a, b in events:
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + (b - a), cnt + 1)
    total = sum(t for t, _ in by_name.values())
    flash = sum(t for name, (t, _) in by_name.items() if "flash_" in name)
    w8a8 = sum(t for name, (t, _) in by_name.items() if "w8a8_kernel" in name)
    busy, end = 0.0, None
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    per_flash = {}
    for kernel in (design[0] for design in FLASH_DESIGN.values()):
        rows = [(t, c) for name, (t, c) in by_name.items() if f"{kernel}<" in name]
        per_flash[kernel] = {"ms": sum(t for t, _ in rows) / 1e3, "calls": sum(c for _, c in rows)}
        check(bool(rows), f"the profiled microbatch ran no {kernel}")
    result = {
        "flash_kernels": per_flash,
        "microbatch_ms": wall_us / 1e3,
        "device_busy_share": busy / wall_us if events else None,
        "device_ms": total / 1e3,
        "flash_kernels_ms": flash / 1e3,
        "flash_share_of_device_time": flash / total if total else None,
        "w8a8_kernel_ms": w8a8 / 1e3,
        "w8a8_share_of_device_time": w8a8 / total if total else None,
        "quantize_rows_ms": quant_us / 1e3,
        "quantize_rows_share_of_device_time": quant_us / total if total else None,
        "top_kernels": [{"name": name[:90], "ms": t / 1e3, "calls": c} for name, (t, c) in top],
    }
    phase(phase_no, f"profiled microbatch (b=8, s=1024, fwd+bwd with remat): {result['microbatch_ms']:.1f} "
                    f"ms wall, device busy {100 * (result['device_busy_share'] or 0):.1f}%, of "
                    f"{result['device_ms']:.1f} ms device time: flash kernels "
                    f"{result['flash_kernels_ms']:.1f} ms, w8a8 kernel {result['w8a8_kernel_ms']:.1f} ms, "
                    f"row quantization {result['quantize_rows_ms']:.1f} ms")
    phase(phase_no, "flash kernels on the main path: " + ", ".join(
        f"{k} {v['ms']:.1f} ms in {v['calls']} calls" for k, v in per_flash.items()))
    for row in result["top_kernels"]:
        phase(phase_no, f"  {row['ms']:8.3f} ms  {row['calls']:5d} calls  {row['name']}")
    if not events:
        phase(phase_no, "the profiler recorded no device events")
    if phase_no == 8:  # what the segment rule skips on the training data, and what it saves
        from llm_fine_tune_distributed_tpu_torch.ops import flash_attention as fa

        result["real_batch_tiles"] = real_batch_tiles(fa, trainer)
        result["skipping_ab"] = skipping_ab(loss_fn, trainer, batch, params)
    return result


# ---------------------------------------------------------------------------
# phase 10: the w8a8 int8 matmul against its plain version
# ---------------------------------------------------------------------------

# the frozen trunk's projections at the recipe's microbatch (8 x 1024 rows):
# (name, K, N, projections of this shape per layer)
W8A8_M = 8192
W8A8_SHAPES = (("q_proj/o_proj", 2048, 2048, 2), ("k_proj/v_proj", 2048, 512, 2),
               ("gate_proj/up_proj", 2048, 11008, 2), ("down_proj", 11008, 2048, 1))
# extra cases: an f32 output, ragged M and N, K off the kernel's 128-byte
# step (the last step zero-filled), and K off 16 (byte loads in place of
# cp.async)
W8A8_EXTRA = (("f32 q_proj", 8192, 2048, 2048, torch.float32),
              ("ragged gate_proj", 1000, 2048, 11008, torch.bfloat16),
              ("ragged N=100", 1000, 2048, 100, torch.bfloat16),
              ("ragged K=2000", 1000, 2000, 2048, torch.bfloat16),
              ("ragged K=2004", 1000, 2004, 257, torch.bfloat16))
INT8_OPS_PER_S = 1979e12  # H100 SXM5 data sheet, dense int8 tensor-core rate
W8A8_TOLERANCE = "bitwise (torch.equal): the int32 sum is exact and both round once"


def w8a8_inputs(m, k, n, seed=0):
    """Trunk-like operands made on the card: activations quantized per row,
    a 0.02-scale weight quantized per column, its codes K-major as the trunk
    keeps them."""
    from llm_fine_tune_distributed_tpu_torch.ops.int8 import quantize_int8
    from llm_fine_tune_distributed_tpu_torch.ops.int8_matmul import kmajor, quantize_rows_int8

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device=DEVICE).to(torch.bfloat16)
    w = torch.randn(k, n, generator=gen, device=DEVICE).mul_(0.02)
    q = quantize_int8(w)
    xq, xs = quantize_rows_int8(x)
    return x, w.to(torch.bfloat16), xq, xs, kmajor(q["int8"]), q["int8_scale"]


def w8a8_bound(m, k, n, out_bytes, peaks):
    """Least time: 2*M*N*K int8 operations at the dense int8 rate, or the
    codes, scales and output moved once at the memory rate."""
    nbytes = m * k + k * n + 4 * m + 4 * n + m * n * out_bytes
    t_ops, t_bytes = 2 * m * n * k / INT8_OPS_PER_S, nbytes / peaks[0]
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", nbytes


def int_mm_ms(xq, wq):
    """``torch._int_mm``'s time, or None where it refuses the shape."""
    try:
        torch._int_mm(xq, wq)
    except RuntimeError as e:
        phase(10, f"torch._int_mm refused ({xq.shape[0]}, {xq.shape[1]}, {wq.shape[1]}): {e}")
        return None
    return time_ms(lambda: torch._int_mm(xq, wq))


def w8a8_kernel_phase(mm, peaks):
    """Phase 10: the kernel bitwise against its plain version at every case,
    then times at the trunk's shapes beside the plain version,
    ``torch._int_mm`` on the same K-major codes (int8 x int8 -> int32 only:
    no row/column scales, no cast) and a bf16 ``torch.matmul`` of the same
    shape (the bf16 trunk's projection). Returns the kernels-line record:
    times summed over one trunk layer's 7 projections."""
    shapes = []
    for name, k, n, count in W8A8_SHAPES:
        shapes.append((name, W8A8_M, k, n, torch.bfloat16, count))
    shapes += [(name, m, k, n, dt, 0) for name, m, k, n, dt in W8A8_EXTRA]
    layer = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
             "bf16_matmul_ms": 0.0, "quantize_rows_ms": 0.0}
    per_shape = []
    for i, (name, m, k, n, dt, count) in enumerate(shapes):
        x, w, xq, xs, wq, ws = w8a8_inputs(m, k, n, seed=i)
        check(wq.stride() == (1, k), f"w8a8 {name}: codes not K-major, strides {wq.stride()}")
        out = mm.w8a8_matmul(xq, xs, wq, ws, dt)
        torch.cuda.synchronize()
        ref = mm.int8_w8a8_matmul_reference(xq, xs, wq, ws, dt)
        err = (out.float() - ref.float()).abs().max().item()
        check(torch.equal(out, ref), f"w8a8 {name} ({m}, {k}, {n}) {dt}: kernel differs from "
                                     f"plain, max|d| {err:.3e}")
        del out, ref
        bound_ms, bound_by, nbytes = w8a8_bound(m, k, n, torch.finfo(dt).bits // 8, peaks)
        row = {"name": name, "m": m, "k": k, "n": n, "dtype": str(dt).split(".")[-1],
               "per_layer": count, "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
               "bytes": nbytes}
        if count:  # a shape of the main path: time it
            row["ms"] = time_ms(lambda: mm.w8a8_matmul(xq, xs, wq, ws, dt))
            row["plain_ms"] = time_ms(lambda: mm.int8_w8a8_matmul_reference(xq, xs, wq, ws, dt))
            row["library_ms"] = int_mm_ms(xq, wq)
            row["bf16_matmul_ms"] = time_ms(lambda: x @ w)
            row["quantize_rows_ms"] = time_ms(lambda: mm.quantize_rows_int8(x))
            for key in layer:
                layer[key] = None if None in (layer[key], row[key]) else layer[key] + count * row[key]
            phase(10, f"{name} M={m} K={k} N={n} bf16: kernel {row['ms']:.4f} ms, plain "
                      f"{row['plain_ms']:.4f} ms, torch._int_mm {row['library_ms']} ms, bf16 "
                      f"matmul {row['bf16_matmul_ms']:.4f} ms, row quantization "
                      f"{row['quantize_rows_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
                      f"{2 * m * n * k / 1e9:.0f} GOP, {nbytes / 1e6:.1f} MB); bitwise equal")
        else:
            phase(10, f"{name} M={m} K={k} N={n} {row['dtype']}: bitwise equal to plain")
        per_shape.append(row)
        del x, w, xq, xs, wq, ws
    phase(10, f"one trunk layer (7 projections at M={W8A8_M}): kernel {layer['ms']:.3f} ms, plain "
              f"{layer['plain_ms']:.3f} ms, torch._int_mm {layer['library_ms']} ms, bf16 "
              f"matmul {layer['bf16_matmul_ms']:.3f} ms, bound {layer['bound_ms']:.3f} ms; row "
              f"quantization of the 7 inputs {layer['quantize_rows_ms']:.3f} ms")
    return {**layer, "bound_by": "operations", "max_abs_err": max(r["max_abs_err"] for r in per_shape),
            "shapes": per_shape}


# one trunk layer's projections at tensor=2's local shapes (M, K, N, count,
# output): q, k/v and gate/up column-parallel (N / 2, bf16 out), o_proj and
# down_proj row-parallel (K / 2; f32 out, summed over the group before the cast)
W8A8_TP_SHAPES = (("q_proj", 2048, 1024, 1, torch.bfloat16),
                  ("k_proj/v_proj", 2048, 256, 2, torch.bfloat16),
                  ("gate_proj/up_proj", 2048, 5504, 2, torch.bfloat16),
                  ("o_proj", 1024, 2048, 1, torch.float32),
                  ("down_proj", 5504, 2048, 1, torch.float32))


def w8a8_tp_local_phase(mm, peaks):
    """Phase 10 at one trunk layer's tensor=2 local shapes (M 8192): the
    kernel bitwise against its plain version, then timed beside it, its
    bound and ``torch._int_mm`` on the same codes. Returns the layer's sums
    and each shape's record."""
    layer = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    rows = []
    for i, (name, k, n, count, dt) in enumerate(W8A8_TP_SHAPES):
        x, w, xq, xs, wq, ws = w8a8_inputs(W8A8_M, k, n, seed=100 + i)
        out = mm.w8a8_matmul(xq, xs, wq, ws, dt)
        torch.cuda.synchronize()
        ref = mm.int8_w8a8_matmul_reference(xq, xs, wq, ws, dt)
        err = (out.float() - ref.float()).abs().max().item()
        check(torch.equal(out, ref), f"w8a8 tensor=2 local {name} ({W8A8_M}, {k}, {n}) {dt}: "
                                     f"kernel differs from plain, max|d| {err:.3e}")
        del out, ref
        bound_ms, bound_by, nbytes = w8a8_bound(W8A8_M, k, n, torch.finfo(dt).bits // 8, peaks)
        row = {"name": name, "m": W8A8_M, "k": k, "n": n, "dtype": str(dt).split(".")[-1],
               "per_layer": count, "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
               "ms": time_ms(lambda: mm.w8a8_matmul(xq, xs, wq, ws, dt)),
               "plain_ms": time_ms(lambda: mm.int8_w8a8_matmul_reference(xq, xs, wq, ws, dt)),
               "library_ms": int_mm_ms(xq, wq)}
        for key in layer:
            layer[key] = None if None in (layer[key], row[key]) else layer[key] + count * row[key]
        phase(10, f"tensor=2 local {name} M={W8A8_M} K={k} N={n} {row['dtype']} out: kernel "
                  f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, torch._int_mm "
                  f"{row['library_ms']} ms, bound {bound_ms:.4f} ms ({bound_by}); bitwise equal")
        rows.append(row)
        del x, w, xq, xs, wq, ws
    phase(10, f"one trunk layer at tensor=2's local shapes (one rank's 7 projections): kernel "
              f"{layer['ms']:.3f} ms, plain {layer['plain_ms']:.3f} ms, torch._int_mm "
              f"{layer['library_ms']} ms, bound {layer['bound_ms']:.3f} ms")
    return {**layer, "bound_by": "operations", "max_abs_err": max(r["max_abs_err"] for r in rows),
            "shapes": rows}


def kernel_entry(name, source, replaces, launches, rec):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, **{k: rec[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}


def ptxas_report(log):
    """{kernel<D>: {"registers", "spill_stores"}} from one library's
    ``-Xptxas -v`` report (the entry functions' mangled names carry the
    kernel's name and its head-dim template argument)."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"\d+((?:flash|paged|w8a8)\w*?kernel)", mangled)
            dim = re.search(r"Li(\d+)E", mangled)
            name = (base.group(1) if base else mangled) + (f"<{dim.group(1)}>" if dim else "")
            if "IfLi" in mangled:
                name += " f32"
            elif "I13__nv_bfloat16Li" in mangled:
                name += " bf16"
            out[name] = {}
        elif name and "spill stores" in line:
            out[name]["spill_stores"] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def w8a8_layer_ms(mm, freeze, spin=True):
    """One trunk layer's 7 projections at M = W8A8_M (W8A8_SHAPES, each
    distinct shape timed once) through ``w8a8_matmul``, on codes made by
    ``freeze.quantize_trunk_int8`` of the checkout at hand (its own layout):
    {"ms": the layer's sum, "kmajor": whether every code leaf is K-major}."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    frozen = {f"model.layers.0.p{i}.kernel": torch.randn(k, n, generator=gen, device=DEVICE).mul_(0.02)
              for i, (_, k, n, _) in enumerate(W8A8_SHAPES)}
    quantized, n_quant = freeze.quantize_trunk_int8(frozen, 1)
    check(n_quant == len(W8A8_SHAPES), f"quantize_trunk_int8 quantized {n_quant} kernels")
    total, kmajor = 0.0, True
    for i, (_, k, n, count) in enumerate(W8A8_SHAPES):
        wq = quantized[f"model.layers.0.p{i}.kernel_int8"]
        ws = quantized[f"model.layers.0.p{i}.kernel_int8_scale"]
        kmajor = kmajor and wq.stride() == (1, k)
        xq, xs = mm.quantize_rows_int8(torch.randn(W8A8_M, k, generator=gen, device=DEVICE)
                                       .to(torch.bfloat16))
        total += count * time_ms(lambda: mm.w8a8_matmul(xq, xs, wq, ws, torch.bfloat16), spin=spin)
    return {"ms": total, "kmajor": kmajor}


def flash_ab_times(tree: str) -> dict:
    """``--flash-ab``: the times of one checkout's flash and w8a8 kernels (in
    a process of its own: every checkout's package has one name)."""
    import os

    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT
    from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
    from llm_fine_tune_distributed_tpu_torch.ops import _build
    from llm_fine_tune_distributed_tpu_torch.ops import flash_attention as fa
    from llm_fine_tune_distributed_tpu_torch.ops import int8_matmul as mm
    from llm_fine_tune_distributed_tpu_torch.parallel import freeze

    for mod in (fa, mm, freeze):
        check(os.path.abspath(mod.__file__).startswith(tree + os.sep),
              f"imported {mod.__file__}, not the checkout at {tree}")
    out = {"tree": tree, "card": card_info(), "torch": torch.__version__}
    _build.build_all(("paged_decode", "flash_fwd", "flash_bwd", "w8a8_matmul"))
    out["spin_cycles"], out["spin_ms"] = calibrate_spin()
    _, live = live_lengths(ByteChatMLTokenizer, WILDERNESS_EXPERT_SYSTEM_PROMPT)
    for spin in (True, False):
        for name, ms in paged_ms(fa, live, spin=spin).items():
            out[f"paged_decode/{name}/{'spin' if spin else 'no_spin'}"] = ms
    q, k, v, do = flash_inputs(torch.bfloat16)
    ragged = flash_segments_case("ragged", q.shape[0], q.shape[1])
    for label, seg in (("ragged", ragged), ("one_segment", torch.ones_like(ragged))):
        o, lse = fa.flash_fwd(q, k, v, seg)
        delta = fa.flash_delta(o, do)
        kernels = {
            "flash_fwd": lambda: fa.flash_fwd(q, k, v, seg),
            "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, seg, lse, delta, do),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, seg, lse, delta, do),
        }
        for spin in (True, False):
            method = "spin" if spin else "no_spin"
            for name, fn in kernels.items():
                out[f"{label}/{name}/{method}"] = time_ms(fn, spin=spin)
            if label == "ragged":
                fwd_ms, bwd_ms = sdpa_times(q, k, v, do, seg, spin=spin)
                out[f"ragged/sdpa_forward/{method}"] = fwd_ms
                out[f"ragged/sdpa_backward/{method}"] = bwd_ms
    del q, k, v, do
    for spin in (True, False):
        layer = w8a8_layer_ms(mm, freeze, spin=spin)
        out[f"w8a8_layer/{'spin' if spin else 'no_spin'}"] = layer["ms"]
        out["w8a8_codes_kmajor"] = layer["kmajor"]
    return out


def ab_runs(trees, one_flag: str, what: str) -> int:
    """``--flash-ab`` / ``--serve-ab DIR [DIR ...]``: ``one_flag`` on each
    checkout in a process of its own (every checkout's package has one
    name), in the order given."""
    import os

    runs = []
    for tree in trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), one_flag, tree],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
            print(f"chip_smoke {one_flag[:-len('-one')]}: {what} {tree} failed "
                  f"(exit {proc.returncode})", file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"runs": runs}), flush=True)
    return 0


def serve_ab_times(tree: str) -> dict:
    """``--serve-ab``: phase 4 (SmolLM3-3B, seed-0 bf16 weights, paged int8,
    a warm-up request then the 4 concurrent ones) on one checkout's port,
    in a process of its own, driven by this script's ``serve_phase``."""
    import os

    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
    from llm_fine_tune_distributed_tpu_torch.infer import generate as gen_mod
    from llm_fine_tune_distributed_tpu_torch.infer import server as server_mod
    from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
    from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
    from llm_fine_tune_distributed_tpu_torch.ops import _build
    from llm_fine_tune_distributed_tpu_torch.ops import flash_attention as fa

    for mod in (fa, server_mod, gen_mod):
        check(os.path.abspath(mod.__file__).startswith(tree + os.sep),
              f"imported {mod.__file__}, not the checkout at {tree}")
    _build.build_all(("paged_decode",))
    config = get_preset("smollm3_3b")
    params = tf.init_params(config, seed=0, device=DEVICE, dtype=torch.bfloat16)
    generator = gen_mod.Generator(params, config, ByteChatMLTokenizer(),
                                  compute_dtype=torch.bfloat16, device=DEVICE)
    served = serve_phase(server_mod, fa, generator)
    keys = ("launches", "decode_steps", "tokens_per_s_concurrent", "window_s",
            "decode_tick_tokens_per_s", "decode_step_ms_mean", "decode_step_ms_mean_concurrent",
            "ttft_s_warmup", "ttft_s_concurrent_mean")
    return {"tree": tree, "card": card_info(), "torch": torch.__version__,
            **{k: served[k] for k in keys}}


# ---------------------------------------------------------------------------
# phase 23: live deployment, the train->serve loop
# ---------------------------------------------------------------------------

DEPLOY_STREAM_TOKENS = 64  # the stream in flight across the swap (128 before PR 19's cut)
DEPLOY_CANARY_WINDOW_S = 3.0  # 23c's --canary-window-s
DEPLOY_CANARY_MIN_REQUESTS = 2  # 23c's --canary-min-requests
DEPLOY_FAILING_REQUESTS = 3  # 23c: the canary's requests, each failed by a prefill fault


def snapshot_state(trainer):
    """Host copies of a trainer's trainable leaves and AdamW moments (23a
    holds the resumed state to them bit for bit)."""
    st = trainer.state
    return {"step": st.step, "count": st.opt_state["count"],
            "trainable": {k: v.detach().to("cpu") for k, v in st.trainable.items()},
            "mu": {k: v.to("cpu") for k, v in st.opt_state["mu"].items()},
            "nu": {k: v.to("cpu") for k, v in st.opt_state["nu"].items()}}


def _equal_on_card(label, got, want):
    bad = [k for k, v in want.items() if not torch.equal(got[k].detach(), v.to(DEVICE))]
    check(set(got) == set(want) and not bad, f"{label}: {len(bad)} leaves differ ({bad[:3]})")


def deploy_resume(workdir, saved):
    """23a: a fresh trainer on phase 8's output with resume_from_checkpoint
    "latest" restores step 3 (trainable leaves and both moments bit for
    bit, the frozen fingerprint verified); a base with one frozen leaf's
    rows reversed is refused with FingerprintMismatch; and a synchronous
    trainable-only save of the resumed state is timed beside phase 8's
    background one."""
    import os
    import shutil

    from llm_fine_tune_distributed_tpu_torch.train.checkpoints import (
        CheckpointManager,
        FingerprintMismatch,
        frozen_fingerprint,
    )
    from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer

    t0 = time.monotonic()
    trainer = SFTTrainer(train_config(workdir, resume_from_checkpoint="latest"), device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    ckpt = trainer._checkpoint_manager()
    t0 = time.monotonic()
    step = trainer._resume(ckpt)
    torch.cuda.synchronize()
    resume_s = time.monotonic() - t0
    st = trainer.state
    check(step == saved["step"] == st.step and st.opt_state["count"] == saved["count"],
          f"resumed step {step}, count {st.opt_state['count']}; saved {saved['step']}")
    _equal_on_card("23a trainable leaves", st.trainable, saved["trainable"])
    _equal_on_card("23a first moments", st.opt_state["mu"], saved["mu"])
    _equal_on_card("23a second moments", st.opt_state["nu"], saved["nu"])
    name = "model.layers.0.self_attn.q_proj.kernel"
    leaf = st.frozen[name]
    st.frozen[name] = leaf.flip(0)  # the same values, rows reversed
    t0 = time.monotonic()
    try:
        ckpt.restore(step, st)
        refused = None
    except FingerprintMismatch as e:
        refused = str(e)
    planted_s = time.monotonic() - t0
    st.frozen[name] = leaf
    check(refused is not None and name in refused,
          f"a base with {name}'s rows reversed was not refused: {refused}")
    t0 = time.monotonic()
    fp = frozen_fingerprint(st.frozen)
    fingerprint_s = time.monotonic() - t0
    sync_dir = os.path.join(workdir, "sync_checkpoint")
    sync = CheckpointManager(sync_dir, trainable_only=True)
    sync.save(step, st, fingerprint=fp, snapshot_async=False)
    sync_save = sync.last_save
    shutil.rmtree(sync_dir)
    rec = {"trainer_build_s": build_s, "resume_s": resume_s, "restored_step": step,
           "planted_base_refused_s": planted_s, "frozen_fingerprint_s": fingerprint_s,
           "frozen_leaves": len(st.frozen), "sync_save": sync_save}
    phase(23, f"(a) resume: trainer built in {build_s:.1f} s, step {step} restored in "
              f"{resume_s:.3f} s (trainable leaves and both moments bit for bit, the "
              f"fingerprint of {len(st.frozen)} frozen leaves verified); {name}'s rows reversed "
              f"-> FingerprintMismatch in {planted_s:.3f} s; frozen fingerprint alone "
              f"{fingerprint_s:.3f} s; a sync trainable-only save "
              f"{sync_save['bytes'] / 1e9:.3f} GB in {sync_save['seconds']:.3f} s")
    del trainer, st, leaf, ckpt
    gc_cuda()
    return rec


def _timed_stream(engine, prompt, n):
    """A greedy stream of ``n`` tokens through the engine's ``stream`` (what
    ``/v1/stream`` iterates): the largest gap between two of its tokens."""
    from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig

    times = [time.monotonic()]
    for _ in engine.stream(prompt, GenerationConfig(max_new_tokens=n, do_sample=False),
                           timeout=600):
        times.append(time.monotonic())
    return max(b - a for a, b in zip(times[1:], times[2:]))


def _check_freed(label, before, params, res):
    """A swap's replaced leaves are freed: of the leaves resident before it
    (weak references), exactly the swapped ones are gone and the rest are
    the same tensors; and ``memory_allocated`` across the apply moved by at
    most 1 MiB per swapped leaf. The caching allocator does not split a
    free block whose remainder is <= 1 MiB, so a new leaf may sit in a block
    up to 1 MiB larger than the one its predecessor freed: SmolLM3's
    embedding (525,336,576 B) in a fresh 2 MiB-rounded segment is exactly
    1 MiB short of it."""
    gone = sorted(k for k, ref in before.items() if ref() is None)
    kept = [k for k, ref in before.items() if ref() is not None and ref() is params[k]]
    n, delta = res["updated_leaves"], res["memory_delta_bytes"][0]
    check(len(gone) == n and len(kept) == len(before) - n,
          f"{label}: {len(gone)} resident leaves freed, {n} swapped; {len(kept)} kept")
    check(abs(delta) <= n << 20,
          f"{label}: memory_allocated across the apply moved by {delta} B, beyond 1 MiB per "
          f"swapped leaf ({n})")


def _generate(srv, question, label):
    status, _, raw = _request(srv.base, "/v1/generate", {"question": question, "greedy": True,
                                                          "max_new_tokens": MAX_NEW_TOKENS})
    check(status == 200, f"{label}: HTTP {status} {raw[:200]!r}")
    return srv.results[-1][1]


def _deploy(srv, path, label, want_status=200):
    status, _, raw = _request(srv.base, path, {})
    body = json.loads(raw)
    check(status == want_status, f"{label}: POST {path} HTTP {status} {body}")
    return body


def _flight_kinds(eng):
    return [e["kind"] for e in eng.recorder.events()]


def _republish(publish_dir, step, manifest_edit):
    """A copy of phase 8's step-3 publish as ``step``, its manifest edited."""
    import os
    import shutil

    from llm_fine_tune_distributed_tpu_torch.train.publish import (
        MANIFEST_NAME,
        atomic_write_json,
        load_manifest,
        step_dir_name,
    )

    src = os.path.join(publish_dir, step_dir_name(3))
    dst = os.path.join(publish_dir, step_dir_name(step))
    os.makedirs(dst)
    manifest = load_manifest(src)
    shutil.copy(os.path.join(src, manifest["weights_file"]),
                os.path.join(dst, manifest["weights_file"]))
    manifest = manifest_edit(dict(manifest, step=step))
    atomic_write_json(os.path.join(dst, MANIFEST_NAME), manifest)
    return manifest


def deploy_swap(tf, gen_mod, server_mod, fa, workdir, card):
    """23b: a paged int8 server at phase 4's geometry over the random base
    (seed 42 in bf16, whose frozen leaves are the trainer's) watching phase
    8's publish directory: a request before; a 128-token stream in flight
    while POST /v1/deploy swaps step 3 in (it finishes on the old weights,
    held to the base's solo run by the margin rule); the replaced leaves
    freed at the swap and at the rollback; after the
    swap two requests equal a fresh server on best_model/
    token for token; paged decode launches 36 x decode steps throughout;
    a republish with a worse eval_loss and one with another frozen
    fingerprint refused, the generation unmoved; POST /v1/deploy/rollback
    gives the pre-swap tokens back."""
    import os

    from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
    from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset

    config = get_preset("smollm3_3b")
    publish_dir = os.path.join(workdir, "publish")
    generator = gen_mod.Generator(tf.init_params(config, seed=42, device=DEVICE,
                                                 dtype=torch.bfloat16),
                                  config, ByteChatMLTokenizer(), compute_dtype=torch.bfloat16,
                                  device=DEVICE)
    kw = dict(engine="paged", quantize_kv="int8", slots=SLOTS, kv_buf_len=KV_BUF_LEN,
              kv_block_len=KV_BLOCK_LEN, prefill_chunk=PREFILL_CHUNK, prompt_bucket=PROMPT_BUCKET)
    stream_prompt = _prompt_ids(generator, {"question": QUESTIONS[2]})
    stream_solo = solo_decode(tf, gen_mod, generator, stream_prompt, DEPLOY_STREAM_TOKENS)
    floor = 2 * int8_kv_noise(tf, generator, stream_prompt)
    layers = config.num_layers
    rec = {"card": card}
    with _Serving(server_mod, generator, publish_watch_dir=publish_dir, publish_poll_s=3600,
                  **kw) as srv:
        eng, mgr = srv.engine, srv.httpd.deploy_manager
        fa.paged_decode_attention.launches = 0
        steps0 = eng.stats_snapshot()["decode_steps"]
        before = [_generate(srv, q, "23b before") for q in QUESTIONS[:2]]
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        resident = {k: weakref.ref(t) for k, t in eng.params.items()}
        stream = {}
        th = threading.Thread(target=lambda: stream.update(max_gap_s=_timed_stream(
            eng, stream_prompt, DEPLOY_STREAM_TOKENS)), daemon=True)
        th.start()
        _wait_for(lambda: len(srv.results) == 3 and len(srv.results[-1][1]) >= 2,
                  "the stream's second token")
        t0 = time.monotonic()
        res = _deploy(srv, "/v1/deploy", "23b deploy")
        deploy_wall_s = time.monotonic() - t0
        th.join(600)
        check("max_gap_s" in stream, "23b: the stream across the swap failed")
        check(res["kind"] == "deploy" and res["step"] == 3 and res["weight_generation"] == 1,
              f"23b deploy: {res}")
        begin = [e for e in eng.recorder.events() if e["kind"] == "weight_swap_begin"]
        check(len(begin) == 1 and begin[0]["live"] >= 1,
              f"the stream was not in flight when the swap was staged: {begin}")
        streamed = srv.results[2][1]
        n_agree, at = margin_agreement(tf, generator, "23b stream across the swap", stream_prompt,
                                       streamed, stream_solo, floor=floor)
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()  # idle to idle: the stream's decode included
        _check_freed("the swap", resident, eng.params, res)
        after = [_generate(srv, q, "23b after") for q in QUESTIONS[:2]]
        # the eval gate and the fingerprint check, with step 3 resident
        worse = _republish(publish_dir, 4, lambda m: dict(
            m, metrics={k: v + 1.0 for k, v in m["metrics"].items()}))
        check(_deploy(srv, "/v1/deploy", "23b worse eval")["kind"] == "noop",
              "a worse eval_loss was deployed")
        _republish(publish_dir, 5, lambda m: dict(m, frozen_fp={
            k: [x * 1.01 for x in v] for k, v in m["frozen_fp"].items()}))
        check(_deploy(srv, "/v1/deploy", "23b foreign base")["kind"] == "noop",
              "a publish of another base was deployed")
        kinds = _flight_kinds(eng)
        check(kinds.count("publish_rejected_eval") == 1
              and kinds.count("publish_rejected_fingerprint") == 1
              and eng.weight_generation == 1,
              f"23b refusals: {kinds.count('publish_rejected_eval')} eval, "
              f"{kinds.count('publish_rejected_fingerprint')} fingerprint, generation "
              f"{eng.weight_generation}")
        resident = {k: weakref.ref(t) for k, t in eng.params.items()}
        t0 = time.monotonic()
        rb = _deploy(srv, "/v1/deploy/rollback", "23b rollback")
        rollback_wall_s = time.monotonic() - t0
        _check_freed("the rollback", resident, eng.params, rb)
        back = [_generate(srv, QUESTIONS[0], "23b after rollback")]
        check(back[0] == before[0], f"after the rollback {back[0]} != before the swap {before[0]}")
        snap = eng.stats_snapshot()
        launches = fa.paged_decode_attention.launches
        decode_steps = snap["decode_steps"] - steps0
        check(launches == layers * decode_steps > 0,
              f"23b: {launches} paged decode launches, want {layers} x {decode_steps}")
        watcher = mgr.watcher
        rec.update({
            "deploy": res, "rollback": rb, "deploy_wall_s": deploy_wall_s,
            "rollback_wall_s": rollback_wall_s, "watcher_load_s": watcher.last_load_s,
            "watcher_fingerprint_s": watcher.last_fingerprint_s,
            "apply_ms": 1000 * res["apply_s"][0], "rollback_apply_ms": 1000 * rb["apply_s"][0],
            "stream_max_gap_s": stream["max_gap_s"], "stream_tokens_agreeing": n_agree,
            "stream_first_difference": at, "memory_before": mem_before,
            "memory_after": mem_after, "launches": launches, "decode_steps": decode_steps,
            "weight_swaps": snap["weight_swaps"], "weight_rollbacks": snap["weight_rollbacks"],
            "eval_gate": worse["metrics"]})
    del generator
    gc_cuda()
    best = gen_mod.load_model_dir(os.path.join(workdir, "out", "best_model"), device=DEVICE,
                                  dtype=torch.bfloat16)
    fresh_gen = gen_mod.Generator(best[0], best[1], ByteChatMLTokenizer(),
                                  compute_dtype=torch.bfloat16, device=DEVICE)
    del best
    with _Serving(server_mod, fresh_gen, **kw) as fresh:
        want = [_generate(fresh, q, "23b best_model/") for q in QUESTIONS[:2]]
    del fresh_gen
    gc_cuda()
    check(after == want, f"after the swap {after} != a fresh server on best_model/ {want}")
    phase(23, f"(b) {card}: POST /v1/deploy swapped step 3 in: watcher load "
              f"{rec['watcher_load_s']:.3f} s, frozen fingerprint "
              f"{rec['watcher_fingerprint_s']:.3f} s, apply {rec['apply_ms']:.1f} ms at the "
              f"drained boundary, deploy {res['duration_s']:.3f} s ({deploy_wall_s:.3f} s over "
              f"HTTP, the {DEPLOY_STREAM_TOKENS}-token stream's drain included); the stream in "
              f"flight finished on the old weights ({n_agree} tokens equal to the base's solo "
              f"run, the rest past a margin within the bound), largest gap "
              f"{1000 * stream['max_gap_s']:.1f} ms; memory_allocated across the apply "
              f"{res['memory_delta_bytes'][0]:+d} B (idle to idle {mem_after - mem_before:+d} B, "
              f"the stream's decode included), across the rollback's "
              f"{rb['memory_delta_bytes'][0]:+d} B; 2 answers equal a fresh server on "
              f"best_model/; eval gate and "
              f"fingerprint refusals; rollback {1000 * rb['duration_s']:.1f} ms (apply "
              f"{rec['rollback_apply_ms']:.1f} ms) and the pre-swap tokens back; paged decode "
              f"launches {launches} == {layers} x {decode_steps}")
    return rec


def deploy_canary(tf, gen_mod, server_mod, workdir, card):
    """23c: two paged int8 replicas with a canary window: a clean rolling
    swap of step 3 leaves both on generation 1; a republish whose canary
    requests fail (a prefill fault each on replica 0) is rejected, replica
    0 rolled back and replica 1 never swapped; a rollback; GET /v1/lineage
    shows the deploy, the rejection and the rollback with the manifest's
    run_id."""
    import os
    import shutil

    from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
    from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
    from llm_fine_tune_distributed_tpu_torch.train.publish import load_manifest, step_dir_name

    config = get_preset("smollm3_3b")
    src = os.path.join(workdir, "publish")
    publish_dir = os.path.join(workdir, "publish_fleet")
    os.makedirs(publish_dir)
    shutil.copytree(os.path.join(src, step_dir_name(3)), os.path.join(publish_dir,
                                                                       step_dir_name(3)))
    run_id = load_manifest(os.path.join(src, step_dir_name(3)))["run_id"]
    generator = gen_mod.Generator(tf.init_params(config, seed=42, device=DEVICE,
                                                 dtype=torch.bfloat16),
                                  config, ByteChatMLTokenizer(), compute_dtype=torch.bfloat16,
                                  device=DEVICE)
    kw = dict(engine="paged", quantize_kv="int8", slots=SLOTS, kv_buf_len=KV_BUF_LEN,
              kv_block_len=KV_BLOCK_LEN, prefill_chunk=PREFILL_CHUNK, prompt_bucket=PROMPT_BUCKET,
              replicas=2, canary_window_s=DEPLOY_CANARY_WINDOW_S,
              canary_min_requests=DEPLOY_CANARY_MIN_REQUESTS, publish_watch_dir=publish_dir,
              publish_poll_s=3600, flight_dir=None)
    with _Serving(server_mod, generator, **kw) as srv:
        rep0, rep1 = srv.engine.replicas
        clean = _deploy(srv, "/v1/deploy", "23c clean deploy")
        check(clean["kind"] == "deploy" and clean["replicas"] == 2
              and [r.weight_generation for r in (rep0, rep1)] == [1, 1],
              f"23c clean rolling swap: {clean}")
        _republish(publish_dir, 4, lambda m: m)
        prompt = _prompt_ids(generator, {"question": QUESTIONS[1]})
        failed = []

        def failing_canary():
            _wait_for(lambda: rep0.weight_generation == 2, "the canary's swap", timeout=600)
            for _ in range(DEPLOY_FAILING_REQUESTS):
                rep0.faults.fail_prefill_next(1)
                try:
                    rep0.submit(prompt, gen_mod.GenerationConfig(max_new_tokens=4,
                                                                 do_sample=False),
                                timeout=600)
                except Exception as e:  # noqa: BLE001 — the 503 is the point
                    failed.append(type(e).__name__)

        th = threading.Thread(target=failing_canary, daemon=True)
        th.start()
        rejected = _deploy(srv, "/v1/deploy", "23c canary deploy")
        th.join(600)
        check(rejected["kind"] == "canary_rejected"
              and rejected["canary"]["verdict"] == "regression" and rejected["run_id"] == run_id,
              f"23c canary: {rejected}")
        check([r.weight_generation for r in (rep0, rep1)] == [3, 1]
              and rep1.stats_snapshot()["weight_swaps"] == 1,
              f"23c: generations {[r.weight_generation for r in (rep0, rep1)]}, replica 1 swaps "
              f"{rep1.stats_snapshot()['weight_swaps']}")
        rb = _deploy(srv, "/v1/deploy/rollback", "23c rollback")
        status, lineage = _get_json(srv.base, "/v1/lineage")
        history = [(r["kind"], r["step"], r["run_id"]) for r in lineage["history"]]
        check(status == 200 and history == [("deploy", 3, run_id), ("canary_rejected", 4, run_id),
                                            ("rollback", -1, None)],
              f"23c lineage: HTTP {status} {history}")
        gens = [r.weight_generation for r in (rep0, rep1)]
    del generator
    gc_cuda()
    rec = {"clean": clean, "canary_rejected": rejected, "rollback": rb,
           "failed_canary_requests": failed, "lineage_history": history, "generations": gens,
           "card": card}
    phase(23, f"(c) {card}: rolling swap over 2 replicas in {clean['duration_s']:.3f} s "
              f"(applies {[round(1000 * s, 1) for s in clean['apply_s']]} ms, canary "
              f"{clean['canary']['verdict']}); a republish whose {len(failed)} canary requests "
              f"failed: {rejected['canary']['verdict']} ({rejected['canary']['reason']}), replica 0 "
              f"rolled back, replica 1 never swapped; rollback over 2 replicas "
              f"{1000 * rb['duration_s']:.1f} ms; /v1/lineage {history}")
    return rec


def deploy_phase(tf, gen_mod, server_mod, fa, workdir, saved, trained, card):
    """Phase 23, live deployment, on phase 8's output (its final
    trainable-only checkpoint, its publish and best_model/): 23a resume,
    23b swap on one engine, 23c canary on a fleet."""
    t0 = time.monotonic()
    rec = {"train_checkpoint": trained.get("checkpoint"), "train_publish": trained.get("publish"),
           "resume": deploy_resume(workdir, saved)}
    rec["swap"] = deploy_swap(tf, gen_mod, server_mod, fa, workdir, card)
    rec["canary"] = deploy_canary(tf, gen_mod, server_mod, workdir, card)
    rec["seconds"] = time.monotonic() - t0
    phase(23, f"phase 23 took {rec['seconds']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 24: the fine-tuning recipes (packing, LoRA, QLoRA, DPO, NF4 serving)
# ---------------------------------------------------------------------------

RECIPE_PACKED_ROWS = 480  # 432 train examples pack to ~110 rows at ~30%: 3 steps of 32
RECIPE_DPO_ROWS = 54  # 48 train pairs: 3 steps of 4 microbatches of 4 pairs
# 24d's depth at full width (cut from 36 to keep the smoke within its time
# budget: its checks, the first loss ln 2, the rewards and the launches as
# derived, hold at any depth)
RECIPE_DPO_LAYERS = 4
LORA_TRAINABLE = 30_228_480  # r 16 on the 7 projections of SmolLM3-3B's 36 layers
LORA_FIRST_LOSS_REL = 1e-3  # 24b's first loss against phase 8's: B = 0, bf16 summation order
QLORA_FIRST_LOSS_REL = 0.02  # 24c's first loss against 24b's: the NF4 base's rounding
DPO_FIRST_LOSS_TOL = 1e-3  # 24d's first loss against ln 2: the reference is the policy


def recipe_run(fa, mm, workdir, label, rows, layers=None, **kw):
    """One phase-24 training run through ``SFTTrainer`` (``DPOTrainer`` for
    ``objective="dpo"``) over the first ``rows`` rows of the repo's JSONL.
    Checks finite losses, 0 watchdog trips, the frozen leaves bit-unchanged
    (held on the host, so that the check adds nothing to the card's peak),
    every trainable leaf moved and the flash launches as derived; returns
    (record, trainer). ``layers``: SmolLM3-3B cut to that depth."""
    import os

    from llm_fine_tune_distributed_tpu_torch.train.dpo import DPOTrainer
    from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer

    os.makedirs(os.path.join(workdir, "data"))
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                           "final_qa_data_unique.jsonl")) as f:
        lines = [next(f) for _ in range(rows)]
    with open(os.path.join(workdir, "data", "final_qa_data_unique.jsonl"), "w") as f:
        f.writelines(lines)
    config = train_config(workdir, publish=False, **kw)  # phase 8's recipe, no publish
    dpo = config.objective == "dpo"
    t0 = time.monotonic()
    from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset

    mc = get_preset(config.model_preset).replace(num_layers=layers) if layers else None
    trainer = (DPOTrainer if dpo else SFTTrainer)(config, model_config=mc, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    mc = trainer.model_config
    phase(24, f"{label}: {type(trainer).__name__} ready in {init_s:.1f} s: "
              f"{trainer.trainable_report}, {trainer.n_train} train / {trainer.n_val} validation "
              f"{'pairs' if dpo else 'rows'}, {trainer.total_steps} steps")
    frozen_before = {k: v.to("cpu") for k, v in trainer.state.frozen.items()}
    trainable_before = {k: v.detach().clone() for k, v in trainer.state.trainable.items()}
    counters = {k: f for k, f in train_counters(fa, mm).items() if k != "w8a8_matmul"}
    for fn in counters.values():  # count the main path's launches only
        fn.launches = 0
    t0 = time.monotonic()
    summary = trainer.train()
    train_s = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    history, meter = trainer.metrics.history, trainer.throughput
    losses = [h["loss"] for h in history]
    check(all(np.isfinite(losses)) and np.isfinite(summary["final_eval_loss"]),
          f"{label}: losses {losses}, eval {summary['final_eval_loss']}")
    watchdog = trainer.watchdog
    check(watchdog is not None and watchdog.trips == 0, f"{label}: watchdog trips")
    for k, v in trainer.state.frozen.items():
        check(torch.equal(v.to("cpu"), frozen_before[k]), f"{label}: frozen leaf {k} changed")
    for k, v in trainer.state.trainable.items():
        check(not torch.equal(v.detach(), trainable_before[k]), f"{label}: trainable leaf {k} "
                                                                "did not move")
    del frozen_before, trainable_before
    # launches: per microbatch each layer's forward, its remat replay and
    # its backward (DPO: the policy's forward and replay, the reference's
    # forward, one backward); per eval batch one forward (DPO: two)
    layers, accum, steps = mc.num_layers, config.gradient_accumulation_steps, len(meter.step_s)
    eval_batches = -(-trainer.n_val // (config.eval_batch_size or config.per_device_batch_size))
    evals = 1 + (steps // config.eval_steps if config.eval_steps else 0)
    replays = 1 if config.gradient_checkpointing else 0
    models = 2 if dpo else 1
    expected = {"flash_fwd": layers * accum * steps * (models + replays)
                + models * layers * eval_batches * evals,
                "flash_bwd_dq": layers * accum * steps, "flash_bwd_dkv": layers * accum * steps}
    check(launches == expected, f"{label}: launches {launches} != derived {expected}")
    steady = slice(1, None)  # steps 2-3: the first step pays first-use costs
    step_s = meter.step_s[steady]
    record = {
        "losses": losses, "eval_loss": summary["final_eval_loss"], "init_s": init_s,
        "train_s": train_s, "step_s": meter.step_s,
        "step_ms_median_steps_2_3": statistics.median(step_s) * 1e3,
        "samples_per_s_per_card": config.per_device_batch_size * accum * len(step_s) / sum(step_s),
        "real_tokens_per_s_per_card": sum(meter.step_real_tokens[steady]) / sum(step_s),
        "train_peak_bytes": history[-1]["device_peak_bytes_in_use"],  # before the export
        "launches": launches, "expected_launches": expected,
        "trainable_params": trainer.trainable_report["trainable_parameters"],
        "quantize_s": trainer.quantize_seconds, "export_merge_s": trainer.export_merge_seconds,
    }
    phase(24, f"{label}: train() in {train_s:.1f} s; losses {[round(x, 4) for x in losses]}, eval "
              f"{summary['final_eval_loss']:.4f}; steps 2-3 median step "
              f"{record['step_ms_median_steps_2_3']:.1f} ms, {record['samples_per_s_per_card']:.2f} "
              f"{'pairs' if dpo else 'samples'}/s/card, {record['real_tokens_per_s_per_card']:.0f} "
              f"real tokens/s/card, peak {record['train_peak_bytes'] / 1e9:.2f} GB at the last "
              f"step; launches {launches} as derived ({layers} layers x {accum} microbatches x "
              f"{steps} steps x ({models} + {replays} replay) + {models} x {layers} x "
              f"{eval_batches} eval batches x {evals}); frozen leaves bit-unchanged, "
              f"{len(trainer.state.trainable)} trainable leaves moved")
    return record, trainer


def _logits_at(tf, config, params, ids, dtype):
    """f32 logits of the last two positions of one no-cache forward."""
    with torch.no_grad():
        hidden, _ = tf.forward(params, ids, config, compute_dtype=dtype, output_hidden=True)
        return tf.unembed(params, hidden[0, -2:], config, compute_dtype=dtype).float()


def merged_export_check(tf, lora_mod, trainer, best_dir):
    """24b: ``best_model/`` equals the trained state merged (``merge_lora``)
    in bf16, leaf for leaf; its logits and those of the trainer's own
    adapted bf16 forward against the base plus the adapter applied in f32
    (phase 22a's rule: the adapted path within twice the merged bf16
    model's own error of that truth)."""
    from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
    from llm_fine_tune_distributed_tpu_torch.infer.generate import load_model_dir

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    config = trainer.model_config
    state = {k: v.detach() for k, v in {**trainer.state.trainable, **trainer.state.frozen}.items()}
    loaded, _ = load_model_dir(best_dir, device=DEVICE)
    merged = lora_mod.merge_lora(state)
    check(set(loaded) == set(merged), "24b: best_model/ leaves differ from the merged state")
    for k, v in merged.items():
        check(torch.equal(loaded[k], v.to(torch.bfloat16)), f"24b: best_model/{k} differs")
    exact = dict(lora_mod.strip_lora(state))
    for name, a in state.items():
        module, _, leaf = name.rpartition(".")
        if leaf == "lora_a":
            delta = (a.float() @ state[module + ".lora_b"].float()) * state[module + ".lora_scale"].float()
            exact[module + ".kernel"] = state[module + ".kernel"].float() + delta
    ids = torch.tensor([ByteChatMLTokenizer().encode(QUESTIONS[0])], device=DEVICE)
    truth = _logits_at(tf, config, exact, ids, torch.float32)
    del exact
    err = {"best_model": (_logits_at(tf, config, loaded, ids, torch.bfloat16) - truth).abs().max().item(),
           "adapted": (_logits_at(tf, config, state, ids, torch.bfloat16) - truth).abs().max().item(),
           "base": (_logits_at(tf, config, lora_mod.strip_lora(state), ids, torch.bfloat16)
                    - truth).abs().max().item()}
    del loaded, merged
    rounding = 2 * err["best_model"]
    check(err["adapted"] <= rounding, f"24b: the adapted bf16 forward is {err['adapted']:.3e} off "
                                      f"the f32 merge, beyond twice best_model/'s {rounding:.3e}")
    phase(24, f"24b: best_model/ = merge_lora(state) in bf16 leaf for leaf; max|dlogits| against "
              f"the base + adapter in f32 (last 2 positions): best_model/ {err['best_model']:.3e}, "
              f"the adapted bf16 path {err['adapted']:.3e} (bound {rounding:.3e}), the base "
              f"without the adapter {err['base']:.3e}")
    return {"max_abs_dlogits": err, "bound": rounding}


def nf4_ask_phase(cli_mod, model_dir, int8_bytes):
    """24e: ``cli.ask_main --quantize nf4`` on a model directory of the
    seed-42 random base: its load seconds and its weights' bytes on the
    card (``memory_allocated``), below ``int8_bytes`` (phase 14's int8
    weights, or the int8 cap when phase 14 did not run)."""
    import contextlib
    import io
    import re

    argv = ["--model-dir", model_dir, "--greedy", "--max-new-tokens", str(MAX_NEW_TOKENS),
            "--quantize", "nf4", QUESTIONS[0]]
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        rc = cli_mod.ask_main(argv)
    wall = time.monotonic() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        phase(24, f"  | {line}")
    check(rc == 0, f"24e: ask_main --quantize nf4 returned {rc}")
    found = {k: re.search(p, text, re.M) for k, p in ASK_PATTERNS.items()}
    check(all(found.values()), f"24e: ask output lacks {[k for k, m in found.items() if not m]}")
    load_s, weight_bytes, allocated = found["load"].groups()
    gc_cuda()
    out = {"load_s": float(load_s), "weight_bytes": int(weight_bytes),
           "memory_allocated_bytes": int(allocated), "wall_s": wall,
           "tokens_per_s": float(found["rate"].group(3)), "int8_bytes": int8_bytes}
    check(out["memory_allocated_bytes"] < int8_bytes,
          f"24e: NF4 weights take {out['memory_allocated_bytes']} bytes, not below the int8 "
          f"weights' {int8_bytes}")
    phase(24, f"24e: ask --quantize nf4: load {out['load_s']:.3f} s, weights on the card "
              f"{out['memory_allocated_bytes'] / 1e9:.3f} GB (memory_allocated; int8: "
              f"{int8_bytes / 1e9:.3f} GB), {out['tokens_per_s']:.2f} tokens/s, wall {wall:.3f} s")
    return out


def _nf4_faults(params):
    """Two wrong NF4 routes over ``params``' NF4 leaves, yielded one at a
    time as (what, params): each word's nibbles read in swapped pairs (row
    8 r + s from nibble s ^ 1), and each block's absmax read from the
    block before it along the in axis."""
    def swapped(words):
        return ((words >> 4) & 0x0F0F0F0F) | ((words & 0x0F0F0F0F) << 4)

    yield "nibbles swapped in pairs", {
        k: swapped(v) if k.endswith(".kernel_nf4") else v for k, v in params.items()}
    yield "absmax from the block before", {
        k: torch.roll(v, 1, dims=0) if k.endswith((".kernel_absmax_q", ".kernel_absmax")) else v
        for k, v in params.items()}


def nf4_engine_logits(tf, gen_mod, generator, reference, prompts, floor_i8):
    """24e's exact check, as 22a's: the NF4 engine path's logits (the
    prefill and one paged decode step of every prompt in one batch,
    ``engine_path``) against the no-cache f32 forward over the NF4 weights
    dequantized in f32. ``rounding`` is twice the error of the bf16
    no-cache forward over the same weights dequantized to bf16
    (``reference``: the very weights the engine multiplies with, cast once
    from the same f32 values); the engine's bound is ``floor_i8`` (the int8
    pool's) + ``rounding``, for its logits at both steps and its first
    token. The engine path over each planted wrong NF4 route
    (``_nf4_faults``) must fall outside that bound."""
    from llm_fine_tune_distributed_tpu_torch.parallel.qlora import dequantize_frozen

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    engine = engine_path(gen_mod, generator, prompts, "24e")
    faults = {what: engine_path(gen_mod, generator, prompts, f"24e {what}", view=view)
              for what, view in _nf4_faults(generator.params)}
    gc_cuda()
    exact = dequantize_frozen(generator.params, torch.float32)
    out = []
    for i, prompt in enumerate(prompts):
        ctx, step0, step1 = engine[i]
        ids = torch.tensor([ctx], device=DEVICE)  # the prompt and the engine's first token
        truth = _last_logits(tf, generator, exact, ids, 2, torch.float32)
        ref = _last_logits(tf, generator, reference.params, ids, 2, torch.bfloat16)
        rounding = 2 * (ref - truth).abs().max().item()
        bound = floor_i8 + rounding
        err = (torch.stack([step0, step1]) - truth).abs().max().item()
        check(err <= bound, f"24e request {i}: the NF4 engine path's logits {err:.3e} off the "
                            f"f32 forward over the dequantized weights, bound {bound:.3e}")
        gap = _first_token_gap(truth[0], prompt, ctx[-1])
        check(gap <= bound, f"24e request {i}: the NF4 engine path's first token is {gap:.3e} "
                            f"below the f32 top logit, bound {bound:.3e}")
        # step 0 only: a faulted run's step 1 fed its own first token
        fault_err = {what: (rows[i][1] - truth[0]).abs().max().item()
                     for what, rows in faults.items()}
        for what, e in fault_err.items():
            check(e > bound, f"24e request {i}: the engine path with {what} is only {e:.3e} off "
                             f"the f32 forward, within the bound {bound:.3e} that must refuse it")
        out.append({"max_abs_dlogits": err, "rounding": rounding, "bound": bound,
                    "first_token_gap": gap, "faults": fault_err})
        phase(24, f"24e request {i}: NF4 engine path (prefill + 1 paged step) max|dlogits| "
                  f"{err:.3e} against the f32 forward over the dequantized weights, bound "
                  f"{bound:.3e} (bf16 rounding {rounding:.3e} + int8 floor {floor_i8:.3e}); "
                  f"first token {gap:.3e} below the top; planted faults "
                  + ", ".join(f"{w} {e:.3e}" for w, e in fault_err.items()))
    del exact
    gc_cuda()
    return out


# 24e's depth: SmolLM3-3B's width and its first 4 layers (cut from 36 when
# phase 26 took the smoke toward its time limit; every 24e check holds the
# engine to the same weights' own references, so none depends on the depth)
NF4_SERVE_LAYERS = 4


def nf4_serve_phase(tf, gen_mod, server_mod, fa, config, tokenizer):
    """24e: phase 4's random weights (at ``NF4_SERVE_LAYERS``) stored as NF4
    (``maybe_quantize``), served from an int8 KV pool at phase 4's geometry
    on phase 4's traffic (paged decode launches layers x decode steps,
    checked by ``serve_phase``);
    the engine path's logits held to the f32 forward over the dequantized
    weights (``nf4_engine_logits``, with two planted faults refused), and
    each request held by the margin rule to the solo run of the same
    weights dequantized to bf16, with twice the int8 pool's error as the
    floor."""
    from llm_fine_tune_distributed_tpu_torch.ops.int8 import maybe_quantize
    from llm_fine_tune_distributed_tpu_torch.parallel.qlora import dequantize_frozen

    before = torch.cuda.memory_allocated()
    params = tf.init_params(config, seed=0, device=DEVICE, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    bf16_bytes = torch.cuda.memory_allocated() - before
    t0 = time.monotonic()
    maybe_quantize(params, "nf4")
    torch.cuda.synchronize()
    quantize_s = time.monotonic() - t0
    nf4_bytes = torch.cuda.memory_allocated() - before
    phase(24, f"24e: phase 4's random weights as NF4 in {quantize_s:.2f} s on the card: "
              f"{nf4_bytes / 1e9:.3f} GB (bf16: {bf16_bytes / 1e9:.3f} GB)")
    generator = gen_mod.Generator(params, config, tokenizer, compute_dtype=torch.bfloat16,
                                  device=DEVICE)
    served = serve_phase(server_mod, fa, generator, phase_no=24)
    reference = gen_mod.Generator(dequantize_frozen(params, torch.bfloat16), config, tokenizer,
                                  compute_dtype=torch.bfloat16, device=DEVICE)
    prompts = [p for p, _ in served["results"][1:]]
    floor = 2 * max(int8_kv_noise(tf, reference, p) for p in prompts)
    exact = nf4_engine_logits(tf, gen_mod, generator, reference, prompts, floor)
    agree = []
    for i, (prompt, ids) in enumerate(served["results"][1:]):
        solo = solo_decode(tf, gen_mod, reference, prompt, MAX_NEW_TOKENS)
        n, at = margin_agreement(tf, reference, f"24e request {i}", prompt, ids, solo, floor=floor)
        agree.append(n)
        if at:
            phase(24, f"  24e request {i}: token {at['token']} differs at a solo top-2 margin "
                      f"{at['margin']:.3e} <= bound {at['bound']:.3e}")
    del generator, reference, params
    gc_cuda()
    served.pop("results")
    served.update({"nf4_weight_bytes": nf4_bytes, "bf16_weight_bytes": bf16_bytes,
                   "quantize_s": quantize_s, "tokens_agreeing_with_solo": agree,
                   "int8_floor": floor, "engine_logits": exact})
    phase(24, f"24e: NF4 weights, paged int8 KV: {served['tokens_per_s_concurrent']:.1f} tokens/s "
              f"over the 4 concurrent requests, mean decode step {served['decode_step_ms_mean']:.2f} "
              f"ms, TTFT warm-up {served['ttft_s_warmup']:.3f} s; tokens equal to the dequantized "
              f"bf16 solo runs per request {agree} (floor {floor:.3e})")
    return served


def recipes_phase(tf, gen_mod, server_mod, cli_mod, fa, mm, trained, int8_bytes, before_d=None):
    """Phase 24, the fine-tuning recipes, each at phase 8's recipe beside
    phase 8's record ``trained``: (a) packing, (b) LoRA, (c) QLoRA, (d)
    DPO with LoRA, (e) NF4 weights: ``ask --quantize nf4`` on 24b's merged
    ``best_model/`` (the seed-42 random base) and a paged int8 engine over
    phase 4's weights in NF4."""
    import math
    import os
    import shutil
    import tempfile

    from llm_fine_tune_distributed_tpu_torch.data.packing import packing_efficiency
    from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
    from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
    from llm_fine_tune_distributed_tpu_torch.parallel import lora as lora_mod
    from llm_fine_tune_distributed_tpu_torch.parallel.qlora import quantized_fraction

    t_phase = time.monotonic()
    out = {"card": card_info()}
    phase(24, f"the fine-tuning recipes on {out['card']}")
    root = tempfile.mkdtemp(prefix="chip_smoke_recipes_")
    try:
        # (a) packing: phase 8's recipe over 480 rows, packed
        rec, trainer = recipe_run(fa, mm, os.path.join(root, "a"), "24a packing",
                                  RECIPE_PACKED_ROWS, packing=True)
        rec["occupancy"] = packing_efficiency(trainer.train_arrays)
        rec["packed_rows"] = trainer.n_train
        rec["tiles"] = real_batch_tiles(fa, trainer, phase_no=24)
        rec["f32_microbatch"] = f32_microbatch_phase(trainer, fa, mm, phase_no=24)
        phase(24, f"24a: {100 * rec['occupancy']:.1f}% token occupancy ({rec['packed_rows']} packed "
                  f"rows; phase 8's rows {100 * trained['real_tokens_per_s_per_card'] / max(trained['padded_tokens_per_s_per_card'], 1e-9):.1f}% real); "
                  f"step {rec['step_ms_median_steps_2_3']:.1f} vs phase 8's "
                  f"{trained['step_ms_median_steps_2_3']:.1f} ms, {rec['samples_per_s_per_card']:.2f} vs "
                  f"{trained['samples_per_s_per_card']:.2f} samples/s/card, "
                  f"{rec['real_tokens_per_s_per_card']:.0f} vs {trained['real_tokens_per_s_per_card']:.0f} "
                  f"real tokens/s/card ({rec['real_tokens_per_s_per_card'] / trained['real_tokens_per_s_per_card']:.2f}x)")
        out["a_packing"] = rec
        del trainer
        gc_cuda()

        # (b) LoRA r 16, alpha 8, the 7 projections
        rec, trainer = recipe_run(fa, mm, os.path.join(root, "b"), "24b LoRA", TRAIN_ROWS,
                                  freeze_strategy="lora")
        check(rec["trainable_params"] == LORA_TRAINABLE,
              f"24b: {rec['trainable_params']} trainable parameters, not {LORA_TRAINABLE}")
        first, base_first = rec["losses"][0], trained["losses"][0]
        rel = abs(first - base_first) / abs(base_first)
        check(rel <= LORA_FIRST_LOSS_REL, f"24b: first loss {first} vs the base model's (phase 8) "
                                          f"{base_first}: rel {rel:.2e}")
        best_b = os.path.join(root, "b", "out", "best_model")
        check(os.path.exists(os.path.join(root, "b", "out", "adapter", "adapter_model.safetensors")),
              "24b: adapter/ missing")
        rec["first_loss_rel_to_base"] = rel
        rec["merged"] = merged_export_check(tf, lora_mod, trainer, best_b)
        rec["profile"] = train_profile_phase(trainer, mm, phase_no=24)
        block_bf16 = sum(v.numel() * 2 for k, v in trainer.state.frozen.items()
                         if ".layers." in k and k.endswith(".kernel"))
        phase(24, f"24b: first loss {first:.4f} vs the base model's {base_first:.4f} (phase 8, the "
                  f"same batch, B = 0): rel {rel:.2e}; step {rec['step_ms_median_steps_2_3']:.1f} vs "
                  f"phase 8's {trained['step_ms_median_steps_2_3']:.1f} ms, peak "
                  f"{rec['train_peak_bytes'] / 1e9:.2f} vs {trained['train_peak_bytes'] / 1e9:.2f} GB")
        out["b_lora"] = rec
        del trainer
        gc_cuda()
        out["e_ask"] = nf4_ask_phase(cli_mod, best_b, int8_bytes)
        shutil.rmtree(os.path.join(root, "b"), ignore_errors=True)

        # (c) QLoRA: NF4 base, block 64, double quant
        rec, trainer = recipe_run(fa, mm, os.path.join(root, "c"), "24c QLoRA", TRAIN_ROWS,
                                  freeze_strategy="qlora")
        nf4_bytes = sum(v.numel() * v.element_size() for k, v in trainer.state.frozen.items()
                        if "kernel_nf4" in k or "kernel_absmax" in k)
        rec["nf4_share_of_frozen_bytes"] = quantized_fraction(trainer.state.frozen)
        rec["block_linears_bf16_bytes"], rec["block_linears_nf4_bytes"] = block_bf16, nf4_bytes
        saved = out["b_lora"]["train_peak_bytes"] - rec["train_peak_bytes"]
        need = 0.5 * (block_bf16 - nf4_bytes)
        check(saved >= need, f"24c: peak {rec['train_peak_bytes']} only {saved} below 24b's "
                             f"(need {need:.0f}: half the block linears' bf16 less NF4 bytes)")
        first, lora_first = rec["losses"][0], out["b_lora"]["losses"][0]
        rel = abs(first - lora_first) / abs(lora_first)
        check(rel <= QLORA_FIRST_LOSS_REL, f"24c: first loss {first} vs 24b's {lora_first}")
        rec["first_loss_rel_to_lora"] = rel
        rec["profile"] = train_profile_phase(trainer, mm, phase_no=24)
        phase(24, f"24c: NF4 holds {100 * rec['nf4_share_of_frozen_bytes']:.1f}% of the frozen bytes "
                  f"(block linears {block_bf16 / 1e9:.3f} GB in bf16 -> {nf4_bytes / 1e9:.3f} GB), "
                  f"quantized in {rec['quantize_s']:.2f} s on the card; peak "
                  f"{rec['train_peak_bytes'] / 1e9:.2f} vs 24b's "
                  f"{out['b_lora']['train_peak_bytes'] / 1e9:.2f} GB ({saved / 1e9:.2f} GB less, "
                  f">= {need / 1e9:.2f}); first loss {first:.4f} vs 24b's {lora_first:.4f} (rel "
                  f"{rel:.2e}); export dequantize and merge {rec['export_merge_s']:.2f} s")
        out["c_qlora"] = rec
        del trainer
        gc_cuda()
        shutil.rmtree(os.path.join(root, "c"), ignore_errors=True)

        # (d) DPO on LoRA, 4 pairs per microbatch (8 sequences per forward)
        if before_d is not None:
            before_d()
        rec, trainer = recipe_run(fa, mm, os.path.join(root, "d"), "24d DPO", RECIPE_DPO_ROWS,
                                  layers=RECIPE_DPO_LAYERS, objective="dpo",
                                  freeze_strategy="lora", per_device_batch_size=4)
        history = trainer.metrics.history
        check(abs(rec["losses"][0] - math.log(2.0)) <= DPO_FIRST_LOSS_TOL,
              f"24d: first loss {rec['losses'][0]} is not ln 2")
        rewards = {k: [h[k] for h in history] for k in ("rewards_chosen", "rewards_rejected",
                                                        "rewards_margin", "rewards_accuracy")}
        check(all(np.isfinite(v).all() for v in rewards.values()), f"24d: rewards {rewards}")
        acc = trainer.extra_eval_logs.get("eval_rewards_accuracy")
        check(acc is not None and 0.0 <= acc <= 1.0, f"24d: eval_rewards_accuracy {acc}")
        rec.update(rewards=rewards, eval_rewards_accuracy=acc)
        phase(24, f"24d: first loss {rec['losses'][0]:.6f} (ln 2 = {math.log(2.0):.6f}); rewards "
                  + ", ".join(f"{k} {[round(x, 4) for x in v]}" for k, v in rewards.items())
                  + f"; eval_rewards_accuracy {acc:.3f}")
        out["d_dpo"] = rec
        del trainer
        gc_cuda()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # (e) NF4 serving on phase 4's weights
    config = get_preset("smollm3_3b")
    out["e_serve"] = nf4_serve_phase(tf, gen_mod, server_mod, fa,
                                     config.replace(num_layers=NF4_SERVE_LAYERS),
                                     ByteChatMLTokenizer())
    out["seconds"] = time.monotonic() - t_phase
    phase(24, f"phase 24 took {out['seconds']:.1f} s on {out['card']}")
    return out


# ---------------------------------------------------------------------------
# phase 25: data-parallel training across processes
# ---------------------------------------------------------------------------

DP_LAYERS = 4  # 25b's depth, at full width
DP_ROWS = 20  # -> 18 train rows, 2 validation rows: 2 steps of 8 (2 ranks x 2 rows x 2 microbatches)
DP_LOSS_REL_TOL = 1e-5  # 25b: world 2 against world 1, f32
DP_LEAF_REL_TOL = 1e-4  # 25b: each updated leaf, relative to its largest entry
# 25c's int8-trunk case (bf16 compute, trunk = layers 0-1 of the 4) at
# tensor=2 against a world-1 run of the same configuration (PERF.md §6:
# derived on the CPU before the first chip run): each step's loss within
# 2e-4 relative (the CPU's worst gap 3.6e-5, at hidden 256, 5 steps); the
# trunk's output on the first microbatch differing from world 1's in at
# most half of its rows (the CPU: 5.2% at hidden 256: an f32 sum of two
# partial products that crosses a bf16 rounding boundary spreads along its
# row through the next row quantization). The row scale without its max
# all-reduce (a rank's own row absmax) changes every row (100% on the CPU)
# and must fail the second; on the CPU it did not move the losses further
# than the right run's rounding does
TP_INT8_LOSS_REL_TOL = 2e-4
TP_INT8_TRUNK_ROWS_DIFFER = 0.5


def tp_collectives_per_microbatch(layers):
    """The tensor group's all-reduces per microbatch at ``layers`` layers
    (PERF.md §6): forward the embedding, o_proj and down_proj per layer,
    the cross-entropy's max and its sums; backward the attention and MLP
    inputs per layer and the unembed's; under remat each layer's o_proj sum
    replayed (the replay stops once the block's saved tensors are back:
    nothing after down_proj's sum is saved)."""
    return {"forward": 1 + 2 * layers + 2, "backward": 2 * layers + 1, "replays": layers}


DP_CLI_LOSS_REL_TOL = 5e-3  # 25a: the losses after the first against phase 8's
# Bounds (s) of the children this script spawns, from their start, about 3x
# the slowest each took on the card (NVIDIA H100 80GB HBM3 at 700 W:
# 25a's CLI process 28.5-63.4 s, 25b's ranks 50.5-83.0 s with ZeRO-3 alone and
# 118.8 s with 25c after it (--distributed-only), the 21 and 22
# processes 90.4 and 83.8 s; 26's ranks serving within 37.8-45.8 s, the last
# one done 72.4-93.9 s after its start, a SIGTERM's drain and exit in 0.7-2.4
# s, from then): past a bound every child of the job is killed, the tail of
# each one's output printed and the phase fails by name. A rank's wait inside
# a collective is bounded by its job's bound too.
CHILD_BOUND_S = {"25a": 190, "25b": 360, "21": 270, "22": 240,
                 "26 serving": 125, "26 done": 250, "26 stop": 8}
# 25b: a rank's memory_allocated after the trainer's init against world 1's
# less the bytes it does not hold, and its init's peak above its slices and
# one whole leaf (the allocator rounds the slices' blocks: +14.7 MB of a
# 1.676 GB state on the card)
DP_MOMENT_ALLOC_REL_TOL = 0.01


def spawn_child(args, env=None):
    """This script in a child process with ``args``; its stdout and stderr
    lines collected on a thread (so no pipe fills). Returns (proc, lines)."""
    import os

    p = subprocess.Popen([sys.executable, os.path.abspath(__file__), *args], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env)
    lines, span = [], [args[0].lstrip("-"), time.monotonic(), None]
    CHILD_SPANS.append(span)

    def read():
        lines.extend(iter(p.stdout.readline, ""))
        p.wait()
        span[2] = time.monotonic()

    threading.Thread(target=read, daemon=True).start()
    return p, lines


def kill_children(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def child_tails(label, procs, lines, n=40) -> str:
    return "\n".join(f"--- {label} child {i} (exit {p.poll()}), its last lines:\n"
                     + "".join(out[-n:]) for i, (p, out) in enumerate(zip(procs, lines)))


def start_job(label, argvs, envs=None, **extra) -> dict:
    """Children of this script, one per argv of ``argvs`` (with the env of
    ``envs``, one each, or the parent's), started: a job (``label``, the
    start, the processes and their output lines, and ``extra``); every one
    still running at exit is killed."""
    children = [spawn_child(a, env) for a, env in zip(argvs, envs or [None] * len(argvs))]
    job = {"label": label, "t0": time.monotonic(), "procs": [c[0] for c in children],
           "lines": [c[1] for c in children], **extra}
    atexit.register(kill_children, job["procs"])
    return job


def join_job(job, bound_s) -> list:
    """``join_children`` of the job within ``bound_s`` of its start; every
    child of the job killed after, whatever happened."""
    try:
        return join_children(job["label"], job["procs"], job["lines"],
                             bound_s - (time.monotonic() - job["t0"]))
    finally:
        kill_children(job["procs"])


def join_children(label, procs, lines, timeout_s) -> list:
    """Every child's exit code, waited for at most ``timeout_s`` in all; past
    it every child is killed, the tail of each one's output printed, and
    ``check failed: <label>`` raised (a hang fails its phase by name, well
    inside the smoke's limit)."""
    deadline = time.monotonic() + timeout_s
    for i, p in enumerate(procs):
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            kill_children(procs)
            time.sleep(0.5)  # the reader threads take the last lines
            tails = child_tails(label, procs, lines)
            print(tails, flush=True)
            check(False, f"{label}: child {i} still running after {timeout_s:.0f} s; every child "
                         f"of the phase killed\n{tails[-6000:]}")
    return [p.returncode for p in procs]


def _data_rows(data_dir, n):
    import os

    os.makedirs(data_dir, exist_ok=True)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                           "final_qa_data_unique.jsonl")) as f:
        lines = [next(f) for _ in range(n)]
    with open(os.path.join(data_dir, "final_qa_data_unique.jsonl"), "w") as f:
        f.writelines(lines)


def _child_env(env):
    import os

    out = dict(os.environ)
    out.update(env)
    return out


def dp_cli_child(config_path, out_path) -> int:
    """25a's process: the training CLI module run as ``__main__`` under the
    launcher's env, with the gradient all-reduce timed by CUDA events and
    the trainer's step times, peak and backend kept; writes them to
    ``out_path``."""
    import runpy

    import torch.distributed as dist

    from llm_fine_tune_distributed_tpu_torch.ops import flash_attention as fa
    from llm_fine_tune_distributed_tpu_torch.ops import int8_matmul as mm
    from llm_fine_tune_distributed_tpu_torch.train import step as step_mod
    from llm_fine_tune_distributed_tpu_torch.train import trainer as trainer_mod

    events, record = [], {}
    counters = train_counters(fa, mm)
    reduce = step_mod.all_reduce_grads

    def timed(grads, extras, *a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = reduce(grads, extras, *a, **kw)
        end.record()
        events.append((start, end, sum(g.numel() * g.element_size() for g in grads)))
        return out

    step_mod.all_reduce_grads = timed
    train = trainer_mod.SFTTrainer.train

    def recording(self):
        for fn in counters.values():
            fn.launches = 0
        summary = train(self)
        record["launches"] = {name: fn.launches for name, fn in counters.items()}
        meter = self.throughput
        record.update(step_s=meter.step_s, step_real_tokens=meter.step_real_tokens,
                      train_peak=self.metrics.history[-1].get("device_peak_bytes_in_use"),
                      backend=dist.get_backend(), world=dist.get_world_size(),
                      dp_size=self.dp_size, samples_per_step=(
                          self.config.per_device_batch_size
                          * self.config.gradient_accumulation_steps * self.dp_size))
        return summary

    trainer_mod.SFTTrainer.train = recording
    sys.argv = ["llm_fine_tune_distributed_tpu_torch.cli", "--config", config_path]
    try:
        runpy.run_module("llm_fine_tune_distributed_tpu_torch.cli", run_name="__main__")
        rc = 0
    except SystemExit as e:
        rc = e.code or 0
    torch.cuda.synchronize()
    record["allreduce_ms"] = [s.elapsed_time(e) for s, e, _ in events]
    record["allreduce_bytes"] = [b for _, _, b in events]
    record["rc"] = rc
    record["seconds"] = time.monotonic() - _T0  # the process's life
    with open(out_path, "w") as f:
        json.dump(record, f)
    return rc


def dp_cli_start():
    """25a's process, started: phase 8's recipe through ``python -m ...cli``
    under a PyTorchJob's env for one worker (``RANK=0``, ``WORLD_SIZE=1``,
    ``MASTER_ADDR``/``MASTER_PORT``), so the trainer runs its data-parallel
    path over NCCL."""
    import os
    import tempfile

    from llm_fine_tune_distributed_tpu_torch.runtime.distributed import free_port, rendezvous_env

    workdir = tempfile.mkdtemp(prefix="chip_smoke_dp_cli_")
    _data_rows(os.path.join(workdir, "data"), TRAIN_ROWS)
    cfg, out = os.path.join(workdir, "cfg.json"), os.path.join(workdir, "child.json")
    train_config(workdir, publish=False).save(cfg)
    env = _child_env(rendezvous_env(0, 1, free_port(), local_rank=0))
    return start_job("phase 25a", [["--dp-cli-child", cfg, out]], [env], workdir=workdir, out=out)


def dp_cli_phase(job, trained):
    """25a, joined (at most ``CHILD_BOUND_S["25a"]`` from its start): the first
    loss bit for bit phase 8's, the later ones within 0.5%; step time,
    samples/s/card and peak beside phase 8's, and the gradient all-reduce's
    ms per step by CUDA events."""
    import os
    import shutil

    workdir = job["workdir"]
    try:
        code = join_job(job, CHILD_BOUND_S["25a"])[0]
        stdout = "".join(job["lines"][0])
        check(code == 0, f"phase 25a: the CLI exited {code}:\n{stdout[-6000:]}")
        with open(job["out"]) as f:
            child = json.load(f)
        with open(os.path.join(workdir, "out", "training_history.json")) as f:
            history = json.load(f)
        with open(os.path.join(workdir, "out", "training_summary.json")) as f:
            summary = json.load(f)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    check(child["backend"] == "nccl" and child["world"] == 1 and summary["world_size"] == 1,
          f"25a: backend {child['backend']} world {child['world']}, summary {summary['world_size']}")
    check(stdout.count("completed successfully") == 1, "25a: no completion banner")
    losses = [h["loss"] for h in history]
    check(losses[0] == trained["losses"][0],
          f"25a: first loss {losses[0]!r} is not phase 8's {trained['losses'][0]!r} bit for bit")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[1:], trained["losses"][1:])]
    check(len(losses) == len(trained["losses"]) and max(rel) <= DP_CLI_LOSS_REL_TOL,
          f"25a: losses {losses} vs phase 8's {trained['losses']}")
    check(child["launches"] == trained["launches"],
          f"25a: launches {child['launches']} vs phase 8's {trained['launches']}")
    steady = slice(1, None)
    step_s = child["step_s"][steady]
    step_ms = statistics.median(step_s) * 1e3
    samples_per_s = child["samples_per_step"] * len(step_s) / sum(step_s)
    reduce_ms = child["allreduce_ms"]
    record = {"losses": losses, "loss_rel_to_phase8": rel, "step_ms_median_steps_2_3": step_ms,
              "samples_per_s_per_card": samples_per_s, "train_peak_bytes": child["train_peak"],
              "allreduce_ms": reduce_ms, "allreduce_ms_median_steps_2_3": statistics.median(
                  reduce_ms[steady]), "allreduce_bytes": child["allreduce_bytes"][0],
              "backend": child["backend"], "launches": child["launches"],
              "child_s": child["seconds"], "seconds": time.monotonic() - job["t0"]}
    phase(25, f"25a: python -m ...cli under RANK=0 WORLD_SIZE=1 MASTER_ADDR/PORT, backend "
              f"{child['backend']}: losses {[round(x, 4) for x in losses]} (first bit-equal to phase "
              f"8's, later rel {[f'{r:.2e}' for r in rel]}); launches {child['launches']} = phase 8's")
    phase(25, f"25a: steps 2-3 median step {step_ms:.1f} ms vs phase 8's "
              f"{trained['step_ms_median_steps_2_3']:.1f}, {samples_per_s:.2f} vs "
              f"{trained['samples_per_s_per_card']:.2f} samples/s/card (beside other work), "
              f"peak at the last step {child['train_peak'] / 1e9:.2f} vs "
              f"{trained['train_peak_bytes'] / 1e9:.2f} GB; gradient all-reduce (NCCL, world 1, "
              f"{record['allreduce_bytes'] / 1e9:.3f} GB of f32) "
              f"{[round(x, 3) for x in reduce_ms]} ms per step by CUDA events; the process lived "
              f"{child['seconds']:.1f} s (bound {CHILD_BOUND_S['25a']} s), joined "
              f"{record['seconds']:.1f} s after its start")
    return record


def dp_config(workdir, rank_batch, **kw):
    """25b's ``TrainConfig``: the default mesh, ``data=1, fsdp=-1``, is
    fsdp=2 over the two ranks and 1 in the world-1 run; ``kw`` overrides
    (25c: the mesh, the int8 case's dtype and trunk)."""
    import os

    from llm_fine_tune_distributed_tpu_torch.config import TrainConfig

    return TrainConfig(**{**dict(
        model_name="smollm3-3b-random", model_preset="smollm3_3b", tokenizer_path="byte-chatml",
        data_dir=os.path.join(workdir, "data"), epochs=1, system_prompt=TRAIN_PROMPT,
        logging_steps=1, compute_dtype="float32", per_device_batch_size=rank_batch,
        gradient_accumulation_steps=2, scale_lr_by_data_parallel=False,
        checkpoint_trainable_only=True), **kw})


def tp_int8_config(workdir, out, **kw):
    """25c's int8-trunk case: 25b's configuration in bf16 with
    ``frozen_compute="int8"`` (the last 2 of the 4 layers train: the trunk
    is layers 0-1), 4 rows a microbatch."""
    import os

    return dp_config(workdir, 4, output_dir=os.path.join(workdir, out), compute_dtype="bfloat16",
                     frozen_compute="int8", **kw)


def int8_trunk_hidden(trainer):
    """The int8 trunk's output (its layers, then the final norm, bf16
    ``[b, s, h]``) on the first microbatch of the first step, under the
    trainer's tensor group if it has one."""
    from llm_fine_tune_distributed_tpu_torch.models.transformer import forward

    full = next(iter(trainer.loader.global_epoch(0)))
    batch = trainer._device_batch(trainer.loader.local_rows(full))
    trunk = trainer.frozen_boundary
    with torch.no_grad():
        hidden, _ = forward({**trainer.state.trainable, **trainer.state.frozen},
                            batch["input_ids"][0], trainer.model_config.replace(num_layers=trunk),
                            padding_mask=batch["attention_mask"][0],
                            attention_impl=trainer.config.attention_impl,
                            compute_dtype=torch.bfloat16, output_hidden=True, frozen_layers=trunk,
                            frozen_compute="int8", tensor=trainer.tensor)
    return hidden


def dp_tp_rank(rank, workdir, fa, mm) -> dict:
    """25c in one of 25b's ranks (25b's trainer freed): ``SFTTrainer`` at
    tensor=2 on 25b's model, rows, global batch and peak lr in f32, then the
    int8-trunk case at tensor=2 in bf16; launches, the tensor group's
    collectives, each leaf's bytes against its whole, a desync planted on a
    norm, rank 0's final leaves gathered whole to a file."""
    import os

    from llm_fine_tune_distributed_tpu_torch.config import MeshConfig
    from llm_fine_tune_distributed_tpu_torch.runtime import distributed
    from llm_fine_tune_distributed_tpu_torch.runtime.desync import check_param_sync
    from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer

    tp2 = MeshConfig(data=1, fsdp=1, tensor=2)
    counters = train_counters(fa, mm)
    coll = distributed.tensor_collectives
    out = {}
    for case in ("f32", "int8"):
        t0 = time.monotonic()
        if case == "f32":
            cfg = dp_config(workdir, 4, output_dir=os.path.join(workdir, "tp_out"), mesh=tp2,
                            desync_check_steps=1)
        else:
            cfg = tp_int8_config(workdir, "tp_int8_out", mesh=tp2)
        trainer = SFTTrainer(cfg, model_config=dp_model_config(), device=DEVICE)
        tensor = trainer.tensor
        if case == "int8":
            hidden = int8_trunk_hidden(trainer)
            if rank == 0:
                torch.save(hidden.cpu(), os.path.join(workdir, "rank0_tp_trunk.pt"))
            del hidden
        leaves = {**trainer.state.trainable, **trainer.state.frozen}
        halves = {k: (v.numel() * v.element_size(), trainer._numel(k, v) * v.element_size())
                  for k, v in leaves.items()}
        for fn in counters.values():
            fn.launches = 0
        coll.reset()
        summary = trainer.train()
        rec = {"losses": [h["loss"] for h in trainer.metrics.history],
               "eval_loss": summary["final_eval_loss"],
               "launches": {name: fn.launches for name, fn in counters.items()},
               "collectives": {"forward": coll.forward, "backward": coll.backward},
               "steps": len(trainer.throughput.step_s), "step_s": trainer.throughput.step_s,
               "n_val": trainer.n_val, "summary_world": summary["world_size"],
               "sliced": sorted(tensor.shapes),
               "sliced_half": all(2 * mine == whole for k, (mine, whole) in halves.items()
                                  if tensor.sliced(k)),
               "whole_norms": all(mine == whole for k, (mine, whole) in halves.items()
                                  if k.endswith("norm.weight")) and not any(
                                      tensor.sliced(k) for k in halves if k.endswith("norm.weight")),
               "leaf_bytes": sum(mine for mine, _ in halves.values()),
               "leaf_bytes_whole": sum(whole for _, whole in halves.values())}
        if case == "f32":
            rec["desync_checks"] = trainer.desync.checks
            bad = {k: v.detach().clone() for k, v in trainer.state.trainable.items()}
            norm = sorted(k for k in bad if k.endswith("norm.weight"))[0]
            if rank == 1:
                bad[norm].view(-1)[0] += 1e-3  # a leaf every rank holds whole
            ok, sums = check_param_sync(bad, None, tensor=tensor, mesh=trainer.mesh)
            rec.update(planted_leaf=norm, planted_caught=not ok, planted_sums=sums)
            full = trainer._full_trainable()  # a collective
            if rank == 0:
                torch.save({k: v.detach().cpu() for k, v in full.items()},
                           os.path.join(workdir, "rank0_tp_trainable.pt"))
            del full, bad
        rec["seconds"] = time.monotonic() - t0
        out[case] = rec
        del trainer, leaves
        gc_cuda()
    return out


def dp_model_config():
    from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset

    return get_preset("smollm3_3b").replace(num_layers=DP_LAYERS)


def _moment_bytes(trainer):
    """Tensor bytes of the trainer's AdamW moments (this rank's slices under
    ZeRO-3)."""
    opt = trainer.state.opt_state
    return sum(v.numel() * v.element_size() for m in ("mu", "nu") for v in opt[m].values())


def _leaf_bytes(trainer):
    """Tensor bytes of the leaves the trainer holds (trainable and frozen;
    this rank's slices under ZeRO-3)."""
    leaves = {**trainer.state.trainable, **trainer.state.frozen}
    return sum(v.numel() * v.element_size() for v in leaves.values())


def built_with_memory(make):
    """``make()``'s trainer, and what its construction left on the card by
    ``memory_allocated`` (``resident``: the leaves, the moments and the
    rest), the leaves' share when AdamW's moments were made (``leaves``)
    and the peak up to then (``leaves_peak``), each above the card's
    memory before."""
    from llm_fine_tune_distributed_tpu_torch.parallel import optimizer as opt_mod

    seen, init = {}, opt_mod.AdamW.init

    def recording(self, params):
        torch.cuda.synchronize()
        seen.update(leaves=torch.cuda.memory_allocated() - base,
                    leaves_peak=torch.cuda.max_memory_allocated() - base)
        return init(self, params)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    opt_mod.AdamW.init = recording
    try:
        trainer = make()
    finally:
        opt_mod.AdamW.init = init
    torch.cuda.synchronize()
    return trainer, {"resident": torch.cuda.memory_allocated() - base, **seen}


DP_HEARTBEAT_TIMEOUT_MS = 1000  # 25b's planted silent rank: its detector's timeout
DP_HEARTBEAT_INTERVAL_MS = 100


def dp_heartbeat_plant(trainer, rank, steps):
    """25b's heartbeat check after the run: a detector over the two ranks
    (rank 0's coordinator on port 0), rank 1's heartbeats stopped; rank 0
    must see rank 1 in ``dead_ranks()`` within the timeout (plus two
    intervals), and the trainer's step boundary must stop both ranks at the
    same step."""
    from llm_fine_tune_distributed_tpu_torch.runtime import distributed
    from llm_fine_tune_distributed_tpu_torch.runtime.failure import FailureDetector

    det = FailureDetector.for_group(DEVICE, port=0, interval_ms=DP_HEARTBEAT_INTERVAL_MS,
                                    timeout_ms=DP_HEARTBEAT_TIMEOUT_MS)
    distributed.barrier(DEVICE)
    out = {"port": det.port, "dead_before": det.dead_ranks()}
    t0 = time.monotonic()
    if rank == 1:
        det.stop_worker()
    else:
        while det.dead_ranks() != [1] and time.monotonic() - t0 < 10:
            time.sleep(0.01)
        out.update(dead=det.dead_ranks(), seen_s=time.monotonic() - t0)
    distributed.barrier(DEVICE)
    trainer.detector = det
    try:
        trainer._step_boundary(steps + 1)
        out["stopped"] = None
    except RuntimeError as e:
        out["stopped"] = str(e)
    det.stop()
    return out


def dp_rank_child(rank, port, workdir) -> int:
    """25b's rank: a gloo group of two made here, on the one card, which
    ``initialize_distributed`` (and so the trainer) takes as it is; then
    ``SFTTrainer`` at fsdp=2 (ZeRO-3) with the heartbeat on, its launches,
    leaves, moments, gathers and desync checks, a divergence planted on
    rank 1, a silent rank planted, and the final leaves (rank 0)."""
    import datetime
    import os

    import torch.distributed as dist

    from llm_fine_tune_distributed_tpu_torch.ops import _build
    from llm_fine_tune_distributed_tpu_torch.ops import flash_attention as fa
    from llm_fine_tune_distributed_tpu_torch.ops import int8_matmul as mm
    from llm_fine_tune_distributed_tpu_torch.parallel import optimizer as opt_mod
    from llm_fine_tune_distributed_tpu_torch.runtime import distributed
    from llm_fine_tune_distributed_tpu_torch.runtime.desync import check_param_sync
    from llm_fine_tune_distributed_tpu_torch.train import step as step_mod
    from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=CHILD_BOUND_S["25b"]))
    torch.cuda.set_device(0)
    distributed.initialize_distributed(device=DEVICE)  # the group above, as it is
    _build.build_all(("flash_fwd", "flash_bwd", "w8a8_matmul"))  # built by the parent: loaded
    trainer, memory = built_with_memory(lambda: SFTTrainer(
        dp_config(workdir, 2, output_dir=os.path.join(workdir, "dp_out"), desync_check_steps=1,
                  heartbeat=True, heartbeat_port=0),
        model_config=dp_model_config(), device=DEVICE))
    moment_bytes, leaf_bytes = _moment_bytes(trainer), _leaf_bytes(trainer)
    reduce_s, zero3 = [], {"gather_s": 0.0, "gather_bytes": 0, "gathers": 0,
                           "scatter_s": 0.0, "scatter_bytes": 0, "scatters": 0}
    reduce = step_mod.all_reduce_grads

    def timed(grads, extras, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reduce(grads, extras, *a, **kw)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t0)
        return out

    def zero3_timed(fn, what):
        def run(t, *a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(t, *a)
            torch.cuda.synchronize()
            zero3[f"{what}_s"] += time.perf_counter() - t0
            zero3[f"{what}_bytes"] += t.numel() * t.element_size() * (2 if what == "gather" else 1)
            zero3[f"{what}s"] += 1
            return out
        return run

    step_mod.all_reduce_grads = timed
    opt_mod.all_gather_rows = zero3_timed(opt_mod.all_gather_rows, "gather")
    opt_mod.reduce_scatter_rows = zero3_timed(opt_mod.reduce_scatter_rows, "scatter")
    counters = train_counters(fa, mm)
    for fn in counters.values():
        fn.launches = 0
    summary = trainer.train()
    launches = {name: fn.launches for name, fn in counters.items()}
    heartbeat_ran = trainer.detector is not None
    shards = trainer.shards
    whole = [k for k in trainer.state.trainable if shards is None or k not in shards.dims]
    bad = {k: v.detach().clone() for k, v in trainer.state.trainable.items()}
    if rank == 1:
        bad[sorted(whole)[0]].view(-1)[0] += 1e-3  # a leaf every rank holds whole
    planted_ok, planted_sums = check_param_sync(bad, shards, mesh=trainer.mesh)
    full = trainer._full_trainable()  # a collective
    steps = len(trainer.throughput.step_s)
    record = {"rank": rank, "losses": [h["loss"] for h in trainer.metrics.history],
              "eval_loss": summary["final_eval_loss"], "launches": launches,
              "moment_bytes": moment_bytes, "leaf_bytes": leaf_bytes, "memory": memory,
              "sharded": sorted(shards.dims) if shards else [],
              "largest_sharded_leaf_bytes": max(
                  (shards.numel(k, v) * v.element_size()
                   for k, v in {**trainer.state.trainable, **trainer.state.frozen}.items()
                   if shards and k in shards.dims), default=0),
              "sharded_trainable_bytes": sum(
                  shards.numel(k, v) * 4 for k, v in trainer.state.trainable.items()
                  if shards and k in shards.dims),
              "sharded_leaf_bytes": sum(
                  shards.numel(k, v) * v.element_size()
                  for k, v in {**trainer.state.trainable, **trainer.state.frozen}.items()
                  if shards and k in shards.dims),
              "desync_checks": trainer.desync.checks, "desync_sums": trainer.desync.last_checksums,
              "planted_caught": not planted_ok, "planted_sums": planted_sums,
              "allreduce_s": reduce_s, "zero3": zero3, "step_s": trainer.throughput.step_s,
              "n_val": trainer.n_val, "summary_world": summary["world_size"],
              "heartbeat_ran": heartbeat_ran,
              "heartbeat": dp_heartbeat_plant(trainer, rank, steps)}
    if rank == 0:
        torch.save({k: v.detach().cpu() for k, v in full.items()},
                   os.path.join(workdir, "rank0_trainable.pt"))
    del full, trainer, bad
    gc_cuda()
    record["seconds_25b"] = time.monotonic() - _T0
    record["tp"] = dp_tp_rank(rank, workdir, fa, mm)  # 25c
    record["seconds"] = time.monotonic() - _T0  # the process's life so far
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)
    distributed.barrier(DEVICE)
    dist.destroy_process_group()
    return 0


def dp_gloo_start():
    """25b's two ranks, started (they run beside the phases after 9, which
    leave the card's memory to them)."""
    import os
    import tempfile

    from llm_fine_tune_distributed_tpu_torch.runtime.distributed import free_port

    workdir = tempfile.mkdtemp(prefix="chip_smoke_dp_gloo_")
    _data_rows(os.path.join(workdir, "data"), DP_ROWS)
    port = free_port()
    return start_job("phase 25b", [["--dp-rank-child", str(rank), str(port), workdir]
                                   for rank in range(2)], workdir=workdir)


def dp_gloo_join(job):
    """25b's ranks, joined (at most ``CHILD_BOUND_S["25b"]`` from their start;
    past it both are killed and the phase fails by name): their records
    and rank 0's final leaves, gathered whole."""
    import os

    lines = job["lines"]
    codes = join_job(job, CHILD_BOUND_S["25b"])
    failed = [f"rank {rank} exited {code}:\n" + "".join(lines[rank])[-4000:]
              for rank, code in enumerate(codes) if code]
    check(not failed, "phase 25b: " + "\n".join(failed))
    ranks = []
    for rank in range(2):
        with open(os.path.join(job["workdir"], f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
    job["joined_s"] = time.monotonic() - job["t0"]
    return ranks, {name: torch.load(os.path.join(job["workdir"], f"rank0_{name}trainable.pt"))
                   for name in ("", "tp_")}


def _worst_leaf(leaves, trainer):
    """The largest max|got - want| / max|want| over the trainer's updated
    leaves."""
    worst = 0.0
    for k, v in trainer.state.trainable.items():
        want = v.detach()
        worst = max(worst, float((leaves[k].to(want.device) - want).abs().max()
                                 / want.abs().max()))
    return worst


def dp_tp_phase(workdir, ranks, tp_leaves, solo, solo_summary, fa, mm):
    """25c (docstring): the tensor=2 records of 25b's ranks against 25b's
    world-1 run (``solo``), and the int8-trunk case against a world-1 run of
    its own, made here."""
    import os

    from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer

    mc = dp_model_config()
    layers = mc.num_layers
    per = tp_collectives_per_microbatch(layers)
    solo_losses = [h["loss"] for h in solo.metrics.history]
    worst = _worst_leaf(tp_leaves, solo)
    t0 = time.monotonic()
    solo8 = SFTTrainer(tp_int8_config(workdir, "solo_int8_out"), model_config=mc, device=DEVICE)
    want = int8_trunk_hidden(solo8).float()
    got = torch.load(os.path.join(workdir, "rank0_tp_trunk.pt")).to(DEVICE).float()
    diff = got - want
    trunk = {"rows_differ": float((diff.abs().amax(-1) > 0).float().mean()),
             "elements_differ": float((diff != 0).float().mean()),
             "rms_ratio": float(diff.square().mean().sqrt() / want.square().mean().sqrt())}
    del want, got, diff
    phase(25, f"25c int8: the trunk's output on the first microbatch at tensor=2 differs from world "
              f"1's in {100 * trunk['rows_differ']:.2f}% of its rows (bound "
              f"{100 * TP_INT8_TRUNK_ROWS_DIFFER:.0f}%), {100 * trunk['elements_differ']:.3f}% of its "
              f"elements, rms {trunk['rms_ratio']:.2e} of world 1's")
    check(trunk["rows_differ"] <= TP_INT8_TRUNK_ROWS_DIFFER,
          f"25c int8: the trunk's output at tensor=2 differs from world 1's in "
          f"{100 * trunk['rows_differ']:.1f}% of its rows (bound "
          f"{100 * TP_INT8_TRUNK_ROWS_DIFFER:.0f}%; rms {trunk['rms_ratio']:.2e} of world 1's)")
    counters = train_counters(fa, mm)
    for fn in counters.values():
        fn.launches = 0
    solo8.train()
    solo8_launches = {name: fn.launches for name, fn in counters.items()}
    solo8_losses = [h["loss"] for h in solo8.metrics.history]
    solo8_s = time.monotonic() - t0
    del solo8
    gc_cuda()
    for r in ranks:
        tp, rank = r["tp"]["f32"], r["rank"]
        accum, steps = 2, tp["steps"]
        eval_batches = -(-tp["n_val"] // 4)
        micro = accum * steps
        rel = [abs(a - b) / abs(b) for a, b in zip(tp["losses"], solo_losses)]
        check(len(tp["losses"]) == len(solo_losses) and max(rel) <= DP_LOSS_REL_TOL,
              f"25c rank {rank}: losses {tp['losses']} vs world 1's {solo_losses}")
        check(abs(tp["eval_loss"] - solo_summary["final_eval_loss"])
              <= DP_LOSS_REL_TOL * abs(solo_summary["final_eval_loss"]),
              f"25c rank {rank}: eval {tp['eval_loss']} vs {solo_summary['final_eval_loss']}")
        want = {"flash_fwd": layers * micro * 2 + layers * eval_batches,
                "flash_bwd_dq": layers * micro, "flash_bwd_dkv": layers * micro, "w8a8_matmul": 0}
        check(tp["launches"] == want, f"25c rank {rank}: launches {tp['launches']} != {want}")
        want_c = {"forward": micro * (per["forward"] + per["replays"])
                  + eval_batches * per["forward"], "backward": micro * per["backward"]}
        check(tp["collectives"] == want_c,
              f"25c rank {rank}: tensor-group collectives {tp['collectives']} != {want_c} "
              f"({per} per microbatch, {per['forward']} per eval batch)")
        check(tp["sliced_half"] and tp["whole_norms"] and tp["sliced"],
              f"25c rank {rank}: a sliced leaf is not half its whole's bytes, or a norm is sliced")
        check(tp["desync_checks"] == 1 + steps, f"25c rank {rank}: {tp['desync_checks']} desync "
                                                f"checks")
        check(tp["planted_caught"], f"25c rank {rank}: the desync planted on {tp['planted_leaf']} "
                                    "passed the check")
        check(tp["summary_world"] == 2, "25c: summary world size")
        i8 = r["tp"]["int8"]
        rel8 = [abs(a - b) / abs(b) for a, b in zip(i8["losses"], solo8_losses)]
        check(len(i8["losses"]) == len(solo8_losses) and max(rel8) <= TP_INT8_LOSS_REL_TOL,
              f"25c int8 rank {rank}: losses {i8['losses']} vs world 1's {solo8_losses} "
              f"(relative {rel8}, bound {TP_INT8_LOSS_REL_TOL})")
        eval8 = -(-i8["n_val"] // 4)
        want8 = 2 * 7 * (accum * i8["steps"] + eval8)  # trunk layers x projections x forwards
        check(i8["launches"]["w8a8_matmul"] == want8 == solo8_launches["w8a8_matmul"],
              f"25c int8 rank {rank}: w8a8 launches {i8['launches']['w8a8_matmul']} vs {want8} "
              f"(world 1 {solo8_launches['w8a8_matmul']})")
        check(i8["sliced_half"], f"25c int8 rank {rank}: a sliced leaf is not half its whole's")
    check(worst <= DP_LEAF_REL_TOL, f"25c: updated leaves differ by {worst:.2e} of their max")
    r0 = ranks[0]["tp"]
    rel8 = max(abs(a - b) / abs(b) for a, b in zip(r0["int8"]["losses"], solo8_losses))
    phase(25, f"25c: tensor=2 in 25b's ranks ({layers} layers, f32; local heads hq "
              f"{mc.num_heads // 2} over hkv {mc.num_kv_heads // 2}) vs world 1: losses "
              f"{[round(x, 6) for x in r0['f32']['losses']]} vs {[round(x, 6) for x in solo_losses]}, "
              f"eval {r0['f32']['eval_loss']:.6f}, leaves within {worst:.2e} of their max; per rank "
              f"{r0['f32']['leaf_bytes'] / 1e9:.4f} of {r0['f32']['leaf_bytes_whole'] / 1e9:.4f} GB "
              f"of leaves ({len(r0['f32']['sliced'])} sliced exactly in half, the norms whole); "
              f"collectives {r0['f32']['collectives']} = derived ({per} per microbatch); flash "
              f"launches {r0['f32']['launches']}; the desync planted on {r0['f32']['planted_leaf']} "
              f"caught on both ranks; steps {[round(x, 2) for x in r0['f32']['step_s']]} s")
    phase(25, f"25c int8 trunk (bf16, layers 0-1) at tensor=2 vs world 1: losses "
              f"{r0['int8']['losses']} vs {solo8_losses} (worst relative {rel8:.2e}, bound "
              f"{TP_INT8_LOSS_REL_TOL}); w8a8 launches per rank {r0['int8']['launches']['w8a8_matmul']} "
              f"= 2 x 7 x forwards; the ranks' cases {round(r0['f32']['seconds'], 1)} and "
              f"{round(r0['int8']['seconds'], 1)} s, world 1's int8 run here {solo8_s:.1f} s")
    return {"losses_tp2": r0["f32"]["losses"], "losses_world1": solo_losses,
            "eval_tp2": r0["f32"]["eval_loss"], "leaf_rel_err_max": worst,
            "launches_per_rank": r0["f32"]["launches"],
            "collectives_per_rank": r0["f32"]["collectives"], "collectives_per_microbatch": per,
            "leaf_bytes_per_rank": r0["f32"]["leaf_bytes"],
            "leaf_bytes_whole": r0["f32"]["leaf_bytes_whole"],
            "planted_caught": [r["tp"]["f32"]["planted_caught"] for r in ranks],
            "step_s": [r["tp"]["f32"]["step_s"] for r in ranks],
            "int8": {"losses_tp2": r0["int8"]["losses"], "losses_world1": solo8_losses,
                     "loss_rel_max": rel8, "bound": TP_INT8_LOSS_REL_TOL, "trunk": trunk,
                     "launches_per_rank": r0["int8"]["launches"],
                     "launches_world1": solo8_launches, "world1_s": solo8_s},
            "seconds_in_ranks": [[r["tp"][c]["seconds"] for c in ("f32", "int8")] for r in ranks]}


def dp_gloo_phase(job, ranks, leaves, fa, mm):
    """25b: two ranks on the one card over gloo (data=1, fsdp=2: ZeRO-3) at
    full width and 4 layers in f32, 2 steps (``dp_gloo_start``,
    ``dp_gloo_join``), against one process at world 1 with the same global
    batch and peak lr, run here: losses, leaves, leaf and moment bytes per
    rank, flash launches per rank, the gathers' and reduce-scatters'
    seconds, desync checks, a planted divergence, the heartbeat and a
    planted silent rank."""
    import os
    import shutil

    from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer

    t0, workdir = job["t0"], job["workdir"]
    leaves, tp_leaves = leaves[""], leaves["tp_"]
    try:
        t_solo = time.monotonic()
        solo, solo_memory = built_with_memory(lambda: SFTTrainer(
            dp_config(workdir, 4, output_dir=os.path.join(workdir, "solo_out")),
            model_config=dp_model_config(), device=DEVICE))
        solo_moments, solo_leaves = _moment_bytes(solo), _leaf_bytes(solo)
        counters = train_counters(fa, mm)
        for fn in counters.values():
            fn.launches = 0
        solo_summary = solo.train()
        solo_launches = {name: fn.launches for name, fn in counters.items()}
        solo_s = time.monotonic() - t_solo
        solo_losses = [h["loss"] for h in solo.metrics.history]
        worst = _worst_leaf(leaves, solo)
        del leaves
        tp_record = dp_tp_phase(workdir, ranks, tp_leaves, solo, solo_summary, fa, mm)
        del tp_leaves, solo
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    mc = dp_model_config()
    accum, steps = 2, len(ranks[0]["step_s"])
    eval_batches = -(-ranks[0]["n_val"] // (2 * 2))
    expected = {"flash_fwd": mc.num_layers * accum * steps * 2 + mc.num_layers * eval_batches,
                "flash_bwd_dq": mc.num_layers * accum * steps,
                "flash_bwd_dkv": mc.num_layers * accum * steps, "w8a8_matmul": 0}
    limit_s = (DP_HEARTBEAT_TIMEOUT_MS + 2 * DP_HEARTBEAT_INTERVAL_MS) / 1e3 + 0.5
    for r in ranks:
        rel = [abs(a - b) / abs(b) for a, b in zip(r["losses"], solo_losses)]
        check(len(r["losses"]) == len(solo_losses) == 2 and max(rel) <= DP_LOSS_REL_TOL,
              f"25b rank {r['rank']}: losses {r['losses']} vs world 1's {solo_losses}")
        check(abs(r["eval_loss"] - solo_summary["final_eval_loss"])
              <= DP_LOSS_REL_TOL * abs(solo_summary["final_eval_loss"]),
              f"25b rank {r['rank']}: eval {r['eval_loss']} vs {solo_summary['final_eval_loss']}")
        check(r["launches"] == expected, f"25b rank {r['rank']}: launches {r['launches']} != {expected}")
        want = solo_moments - r["sharded_trainable_bytes"]  # half of each sharded leaf's moments
        check(r["moment_bytes"] == want, f"25b rank {r['rank']}: moments {r['moment_bytes']} "
                                         f"tensor bytes vs world 1's {solo_moments} less half the "
                                         f"sharded leaves' ({want})")
        want = solo_leaves - r["sharded_leaf_bytes"] // 2  # ZeRO-3: half of each sharded leaf
        check(r["leaf_bytes"] == want, f"25b rank {r['rank']}: leaves {r['leaf_bytes']} tensor "
                                       f"bytes vs world 1's {solo_leaves} less half the sharded "
                                       f"leaves' ({want})")
        # what the trainer's construction left on the card: world 1's less
        # the bytes the rank does not hold; up to its moments, never more
        # than its slices and one whole leaf
        mem = r["memory"]
        want = (solo_memory["resident"] - (solo_leaves - r["leaf_bytes"])
                - (solo_moments - r["moment_bytes"]))
        check(abs(mem["resident"] - want) <= DP_MOMENT_ALLOC_REL_TOL * want,
              f"25b rank {r['rank']}: memory_allocated after init {mem['resident']} vs world 1's "
              f"{solo_memory['resident']} less the bytes not held ({want})")
        peak = mem["leaves"] * (1 + DP_MOMENT_ALLOC_REL_TOL) + r["largest_sharded_leaf_bytes"]
        check(mem["leaves_peak"] <= peak,
              f"25b rank {r['rank']}: init peaked at {mem['leaves_peak']} bytes before the "
              f"moments, above its leaves {mem['leaves']} and one whole leaf "
              f"{r['largest_sharded_leaf_bytes']} ({peak:.0f})")
        check(r["desync_checks"] == 1 + steps and len(set(r["desync_sums"])) == 1,
              f"25b rank {r['rank']}: desync checks {r['desync_checks']}, {r['desync_sums']}")
        check(r["planted_caught"], f"25b rank {r['rank']}: the planted divergence passed the check")
        check(r["summary_world"] == 2, "25b: summary world size")
        hb = r["heartbeat"]
        check(r["heartbeat_ran"] and hb["dead_before"] == [], f"25b rank {r['rank']}: heartbeat {hb}")
        check(hb["stopped"] is not None and f"stopped heartbeating at step {steps + 1}" in hb["stopped"],
              f"25b rank {r['rank']}: the silent rank did not stop the run at step {steps + 1}: {hb}")
    hb0 = ranks[0]["heartbeat"]
    check(hb0["dead"] == [1] and hb0["seen_s"] <= limit_s,
          f"25b: rank 0's detector saw {hb0.get('dead')} after {hb0.get('seen_s')} s (limit "
          f"{limit_s} s)")
    check(worst <= DP_LEAF_REL_TOL, f"25b: updated leaves differ by {worst:.2e} of their max")
    z = ranks[0]["zero3"]
    record = {"losses_world2": ranks[0]["losses"], "losses_world1": solo_losses,
              "eval_world2": ranks[0]["eval_loss"], "eval_world1": solo_summary["final_eval_loss"],
              "leaf_rel_err_max": worst, "launches_per_rank": ranks[0]["launches"],
              "launches_world1": solo_launches, "expected_launches_per_rank": expected,
              "moment_bytes_per_rank": ranks[0]["moment_bytes"], "moment_bytes_world1": solo_moments,
              "leaf_bytes_per_rank": ranks[0]["leaf_bytes"], "leaf_bytes_world1": solo_leaves,
              "init_memory_per_rank": [r["memory"] for r in ranks],
              "init_memory_world1": solo_memory,
              "largest_sharded_leaf_bytes": ranks[0]["largest_sharded_leaf_bytes"],
              "sharded_leaves": len(ranks[0]["sharded"]), "zero3_per_rank": [r["zero3"] for r in ranks],
              "heartbeat": [r["heartbeat"] for r in ranks],
              "gloo_allreduce_s": [r["allreduce_s"] for r in ranks],
              "step_s": [r["step_s"] for r in ranks], "rank_seconds": [r["seconds"] for r in ranks],
              "world1_s": solo_s, "seconds": time.monotonic() - t0, "c_tensor_parallel": tp_record}
    phase(25, f"25b: 2 ranks over gloo on one card (fsdp=2 ZeRO-3, {DP_LAYERS} layers, f32) vs "
              f"world 1: losses {[round(x, 6) for x in ranks[0]['losses']]} vs "
              f"{[round(x, 6) for x in solo_losses]}, eval {ranks[0]['eval_loss']:.6f} vs "
              f"{solo_summary['final_eval_loss']:.6f}, leaves within {worst:.2e} of their max")
    m0 = ranks[0]["memory"]
    phase(25, f"25b: per rank {ranks[0]['leaf_bytes'] / 1e9:.4f} GB of leaves and "
              f"{ranks[0]['moment_bytes'] / 1e9:.4f} GB of AdamW moments (tensors) vs world 1's "
              f"{solo_leaves / 1e9:.4f} and {solo_moments / 1e9:.4f} ({len(ranks[0]['sharded'])} "
              f"leaves sharded); memory_allocated after init {m0['resident'] / 1e9:.4f} vs "
              f"{solo_memory['resident'] / 1e9:.4f} GB at world 1; init's peak before the moments "
              f"{m0['leaves_peak'] / 1e9:.4f} GB over its slices' {m0['leaves'] / 1e9:.4f} (one "
              f"whole leaf at most {ranks[0]['largest_sharded_leaf_bytes'] / 1e9:.4f}; world 1 "
              f"{solo_memory['leaves_peak'] / 1e9:.4f}); flash launches per rank "
              f"{ranks[0]['launches']} = derived; {ranks[0]['desync_checks']} desync checks passed "
              f"on each rank, the planted divergence failed on both")
    phase(25, f"25b: ZeRO-3 collectives on rank 0 over gloo through the host: "
              f"{z['gathers']} all-gathers, {z['gather_bytes'] / 1e9:.2f} GB whole, "
              f"{z['gather_s']:.2f} s; {z['scatters']} reduce-scatters, "
              f"{z['scatter_bytes'] / 1e9:.2f} GB, {z['scatter_s']:.2f} s; steps "
              f"{[round(x, 2) for x in ranks[0]['step_s']]} s; the whole leaves' all-reduce "
              f"{[[round(x, 2) for x in r['allreduce_s']] for r in ranks]} s per step")
    phase(25, f"25b: heartbeat on both ranks through the run; planted silent rank 1 seen dead by "
              f"rank 0 after {hb0['seen_s']:.2f} s (timeout {DP_HEARTBEAT_TIMEOUT_MS} ms), both "
              f"ranks stopped at step {steps + 1}; each rank's process lived "
              f"{[round(r['seconds'], 1) for r in ranks]} s (bound {CHILD_BOUND_S['25b']} s), joined "
              f"{job['joined_s']:.1f} s after their start; the world-1 run here {solo_s:.1f} s")
    return record


def distributed_phase(fa, mm, trained, gloo_job, cli_job=None, joined=None):
    """Phase 25: 25b's ranks (started by ``dp_gloo_start``) joined (or
    ``joined`` already: ``dp_gloo_join``'s), their world-1 run here and the
    checks; 25a over NCCL through the CLI (started by ``dp_cli_start``: in a
    full run before 24d, otherwise here, after the ranks: the card holds 25a
    beside the world-1 run, not beside the ranks too) joined and checked."""
    ranks, leaves = joined or dp_gloo_join(gloo_job)
    cli_job = cli_job or dp_cli_start()
    try:
        gloo = dp_gloo_phase(gloo_job, ranks, leaves, fa, mm)
    except BaseException:
        kill_children(cli_job["procs"])
        raise
    return {"a_cli_nccl": dp_cli_phase(cli_job, trained), "b_gloo_two_ranks": gloo}


def distributed_only() -> int:
    """Phase 25 alone: the flash and w8a8 kernels built, phase 8 trained
    (the record 25a compares with), then 25a-25c; a JSON summary is the
    last line."""
    import shutil
    import tempfile

    from llm_fine_tune_distributed_tpu_torch.ops import _build
    from llm_fine_tune_distributed_tpu_torch.ops import flash_attention as fa
    from llm_fine_tune_distributed_tpu_torch.ops import int8_matmul as mm

    t_start = time.monotonic()
    phase(1, card_info())
    _build.build_all(("flash_fwd", "flash_bwd", "w8a8_matmul"))  # 25c's int8 case: w8a8
    workdir = tempfile.mkdtemp(prefix="chip_smoke_dp_train_")
    try:
        trained, trainer = train_phase(fa, mm, workdir)
        del trainer
        gc_cuda()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    dp = distributed_phase(fa, mm, trained, dp_gloo_start())
    total_s = time.monotonic() - t_start
    phase(25, f"total_s {total_s:.1f}")
    keys = ("losses", "step_ms_median_steps_2_3", "samples_per_s_per_card", "train_peak_bytes",
            "launches")
    print(json.dumps({"distributed": dp, "train": {k: trained[k] for k in keys},
                      "total_s": total_s}, default=str), flush=True)
    return 0


def deploy_only() -> int:
    """Phase 23 alone: the flash and paged decode kernels built, phase 8
    trained (its final checkpoint and publish), then 23a-23c; a JSON
    summary is the last line."""
    import shutil
    import tempfile

    from llm_fine_tune_distributed_tpu_torch.infer import generate as gen_mod
    from llm_fine_tune_distributed_tpu_torch.infer import server as server_mod
    from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
    from llm_fine_tune_distributed_tpu_torch.ops import _build
    from llm_fine_tune_distributed_tpu_torch.ops import flash_attention as fa
    from llm_fine_tune_distributed_tpu_torch.ops import int8_matmul as mm

    t_start = time.monotonic()
    card = card_info()
    phase(1, card)
    _build.build_all(("paged_decode", "flash_fwd", "flash_bwd"))
    workdir = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
    try:
        trained, trainer = train_phase(fa, mm, workdir)
        saved = snapshot_state(trainer)
        del trainer
        gc_cuda()
        deploy = deploy_phase(tf, gen_mod, server_mod, fa, workdir, saved, trained, card)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    total_s = time.monotonic() - t_start
    phase(23, f"total_s {total_s:.1f}")
    print(json.dumps({"deploy": deploy, "train_peak_bytes": trained["train_peak_bytes"],
                      "total_s": total_s}, default=str), flush=True)
    return 0


def recipes_only() -> int:
    """Phase 24 alone: the flash and paged decode kernels built, phase 8
    trained (the record 24a-24c compare with), then 24a-24e (24e's ask held
    to the int8 weights' cap, as phase 14 did not run); a JSON summary is
    the last line."""
    import shutil
    import tempfile

    from llm_fine_tune_distributed_tpu_torch import cli as cli_mod
    from llm_fine_tune_distributed_tpu_torch.infer import generate as gen_mod
    from llm_fine_tune_distributed_tpu_torch.infer import server as server_mod
    from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
    from llm_fine_tune_distributed_tpu_torch.ops import _build
    from llm_fine_tune_distributed_tpu_torch.ops import flash_attention as fa
    from llm_fine_tune_distributed_tpu_torch.ops import int8_matmul as mm

    t_start = time.monotonic()
    phase(1, card_info())
    _build.build_all(("paged_decode", "flash_fwd", "flash_bwd"))
    workdir = tempfile.mkdtemp(prefix="chip_smoke_recipes_train_")
    try:
        trained, trainer = train_phase(fa, mm, workdir)
        del trainer
        gc_cuda()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    recipes = recipes_phase(tf, gen_mod, server_mod, cli_mod, fa, mm, trained,
                            INT8_WEIGHT_BYTES_MAX)
    total_s = time.monotonic() - t_start
    phase(24, f"total_s {total_s:.1f}")
    keys = ("losses", "step_ms_median_steps_2_3", "samples_per_s_per_card",
            "real_tokens_per_s_per_card", "train_peak_bytes", "launches")
    print(json.dumps({"recipes": recipes, "train": {k: trained[k] for k in keys},
                      "total_s": total_s}, default=str), flush=True)
    return 0


# Phases 21 and 22 run in processes of their own (``--fleet-only``,
# ``--adapters-only``: each makes its own phase 4 weights, serving record and
# solo runs) beside phases 16-20, and are joined before phase 5: the card's
# kernel timings (phases 7 and 10) never share it.


def phase_child_start(flag, phase_no):
    """``python3 chip_smoke.py <flag>`` in a process of its own, started."""
    return start_job(f"phase {phase_no}", [[flag]], flag=flag, phase_no=phase_no)


def phase_child_join(job, key):
    """The child's record (``key`` of its JSON summary, its last JSON line),
    waited for at most its phase's ``CHILD_BOUND_S`` from its start; its
    phase lines echoed here. A child that fails or hangs fails its phase by
    name."""
    label, phase_no = job["label"], job["phase_no"]
    bound_s = CHILD_BOUND_S[str(phase_no)]
    code = join_job(job, bound_s)[0]
    time.sleep(0.2)  # the reader thread takes the last lines
    lines = list(job["lines"][0])
    check(code == 0, f"{label}: {job['flag']} exited {code}:\n" + "".join(lines)[-6000:])
    for line in lines:
        if line.startswith("[phase "):
            print(f"  | {line.rstrip()}", flush=True)
    summary = next(json.loads(line) for line in reversed(lines) if line.startswith("{"))
    phase(phase_no, f"{job['flag']} in a process of its own beside phases 16-20: exit 0, its own "
                    f"set-up included {summary['total_s']:.1f} s (bound {bound_s} s), joined "
                    f"{time.monotonic() - job['t0']:.1f} s after its start")
    rec = summary[key]
    rec["child_s"] = summary["total_s"]
    return rec


def fleet_only() -> int:
    """Phase 21 alone: the paged decode kernel built, phase 4's generator and
    serving run (what 21b, 21d and 21e compare with), phase 15's solo runs
    of its 4 questions, then 21a-21f; a JSON summary is the last line."""
    from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
    from llm_fine_tune_distributed_tpu_torch.infer import engine as engine_mod
    from llm_fine_tune_distributed_tpu_torch.infer import generate as gen_mod
    from llm_fine_tune_distributed_tpu_torch.infer import server as server_mod
    from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
    from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
    from llm_fine_tune_distributed_tpu_torch.ops import _build
    from llm_fine_tune_distributed_tpu_torch.ops import flash_attention as fa

    t_start = time.monotonic()
    phase(1, card_info())
    _build.build_all(("paged_decode",))
    params = tf.init_params(get_preset("smollm3_3b"), seed=0, device=DEVICE, dtype=torch.bfloat16)
    generator = gen_mod.Generator(params, get_preset("smollm3_3b"), ByteChatMLTokenizer(),
                                  compute_dtype=torch.bfloat16, device=DEVICE)
    served = serve_phase(server_mod, fa, generator)
    solo = {tuple(p): solo_decode(tf, gen_mod, generator, p, MAX_NEW_TOKENS)
            for p, _ in served["results"][1:]}
    fleet = fleet_phase(tf, gen_mod, engine_mod, server_mod, fa, generator, served, solo)
    served.pop("results")
    print(json.dumps({"serve": served, "fleet": fleet, "total_s": time.monotonic() - t_start},
                     default=str), flush=True)
    return 0


def adapters_only() -> int:
    """Phase 22 alone: the paged decode kernel built, phase 4's generator,
    phase 15's solo runs of its 4 questions, then 22a-22g; a JSON summary
    is the last line."""
    from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
    from llm_fine_tune_distributed_tpu_torch.infer import generate as gen_mod
    from llm_fine_tune_distributed_tpu_torch.infer import server as server_mod
    from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
    from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
    from llm_fine_tune_distributed_tpu_torch.ops import _build
    from llm_fine_tune_distributed_tpu_torch.ops import flash_attention as fa

    t_start = time.monotonic()
    phase(1, card_info())
    _build.build_all(("paged_decode",))
    config = get_preset("smollm3_3b")
    generator = gen_mod.Generator(
        tf.init_params(config, seed=0, device=DEVICE, dtype=torch.bfloat16), config,
        ByteChatMLTokenizer(), compute_dtype=torch.bfloat16, device=DEVICE)
    prompts = [_prompt_ids(generator, {"question": q}) for q in QUESTIONS]
    solo = {tuple(p): solo_decode(tf, gen_mod, generator, p, MAX_NEW_TOKENS) for p in prompts}
    adapters = adapter_phase(tf, gen_mod, server_mod, fa, generator, solo)
    print(json.dumps({"adapters": adapters, "total_s": time.monotonic() - t_start},
                     default=str), flush=True)
    return 0


def capture_check(captures: int, push=None) -> int:
    """20e's capture ``captures`` times on phase 20's paged int8 server
    (phase 4's weights, the trace log, a 0.2 s ring, phase 4's traffic
    first), each over a 128-token request, with ``push`` tiny kernels
    before each stop (``ProfilerCapture.PUSH_LAUNCHES``; None: its default,
    0: none). One JSON line per capture (its paged decode kernels and
    whether they are whole ticks), then the count of captures that cut a
    tick."""
    import os
    import tempfile

    from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
    from llm_fine_tune_distributed_tpu_torch.infer import generate as gen_mod
    from llm_fine_tune_distributed_tpu_torch.infer import server as server_mod
    from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
    from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
    from llm_fine_tune_distributed_tpu_torch.observe.profiler import ProfilerCapture
    from llm_fine_tune_distributed_tpu_torch.ops import _build

    phase(1, card_info())
    _build.build_all(("paged_decode",))
    config = get_preset("smollm3_3b")
    generator = gen_mod.Generator(
        tf.init_params(config, seed=0, device=DEVICE, dtype=torch.bfloat16), config,
        ByteChatMLTokenizer(), compute_dtype=torch.bfloat16, device=DEVICE)
    if push is not None:
        ProfilerCapture.PUSH_LAUNCHES = push
    push = ProfilerCapture.PUSH_LAUNCHES
    cut = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_capture_") as tmp:
        kw = dict(_observe_kw("paged"), trace_log=os.path.join(tmp, "traces.jsonl"),
                  profile_dir=os.path.join(tmp, "profiles"))
        with _Serving(server_mod, generator, **kw) as srv:
            base, eng = srv.base, srv.engine
            _concurrent(base)
            for i in range(captures):
                join = _post_async(base, "/v1/generate", {
                    "question": QUESTIONS[0], "greedy": True, "max_new_tokens": PROFILED_TOKENS})
                start = eng.stats.values(("decode_steps",))["decode_steps"]
                _wait_for(lambda: eng.stats.values(("decode_steps",))["decode_steps"] > start,
                          "the request's first decode tick")
                status, _, raw = _request(base, "/v1/profile", {"duration_s": PROFILE_S})
                check(status == 200, f"POST /v1/profile: HTTP {status} {raw!r}")
                trace_dir = json.loads(raw)["trace_dir"]
                _wait_for(lambda: any(e["kind"] == "profile_stop" and e["dir"] == trace_dir
                                      for e in eng.recorder.events()), "the capture's stop")
                check(join()[0] == 200, "the profiled request failed")
                path = os.path.join(trace_dir, "trace.json")
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
                os.remove(path)
                paged = sum(1 for e in events if e.get("cat") == "kernel"
                            and "paged_decode_kernel" in e.get("name", ""))
                whole = paged > 0 and paged % config.num_layers == 0
                cut += not whole
                print(json.dumps({"capture": i, "push": push, "paged_decode_kernels": paged,
                                  "whole_ticks": whole}), flush=True)
    print(json.dumps({"push": push, "captures": captures, "cut": cut}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# phase 26: tensor-parallel serving
# ---------------------------------------------------------------------------

TP_F32_LAYERS = 4  # 26b's f32 logit check, at full width
# 26b's f32 logits against one process's, relative to max|logit|: the
# summation order of the row-parallel all-reduces (~1e-6), and an int8 K/V
# code that a rank's f32 rounding may put one step from world 1's
TP_F32_LOGIT_REL_TOL = 1e-3
TP_WEIGHT_ALLOC_REL_TOL = 0.02  # 26a's memory_allocated growth against its weights' bytes
TP_LOCAL_HEADS = {2: (8, 2), 4: (4, 1)}  # SmolLM3-3B's (query, kv) heads per rank


def _tp_files(workdir, mode, rank):
    import os

    return os.path.join(workdir, f"tp_{mode}_rank{rank}.json")


def tp_f32_logits(tf, params, config, cache_config, mesh, prompt):
    """Logits of a prompt's prefill through a fresh int8 block pool and of
    one paged decode step after it (the paged decode kernel), f32."""
    L = KV_BLOCK_LEN
    nblocks = -(-(len(prompt) + 1) // L)
    pool = tf.init_paged_cache(cache_config, 1 + nblocks, L, dtype=torch.float32, kv_quant="int8",
                               device=DEVICE)
    table = torch.arange(1, 1 + nblocks, dtype=torch.int32, device=DEVICE)[None, :]
    ids = torch.tensor([list(prompt)], device=DEVICE)
    kw = dict(block_tables=table, compute_dtype=torch.float32, output_hidden=True, mesh=mesh)
    with torch.no_grad():
        hidden, _ = tf.forward(params, ids, config, cache=pool, cache_pos=0, **kw)
        first = tf.unembed(params, hidden[:, -1], config, compute_dtype=torch.float32, mesh=mesh)
        nxt = first.argmax(dim=-1)[:, None]
        hidden, _ = tf.forward(params, nxt, config, cache=pool, cache_pos=len(prompt), **kw)
        second = tf.unembed(params, hidden[:, -1], config, compute_dtype=torch.float32, mesh=mesh)
    return torch.stack([first[0], second[0]]).cpu()


def tp_f32_rank(tf, fa, workdir, rank):
    """26b's f32 part on one rank: the 4-layer model's slice, then the
    prefill and the paged step through the tensor group (both ranks call
    the same functions in the same order: no bridge)."""
    import os

    from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT
    from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
    from llm_fine_tune_distributed_tpu_torch.infer.generate import make_tp_mesh
    from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
    from llm_fine_tune_distributed_tpu_torch.parallel.sharding import (
        local_model_config,
        shard_params,
    )

    config = get_preset("smollm3_3b").replace(num_layers=TP_F32_LAYERS)
    prompts, _ = live_lengths(ByteChatMLTokenizer, WILDERNESS_EXPERT_SYSTEM_PROMPT)
    mesh = make_tp_mesh(2, config)
    params = shard_params(tf.init_params(config, seed=0, device=DEVICE, dtype=torch.float32),
                          mesh, config)
    fa.paged_decode_attention.launches = 0
    logits = tp_f32_logits(tf, params, config, local_model_config(config, 2), mesh, prompts[0])
    launches = fa.paged_decode_attention.launches
    if rank == 0:
        torch.save(logits, os.path.join(workdir, "tp_f32_logits.pt"))
    del params
    gc_cuda()
    return {"launches": launches}


TP_NF4_TOKENS = 32  # 26b's NF4 case: greedy tokens of one prompt (31 paged decode steps)
# 26b's NF4 case: the tp run's logits against one process's at every step
# up to the first token that differs (the same context), relative to the
# largest. Both are bf16 over the same NF4 weights, each ~1.5e-2 of max|logit|
# from the f32 forward over the dequantized weights (4 layers, this prompt,
# on the CPU; 2.8e-2 with the int8 pool on the card); a rank dequantizing its
# slice at origin 0 moves them 0.14 (0.156 on the card, NVIDIA H100 80GB
# HBM3), the port's tp run 1.5e-2.
TP_NF4_LOGIT_REL_TOL = 0.04


def tp_nf4_greedy(tf, params, config, mesh, prompt, n_tokens):
    """Greedy tokens and their logits (f32 copies of the bf16 ones) of a
    prefill through a fresh int8 block pool and ``n_tokens - 1`` paged
    decode steps (the paged decode kernel), in bf16, under ``mesh``'s
    tensor group when it has one."""
    from llm_fine_tune_distributed_tpu_torch.parallel.sharding import local_model_config

    L = KV_BLOCK_LEN
    nblocks = -(-(len(prompt) + n_tokens) // L)
    cache_config = local_model_config(config, mesh.tensor_size) if mesh is not None else config
    pool = tf.init_paged_cache(cache_config, 1 + nblocks, L, dtype=torch.bfloat16,
                               kv_quant="int8", device=DEVICE)
    table = torch.arange(1, 1 + nblocks, dtype=torch.int32, device=DEVICE)[None, :]
    kw = dict(block_tables=table, compute_dtype=torch.bfloat16, output_hidden=True, mesh=mesh)
    ids, tokens, logits = torch.tensor([list(prompt)], device=DEVICE), [], []
    with torch.no_grad():
        for t in range(n_tokens):
            pos = 0 if t == 0 else len(prompt) + t - 1
            hidden, _ = tf.forward(params, ids, config, cache=pool, cache_pos=pos, **kw)
            row = tf.unembed(params, hidden[:, -1], config, compute_dtype=torch.bfloat16,
                             mesh=mesh)[0].float()
            tokens.append(int(row.argmax()))
            logits.append(row.cpu())
            ids = torch.tensor([[tokens[-1]]], device=DEVICE)
    return tokens, torch.stack(logits)


def tp_nf4_rank(tf, fa, gen_mod, workdir, rank):
    """26b's NF4 case on one rank: phase 4's random weights at
    ``NF4_SERVE_LAYERS`` (24e's), quantized whole by the server's
    ``maybe_quantize`` and then sliced by ``Generator(mesh=...)``, as
    ``--quantize nf4 --tp 2`` loads them: each NF4 leaf must equal its slice
    of the whole model's (columns beside q/k/v/gate/up, rows beside o/down,
    the double quantization's scale and offset whole); then greedy tokens
    through the int8 pool at tp 2 and, on rank 0, one process's run of the
    same weights and the no-cache f32 forward over the weights dequantized
    in f32 at that run's context: each step's max|dlogits| between the two
    (``solo_f32_dist``) is measured apart from the tp run, and bounds it in
    the parent's margin rule."""
    import os

    from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT
    from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
    from llm_fine_tune_distributed_tpu_torch.infer.generate import make_tp_mesh
    from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
    from llm_fine_tune_distributed_tpu_torch.ops.int8 import maybe_quantize
    from llm_fine_tune_distributed_tpu_torch.runtime import distributed

    t0 = time.monotonic()
    config = get_preset("smollm3_3b").replace(num_layers=NF4_SERVE_LAYERS)
    params = maybe_quantize(tf.init_params(config, seed=0, device=DEVICE, dtype=torch.bfloat16),
                            "nf4")
    gen = gen_mod.Generator(params, config, ByteChatMLTokenizer(), compute_dtype=torch.bfloat16,
                            device=DEVICE, mesh=make_tp_mesh(2, config))
    nf4 = [k for k in params if ".kernel_nf4" in k or ".kernel_absmax" in k]
    wrong = []
    for k in nf4:
        whole = params[k]
        if k.endswith(("_absmax_scale", "_absmax_offset")):
            want = whole
        else:
            dim = 0 if (".o_proj." in k or ".down_proj." in k) else 1
            n = whole.shape[dim] // 2
            want = whole.narrow(dim, rank * n, n)
        if gen.params[k].shape != want.shape or not torch.equal(gen.params[k], want):
            wrong.append(k)
    prompts, _ = live_lengths(ByteChatMLTokenizer, WILDERNESS_EXPERT_SYSTEM_PROMPT)
    fa.paged_decode_attention.launches = 0
    tokens, logits = tp_nf4_greedy(tf, gen.params, config, gen.mesh, prompts[0], TP_NF4_TOKENS)
    launches = fa.paged_decode_attention.launches
    out = {"leaves": len(nf4), "wrong_leaves": wrong, "launches": launches,
           "decode_steps": TP_NF4_TOKENS - 1,
           "nf4_bytes": sum(gen.params[k].nbytes for k in nf4),
           "nf4_bytes_whole": sum(params[k].nbytes for k in nf4)}
    del gen
    if rank == 0:
        from llm_fine_tune_distributed_tpu_torch.parallel.qlora import dequantize_frozen

        solo_tokens, solo_logits = tp_nf4_greedy(tf, params, config, None, prompts[0],
                                                 TP_NF4_TOKENS)
        torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
        exact = dequantize_frozen(params, torch.float32)
        ids = torch.tensor([list(prompts[0]) + solo_tokens[:-1]], device=DEVICE)
        with torch.no_grad():  # position len(prompt) - 1 + t gives step t's logits
            hidden, _ = tf.forward(exact, ids, config, compute_dtype=torch.float32,
                                   output_hidden=True)
            truth = tf.unembed(exact, hidden[0, len(prompts[0]) - 1:], config,
                               compute_dtype=torch.float32).float().cpu()
        del exact, hidden
        torch.save({"tokens": tokens, "logits": logits, "solo_tokens": solo_tokens,
                    "solo_logits": solo_logits,
                    "solo_f32_dist": (solo_logits - truth).abs().amax(dim=1),
                    "f32_max_abs": truth.abs().amax(dim=1)}, os.path.join(workdir, "tp_nf4.pt"))
    del params
    distributed.barrier(DEVICE)
    gc_cuda()
    out["seconds"] = time.monotonic() - t0
    return out


def tp_child(mode, rank, world, port, workdir, model_dir) -> int:
    """26a (``mode`` "a", world 1 under the launcher's env, NCCL) or one of
    26b's two ranks (``mode`` "b", a gloo group made here first): the
    server's ``main`` with ``--tp world`` at phase 4's geometry, its
    collectives timed by CUDA events and its tokens, launches, weights and
    pool recorded; in 26b, rank 1 fails at its first decode step after the
    parent creates ``workdir/fault``."""
    import datetime
    import os

    import torch.distributed as dist

    from llm_fine_tune_distributed_tpu_torch.infer import generate as gen_mod
    from llm_fine_tune_distributed_tpu_torch.infer import server as server_mod
    from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
    from llm_fine_tune_distributed_tpu_torch.ops import _build
    from llm_fine_tune_distributed_tpu_torch.ops import flash_attention as fa

    _build.build_all(("paged_decode",))  # built by the parent: loaded
    record = {"mode": mode, "rank": rank, "world": world}
    if mode == "b":
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                                rank=rank,
                                timeout=datetime.timedelta(seconds=CHILD_BOUND_S["26 done"]))
        torch.cuda.set_device(0)
        record["f32"] = tp_f32_rank(tf, fa, workdir, rank)
        record["nf4"] = tp_nf4_rank(tf, fa, gen_mod, workdir, rank)

    # the decode step's collectives ([slots, 1, hidden] all-reduces, the
    # [slots, vocab slice] gather), each between two CUDA events
    events = []

    def timed(fn):
        def run(t, group, *rest):
            if t.shape[0] != SLOTS or (t.dim() == 3 and t.shape[1] != 1):
                return fn(t, group, *rest)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(t, group, *rest)
            end.record()
            events.append((start, end))
            return out
        return run

    tf.tp_all_reduce_ = timed(tf.tp_all_reduce_)
    tf.tp_all_gather_last = timed(tf.tp_all_gather_last)
    log, pools, built, results = [], [], {}, []
    step, final = gen_mod.Generator.paged_step, gen_mod.Generator.paged_prefill_final
    init_paged = gen_mod.Generator.init_paged_state
    fault = os.path.join(workdir, "fault")

    def finish():
        torch.cuda.synchronize()
        record.update(launches=fa.paged_decode_attention.launches, log=log,
                      decode_steps_here=sum(1 for e in log if e[0] == "step"),
                      decode_collectives=len(events),
                      collective_ms=sum(a.elapsed_time(b) for a, b in events),
                      pool_bytes=pools[-1] if pools else None, results=results)
        eng = built.get("engine")
        if eng is not None:
            record["stats"] = eng.stats_snapshot()
            record["memory_breakdown"] = eng.memory_breakdown()
        with open(_tp_files(workdir, mode, rank), "w") as f:
            json.dump(record, f, default=str)

    def logged_step(self, pool, state, live, tables):
        if rank == 1 and os.path.exists(fault):
            finish()
            raise RuntimeError("planted follower fault")
        toks = step(self, pool, state, live, tables)
        log.append(("step", live.tolist(), toks.tolist()))
        return toks

    def logged_final(self, *args, **kw):
        tok = final(self, *args, **kw)
        log.append(("first", int(args[7]), int(args[5]), int(tok)))  # slot, prompt_len
        return tok

    def recorded_pool(self, *args, **kw):
        pool, state = init_paged(self, *args, **kw)
        pools.append(sum(t.nbytes for e in pool["layers"].values() for t in e.values()))
        return pool, state

    def weights(generator):
        torch.cuda.synchronize()
        record["weights_allocated"] = torch.cuda.memory_allocated() - base
        record["weight_tensor_bytes"] = sum(t.nbytes for t in generator.params.values())

    build, follow = server_mod.build_server, server_mod.follow_slots

    def recording_build(generator, **kw):
        weights(generator)
        httpd, eng = build(generator, **kw)
        submit_full = eng.submit_full

        def recording_submit_full(prompt_ids, gen, seed=0, timeout=None, **skw):
            req = submit_full(prompt_ids, gen, seed=seed, timeout=timeout, **skw)
            results.append((list(prompt_ids), list(req.result)))
            return req

        eng.submit_full = recording_submit_full
        built["engine"] = eng
        return httpd, eng

    def recording_follow(generator, *a, **kw):
        weights(generator)
        return follow(generator, *a, **kw)

    gen_mod.Generator.paged_step = logged_step
    gen_mod.Generator.paged_prefill_final = logged_final
    gen_mod.Generator.init_paged_state = recorded_pool
    server_mod.build_server, server_mod.follow_slots = recording_build, recording_follow
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    fa.paged_decode_attention.launches = 0
    rc = server_mod.main(["--model-dir", model_dir, "--device", "cuda", "--tp", str(world),
                          "--engine", "paged", "--quantize-kv", "int8", "--slots", str(SLOTS),
                          "--kv-buf-len", str(KV_BUF_LEN), "--kv-block-len", str(KV_BLOCK_LEN),
                          "--prefill-chunk", str(PREFILL_CHUNK), "--host", "127.0.0.1",
                          "--port", "0", "--flight-dir", ""])
    finish()
    sys.stdout.flush()
    if mode == "b":
        os._exit(rc)  # the group lost rank 1: no teardown
    return rc


def _tp_spawn(mode, world, workdir, model_dir, env):
    """The ranks of one 26 run, started (``start_job``): (their processes,
    their output lines)."""
    from llm_fine_tune_distributed_tpu_torch.runtime.distributed import free_port

    port = free_port()
    job = start_job(f"phase 26{mode}", [["--tp-child", mode, str(rank), str(world), str(port),
                                         workdir, model_dir] for rank in range(world)],
                    [_child_env(env(rank)) for rank in range(world)])
    return job["procs"], job["lines"]


def _tp_listening(label, procs, lines, t_start):
    """(rank 0's base URL once it prints ``listening on``, seconds since the
    ranks' start), within ``CHILD_BOUND_S["26 serving"]`` of it; past that, or when a
    rank exits first, every rank is killed and the phase fails by name."""
    while time.monotonic() - t_start < CHILD_BOUND_S["26 serving"]:
        for line in list(lines[0]):
            m = re.search(r"listening on (http://[0-9.]+:[0-9]+)", line)
            if m:
                return m.group(1), time.monotonic() - t_start
        for r, p in enumerate(procs):
            if p.poll() is not None:
                kill_children(procs)
                check(False, f"{label}: rank {r} exited {p.returncode} before serving:\n"
                             + child_tails(label, procs, lines))
        time.sleep(0.2)
    kill_children(procs)
    tails = child_tails(label, procs, lines)
    print(tails, flush=True)
    check(False, f"{label}: rank 0 not serving {CHILD_BOUND_S['26 serving']} s after the ranks' "
                 "start; "
                 f"every rank killed\n{tails[-6000:]}")


def _tp_stop(label, procs, lines, codes):
    """SIGTERM to rank 0, then every rank's exit (within
    ``CHILD_BOUND_S["26 stop"]``) and exit code checked."""
    import signal

    t0 = time.monotonic()
    procs[0].send_signal(signal.SIGTERM)
    got = join_children(label, procs, lines, CHILD_BOUND_S["26 stop"])
    for rank, (code, want) in enumerate(zip(got, codes)):
        ok = code == want if want == 0 else code != 0
        check(ok, f"{label}: rank {rank} exited {code}:\n" + "".join(lines[rank])[-4000:])
    return time.monotonic() - t0


TP_STAGGER_S = 0.05  # between 26's concurrent requests, in phase 4's admission order


def tp_admission_order(served):
    """The indices into QUESTIONS of phase 4's concurrent requests in the
    order its paged engine admitted them (their prompt lengths differ)."""
    from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT
    from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer

    prompts, _ = live_lengths(ByteChatMLTokenizer, WILDERNESS_EXPERT_SYSTEM_PROMPT)
    index = {len(p): i for i, p in enumerate(prompts)}
    return [index[n] for n in served["prefill_order"][1:]]


def tp_traffic(label, base, order, deadline):
    """Phase 4's traffic over HTTP: one warm-up request, then the 4
    concurrent ones, started in ``order`` ``TP_STAGGER_S`` apart; the
    concurrent window's tokens/s and mean decode tick from ``/v1/stats``
    before and after. The requests are waited for until ``deadline``."""
    warm = _http(base, "/v1/generate", {"question": WARMUP_QUESTION, "greedy": True,
                                        "max_new_tokens": MAX_NEW_TOKENS})
    check(warm[0] == 200, f"26 warm-up: HTTP {warm[0]}")
    before = json.loads(_http(base, "/v1/stats")[1])
    outs = [None] * len(QUESTIONS)

    def post(i):
        outs[i] = _http(base, "/v1/generate", {"question": QUESTIONS[i], "greedy": True,
                                               "max_new_tokens": MAX_NEW_TOKENS})

    threads = [threading.Thread(target=post, args=(i,)) for i in order]
    t0 = time.monotonic()
    for t in threads:
        t.start()
        time.sleep(TP_STAGGER_S)
    for t in threads:
        t.join(max(deadline - time.monotonic(), 0.1))
    check(all(o is not None and o[0] == 200 for o in outs),
          f"{label}: requests {outs} (unanswered ones past {CHILD_BOUND_S['26 done']} s from the "
          "ranks' start)")
    after = json.loads(_http(base, "/v1/stats")[1])
    h0, h1 = before["histograms"]["decode_tick_s"], after["histograms"]["decode_tick_s"]
    ticks = h1["count"] - h0["count"]
    return {"tokens_per_s_concurrent": (after["tokens_served"] - before["tokens_served"])
            / (max(o[3] for o in outs) - t0),
            "decode_step_ms_mean_concurrent": 1e3 * (h1["mean"] * h1["count"]
                                                     - h0["mean"] * h0["count"]) / ticks,
            "decode_step_ms_mean": 1e3 * h1["mean"], "request_s_warmup": warm[2]}


def _healthz(base):
    import urllib.error

    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def tp_start(generator):
    """Phase 26's start, right after phase 4: phase 4's weights written as a
    checkpoint with the port's codec, then 26a's job (the server as a
    one-worker launcher job: NCCL, world 1) and 26b's two ranks (gloo, the
    4-layer f32 check first) started at once, so that their imports and
    loads run while phase 15 does; every one is killed at exit if it is
    still running."""
    import os
    import tempfile

    from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
    from llm_fine_tune_distributed_tpu_torch.models import hf_io
    from llm_fine_tune_distributed_tpu_torch.models.configs import to_hf_dict
    from llm_fine_tune_distributed_tpu_torch.runtime.distributed import free_port, rendezvous_env

    jobs = {"t_start": time.monotonic(), "workdir": tempfile.mkdtemp(prefix="chip_smoke_tp_")}
    model_dir = os.path.join(jobs["workdir"], "model")
    hf_io.save_hf_checkpoint(generator.params, model_dir)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(to_hf_dict(generator.config), f)
    ByteChatMLTokenizer().save_pretrained(model_dir)
    jobs["checkpoint_write_s"] = time.monotonic() - jobs["t_start"]
    port = free_port()
    jobs["a"] = _tp_spawn("a", 1, jobs["workdir"], model_dir,
                          lambda rank: rendezvous_env(0, 1, port, local_rank=0))
    jobs["b"] = _tp_spawn("b", 2, jobs["workdir"], model_dir, lambda rank: {})
    jobs["kill"] = lambda: kill_children(jobs["a"][0] + jobs["b"][0])
    return jobs


def tp_serve(jobs, served):
    """26a and 26b, each one's traffic while the other only waits (the
    parent waits until both serve). 26a's and 26b's four concurrent
    requests start in phase 4's admission order, 50 ms apart (a freed int8
    block keeps its scale, so the order decides the pool's history). In
    26b, after phase 4's traffic a fault is planted in rank 1 and rank 0's
    /healthz must turn 503."""
    import os

    workdir = jobs["workdir"]
    a_procs, a_lines = jobs["a"]
    b_procs, b_lines = jobs["b"]
    order = tp_admission_order(served)
    deadline = jobs["t_start"] + CHILD_BOUND_S["26 done"]
    try:
        a_base, a_ready = _tp_listening("phase 26a", a_procs, a_lines, jobs["t_start"])
        b_base, b_ready = _tp_listening("phase 26b", b_procs, b_lines, jobs["t_start"])
        a_stop = None
        try:
            a_traffic = tp_traffic("phase 26a", a_base, order, deadline)
        finally:
            a_stop = _tp_stop("phase 26a", a_procs, a_lines, [0])
        b_traffic = tp_traffic("phase 26b", b_base, order, deadline)
        with open(os.path.join(workdir, "fault"), "w"):
            pass
        status = None
        try:
            status = _http(b_base, "/v1/generate", {"question": WARMUP_QUESTION, "greedy": True,
                                                    "max_new_tokens": 4})[0]
        except Exception as e:  # the request fails with the follower
            status = getattr(e, "code", type(e).__name__)
        t0 = time.monotonic()
        health = _healthz(b_base)
        while health[0] == 200 and time.monotonic() - t0 < 120:
            time.sleep(0.1)
            health = _healthz(b_base)
        b_traffic.update(fault_request_status=status, healthz_after_fault=list(health),
                         seconds_to_503=time.monotonic() - t0, ready_s=b_ready)
        a_traffic.update(ready_s=a_ready, stop_s=a_stop)
        check(health[0] == 503 and "wedged" in health[1],
              f"26b: /healthz after the planted fault: {health}")
        code = join_children("phase 26b", b_procs[1:], b_lines[1:], CHILD_BOUND_S["26 stop"])[0]
        check(code != 0, "26b: rank 1 survived its planted fault")
    finally:
        kill_children(a_procs)
        b_stop = _tp_stop("phase 26b", b_procs, b_lines, [0, 1])
    b_traffic["stop_s"] = b_stop
    check(any("nccl" in line for line in a_lines[0]), "26a: the tensor group is not NCCL:\n"
          + "".join(a_lines[0])[-2000:])
    with open(_tp_files(workdir, "a", 0)) as f:
        a = json.load(f)
    b = []
    for rank in range(2):
        with open(_tp_files(workdir, "b", rank)) as f:
            b.append(json.load(f))
    return a, a_traffic, b, b_traffic


def tp_kernel_phase(fa, peaks, live):
    """26c: the paged decode kernel against its plain version at the
    ranks' local head shapes, and its time at tp 2's live shape."""
    kernel, plain = fa.paged_decode_attention, fa.paged_decode_attention_reference
    errs = {}
    for tp, (hq, hkv) in TP_LOCAL_HEADS.items():
        for name, (lengths, nb, shared, dead) in paged_cases(live).items():
            for dtype in (torch.float32, torch.bfloat16):
                args, lens = make_case(lengths, nb, dtype, shared_prefix_blocks=shared,
                                       dead_rows=dead, hq=hq, hkv=hkv, seed=3)
                errs[f"tp{tp} {name} {dtype}"] = check_close(
                    f"tp {tp} local heads hq={hq} hkv={hkv} {name}", kernel, plain, args, lens,
                    phase_no=26)
    lengths, nb, shared, dead = paged_cases(live)["live"]
    hq, hkv = TP_LOCAL_HEADS[2]
    args, lens = make_case(lengths, nb, torch.bfloat16, shared_prefix_blocks=shared,
                           dead_rows=dead, hq=hq, hkv=hkv, seed=3)
    ms = time_ms(lambda: kernel(*args, lengths=lens))
    plain_ms = time_ms(lambda: plain(*args, lengths=lens))
    bound_ms, bound_by, nbytes = bound(args, lens, peaks)
    split = fa.paged_decode_split_len(len(lengths), hkv, nb, KV_BLOCK_LEN,
                                      torch.cuda.get_device_properties(0).multi_processor_count)
    phase(26, f"26c: tp 2 local live shape (hq {hq}, hkv {hkv}, nb {nb}): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.2f} MB), "
              f"{100 * bound_ms / ms:.1f}% of the bound, split {split} positions")
    return {"max_abs_err": errs, "tp2_live": {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                              "bound_by": bound_by, "bytes": nbytes,
                                              "split_len": split, "hq": hq, "hkv": hkv}}


def _tp_tokens(rec):
    return {tuple(p): ids for p, ids in rec["results"]}


def tp_phase(tf, gen_mod, fa, generator, served, solo, peaks, live, jobs):
    """Phase 26 (docstring): 26a, 26b (started by ``tp_start``) and 26c
    against phase 4's run and its solo runs, on phase 4's generator."""
    import os
    import shutil

    from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT
    from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
    from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset

    t_start = time.monotonic()
    config = generator.config
    layers = config.num_layers
    out = {"c_kernel": tp_kernel_phase(fa, peaks, live),
           "checkpoint_write_s": jobs["checkpoint_write_s"]}
    try:
        a, a_traffic, b, b_traffic = tp_serve(jobs, served)
        f32 = torch.load(os.path.join(jobs["workdir"], "tp_f32_logits.pt"))
        nf4 = torch.load(os.path.join(jobs["workdir"], "tp_nf4.pt"))
    finally:
        jobs["kill"]()
        shutil.rmtree(jobs["workdir"], ignore_errors=True)

    # 26a: world 1 over NCCL is phase 4, bit for bit, in whatever order its
    # requests were admitted (a block a request is given starts from scale
    # zero, so a request's K/V codes do not depend on the pool's history)
    phase4 = {tuple(p): ids for p, ids in served["results"]}
    got_a = _tp_tokens(a)
    order_a = [e[2] for e in a["log"] if e[0] == "first"]
    floor = 2 * max(int8_kv_noise(tf, generator, list(p)) for p in solo)
    same_order = order_a == served["prefill_order"]
    check(got_a == phase4, f"26a: tokens differ from phase 4's (admission order {order_a} vs "
          f"phase 4's {served['prefill_order']}): "
          + str({k[-3:]: (v, phase4.get(k)) for k, v in got_a.items() if phase4.get(k) != v}))
    steps_a = a["stats"]["decode_steps"]
    per_step = 2 * layers + 2  # two all-reduces a layer, the embedding's, the logits' gather
    check(a["launches"] == layers * steps_a,
          f"26a: {a['launches']} paged decode launches != {layers} x {steps_a} decode steps")
    check(a["decode_collectives"] == per_step * steps_a,
          f"26a: {a['decode_collectives']} decode collectives != {per_step} x {steps_a}")
    rec_a = {"tokens_equal_phase4": got_a == phase4, "admission_order": order_a,
             "admission_order_phase4": served["prefill_order"], "launches": a["launches"],
             "decode_steps": steps_a,
             "collectives_per_step": a["decode_collectives"] / steps_a,
             "collective_ms_per_step": a["collective_ms"] / steps_a,
             "weights_allocated": a["weights_allocated"], "pool_bytes": a["pool_bytes"],
             **a_traffic}
    held = "bit-equal to phase 4's, admitted in " + (
        "phase 4's order" if same_order else
        f"another order ({order_a} vs phase 4's {served['prefill_order']})")
    phase(26, f"26a: python -m ...infer.server --tp 1 (PyTorchJob env, NCCL, world 1): tokens of "
              f"{len(got_a)} requests {held}; paged decode launches {a['launches']} "
              f"== {layers} x {steps_a} decode steps; {per_step} collectives per decode step, "
              f"{rec_a['collective_ms_per_step']:.3f} ms of them per step by CUDA events")
    phase(26, f"26a: {a_traffic['tokens_per_s_concurrent']:.1f} tokens/s, concurrent decode tick "
              f"{a_traffic['decode_step_ms_mean_concurrent']:.2f} ms vs phase 4's "
              f"{served['tokens_per_s_concurrent']:.1f} tokens/s, "
              f"{served['decode_step_ms_mean_concurrent']:.2f} ms (this call); weights "
              f"{a['weights_allocated'] / 1e9:.3f} GB, pool {a['pool_bytes'] / 1e9:.3f} GB")

    # 26b: two ranks over gloo
    r0, r1 = b
    got_b = {"results": [([], [])] + [list(x) for x in r0["results"]
                                      if tuple(x[0]) in solo]}
    check(len(got_b["results"]) == 1 + len(QUESTIONS), f"26b: {len(r0['results'])} results")
    hold_to_solo(tf, generator, "26b tp 2", got_b, solo, floor=floor, phase_no=26)
    check(r1["log"] == r0["log"][: len(r1["log"])] and len(r1["log"]) == len(r0["log"]),
          "26b: rank 1's first tokens and decode steps differ from rank 0's")
    steps_b = r0["stats"]["decode_steps"]
    check(r1["decode_steps_here"] == steps_b, f"26b: rank 1 ran {r1['decode_steps_here']} decode "
                                              f"steps, rank 0 {steps_b}")
    want_w = sum((2 if len(shape) == 1 else 1) * int(np.prod(shape))
                 for shape in tf.param_shapes(config).values())  # bf16: 2 bytes, halved matrices
    # what memory_allocated holds beyond the weights after a load at world 1
    load_extra = a["weights_allocated"] - a["weight_tensor_bytes"]
    check(0 <= load_extra <= TP_WEIGHT_ALLOC_REL_TOL * a["weight_tensor_bytes"],
          f"26a: memory_allocated grew {a['weights_allocated']} for {a['weight_tensor_bytes']} "
          "bytes of weights")
    for r in (r0, r1):
        check(r["launches"] == layers * steps_b,
              f"26b rank {r['rank']}: {r['launches']} launches != {layers} x {steps_b}")
        check(r["pool_bytes"] * 2 == a["pool_bytes"],
              f"26b rank {r['rank']}: pool {r['pool_bytes']} bytes, 26a's {a['pool_bytes']}")
        check(r["weight_tensor_bytes"] == want_w,
              f"26b rank {r['rank']}: {r['weight_tensor_bytes']} weight bytes, want {want_w}")
        check(want_w <= r["weights_allocated"] <= want_w + load_extra,
              f"26b rank {r['rank']}: memory_allocated grew {r['weights_allocated']}, want "
              f"{want_w} + at most 26a's loader overhead {load_extra}")
        check(r["f32"]["launches"] == TP_F32_LAYERS, f"26b f32: {r['f32']} launches")
    check(r0["decode_collectives"] == per_step * steps_b,
          f"26b: {r0['decode_collectives']} decode collectives != {per_step} x {steps_b}")
    # the f32 logits of the same prefill and paged step at world 1, here
    f32_config = get_preset("smollm3_3b").replace(num_layers=TP_F32_LAYERS)
    params32 = tf.init_params(f32_config, seed=0, device=DEVICE, dtype=torch.float32)
    prompts, _ = live_lengths(ByteChatMLTokenizer, WILDERNESS_EXPERT_SYSTEM_PROMPT)
    want32 = tp_f32_logits(tf, params32, f32_config, f32_config, None, prompts[0])
    del params32
    gc_cuda()
    rel = [((f32[i] - want32[i]).abs().max() / want32[i].abs().max()).item() for i in range(2)]
    check(max(rel) <= TP_F32_LOGIT_REL_TOL, f"26b f32 logits rel {rel} > {TP_F32_LOGIT_REL_TOL}")
    # 26b's NF4 case: each rank's leaves, its launches; its logits against
    # one process's at every step of the same context (TP_NF4_LOGIT_REL_TOL),
    # and its greedy tokens by the margin rule: at the first differing step
    # the solo top-2 margin within twice the solo run's distance from the
    # f32 forward over the dequantized weights (measured apart from the tp
    # run; its bf16 rounding and its int8 pool's error are both in it)
    for r in (r0, r1):
        q = r["nf4"]
        check(q["leaves"] > 0 and not q["wrong_leaves"],
              f"26b rank {r['rank']} NF4: leaves not the whole model's slice: {q['wrong_leaves'][:4]}")
        check(q["launches"] == NF4_SERVE_LAYERS * q["decode_steps"],
              f"26b rank {r['rank']} NF4: {q['launches']} paged decode launches != "
              f"{NF4_SERVE_LAYERS} x {q['decode_steps']}")
    check(len(nf4["tokens"]) == len(nf4["solo_tokens"]) == TP_NF4_TOKENS, "26b NF4: token count")
    nf4_agree, nf4_at = len(nf4["tokens"]), None
    for t, (a_tok, b_tok) in enumerate(zip(nf4["tokens"], nf4["solo_tokens"])):
        if a_tok != b_tok:
            nf4_agree = t
            break
    same_ctx = min(nf4_agree + 1, TP_NF4_TOKENS)  # steps whose logits share one context
    nf4_rel = ((nf4["logits"][:same_ctx] - nf4["solo_logits"][:same_ctx]).abs().amax(dim=1)
               / nf4["solo_logits"][:same_ctx].abs().amax(dim=1))
    solo_rel = nf4["solo_f32_dist"] / nf4["f32_max_abs"]
    check(float(nf4_rel.max()) <= TP_NF4_LOGIT_REL_TOL,
          f"26b NF4: the tp run's logits {float(nf4_rel.max()):.3e} of max|logit| off one "
          f"process's at step {int(nf4_rel.argmax())} (steps 0-{same_ctx - 1} share the context), "
          f"> {TP_NF4_LOGIT_REL_TOL}; one process is {float(solo_rel.max()):.3e} off the f32 "
          "forward over the dequantized weights")
    if nf4_agree < TP_NF4_TOKENS:
        t = nf4_agree
        top2 = nf4["solo_logits"][t].topk(2).values
        margin = float(top2[0] - top2[1])
        bound = 2 * float(nf4["solo_f32_dist"][t])
        nf4_at = {"token": t, "margin": margin, "bound": bound,
                  "solo_f32_dist": float(nf4["solo_f32_dist"][t])}
        check(margin <= bound, f"26b NF4: token {t} is {nf4['tokens'][t]}, one process's "
                               f"{nf4['solo_tokens'][t]}, at a top-2 margin {margin:.3e} > "
                               f"{bound:.3e} (twice one process's distance from the f32 "
                               f"forward over the dequantized weights, "
                               f"{nf4_at['solo_f32_dist']:.3e})")
    rec_nf4 = {"layers": NF4_SERVE_LAYERS, "leaves_per_rank": r0["nf4"]["leaves"],
               "nf4_bytes_per_rank": r0["nf4"]["nf4_bytes"],
               "nf4_bytes_whole": r0["nf4"]["nf4_bytes_whole"],
               "launches_per_rank": [r0["nf4"]["launches"], r1["nf4"]["launches"]],
               "decode_steps": r0["nf4"]["decode_steps"], "tokens_agreeing_with_solo": nf4_agree,
               "first_difference": nf4_at, "logit_rel_max": float(nf4_rel.max()),
               "logit_rel_tol": TP_NF4_LOGIT_REL_TOL,
               "solo_f32_rel_max": float(solo_rel.max()), "seconds_per_rank": [r0["nf4"]["seconds"],
                                                                r1["nf4"]["seconds"]]}
    rec_b = {"decode_steps": steps_b, "launches_per_rank": [r0["launches"], r1["launches"]],
             "weights_allocated_per_rank": [r0["weights_allocated"], r1["weights_allocated"]],
             "weight_tensor_bytes_per_rank": want_w, "pool_bytes_per_rank": r0["pool_bytes"],
             "collective_ms_per_step_rank0": r0["collective_ms"] / steps_b,
             "tokens_agreeing_with_solo": got_b["tokens_agreeing_with_solo"],
             "first_difference": got_b["first_difference"], "int8_floor": floor,
             "f32_logit_rel": rel, "nf4": rec_nf4, **b_traffic}
    phase(26, f"26b: --tp 2 over gloo on one card: tokens vs solo (margin rule + twice the int8 "
              f"error {floor:.3e}) {got_b['tokens_agreeing_with_solo']}; rank 1's first tokens and "
              f"decode steps == rank 0's; launches {rec_b['launches_per_rank']} == {layers} x "
              f"{steps_b} on each rank")
    phase(26, f"26b: weights per rank {want_w / 1e9:.3f} GB of tensors (memory_allocated "
              f"{r0['weights_allocated'] / 1e9:.3f} / {r1['weights_allocated'] / 1e9:.3f} GB) vs "
              f"26a's {a['weights_allocated'] / 1e9:.3f}; pool per rank {r0['pool_bytes'] / 1e9:.3f} "
              f"GB == half of 26a's {a['pool_bytes'] / 1e9:.3f}")
    phase(26, f"26b --quantize nf4 --tp 2 ({NF4_SERVE_LAYERS} layers, quantized whole, then "
              f"sliced): {rec_nf4['leaves_per_rank']} NF4 leaves per rank equal to the whole "
              f"model's slice ({rec_nf4['nf4_bytes_per_rank'] / 1e6:.1f} of "
              f"{rec_nf4['nf4_bytes_whole'] / 1e6:.1f} MB); logits over steps 0-{same_ctx - 1} "
              f"{rec_nf4['logit_rel_max']:.3e} of max|logit| off one process's (<= "
              f"{TP_NF4_LOGIT_REL_TOL}; one process {rec_nf4['solo_f32_rel_max']:.3e} off the f32 "
              f"forward); greedy tokens equal to one process's {nf4_agree} of {TP_NF4_TOKENS}"
              + (f" (token {nf4_at['token']} at a top-2 margin {nf4_at['margin']:.3e} <= "
                 f"{nf4_at['bound']:.3e})" if nf4_at else "")
              + f"; paged decode launches {rec_nf4['launches_per_rank']} == {NF4_SERVE_LAYERS} x "
              f"{rec_nf4['decode_steps']} on each rank; {r0['nf4']['seconds']:.1f} s in the ranks")
    phase(26, f"26b: f32 {TP_F32_LAYERS}-layer prefill + paged step vs world 1: max|dlogits| / "
              f"max|logit| {rel[0]:.2e}, {rel[1]:.2e} (<= {TP_F32_LOGIT_REL_TOL})")
    phase(26, f"26b: gloo through the host (a correctness phase's cost): tick "
              f"{b_traffic['decode_step_ms_mean_concurrent']:.1f} ms, "
              f"{b_traffic['tokens_per_s_concurrent']:.2f} tokens/s, collectives "
              f"{rec_b['collective_ms_per_step_rank0']:.1f} ms per step on rank 0; planted fault: "
              f"rank 1 exited non-zero, /healthz {b_traffic['healthz_after_fault'][0]} "
              f"{b_traffic['seconds_to_503']:.2f} s later")
    out.update(a_world1_nccl=rec_a, b_gloo_two_ranks=rec_b,
               seconds=time.monotonic() - t_start,
               seconds_since_start=time.monotonic() - jobs["t_start"])
    phase(26, f"{out['seconds']:.1f} s after phase 15 ({out['seconds_since_start']:.1f} s since "
              f"the jobs' start after phase 4; checkpoint written in "
              f"{out['checkpoint_write_s']:.1f} s); ranks serving by {a_traffic['ready_s']:.1f} / "
              f"{b_traffic['ready_s']:.1f} s (bound {CHILD_BOUND_S['26 serving']} s), stopped in "
              f"{a_traffic['stop_s']:.1f} / {b_traffic['stop_s']:.1f} s (bound "
              f"{CHILD_BOUND_S['26 stop']} s)")
    return out


TP_COST_CALLS = 500  # --tp-collective-cost: calls timed per collective
# --tp-collective-cost's variants of the launcher's env: the NCCL flight
# recorder's per-collective trace buffer at PyTorch's default size, and the
# port's default (runtime/distributed.initialize_distributed: off)
TP_COST_ENVS = {"flight_recorder_2000": {"TORCH_NCCL_TRACE_BUFFER_SIZE": "2000",
                                         "TORCH_FR_BUFFER_SIZE": "2000"},
                "port_default": {}}


def tp_cost_child() -> int:
    """One world-1 NCCL process under the launcher's env: the host wall time
    per call of the decode step's collectives at SmolLM3-3B's shapes (an
    all-reduce of [8, 1, 2048] bf16, the gather of [8, 64128] f32 logits
    at tp 2, here at world 1 the whole [8, 128256]), with and without a
    CUDA event pair around each, as one JSON line."""
    from llm_fine_tune_distributed_tpu_torch.runtime import distributed

    distributed.initialize_distributed(device=DEVICE)
    group = torch.distributed.group.WORLD
    x = torch.randn(SLOTS, 1, 2048, device=DEVICE).to(torch.bfloat16)
    logits = torch.randn(SLOTS, 128256, device=DEVICE)
    out = {}
    for name, call in (("all_reduce", lambda: distributed.tp_all_reduce_(x, group)),
                       ("all_gather_last", lambda: distributed.tp_all_gather_last(logits, group,
                                                                                  1, 0))):
        for evented in (False, True):
            for _ in range(20):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TP_COST_CALLS):
                if evented:
                    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    a.record()
                call()
                if evented:
                    b.record()
            torch.cuda.synchronize()
            out[f"{name}{'_evented' if evented else ''}_us"] = (
                1e6 * (time.perf_counter() - t0) / TP_COST_CALLS)
    t0 = time.perf_counter()
    for _ in range(TP_COST_CALLS):
        x.add_(0)
    torch.cuda.synchronize()
    out["elementwise_launch_us"] = 1e6 * (time.perf_counter() - t0) / TP_COST_CALLS
    print(json.dumps(out), flush=True)
    distributed.destroy()
    return 0


def tp_collective_cost() -> int:
    """The decode step's collectives' host cost per call at world 1 over
    NCCL, in a launcher's env and with the flight recorder's buffer off,
    each in a process of its own; the last line lists both."""
    import os

    from llm_fine_tune_distributed_tpu_torch.runtime.distributed import free_port, rendezvous_env

    phase(1, card_info())
    out = {}
    for name, extra in TP_COST_ENVS.items():
        env = _child_env({**rendezvous_env(0, 1, free_port(), local_rank=0), **extra})
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--tp-cost-child"],
                              capture_output=True, text=True, env=env, timeout=300)
        check(proc.returncode == 0, f"cost child {name}: {proc.stdout[-2000:]}{proc.stderr[-3000:]}")
        out[name] = json.loads(proc.stdout.strip().splitlines()[-1])
        phase(26, f"collective cost, {name}: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                                        out[name].items()))
    print(json.dumps(out), flush=True)
    return 0


def tp_only() -> int:
    """Phase 26 alone: the paged decode kernel built, phase 4's generator and
    serving run (what 26a compares with), phase 15's solo runs of its 4
    questions, then 26a-26c; a JSON summary is the last line."""
    from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT
    from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
    from llm_fine_tune_distributed_tpu_torch.infer import generate as gen_mod
    from llm_fine_tune_distributed_tpu_torch.infer import server as server_mod
    from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
    from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
    from llm_fine_tune_distributed_tpu_torch.ops import _build
    from llm_fine_tune_distributed_tpu_torch.ops import flash_attention as fa

    t_start = time.monotonic()
    card = card_info()
    phase(1, card)
    peaks = _peaks(torch.cuda.get_device_name(0))
    _build.build_all(("paged_decode",))
    _, live = live_lengths(ByteChatMLTokenizer, WILDERNESS_EXPERT_SYSTEM_PROMPT)
    params = tf.init_params(get_preset("smollm3_3b"), seed=0, device=DEVICE, dtype=torch.bfloat16)
    generator = gen_mod.Generator(params, get_preset("smollm3_3b"), ByteChatMLTokenizer(),
                                  compute_dtype=torch.bfloat16, device=DEVICE)
    served = serve_phase(server_mod, fa, generator)
    jobs = tp_start(generator)
    solo = {tuple(p): solo_decode(tf, gen_mod, generator, p, MAX_NEW_TOKENS)
            for p, _ in served["results"][1:]}
    tp = tp_phase(tf, gen_mod, fa, generator, served, solo, peaks, live, jobs)
    served.pop("results")
    print(json.dumps({"card": card, "serve": served, "tp": tp,
                      "total_s": time.monotonic() - t_start}, default=str), flush=True)
    return 0


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible to torch; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if argv[:1] == ["--flash-ab"] and len(argv) > 1:
        return ab_runs(argv[1:], "--flash-ab-one", "timing")
    if argv[:1] == ["--flash-ab-one"] and len(argv) == 2:
        print(json.dumps(flash_ab_times(argv[1])), flush=True)
        return 0
    if argv == ["--fleet-only"]:
        return fleet_only()
    if argv == ["--adapters-only"]:
        return adapters_only()
    if argv == ["--deploy-only"]:
        return deploy_only()
    if argv == ["--recipes-only"]:
        return recipes_only()
    if argv == ["--distributed-only"]:
        return distributed_only()
    if argv == ["--tp-only"]:
        return tp_only()
    if argv == ["--tp-collective-cost"]:
        return tp_collective_cost()
    if argv == ["--tp-cost-child"]:
        return tp_cost_child()
    if argv[:1] == ["--tp-child"] and len(argv) == 7:
        return tp_child(argv[1], int(argv[2]), int(argv[3]), int(argv[4]), argv[5], argv[6])
    if argv[:1] == ["--dp-cli-child"] and len(argv) == 3:
        return dp_cli_child(argv[1], argv[2])
    if argv[:1] == ["--dp-rank-child"] and len(argv) == 4:
        return dp_rank_child(int(argv[1]), int(argv[2]), argv[3])
    if argv[:1] == ["--capture-check"] and len(argv) in (2, 3):
        return capture_check(int(argv[1]), int(argv[2]) if len(argv) == 3 else None)
    if argv[:1] == ["--serve-ab"] and len(argv) > 1:
        return ab_runs(argv[1:], "--serve-ab-one", "serving")
    if argv[:1] == ["--serve-ab-one"] and len(argv) == 2:
        print(json.dumps(serve_ab_times(argv[1])), flush=True)
        return 0
    if argv:
        print(__doc__, file=sys.stderr)
        return 2
    import os
    import shutil
    import tempfile

    from llm_fine_tune_distributed_tpu_torch import cli as cli_mod
    from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
    from llm_fine_tune_distributed_tpu_torch.infer import engine as engine_mod
    from llm_fine_tune_distributed_tpu_torch.infer import generate as gen_mod
    from llm_fine_tune_distributed_tpu_torch.infer import server as server_mod
    from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
    from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
    from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT
    from llm_fine_tune_distributed_tpu_torch.ops import _build
    from llm_fine_tune_distributed_tpu_torch.ops import flash_attention as fa
    from llm_fine_tune_distributed_tpu_torch.ops import int8_matmul as mm

    t_start = time.monotonic()
    card = card_info()
    kind = torch.cuda.get_device_name(0)
    phase(1, f"{card} | torch {torch.__version__} CUDA {torch.version.cuda} | "
             f"python {sys.version.split()[0]}")
    peaks = _peaks(kind)
    cycles, spin_ms = calibrate_spin()
    phase(1, f"timing spin: torch.cuda._sleep({cycles}) = {spin_ms:.3f} ms by CUDA events "
             f"(target {SPIN_MS} ms)")

    t0 = time.monotonic()
    sources = ("paged_decode", "flash_fwd", "flash_bwd", "w8a8_matmul")
    _build.build_all(sources)  # one nvcc per source, all at once
    build_s = time.monotonic() - t0
    phase(2, f"{', '.join(sources)} ready in {build_s:.1f} s")
    ptxas = {}
    for name in sources:  # the report kept beside each library, built now or before
        report = ptxas_report(_build.ptxas_log(name))
        ptxas.update(report)
        built = _build.build_log.get(name)
        phase(2, f"  {name}: " + (f"built in {built['seconds']:.1f} s" if built else "already in build/"))
        for kernel, info in sorted(report.items()):
            phase(2, f"    {kernel}: {info.get('registers')} registers per thread, "
                     f"{info.get('spill_stores')} bytes of spill stores")
    tensor_core = [f"{design[0]}<{d}>" for design in FLASH_DESIGN.values() for d in (64, 128)]
    paged = [f"paged_decode_kernel<{g}> {dt}" for g in range(1, 17) for dt in ("bf16", "f32")]
    for kernel in tensor_core + [f"w8a8_kernel<16> {dt}" for dt in ("bf16", "f32")] + paged:
        check(ptxas.get(kernel, {}).get("spill_stores") == 0,  # none of these may spill
              f"ptxas: {kernel}: {ptxas.get(kernel, 'no report')}")

    config = get_preset("smollm3_3b")
    tokenizer = ByteChatMLTokenizer()
    prompts, live = live_lengths(ByteChatMLTokenizer, WILDERNESS_EXPERT_SYSTEM_PROMPT)
    kernels = kernel_phase(fa, peaks, live)

    t0 = time.monotonic()
    params = tf.init_params(config, seed=0, device=DEVICE, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in params.values())
    phase(4, f"smollm3_3b random bf16 weights: {nparams / 1e9:.3f} B params, "
             f"{sum(t.numel() * t.element_size() for t in params.values()) / 1e9:.2f} GB "
             f"in {time.monotonic() - t0:.1f} s")
    generator = gen_mod.Generator(params, config, tokenizer, compute_dtype=torch.bfloat16,
                                  device=DEVICE)
    served = serve_phase(server_mod, fa, generator)
    phase(4, f"{kind} ({card}): {served['tokens_per_s_concurrent']:.1f} tokens/s over the "
             f"4 concurrent requests' {served['window_s']:.3f} s window, "
             f"{served['decode_tick_tokens_per_s']:.1f} tokens/s over their decode ticks, "
             f"mean decode step {served['decode_step_ms_mean']:.2f} ms, "
             f"TTFT warm-up {served['ttft_s_warmup']:.3f} s, concurrent mean "
             f"{served['ttft_s_concurrent_mean']:.3f} s, "
             f"int8 KV pool {served['kv_pool_bytes'] / 1e9:.3f} GB")

    tp_jobs = tp_start(generator)  # phase 26's jobs load while phase 15 runs
    engines = engines_phase(tf, gen_mod, server_mod, fa, generator)
    phase4_solo = engines["solo"]  # phase 21 holds its fleets' tokens to them too
    tp = tp_phase(tf, gen_mod, fa, generator, served, phase4_solo, peaks, live, tp_jobs)
    # phases 21 and 22 in processes of their own, beside 16-20 (phase 26's
    # children are gone)
    fleet_job = phase_child_start("--fleet-only", 21)
    adapters_job = phase_child_start("--adapters-only", 22)
    speculation = spec_phase(tf, gen_mod, engine_mod, server_mod, fa, generator, engines, served,
                             prompts)
    overload = overload_phase(tf, gen_mod, engine_mod, server_mod, fa, generator)
    supervision = supervision_phase(tf, gen_mod, engine_mod, server_mod, fa, generator)
    observability = observability_phase(server_mod, fa, generator, peaks)
    fleet = phase_child_join(fleet_job, "fleet")
    adapters = phase_child_join(adapters_job, "adapters")
    step = f32_step_phase(tf, fa, params, config, prompts[0])
    profiled = profile_phase(generator, prompts)
    dense = dense_phase(tf, gen_mod, engine_mod, params, config, tokenizer, prompts[0])
    del generator, params  # free the serving phases' tensors before training
    gc_cuda()
    torch.cuda.reset_peak_memory_stats()

    flash = flash_kernel_phase(fa, peaks)
    flash_tp = flash_tp_local_phase(fa, peaks)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:  # phase 14 asks the model phase 8 trains
        trained, trainer = train_phase(fa, mm, workdir)
        saved8 = snapshot_state(trainer)  # phase 23a holds its resume to it
        train_profile = train_profile_phase(trainer, mm)
        microbatch = f32_microbatch_phase(trainer, fa, mm)
        del trainer  # free phase 8's state before asking and before the int8 trunk
        gc_cuda()
        gloo_job = dp_gloo_start()  # 25b's ranks run beside phases 14-23
        best_model = os.path.join(workdir, "out", "best_model")
        recorded = []  # (prompt, token ids) of every generate_ids in the asks
        first = []  # the first ask's Generator, kept for 16d's solo run
        generate_ids = gen_mod.Generator.generate_ids

        def recording(self, prompt_ids, gen=None, seed=0):
            ids = generate_ids(self, prompt_ids, gen, seed)
            recorded.append((list(prompt_ids), list(ids)))
            first[:] = first or [self]
            return ids

        gen_mod.Generator.generate_ids = recording
        try:
            asked = ask_phase(cli_mod, best_model)
            speculation["ask"] = ask_spec_phase(cli_mod, tf, gen_mod, best_model, recorded,
                                                first[0])
            golden = golden_phase(tf, gen_mod, first[0], best_model, config, tokenizer, recorded)
        finally:
            gen_mod.Generator.generate_ids = generate_ids
            first.clear()
        gc_cuda()
        deploy = deploy_phase(tf, gen_mod, server_mod, fa, workdir, saved8, trained, card)
        del saved8
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    served_i8, profiled_i8, profiled_bf16 = int8_weights_serve_phase(
        tf, gen_mod, server_mod, fa, config, tokenizer, prompts)
    for name, rec in (("phase 14 bf16 weights", profiled_bf16), ("phase 6 bf16 weights", profiled)):
        phase(14, f"decode step at {rec['live_rows']} live rows, int8 weights vs {name}: device "
                  f"time {profiled_i8['device_ms_per_step']:.3f} vs {rec['device_ms_per_step']:.3f} "
                  f"ms, step {profiled_i8['step_ms']:.2f} vs {rec['step_ms']:.2f} ms, device busy "
                  f"{100 * (profiled_i8['device_busy_share'] or 0):.1f}% vs "
                  f"{100 * (rec['device_busy_share'] or 0):.1f}%")

    gloo_joined = dp_gloo_join(gloo_job)  # the kernel's timing below has the card alone
    w8a8 = w8a8_kernel_phase(mm, peaks)
    w8a8_tp = w8a8_tp_local_phase(mm, peaks)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_int8_") as workdir:
        trained_i8, trainer = train_phase(fa, mm, workdir, frozen_compute="int8")
    first, first_i8 = trained["losses"][0], trained_i8["losses"][0]
    check(abs(first_i8 - first) <= 0.02 * abs(first),
          f"int8-trunk first loss {first_i8} vs phase 8's {first}: beyond 2% relative")
    phase(11, f"first-step loss {first_i8:.4f} vs phase 8's {first:.4f} "
              f"(rel {abs(first_i8 - first) / abs(first):.2e}); steps 2-3 median step "
              f"{trained_i8['step_ms_median_steps_2_3']:.1f} ms vs {trained['step_ms_median_steps_2_3']:.1f}, "
              f"{trained_i8['samples_per_s_per_card']:.2f} vs {trained['samples_per_s_per_card']:.2f} "
              f"samples/s/card, {trained_i8['real_tokens_per_s_per_card']:.0f} vs "
              f"{trained['real_tokens_per_s_per_card']:.0f} real tokens/s/card, peak memory at the "
              f"last step {trained_i8['train_peak_bytes'] / 1e9:.2f} vs "
              f"{trained['train_peak_bytes'] / 1e9:.2f} GB")
    train_profile_i8 = train_profile_phase(trainer, mm)
    microbatch_i8 = f32_microbatch_phase(trainer, fa, mm)
    del trainer
    gc_cuda()
    # 25a's CLI process trains beside 24d (at 4 layers), 24e and 25b's world-1
    # run (24c's trainer is gone: the card holds them; none has a timing check)
    cli_job = {}
    recipes = recipes_phase(tf, gen_mod, server_mod, cli_mod, fa, mm, trained,
                            asked["int8"]["memory_allocated_bytes"],
                            before_d=lambda: cli_job.update(dp_cli_start()))
    gc_cuda()
    dp = distributed_phase(fa, mm, trained, gloo_job, cli_job, gloo_joined)

    live_rec = kernels["live"]
    paged = kernel_entry("paged_decode_attention",
                         "llm_fine_tune_distributed_tpu_torch/csrc/paged_decode.cu",
                         "llm_fine_tune_distributed_tpu/ops/flash_attention.py:353",
                         served["launches"], {**live_rec, "library_ms": None})
    paged["launches_int8_weights"] = served_i8["launches"]  # phase 14's run
    paged["launches_stream"] = engines["stream"]["paged"]["launches"]  # phase 15's /v1/stream
    # phase 18: launches across a preemption and its resume (18c), and under a queue cap (18a)
    paged["launches_preempt_resume"] = overload["c_paged"]["launches"]
    paged["launches_queue_cap"] = overload["a"]["launches"]
    # phase 19a: launches across a failed tick, the restart and the new pool
    paged["launches_restart"] = supervision["a"]["launches"]
    # phase 20a: launches under traced requests, the SLO ring and the trace log
    paged["launches_observability"] = observability["a"]["launches"]
    # phase 21: a stream migrated between replicas (21c), a restart beside a
    # live sibling (21f), the decode replica of a disaggregated fleet (21d)
    # and a fleet of two serving phase 4's traffic (21e)
    for sub in ("c", "f", "d", "e"):
        paged[f"launches_fleet_21{sub}"] = fleet[sub]["launches"]
    # phase 22b: two tenants, a base request and a sampled neighbour co-batched
    paged["launches_adapters_22b"] = adapters["a"]["launches"]
    # phase 23b: a stream in flight across a hot-swap, the swapped weights, the rollback
    paged["launches_deploy_23b"] = deploy["swap"]["launches"]
    # phase 24e: phase 4's traffic over NF4 weights
    paged["launches_nf4_weights_24e"] = recipes["e_serve"]["launches"]
    # phase 26: the server at --tp 1 over NCCL (26a), each of 26b's two ranks
    # on its 2 kv heads, and the kernel at tp 2's local live shape (26c)
    paged["launches_tp_26a"] = tp["a_world1_nccl"]["launches"]
    paged["launches_tp_26b_per_rank"] = tp["b_gloo_two_ranks"]["launches_per_rank"]
    paged["launches_tp_26b_nf4_per_rank"] = tp["b_gloo_two_ranks"]["nf4"]["launches_per_rank"]
    paged["tp2_local_live"] = tp["c_kernel"]["tp2_live"]
    paged.update({
        "kernel": "paged_decode_kernel",
        "design": PAGED_DESIGN,
        "tolerance": TOLERANCE,
        "ptxas": {k: v for k, v in ptxas.items() if k.startswith("paged_decode_kernel")},
        "shapes": {name: {"lengths": rec["lengths"], "nb": rec["nb"], "split_len": rec["split_len"]}
                   for name, rec in kernels.items()},
        "share_of_bound": live_rec["share_of_bound"],
        **{name: {k: kernels[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                  "share_of_bound", "max_abs_err")}
           for name in ("full", "single")},
    })
    flash_sources = {
        "flash_fwd": ("flash_fwd.cu", "llm_fine_tune_distributed_tpu/ops/flash_attention.py:51"),
        "flash_bwd_dq": ("flash_bwd.cu", "llm_fine_tune_distributed_tpu/ops/flash_attention.py:133"),
        "flash_bwd_dkv": ("flash_bwd.cu", "llm_fine_tune_distributed_tpu/ops/flash_attention.py:167"),
    }
    entries = [paged]
    for name, (src, replaces) in flash_sources.items():
        entry = kernel_entry(name, f"llm_fine_tune_distributed_tpu_torch/csrc/{src}", replaces,
                             trained["launches"][name], flash[name])
        kernel_name, design = FLASH_DESIGN[name]
        entry.update({"kernel": kernel_name, "design": design, "tolerance": FLASH_TOLERANCE,
                      "ptxas": {k: v for k, v in ptxas.items() if k.startswith(kernel_name)},
                      **{k: flash[name][k] for k in flash[name] if k not in entry},
                      "max_abs_err_f32": flash[name]["max_abs_err_f32"],
                      "shapes": {k: FLASH_SHAPE[k] for k in FLASH_SHAPE} | {
                          "dtype": "bf16", "lengths": list(FLASH_LENGTHS)},
                      "library": "scaled_dot_product_attention "
                                 + ("forward" if name == "flash_fwd" else "backward (dq, dk, dv)"),
                      # phase 24: packing, LoRA, QLoRA and DPO training
                      "launches_recipes_24": {k: recipes[k]["launches"][name]
                                              for k in ("a_packing", "b_lora", "c_qlora", "d_dpo")},
                      # phase 25b: each of the two data-parallel ranks
                      "launches_dp_25b_per_rank":
                          dp["b_gloo_two_ranks"]["launches_per_rank"][name],
                      # phase 25c: each of the two tensor-parallel ranks (f32,
                      # local heads), and phase 7 at their bf16 local shape
                      "launches_tp_25c_per_rank":
                          dp["b_gloo_two_ranks"]["c_tensor_parallel"]["launches_per_rank"][name],
                      "tp2_local": flash_tp[name]})
        entries.append(entry)
    w8a8_entry = kernel_entry("w8a8_matmul", "llm_fine_tune_distributed_tpu_torch/csrc/w8a8_matmul.cu",
                              "llm_fine_tune_distributed_tpu/ops/int8_matmul.py:89",
                              trained_i8["launches"]["w8a8_matmul"], w8a8)
    w8a8_entry.update({
        "tolerance": W8A8_TOLERANCE,
        "times_are": f"sums over one trunk layer's 7 projections at M={W8A8_M}, bf16 output",
        "library": "torch._int_mm on the same K-major codes (int8 x int8 -> int32, no scales and "
                   "no cast)",
        "bf16_matmul_ms": w8a8["bf16_matmul_ms"],
        "quantize_rows_ms": w8a8["quantize_rows_ms"],
        "shapes": w8a8["shapes"],
        # phase 25c's int8 case: each tensor=2 rank; phase 10 at its local shapes
        "launches_tp_25c_per_rank":
            dp["b_gloo_two_ranks"]["c_tensor_parallel"]["int8"]["launches_per_rank"]["w8a8_matmul"],
        "tp2_local": w8a8_tp,
    })
    entries.append(w8a8_entry)
    for rec in (served, served_i8):
        rec.pop("results")
    summary = {"card": card, "timing_spin": dict(_SPIN), "ptxas": ptxas, "serve": served,
               "serve_engines": engines, "f32_decode_step": step,
               "decode_profile": profiled, "build_s": build_s, "train": trained,
               "train_profile": train_profile, "f32_microbatch": microbatch,
               "train_int8": trained_i8, "train_profile_int8": train_profile_i8,
               "f32_microbatch_int8": microbatch_i8, "dense_generation": dense, "ask": asked,
               "serve_int8_weights": served_i8, "decode_profile_int8_weights": profiled_i8,
               "decode_profile_bf16_phase14": profiled_bf16, "speculation": speculation,
               "golden": golden, "overload": overload, "supervision": supervision,
               "observability": observability, "fleet": fleet, "adapters": adapters,
               "deploy": deploy, "recipes": recipes, "distributed": dp, "tensor_parallel": tp,
               "total_s": time.monotonic() - t_start}
    phase(12, f"total_s {summary['total_s']:.1f}")
    summary["phase_seconds"] = phase_seconds()
    summary["phases_beside_children"] = phases_beside_children()
    print(json.dumps({"phase_seconds": summary["phase_seconds"],
                      "phases_beside_children": summary["phases_beside_children"]}), flush=True)
    print(json.dumps({"summary": summary}, default=str), flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
