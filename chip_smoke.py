#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

Run from the repository root:  python3 chip_smoke.py
(``python3 chip_smoke.py --cascades`` runs phases 1-3 and the two fabric
round batches' cascade comparisons only, ``--split`` phases 1-2 and 20,
``--sanitize`` phases 1-2 and 21, ``--examples`` phases 1-2 and 22; none
of them prints the result line.)

Phases (any failure exits non-zero and prints no result):

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: the kernel libraries (congestion_cascade.cu: the single-host and
   host-segmented cascades; congestion_scan.cu: the single-switch scan, a
   single pass with decoupled look-back;
   qos_cascade.cu: the single-host and host-segmented QoS cascades; the
   two cascades a thread-block cluster of CTAs per epoch row, and the
   count of atomic and f64-add instructions in their SASS printed;
   ssd_scan.cu: Mamba2's SSD chunked scan, a Gram pre-pass C·Bᵀ per chunk
   and the heads' scan, every product on the tensor cores in 3xTF32;
   flash_attention.cu: the bf16 prefill kernel (TMA-fed K/V ring, wgmma,
   P·V as P_hi·V + P_lo·V), the split-KV decode kernel and its merge, and
   the f32 CUDA-core kernel; expand_events.cu: the default dispatch's
   padded event planes from the compact staging), one nvcc per source, all
   started together, from the repository's sources into
   build/repro_torch_kernels/;
3. kernels vs plain, each on the same CUDA inputs as its plain PyTorch
   version, with median times over CUDA events; for the four cascades also
   the partitioned mirror (ref.serial_queue_cascade_partitioned /
   ref.qos_cascade_partitioned at the kernel's CTAs per row) against the
   plain version bitwise, and the kernel's merge flags against the
   mirror's, exactly (the merges run and skipped, the CTAs per row and the
   share of pads printed with each row):
   - the cascade at [4, 3000] S=3, [32, 131072] with figure1's stages,
     [8, 65536] with chained_topology(8)'s nine stages and the slice-1 main
     path's own batch: slot indices exactly equal, final times to rtol
     1e-6, per-stage delays to rtol 1e-5;
   - the host-segmented cascade at [4, 3000] on figure1 re-declared for 3
     hosts; on pooled_topology(n_hosts=8) at [32, 131072], tie-heavy at
     [32, 131072] (integers from a span of n/4), in one row of 2**20
     events (the most CTAs a row) and in [256, 4096] (one CTA a row); on
     pooled_topology(n_hosts=20), tie-heavy [8, 16384]; and
     the fabric round's own batch: as above, per-host delays to rtol 1e-5,
     their sum over hosts equal to the single-host kernel's delays to rtol
     1e-6, and the same merge flags as the single-host kernel's;
   - the scan at [32, 131072] with a random mask, in one row of 2**20
     events, at [256, 4096], tie-heavy at [32, 131072] with every event
     masked, at [32, 131072] with none masked, at a ragged [8, 131071]
     (rows that start misaligned) and at [3, 1], and on one stage of the
     wide fabric's batch: start and delay bitwise equal (and to rtol
     1e-6), timed on the card (calls back to back) and around one call,
     with GB/s and the share of the bound printed; the wide batch also 50
     times back to back, each result equal to the first;
   - the QoS cascade at [4, 3000] on a 3-switch QoS chain (3 classes,
     weights 4:2:1) with disciplines (wfq, priority, fifo), and at
     [32, 131072] on the same chain with (wfq, wfq, wfq), which elides
     folds, and (priority, priority, priority), each on tie-free rows
     (unique integers below 2**22) and tie-heavy rows (integers from a small
     span); at [32, 131072] on figure1 declared with 3 classes and every
     switch FIFO, whose final times must equal the FIFO cascade kernel's
     bitwise and its per-stage totals to rtol 1e-6; at [8, 16384] on the
     chain with stages (wfq, wfq at zero service, priority, fifo), whose
     fold runs at the unscanned stage; on the qos-main path's batch; and
     the host-segmented QoS cascade on pooled_topology(n_hosts=8) under
     priority with 2 classes (tie-heavy [32, 131072], one row of 2**20,
     [256, 4096]), on 16 hosts (32 slots, tie-heavy [8, 16384]) and on
     the priority fabric's own batch: slot indices
     exactly equal, final times to rtol 1e-6,
     per-(host, class) delays to rtol 1e-5, their sum over hosts equal to the
     single-host QoS kernel's to rtol 1e-6;
   - the expansion (``ops.expand_events``) on columns staged by
     ``EventStager.stage_compact`` and copied to the card, at the
     analyzer's buckets: on a ragged 3-host QoS batch (an empty row, a
     one-event row, rows past the batch) and at the pooled fabric's width
     (33 rows of 442,368 and 430,592 events on 8 hosts in [64, 524288]
     planes, the benchmark's pool8 round), then on phases 4-7's own
     batches: every plane bitwise the plain version's (``ref.expand_events``
     on the same CUDA columns) and the host fill's (``EventStager.stage``),
     timed on the card (calls back to back) beside the plain version and
     the bound (the columns read once, every plane slot written once);
4. slice-1 main path: CXLMemSim attached to a bf16 stand-in step on the
   card, with the qwen3-0.6b published config's layer-epoch trace (8 x 4096
   tokens) on the paper's Figure 1 topology, under the default
   (asynchronous on the shared engine), one warm-up step, then 3
   measured steps; over those 3 the cascade's launch count must rise by
   exactly 3, the expansion's by 3 and the plain path's by 0, the report's
   delay totals must match the f64 oracle ``analyze_ref``, and both
   switches must queue; then the compact host staging on the host clock,
   and a torch.profiler table of one batch;
5. the shared fabric: FabricSession with 8 trace-only qwen3-0.6b decode
   tenants (batch 64, 4096-token caches) pooling their KV caches on
   pooled_topology(n_hosts=8) with trace-driven coherency, synchronous
   (``async_analysis=False``, as phases 6, 8, 12 and 14 run their
   sessions), one warm-up round, then 3 measured rounds; over those 3 the host-segmented kernel's
   launch count must rise by exactly 3, the plain path's and the
   single-host kernel's by 0; totals and the per-host decomposition must
   match ``analyze_ref`` on the merged epochs; then the host time of the
   merge and of staging, and a torch.profiler table of one round's batch;
6. the wide fabric: 32 smaller decode tenants on pooled_topology(n_hosts=32),
   33 stages, over the 31-bit route word, so the analyzer runs the unfused
   per-stage loop: 2 rounds, the scan's launch count must rise by stages x
   rounds and the plain path's by 0, and the totals must match
   ``analyze_ref``; then a torch.profiler table of one round's batch;
7. qos-main: phase 4 on Figure 1 re-declared with strict-priority switches
   and 2 classes (every traced event is class 0, and priority with one
   populated class is FIFO): one warm-up step, then 3 measured steps; the
   single-host QoS kernel's launch count must rise by exactly 3 and every
   other kernel's and the plain path's by 0, the totals must match
   ``analyze_ref`` and equal phase 4's (latency and congestion to rel 1e-6),
   and class 1 must carry no congestion;
8. qos-fabric: phase 5's 8 tenants with tenants 0-1 in class 0 and 2-7 in
   class 1, on pooled_topology(n_hosts=8, discipline="priority",
   class_weights=(1, 1)): one warm-up round, then 3 measured rounds; the
   host-segmented QoS kernel's launch count must rise by exactly 3 and every
   other kernel's and the plain path's by 0; totals, per-host and per-class
   results must match ``analyze_ref`` on the merged epochs, the per-class
   sums close on the congestion total, and class 0's tenants must not wait
   longer than in phase 5's FIFO run and together wait less; then the same
   checks with discipline="wfq", class_weights=(4, 1) (the class-0 wait
   against FIFO only printed): one warm-up round, 2 measured;
9. Mamba2 serving at mamba2-2.7b's published widths (random weights from
   seed 0, bf16 compute): the SSD kernels (two launches a call, built with
   the others from ssd_scan.cu) against the plain chunked version at the
   reference's four test cases (f32; the first also against the sequential
   recurrence) and at the prefill shape x[8, 4096, 80, 64], N=128,
   chunk=128, in bf16 and f32, timed beside the bound on the tensor cores
   in 3xTF32 (and the same FLOPs' time on the f32 CUDA cores), and a
   layout over one block's shared memory (P=128, N=256, f32) refused
   without a launch; then prefill S-1
   tokens plus one decode step against the last logits of a prefill of S,
   at full width, in f32 (8 layers, every
   sequence's rel < 5e-4) and bf16 (2 layers, the median sequence's rel <
   3e-2, every one < 0.15); then 8 requests of 4096 tokens served
   (one prefill, 16 greedy decode steps) on the 64-layer model; then the
   prefill step attached to CXLMemSim on Figure 1 with the weights in
   cxl_pool1 (one warm-up step, 3 measured: exactly 64 SSD launches and one
   cascade per step, totals against ``analyze_ref``) and the decode step
   from the prefill's caches (one warm-up, 8 measured: one cascade per step,
   no SSD launch) in three modes in turn: with ``async_analysis=False``,
   under the default, and under the default with the interpreter's thread
   switch interval cut to 0.1 ms (the GIL probe), the three runs' totals
   equal and each run's native step, its ratio to the synchronous run's,
   its launching (wall and the submitting thread's CPU seconds) and its
   wait for the card, and the dispatcher's overlap with the native steps
   printed; then a torch.profiler table of one prefill;
10. dense serving at qwen3-0.6b's published widths (random weights from
   seed 0, bf16 compute): the flash attention kernels (built with the
   others from flash_attention.cu; the wrapper picks the bf16 wgmma kernel,
   the f32 CUDA-core kernel or, for at most 4 query rows a KV head, the
   split-KV decode kernel) against the plain full-matrix version
   ``ref.mha_attention`` at the reference's five test cases (f32 within
   2e-5, bf16 within 2e-2), at the prefill shape q[8, 16, 4096, 128] x
   k, v[8, 8, 4096, 128], causal, in bf16 (rtol 2**-7, one bf16 rounding,
   atol 2e-5 of the output's largest magnitude) and f32 (within 2e-5), and
   at the decode shape q[8, 16, 1, 128] x k, v[8, 8, 4112, 128] at
   q_offset 4096 in f32 (within 2e-5), each with the plain version minus
   the last visible BLOCK_K keys failing that bar, timed on the card
   (calls back to back) beside its bound, the plain version and (bf16
   prefill) scaled_dot_product_attention;
   then prefill S-1 tokens plus one decode step against the last logits of a
   prefill of S, at full width, in f32 (all 28 layers) and bf16 (2 layers),
   every sequence's rel < 5e-4 and < 3e-2; then 8 requests of 4096 tokens served (one prefill padded to
   4112, 16 greedy decode steps) on the 28-layer model; then ops.attention,
   the kernel's entry point, on layer 0's own q/k/v from that prefill
   (against the model's chunked attention) and at the decode shape (Sq = 1,
   q_offset = the cache length, over the padded cache, against the decode
   block's attention; the decode kernel), at the same bf16 bar and with the
   same planted fault failing it: exactly 2 flash calls (3 kernel
   launches: the prefill kernel, the decode kernel and its merge); the
   decode call's kernels timed on the card (back to back) beside
   scaled_dot_product_attention's over the visible keys (checked against
   it at 2e-2); then the prefill step
   attached to CXLMemSim on Figure 1 with the KV cache in cxl_pool1 (one
   warm-up step, 3 measured: one cascade per step, totals against
   ``analyze_ref``) and the decode step from the prefill's caches (one
   warm-up, 8 measured) in phase 9's three modes; then a torch.profiler
   table of one prefill;
11. migration and the device cache at qwen3-0.6b's widths: phase 4's
   program with software migration (1 MiB pages, promote at a hotness of
   1024 weighted events, demote below 1, an 8 GiB local budget, cold
   local-born regions to cxl_pool2) and a 1 GiB expander cache (4 KiB
   lines), one warm-up step and 3 measured: one cascade launch a step, at
   least one promotion and one demotion, the analyzer's seconds and the
   host seconds of the pre-analysis (re-synthesis, migration, the cache's
   tag update) per step, and the totals against ``analyze_ref`` on the
   measured steps' own epochs and scale rows; then phase 4's program
   without either, with the cache alone, with a zero-capacity cache and
   with migration mode "off" (1 + 3 steps each): congestion, and but for
   the cache alone latency, bitwise equal to phase 4's report, bandwidth
   to rel 1e-6 (f32 atomics; the largest difference printed), and every
   cascade call's slot indices bitwise equal to the run without either;
12. fabric8 with migration (the same daemon, cold regions to shared_pool)
   on one local budget shared by the 8 tenants and the 1 GiB cache warmed
   by the merged stream: one warm-up round and 2 measured, one
   host-segmented launch a round (the round replay is off), the pre-analysis
   split as in phase 11, and the last round's totals and per-host latency
   and congestion against ``analyze_ref`` on its own merged epochs and
   scale rows;
13. the model zoo: each of the ten archs' published memory program
   (``get_config``; decode at batch 8 and 4096 tokens, prefill for
   hubert-xlarge; bf16 weights in cxl_pool1) on Figure 1 with every CXL
   pool raised to 1 TiB, attached to phase 4's stand-in step in layer
   epochs, 1 + 1 steps: one cascade launch a step, the three totals against
   ``analyze_ref``; an arch whose layer epochs reach 2**23 ns (where the
   f32 epoch-relative times the analyzer shares with the reference lose
   their sub-ns resolution) holds latency and bandwidth to ``analyze_ref``,
   congestion to the plain version on the same epochs, and then runs in
   quantum epochs of 2**22 ns with all three totals against
   ``analyze_ref``;
14. the device-resident epoch pipeline (synchronous): ``ops.chain_cascade``
   on the card (the merges as torch ops, each stage's scan in the scan
   kernel over ``mask = idx >= 0``) against its plain version (the
   reference's arange scan) on the same CUDA tensors, final times and
   slots bitwise and per-stage delays to rel 1e-6, on main's own packed
   batch and at main's caps tie-free, tie-heavy, mostly ``+inf`` pads,
   with an empty stage and with all-pad rows; then pipeline-main: phase
   4's program with ``pipeline=True, warmup=True`` (one build at attach),
   1 + 3 steps: 3 scan launches a step and no cascade launch, no build
   after the warm-up, pinned host planes, the totals against
   ``analyze_ref`` and phase 4's (latency to rel 1e-6, congestion and
   bandwidth to rtol 1e-4), the dispatch split per step and a
   torch.profiler table of one batch; then pipeline-fabric8,
   pipeline-wide32 (1 + 1 rounds) and pipeline-qos-main (1 + 1 steps),
   each against its own phase (5, 6, 7) per round or step at the fabric
   bars, with its launches and split;
15. the shared analysis engine: engine-main, phase 4's program
   synchronously and with ``async_analysis=True`` on a private engine in
   turns (sync, async, async, sync; 1 + 3 steps each): one cascade launch
   a step, every cascade on the engine's own CUDA stream, the asynchronous
   totals against phase 4's (latency and bandwidth to rel 1e-6,
   congestion 1e-4), and the native, analyzer and wall seconds of the
   measured steps printed for both modes, with each dispatch's launch and
   finish on the host clock; then 3 more steps of each run timed alike
   (the first measured step of an asynchronous run fills the engine's
   second ring slot for the first time); engine-pipeline-main, phase
   14's pipeline-main through an engine (1 + 3 steps): 3 scan launches a
   step, no build after attach, staging through the engine's pinned
   2-slot ring, totals against phase 14's at the same bars;
   engine-fabric8, phase 5's fabric under the session's default,
   overlapped rounds on the shared engine (1 + 3): one hosts launch a
   round, totals and per-host latency and congestion against phase 5's
   synchronous ones at the fabric bars; engine-coalesced, 4 sessions of
   phase 4's program cut to 28, 24, 20 and 12 layers (31, 27, 23 and 15
   epochs a step) on one engine whose steps' submissions queue behind a
   held dispatcher: 4 sessions coalesced, exactly one cascade launch, over
   ``[128, 131072]``, each session's step against its own solo analysis
   (latency rel 1e-6, congestion and bandwidth rel 1e-5; the four solo
   analyses differ pairwise by more than those bars, so a mix-up of
   sessions fails); the stacked batch's cascade against its plain version
   and timed beside the 4 solo batches; then train-main (phase 17b)
   attached twice, 1 + 3 steps each, the model training on through both:
   with ``async_analysis=False``, then under the default (asynchronous on
   the shared engine): one cascade launch a step and nothing else, both
   runs' totals equal and phase 4's, the default run's mean native step
   within 1.10 of the synchronous run's and each of its dispatches
   launched during its own step; per step the native seconds, their ratio
   and the dispatch's launch and finish times printed, and the wall
   against the synchronous native + analyzer seconds;
16. scenario sweeps and the fleet: sweep-main, phase 4's program on Figure 1
   through ``ScenarioSuite`` with 64 scenarios (4 policies x 4 overrides x
   2 granularities x 2 caches, benchmarks/scenario_sweep.py's axes): one
   dispatch, 16 unique cascades in 2 FIFO cascade launches (one per STT
   row), the tag simulations, the stage / transfer / compute split, the
   cascades' device ms and the peak device memory printed, a warm second
   run, every scenario against its own solo analysis on the card (rel
   1e-6) and 8 (between them every policy, override, granularity and
   cache) against ``analyze_ref`` at the main path's bars; sweep-qos, the
   same program with the optimizer state and gradients in class 1 under
   FIFO, priority, WFQ 4:1 and WFQ 1:4 (4 single-host QoS launches; FIFO
   equal to QoS off at tests/test_qos_cascade.py:470's bars, class 0 never
   queuing, priority equal to FIFO, WFQ ordering class 1's congestion by
   its weight); fleet-frontier, 32 racks of ``pooled_topology(n_hosts=4)``
   and 192 synthetic 10 GiB tenants over 8 offload fractions (one dispatch
   over 256 rack planes, one host-segmented cascade launch, every plane
   against its solo analysis, stranded GB non-decreasing from 0);
   fleet-hetero-qos, the tenants in alternating classes on racks
   alternating between the base and a slow expander and between WFQ 4:1
   and priority (2 host-segmented QoS launches, every rack against the
   same fleet run on the CPU); each cell's launch batch against its
   kernel's plain version;
17. training: train-small, qwen3-0.6b's SMOKE at f32 with one seeded
   model's weights on the card and the CPU, 3 train steps each from the
   same SyntheticPipeline batches (losses to rel 1e-5, parameters within 2
   x the sum of the steps' lr); train-main (run in phase 15),
   qwen3-0.6b's own train step at
   its published widths (bf16 compute over f32 master parameters and AdamW
   moments, remat, the head in 4096-token chunks) on 8 x 4096-token
   batches, attached to phase 4's program, policy and topology: one
   warm-up step, then 3 measured; the cascade's launch count must rise by
   exactly 3 and nothing else launch, the totals must equal phase 4's
   (congestion and latency bitwise, bandwidth to rel 1e-6) and meet its
   bars against ``analyze_ref``, every loss must be finite and the first
   within 1.0 of ln(151936); the native and analyzer seconds per step
   printed beside phase 4's stand-in, the peak device memory, and a
   torch.profiler table of one more step; then the refusals: ``ops.ssd``
   and ``ops.attention`` on CUDA tensors that require grad, and a train
   step for mamba2 on the card, raise NotImplementedError without a launch;
18. the MoE and hybrid families: moe-small, granite-moe-3b-a800m's,
   llama4-maverick's and jamba's SMOKE (jamba also with a sliding window
   of 16) at f32, one seeded model's weights on the card and the CPU:
   forward logits (rtol 1e-4 of the largest logit) and aux with every MoE
   routing compared (a token routed differently must be a near-tie, its
   CPU probabilities within 16 ulps, and its sequence leaves the logits
   bar), the lossless prefill S-1 plus one decode against the forward of S
   on the card (under 5e-4), 3 train steps of granite and llama4 with and
   without int8 compression (as phase 17's train-small), and the three
   dispatches on one layer at granite's widths (256 tokens, lossless and
   lossy capacity) against the CPU at 2e-5 and against each other;
   serve-moe, granite-moe-3b-a800m at its published widths and depth
   (3,298,793,472 parameters, bf16 compute, einsum dispatch): the f32
   roundtrip in the dense dispatch at 32 layers (every sequence under
   5e-4), 8 x 4096 tokens served (prefill padded to 4112, 16 decodes) with
   the share of routes past capacity in the prefill and a decode, the
   prefill (1 + 3) and decode (1 + 8) steps attached to granite's own
   programs with the weights in cxl_pool1 (one cascade launch a step,
   totals against ``analyze_ref``), and a torch.profiler table of one
   prefill; train-moe, granite's own train step (bf16 over f32 master
   parameters, remat) on 4 x 4096-token batches (8 x 4096 does not fit
   the card) attached to its own train program under main's policy: 1 + 3 steps, one cascade launch a step and
   nothing else, its layer epochs past 2**23 ns held as phase 13 holds
   them and run again in quantum epochs (1 + 1 steps), every loss finite
   and the first within 1.0 of ln(49155); native and analyzer seconds, the
   peak memory and the model-FLOP rate (the script profiles one train
   step, train-main's in phase 15); jamba, jamba-v0.1-52b at its published widths cut to one of its 4
   groups (7 Mamba2 sublayers through ssd_scan.cu, 1 attention, 4 MoE
   feed-forwards): 8 x 4096 tokens served (7 SSD calls) with the routes
   past capacity, then the prefill (1 + 3: 7 SSD calls and one cascade a
   step) and decode (1 + 8: no SSD call) attached to the cut config's own
   programs with the weights in cxl_pool1, held as above;
   llama4-maverick stays at SMOKE (one MoE layer's experts are 64 GB in
   f32);
19. the VLM and audio families and the two remaining dense configs:
   family-small, chatglm3-6b's (rope2d), starcoder2-3b's (GELU MLP),
   qwen2-vl-72b's (M-RoPE, embedding inputs) and hubert-xlarge's
   (LayerNorm, GELU, bidirectional, embedding inputs) SMOKE at f32, one
   seeded model's weights on the card and the CPU: forward logits (rtol
   1e-4 of the largest), the three decoders' prefill S-1 plus one decode
   against their forward of S on the card (under 5e-4), 3 train steps
   each (as train-small), and starcoder2's 3 steps under
   ``remat_policy_name="dots"`` against ``"nothing"`` on the card (same
   bars, the peak memory of each printed); then at published widths (bf16
   compute over f32 weights from seed 0), each served 8 x 4096 tokens or
   frames (one prefill and, for a decoder, 8 decodes, timed) and attached
   to its own programs with the weights in cxl_pool1 (prefill 1 + 3,
   decode 1 + 8; one cascade launch a step; totals against
   ``analyze_ref``, and layer epochs past 2**23 ns held as phase 13 holds
   them, then 1 + 1 steps in quantum epochs): serve-starcoder2 and
   train-starcoder2 (30 layers; its own train step on 4 x 4096-token
   batches attached to its own train program under main's policy, 1 + 3
   steps, as train-moe: every loss finite, the first within 1.0 of
   ln(49152), native and analyzer seconds, peak memory and model-FLOP
   rate), serve-chatglm3 (28 layers),
   serve-hubert (48 layers, a forward of 8 x 4096 frames, no decode) and
   train-hubert (8 x 4096 frames, the first loss within 1.0 of ln(504)),
   serve-qwen2vl (cut to 12 of its 80 layers, widths kept, embeddings in
   and out of the decode);
20. the split over several devices: each split path (the analyzer's 16
   sessions, the engine's 4 coalesced ones, sweep-main, sweep-qos,
   fleet-frontier, fleet-hetero-qos) unsharded twice and once over a
   virtual mesh of ``cuda:0`` (and of the real cards where there are
   several), the split run bitwise its unsharded twin, launches counted;
21. the sanitizers on the card: engine-main (a private engine, 1 + 3
   steps), the 4 coalesced sessions behind a held dispatcher (each warmed
   alone, then one step each: one cascade launch), fabric8 on a private
   engine (1 + 2 overlapped rounds), pipeline-main (1 + 3) and sweep-main
   (a warm run, then one measured), each once plainly and once built
   inside ``LockOrderSanitizer`` and ``AxisSanitizer`` and measured inside
   ``RecompileSanitizer(allowed_lowerings=0, allowed_builds=0)``: every
   number of the sanitized run bitwise its twin's, the same launches, no
   dispatch-cache build, no nvcc run, no lock-order cycle (each scope's
   edges printed) and ``compile_cache_size`` flat; then a transposed
   ``[N, B]`` batch into ``_analyze_batch``, ``ops.congestion_cascade``
   and ``ops.qos_congestion_cascade`` on CUDA tensors under
   ``AxisSanitizer`` (each raises ``AxisContractError``, nothing
   launches), and the unarmed ``@axes`` wrapper's cost a call against the
   undecorated function's;
22. the six examples (``examples/*_torch.py``), each's ``run()`` on the
   card at the example's own sizes: quickstart (qwen3-0.6b SMOKE, 5
   attached train steps on Figure 1; run twice, the second run warm),
   serve_offload (mistral-large-123b SMOKE, prefill and 16 attached
   decodes under 3 policies, each from its own copy of the prefill's
   caches: the 3 first decodes' logits equal), fabric_pooling (2 tenants, 5 rounds: the host-segmented cascade),
   migration_caching (the 3 x 3 grid, 10 steps a cell), topology_explorer
   (6 structures x 3 bandwidths, then 2 rounds of successive halving) and
   train_100m at its published widths (12 layers, d_model 640, vocab
   32768, 8 x 256 tokens, 200 steps, a checkpoint every 50, attached:
   every loss finite, the first within 1.0 of ln(32768), the mean of the
   last 10 below the first 10's; native seconds a step and peak memory
   printed, and a torch.profiler table of one more unattached step):
   the path's cascade launched, no other kernel and no plain version;
   each's wall seconds and printed lines; every example but
   train_100m run again with ``device="cpu"`` and its simulated numbers
   held to the card's at tests/test_torch_examples.py's bars (latency,
   bandwidth, coherency and per-pool latency rel 1e-5; congestion rel
   1e-4, abs 1e-12 s; epochs, rounds, BI messages, promotions, hit
   fractions, the best candidate, the refined label and the dispatch
   count equal; the sweep's delays and slowdowns rel 1e-5);
23. a JSON ``kernels`` line (the expansion's launches are every one the
   script made; its ms, plain_ms and bound_ms the pooled fabric's width),
   then the card's nvidia-smi line, then the result line ``{"ok": true,
   "device": {...}}``.

The earlier phases (4-6) must show no QoS launch, no phase before 9 an SSD
launch, and no attached step a flash launch (the model's attention is the
plain chunked version, as in the reference).  Every dispatch of the
analyzer's default path launches the expansion once, and every launch
check counts it: the paths that bypass that dispatch (the pipeline,
coalesced sessions, sweeps, fleets, the split) must launch none.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time
import types
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT / "examples"))  # _parity: the examples' bars

import _parity as parity  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke  # noqa: E402
from repro_torch.configs.mamba2_2_7b import CONFIG as M2_CONFIG  # noqa: E402
from repro_torch.configs.qwen3_0_6b import CONFIG  # noqa: E402
from repro_torch.configs.qwen3_0_6b import SMOKE as Q3_SMOKE  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CACHELINE_BYTES,
    H100_SXM,
    PAGE_BYTES,
    AnalysisEngine,
    ClassMapPolicy,
    CoherencyConfig,
    CXLMemSim,
    DelayBreakdown,
    DeviceCacheConfig,
    DeviceCacheModel,
    EpochAnalyzer,
    EpochSchedule,
    EventStager,
    FabricSession,
    FleetSim,
    HotnessTieredPolicy,
    InterleavePolicy,
    LocalOnlyPolicy,
    MemEvents,
    MigrationConfig,
    MigrationSimulator,
    Pool,
    QosSpec,
    Scenario,
    ScenarioSuite,
    Switch,
    Tenant,
    Topology,
    TopologyOverride,
    analyze_ref,
    bucket_pow2,
    chained_topology,
    figure1_topology,
    flatten_stack,
    plan_cascade,
    plan_chain,
    pooled_topology,
    synthesize_step_trace,
    synthetic_tenant,
)
from repro_torch.analysis.sanitize import (  # noqa: E402
    AxisSanitizer,
    LockOrderSanitizer,
    RecompileSanitizer,
)
from repro_torch.annotations import AxisContractError, axes  # noqa: E402
from repro_torch.core import analyzer as tan  # noqa: E402
from repro_torch.core import scenario as tscenario  # noqa: E402
from repro_torch.core.units import s_to_ms, s_to_ns  # noqa: E402
from repro_torch.kernels import congestion as kcong  # noqa: E402
from repro_torch.kernels import expand as kexpand  # noqa: E402
from repro_torch.launch.mesh import make_data_mesh, mesh_devices  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import ssd_scan as kssd  # noqa: E402
from repro_torch.models import transformer as mtf  # noqa: E402
from repro_torch.data.pipeline import SyntheticPipeline  # noqa: E402
from repro_torch.interop import model_params_from_arrays, params_to_arrays  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.models import Model, build_regions_and_phases  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.compression import init_error_state  # noqa: E402
from repro_torch.models import attention as mattn  # noqa: E402
from repro_torch.models import moe as mmoe  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
TF32X3_OPS_PER_S = 495e12 / 3  # H100 SXM TF32 tensor cores, dense, three products per f32 one
MS_PER_S = 1e3
BYTES_PER_EVENT = 16  # cascade: read t + route bits, write t_final + slot_idx
HOSTS_BYTES_PER_EVENT = 20  # hosts cascade: + read the host id
SCAN_BYTES_PER_EVENT = 13  # scan: read t + mask byte, write start + delay
QOS_BYTES_PER_EVENT = 20  # QoS cascade: the cascade's 16 + read the class
QOS_HOSTS_BYTES_PER_EVENT = 24  # host-segmented QoS cascade: + read the host id
# the expansion: read each real event's 32-bit columns once, write every slot
# of every 32-bit plane and of the valid byte plane once
EXPAND_WORD_BYTES = 4
# pooled KV fabric rounds of the benchmark's 8-host cell: 33 epochs in
# [64, 524288] planes, 14,221,312 real events, the longest epoch 442,368
POOL8_ROWS = (442_368,) + (430_592,) * 32
OPS_PER_QUEUED_EVENT = 6  # stt*rank, t - p, max, f + p, start - t, sum
POLICY = {"opt_state": "cxl_pool2", "grad": "cxl_pool1"}
# the shared fabric: the paper's KV-cache pooling scenario at qwen3-0.6b's widths
FABRIC_HOSTS = 8
FABRIC_LOAD = dict(kind="decode", batch=64, seq=1, cache_len=4096)
FABRIC_EVENTS_PER_ACCESS = 8192
# the wide fabric: more hosts than the route word holds stages, cut in depth
WIDE_HOSTS = 32
WIDE_LOAD = dict(kind="decode", batch=8, seq=1, cache_len=1024)
WIDE_EVENTS_PER_ACCESS = 256
FABRIC_POLICY = {"kvcache": "shared_pool"}
# the QoS chain of the reference's QoS tests: 3 switches, 3 classes
QOS_WEIGHTS = (4.0, 2.0, 1.0)
# the QoS fabric: tenants 0-1 latency-critical (class 0), 2-7 batch (class 1)
FABRIC_CLASSES = (0, 0, 1, 1, 1, 1, 1, 1)
# phase 11: a software tiering daemon (1 MiB pages) and a 1 GiB expander
# cache.  Layer epochs touch one layer's regions each, so a region is hot in
# its epoch (an access is up to max_events_per_access events; the hotness is
# an EWMA of the weighted counts) and cold some epochs later: promote at a
# hotness of 1024, demote below 1, within an 8 GiB local budget, below the
# program's 24 GiB of local-born bytes, so promotions wait for demotions
MAIN_MIGRATION = MigrationConfig(
    mode="software", promote_threshold=1024.0, demote_threshold=1.0,
    local_budget_bytes=8 << 30, granularity_bytes=1 << 20, demote_pool="cxl_pool2",
)
# phase 12: the same daemon for every tenant, on one shared 8 GiB budget
FABRIC_MIGRATION = dataclasses.replace(MAIN_MIGRATION, demote_pool="shared_pool")
CACHE = DeviceCacheConfig(capacity_bytes=1 << 30, line_bytes=4096)
DELAY_KEYS = ("latency_s", "congestion_s", "bandwidth_s", "per_pool_latency_ns",
              "per_switch_congestion_ns", "per_switch_bandwidth_ns")
# phase 13: every arch's bf16 weights in the CXL pool behind switch0, on
# Figure 1 with 1 TiB CXL pools (llama4-maverick's weights are 739 GiB)
ZOO_POLICY = {"param": "cxl_pool1"}
ZOO_POOL_BYTES = 1 << 40
# epoch-relative times are f32 in the analyzer: from 2**23 ns on their ulp
# is 1 ns, and the closed-form queue scan rounds a start past its arrival
# (both packages; ROADMAP.md queue 3).  An arch whose layer epochs reach it
# is also run in quantum epochs of 2**22 ns, the Timer's cut
F32_EXACT_NS = float(2**23)
ZOO_QUANTUM_NS = float(2**22)
# Mamba2 serving: mamba2-2.7b at its published widths, 8 requests of 4096 tokens
SSD_CASES = [  # tests/test_kernels.py's cases: B, L, H, P, N, chunk
    (2, 256, 4, 32, 16, 64),
    (1, 128, 2, 64, 128, 128),
    (1, 512, 8, 16, 32, 128),
    (2, 64, 1, 8, 8, 32),
]
SERVE_BATCH, SERVE_SEQ, SERVE_DECODES = 8, 4096, 16
M2_POLICY = {"param": "cxl_pool1"}  # the weights in the CXL pool behind switch0
# prefill S-1 + decode 1 against prefill S at full width, cut in depth.  The
# error of a sequence: max abs logit difference over its max abs logit.
# f32, 8 layers: every sequence under the reference's bar
# (tests/test_arch_smoke.py).  bf16, 2 layers: the median sequence under
# 1.5x the bar of the bf16 CPU test at SMOKE, every sequence under a guard
# of 0.15.  Not the median bar on each: the two bf16 paths round in
# different places (conv and SSD output in bf16 in prefill, f32 in decode,
# as in the reference), and on some sequences the layers amplify that.  At
# this width and depth, on the port's weights drawn on the CPU and 8 x 4096
# tokens, the reference's own bf16 roundtrip parts by 0.068 on one sequence
# (0.009 on a typical one) and the two packages' bf16 prefills by 0.112 on
# it (tests/test_torch_mamba2.py::
# test_full_width_bf16_roundtrip_parts_in_the_reference_too); the guard is
# about twice the reference's split.
ROUNDTRIP_F32 = (8, 5e-4)  # layers, bar on every sequence
ROUNDTRIP_BF16 = (2, 3e-2, 0.15)  # layers, bar on the median, guard on every sequence
# Dense serving: qwen3-0.6b at its published widths, 8 requests of 4096 tokens
ATTN_CASES = [  # tests/test_kernels.py's cases: B, H, Hk, Sq, Sk, D, causal, q_offset
    (1, 4, 2, 256, 256, 64, True, 0),
    (2, 8, 2, 128, 128, 32, False, 0),
    (1, 2, 2, 128, 512, 64, True, 384),
    (1, 16, 8, 512, 512, 128, True, 0),
    (2, 4, 4, 256, 256, 128, True, 0),
]
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py's bars


def attn_bar(want, dtype, at_cases):
    """The flash kernel's bar against its plain version.  On ATTN_CASES,
    tests/test_kernels.py's (rtol = atol = ATTN_TOL).  At the main path's
    bf16 shapes, where 2e-2 is about the size of a typical output, one bf16
    rounding of the f32 result (rtol 2**-7: both sum in f32 and round once)
    plus 2e-5 of the output's largest magnitude for f32 sums in another
    order, as compare_ssd; f32 stays at 2e-5."""
    if at_cases or dtype == torch.float32:
        tol = ATTN_TOL[dtype]
        return dict(rtol=tol, atol=tol)
    return dict(rtol=2 ** -7, atol=2e-5 * float(want.float().abs().max()))


def check_bar_rejects_a_skipped_tile(name, q, k, v, causal, q_offset, want, bar):
    """A planted fault must fail the bar: the plain version with the last
    visible BLOCK_K keys dropped (the bf16 wgmma kernel's KV tile at or below
    the last query's position; the same cut whichever kernel the wrapper
    picks, though the f32 kernel's tiles are 64 keys and the decode kernel's
    splits whole multiples of BLOCK_K).  Returns that fault's max error."""
    last = q_offset + q.shape[2] - 1 if causal else k.shape[2] - 1
    cut = last // kflash.BLOCK_K * kflash.BLOCK_K
    bad = kref.mha_attention(q, k[:, :, :cut].contiguous(), v[:, :, :cut].contiguous(),
                             causal=causal, q_offset=q_offset).float()
    err = float((bad - want.float()).abs().max())
    passed = bool(torch.isclose(bad, want.float(), **bar).all())
    check(not passed, f"{name}: the bar {bar} does not reject keys {cut}..{last} "
          f"dropped (max abs error {err})")
    return err
Q3_PAD_TO = SERVE_SEQ + SERVE_DECODES  # the decode budget of the prefill's KV cache
Q3_POLICY = {"kvcache": "cxl_pool1"}  # the KV cache in the CXL pool behind switch0
# prefill S-1 + decode 1 against prefill S, as for mamba2.  f32: all 28
# layers, every sequence under the reference's bar.  bf16: 2 layers, every
# sequence under 3e-2 (mamba2's median bar, held here on each): five times
# the reference's own split at this width and depth, 0.0059 on its witness
# sequence (tests/test_torch_qwen3.py::
# test_full_width_bf16_roundtrip_in_the_reference).
Q3_ROUNDTRIP_F32 = (28, 5e-4)  # layers, bar on every sequence
Q3_ROUNDTRIP_BF16 = (2, 3e-2)  # layers, bar on every sequence


SLEEP_CYCLES = 200_000_000  # device_ms's sleep: about 0.1 s at an H100's 1.98 GHz


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, reps: int) -> float:
    """Time on the card of one call of ``fn``, the host's work left out: a
    sleep kernel holds the stream while the host enqueues ``reps`` calls,
    so that the card runs them back to back between two events.  Checks
    that the host finished enqueueing before the sleep ended.  (A
    torch.profiler trace lost kernel records of short calls on the card.)"""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    t0 = time.perf_counter()
    ev[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[1].record()
    for _ in range(reps):
        fn()
    ev[2].record()
    host_ms = (time.perf_counter() - t0) * MS_PER_S
    ev[2].synchronize()
    sleep_ms = ev[0].elapsed_time(ev[1])
    check(host_ms < sleep_ms, f"enqueueing {reps} calls took {host_ms} ms, the sleep {sleep_ms}")
    return ev[1].elapsed_time(ev[2]) / reps


def bound_ms(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple:
    """The least time for one call: bytes moved once over the HBM rate, or
    the operations over ``ops_per_s`` (default the f32 CUDA-core rate),
    whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * MS_PER_S
    t_ops = ops / ops_per_s * MS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cascade_bound(t, bits, n_stages, bytes_per_event, out_per_row):
    """Bound of one cascade call on these inputs: the events the stages
    queue here decide the operations."""
    nbytes = bytes_per_event * t.numel() + 4 * (n_stages + t.shape[0] * out_per_row)
    queued = sum(int(((bits >> s) & 1).sum()) for s in range(n_stages))
    return bound_ms(nbytes, OPS_PER_QUEUED_EVENT * queued)


def synthetic_times(rows: int, n: int, seed: int, dev):
    """Sorted uniform (even rows) and bursty (odd rows) arrival times at a
    density that queues at every stage."""
    rng = np.random.default_rng(seed)
    span = 3.0 * n  # ns: ~3 ns between arrivals
    t = np.empty((rows, n), np.float32)
    for r in range(rows):
        if r % 2 == 0:
            x = rng.uniform(0, span, n)
        else:
            centers = rng.uniform(0, span, max(1, n // 64))
            x = rng.choice(centers, size=n) + rng.exponential(20.0, size=n)
        t[r] = np.sort(x)
    return torch.from_numpy(t).to(dev), rng


def synthetic_inputs(rows: int, n: int, n_stages: int, seed: int, dev):
    """Synthetic times and random route words."""
    t, rng = synthetic_times(rows, n, seed, dev)
    bits = rng.integers(0, 1 << n_stages, (rows, n)).astype(np.int32)
    return t, torch.from_numpy(bits).to(dev)


def fabric_inputs(flat, rows: int, n: int, seed: int, dev, ties: bool = False):
    """Synthetic times on a multi-host fabric (with ``ties``, integers from
    a span of n/4, as ``qos_inputs(ties=True)``): each event a random
    virtual (host, pool) pair, with that pair's route word and host id."""
    t, rng = synthetic_times(rows, n, seed, dev)
    if ties:
        t = torch.from_numpy(
            np.sort(rng.integers(0, max(2, n // 4), (rows, n)), axis=1).astype(np.float32)
        ).to(dev)
    bits_pool, _, order = plan_cascade(flat)
    vp = rng.integers(0, flat.route.shape[0], (rows, n))
    bits = torch.from_numpy(bits_pool[vp].astype(np.int32)).to(dev)
    hosts = torch.from_numpy((vp // flat.n_pools).astype(np.int32)).to(dev)
    stts = torch.tensor(flat.switch_stt_ns[list(order)], dtype=torch.float32, device=dev)
    return t, bits, hosts, stts


def cascade_ctas(t) -> int:
    """The cascade kernels' CTAs per row for this batch on this card."""
    sms = torch.cuda.get_device_properties(t.device).multi_processor_count
    return kcong.ctas_per_row(t.shape[0], t.shape[1], sms)


def pad_share(t) -> float:
    """The share of a batch's events that are pads (time finfo.max/4)."""
    return float((t >= torch.finfo(torch.float32).max / 4).float().mean())


def check_mirror(name, flags, plain, mirror):
    """The partitioned mirror against the plain version (slot indices and
    final times bitwise, delays at the kernels' bar), and the kernel's merge
    flags against the mirror's, exactly.  Returns the merges the mirror ran
    and skipped per call (all rows)."""
    tm, im, pm, fm = mirror
    check(torch.equal(im, plain[1]), f"{name}: the mirror's slot_idx differs from the plain version")
    check(torch.equal(tm, plain[0]), f"{name}: the mirror's final times differ from the plain version")
    torch.testing.assert_close(pm, plain[2], rtol=1e-5, atol=0.0)
    got = flags.cpu()
    check(torch.equal(got, fm),
          f"{name}: merge flags differ from the mirror's in {int((got != fm).sum())} of "
          f"{fm.numel()} (row, stage) entries")
    return dict(merges_run=int((fm == kref.MERGE_RAN).sum()),
                merges_skipped=int((fm == kref.MERGE_SKIPPED).sum()))


def compare(name, t, bits, stts, reps=20):
    """Cascade kernel vs plain on the same CUDA inputs, and its merge flags
    vs the partitioned mirror's."""
    tk, ik, pk = kcong.congestion_cascade(t, bits, stts)
    fk = kcong.last_merge_flags
    tp, ip, pp = kref.serial_queue_cascade(t, bits, stts)
    torch.cuda.synchronize()
    check(torch.equal(ik, ip), f"{name}: slot_idx differs from the plain version")
    torch.testing.assert_close(tk, tp, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(pk, pp, rtol=1e-5, atol=0.0)
    check(bool(torch.isfinite(pk).all()), f"{name}: non-finite delays")
    err = float((tk - tp).abs().max())
    ms = median_ms(lambda: kcong.congestion_cascade(t, bits, stts), reps)
    plain_ms = median_ms(lambda: kref.serial_queue_cascade(t, bits, stts), max(3, reps // 4))
    n_stages = int(stts.shape[0])
    k = cascade_ctas(t)
    merges = check_mirror(name, fk, (tp, ip, pp),
                          kref.serial_queue_cascade_partitioned(t, bits, stts, k))
    bms, by = cascade_bound(t, bits, n_stages, BYTES_PER_EVENT, n_stages)
    row = dict(shape=list(t.shape), stages=n_stages, ctas=k, pad_share=pad_share(t), **merges,
               ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, max_abs_err=err,
               delay_ns=[float(x) for x in pk.sum(0)])
    print(f"[kernel] {name}: {json.dumps(row)}")
    return row


def compare_hosts(name, t, bits, hosts, stts, n_hosts, reps=20):
    """Host-segmented cascade kernel vs plain, and vs the single-host
    kernel's per-stage totals, on the same CUDA inputs."""
    tk, ik, pk = kcong.congestion_cascade_hosts(t, bits, hosts, stts, n_hosts)
    fk = kcong.last_merge_flags
    tp, ip, pp = kref.serial_queue_cascade(t, bits, stts, hosts=hosts, n_hosts=n_hosts)
    _, i1, p1 = kcong.congestion_cascade(t, bits, stts)
    f1 = kcong.last_merge_flags
    torch.cuda.synchronize()
    check(torch.equal(ik, ip), f"{name}: slot_idx differs from the plain version")
    check(torch.equal(ik, i1), f"{name}: slot_idx differs from the single-host kernel")
    check(torch.equal(fk, f1), f"{name}: merge flags differ from the single-host kernel's")
    torch.testing.assert_close(tk, tp, rtol=1e-6, atol=0.0)
    # per-host sums: double atomics in a run-dependent order (kernel) and an
    # f64 scatter-add (plain), both rounded to f32
    torch.testing.assert_close(pk, pp, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(pk.sum(-1), p1, rtol=1e-6, atol=0.0)
    check(bool(torch.isfinite(pk).all()), f"{name}: non-finite delays")
    err = float((tk - tp).abs().max())
    ms = median_ms(lambda: kcong.congestion_cascade_hosts(t, bits, hosts, stts, n_hosts), reps)
    single_ms = median_ms(lambda: kcong.congestion_cascade(t, bits, stts), reps)
    plain_ms = median_ms(
        lambda: kref.serial_queue_cascade(t, bits, stts, hosts=hosts, n_hosts=n_hosts),
        max(3, reps // 4),
    )
    n_stages = int(stts.shape[0])
    k = cascade_ctas(t)
    merges = check_mirror(name, fk, (tp, ip, pp), kref.serial_queue_cascade_partitioned(
        t, bits, stts, k, hosts=hosts, n_hosts=n_hosts))
    bms, by = cascade_bound(t, bits, n_stages, HOSTS_BYTES_PER_EVENT, n_stages * n_hosts)
    row = dict(shape=list(t.shape), stages=n_stages, hosts=n_hosts, ctas=k,
               pad_share=pad_share(t), **merges, ms=ms, single_host_ms=single_ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by, max_abs_err=err,
               psd_max_rel_err=float(((pk - pp).abs() / pp.abs().clamp(min=1e-30)).max()),
               delay_ns_per_host=[float(x) for x in pk.sum((0, 1))])
    print(f"[kernel] {name}: {json.dumps(row)}")
    return row


def compare_scan(name, t, mask, stt, reps=20):
    """Scan kernel vs plain on the same CUDA inputs: start and delay
    bitwise equal (and within rtol 1e-6).  ``ms`` is the kernel's time on
    the card (``device_ms``: calls back to back), ``call_ms`` CUDA events
    around one call (the host's enqueueing included, as earlier slices
    timed the scan)."""
    sk, dk = kcong.congestion_scan(t, mask, stt)
    sp, dp = kref.congestion_scan(t, mask, stt)
    torch.cuda.synchronize()
    torch.testing.assert_close(sk, sp, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(dk, dp, rtol=1e-6, atol=0.0)
    check(bool(torch.isfinite(dk).all()), f"{name}: non-finite delays")
    err = max(float((sk - sp).abs().max()), float((dk - dp).abs().max()))
    check(torch.equal(sk, sp) and torch.equal(dk, dp) and err == 0,
          f"{name}: the scan differs from the plain version (max abs err {err})")
    ms = device_ms(lambda: kcong.congestion_scan(t, mask, stt), 2 * reps)
    call_ms = median_ms(lambda: kcong.congestion_scan(t, mask, stt), reps)
    plain_ms = median_ms(lambda: kref.congestion_scan(t, mask, stt), max(3, reps // 4))
    masked = int(mask.sum())
    nbytes = SCAN_BYTES_PER_EVENT * t.numel()
    bms, by = bound_ms(nbytes, OPS_PER_QUEUED_EVENT * masked)
    row = dict(shape=list(t.shape), masked=masked, stt=stt, ms=ms, call_ms=call_ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               gb_per_s=nbytes / (ms / MS_PER_S) / 1e9, bound_share=bms / ms,
               max_abs_err=err, delay_ns=float(dk.sum()))
    print(f"[kernel] {name}: {json.dumps(row)}")
    return row


def scan_kernel_phase(dev):
    """The scan against its plain version, bitwise: a random mask at
    [32, 131072]; one row of 2**20 events (the longest look-back chain);
    [256, 4096] (one tile a row); tie-heavy rows with every event masked;
    rows with none masked; a ragged row length whose rows start misaligned
    (the kernel's scalar path); rows of one event."""
    t, rng = synthetic_times(32, 131072, 6, dev)
    mask = torch.from_numpy(rng.random((32, 131072)) < 0.5).to(dev)
    rows = [compare_scan("scan_random_mask", t, mask, 2.0)]
    for name, (b, n), seed, ties, share in (
        ("scan_one_row", (1, 1 << 20), 14, False, 0.5),
        ("scan_many_rows", (256, 4096), 15, False, 0.5),
        ("scan_ties_all_masked", (32, 131072), 16, True, 1.0),
        ("scan_none_masked", (32, 131072), 17, False, 0.0),
        ("scan_ragged", (8, 131071), 18, False, 0.5),
        ("scan_one_event", (3, 1), 19, False, 1.0),
    ):
        t, rng = synthetic_times(b, n, seed, dev)
        if ties:  # integers from a span of n/4, as fabric_inputs(ties=True)
            t = torch.from_numpy(
                np.sort(rng.integers(0, max(2, n // 4), (b, n)), axis=1).astype(np.float32)
            ).to(dev)
        mask = torch.from_numpy(rng.random((b, n)) < share).to(dev)
        rows.append(compare_scan(name, t, mask, 2.0))
    return rows


def check_scan_repeats(name, t, mask, stt, reps=50):
    """``reps`` launches back to back on one batch, each bitwise equal to
    the first: a status word not reset or a race in the look-back would
    show here."""
    first = kcong.congestion_scan(t, mask, stt)
    outs = [kcong.congestion_scan(t, mask, stt) for _ in range(reps)]
    torch.cuda.synchronize()
    bad = [i for i, (s, d) in enumerate(outs)
           if not (torch.equal(s, first[0]) and torch.equal(d, first[1]))]
    check(not bad, f"{name}: launches {bad} of {reps} differ from the first")
    print(f"[kernel] {name}: {reps} launches back to back, each equal to the first")


def qos_chain(disciplines) -> Topology:
    """A depth-3 switch chain with per-switch disciplines and 3 classes (a
    copy of the reference's QoS test topology); the RC is a fourth, FIFO
    stage."""
    switches = [
        Switch(f"sw{d}", 70.0, 64.0 - 8.0 * d, 2.0 + d, parent=f"sw{d - 1}" if d else None,
               discipline=disc, class_weights=QOS_WEIGHTS if disc == "wfq" else None)
        for d, disc in enumerate(disciplines)
    ]
    last = f"sw{len(switches) - 1}"
    return Topology(
        pools=[Pool("local", 88.9, 76.8, 1 << 36, is_local=True),
               Pool("far1", 180.0, 32.0, 1 << 38, parent=last),
               Pool("far2", 200.0, 32.0, 1 << 38, parent=last)],
        switches=switches, n_qos_classes=len(QOS_WEIGHTS),
    )


def qos_tables(flat, dev):
    """The stages' service times, discipline codes and class weights, in
    the cascade's stage order."""
    order = list(plan_cascade(flat)[2])
    return (
        torch.tensor(flat.switch_stt_ns[order], dtype=torch.float32, device=dev),
        torch.tensor(flat.discipline_codes()[order], dtype=torch.int32, device=dev),
        torch.tensor(flat.class_weight_table()[order], dtype=torch.float32, device=dev),
    )


def qos_inputs(flat, rows: int, n: int, seed: int, ties: bool, dev):
    """Integer arrival times, tie-free (unique below 2**22) or tie-heavy
    (about four events per integer), with each event a random pool's route
    word and a random class."""
    rng = np.random.default_rng(seed)
    if ties:
        t = rng.integers(0, max(2, n // 4), (rows, n))
    else:
        t = np.stack([rng.choice(1 << 22, size=n, replace=False) for _ in range(rows)])
    t = np.sort(t, axis=1).astype(np.float32)
    bits_pool = plan_cascade(flat)[0]
    bits = bits_pool[rng.integers(0, flat.n_pools, (rows, n))].astype(np.int32)
    qos = rng.integers(0, flat.n_qos_classes, (rows, n)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (t, bits, qos))


def qos_bound(t, bits, disc, n_classes, bytes_per_event, out_per_row):
    """Bound of one QoS cascade call on these inputs: the queued events of
    each stage times the scans that stage runs decide the operations."""
    nbytes = bytes_per_event * t.numel() + 4 * t.shape[0] * out_per_row
    scans = sum(
        int(((bits >> s) & 1).sum()) * (1 if int(d) == kref.DISC_FIFO else n_classes)
        for s, d in enumerate(disc.tolist())
    )
    return bound_ms(nbytes, OPS_PER_QUEUED_EVENT * scans)


def compare_qos(name, t, bits, qos, stts, disc, w, reps=20):
    """QoS cascade kernel vs plain on the same CUDA inputs."""
    tk, ik, pk = kcong.qos_congestion_cascade(t, bits, qos, stts, disc, w)
    fk = kcong.last_merge_flags
    tp, ip, pp = kref.qos_cascade_dyn(t, bits, stts, qos, disc, w)
    torch.cuda.synchronize()
    check(torch.equal(ik, ip), f"{name}: slot_idx differs from the plain version")
    torch.testing.assert_close(tk, tp, rtol=1e-6, atol=0.0)
    # per-class sums: double atomics in a run-dependent order (kernel) and an
    # f64 scatter-add (plain), both rounded to f32
    torch.testing.assert_close(pk, pp, rtol=1e-5, atol=0.0)
    check(bool(torch.isfinite(pk).all()), f"{name}: non-finite delays")
    err = float((tk - tp).abs().max())
    ms = median_ms(lambda: kcong.qos_congestion_cascade(t, bits, qos, stts, disc, w), reps)
    plain_ms = median_ms(lambda: kref.qos_cascade_dyn(t, bits, stts, qos, disc, w),
                         max(3, reps // 4))
    n_stages, n_classes = int(stts.shape[0]), int(w.shape[1])
    k = cascade_ctas(t)
    merges = check_mirror(name, fk, (tp, ip, pp),
                          kref.qos_cascade_partitioned(t, bits, stts, qos, disc, w, k))
    bms, by = qos_bound(t, bits, disc, n_classes, QOS_BYTES_PER_EVENT, n_stages * n_classes)
    row = dict(shape=list(t.shape), stages=n_stages, classes=n_classes,
               disciplines=disc.tolist(), stts=stts.tolist(), ctas=k, pad_share=pad_share(t),
               **merges, ms=ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, max_abs_err=err,
               delay_ns_per_class=[float(x) for x in pk.sum((0, 1, 2))])
    print(f"[kernel] {name}: {json.dumps(row)}")
    return row, (tk, ik, pk)


def compare_qos_fifo(name, t, bits, qos, stts, disc, w):
    """An all-FIFO QoS topology: the QoS kernel vs its plain version, and
    its final times bitwise equal to the FIFO cascade kernel's."""
    row, (tk, _, pk) = compare_qos(name, t, bits, qos, stts, disc, w)
    tf, _, pf = kcong.congestion_cascade(t, bits, stts)
    torch.cuda.synchronize()
    check(torch.equal(tk, tf), f"{name}: final times differ from the FIFO cascade kernel's")
    torch.testing.assert_close(pk.sum((2, 3)), pf, rtol=1e-6, atol=0.0)
    print(f"[kernel] {name}: final times bitwise equal to the FIFO cascade kernel's")
    return row


def compare_qos_hosts(name, t, bits, qos, hosts, stts, disc, w, n_hosts, reps=20):
    """Host-segmented QoS kernel vs plain, and vs the single-host QoS
    kernel's per-class totals, on the same CUDA inputs."""
    args = (t, bits, qos, hosts, stts, disc, w, n_hosts)
    tk, ik, pk = kcong.qos_congestion_cascade_hosts(*args)
    fk = kcong.last_merge_flags
    tp, ip, pp = kref.qos_cascade_dyn(t, bits, stts, qos, disc, w, hosts=hosts,
                                      n_hosts=n_hosts)
    _, i1, p1 = kcong.qos_congestion_cascade(t, bits, qos, stts, disc, w)
    f1 = kcong.last_merge_flags
    torch.cuda.synchronize()
    check(torch.equal(ik, ip), f"{name}: slot_idx differs from the plain version")
    check(torch.equal(ik, i1), f"{name}: slot_idx differs from the single-host QoS kernel")
    check(torch.equal(fk, f1), f"{name}: merge flags differ from the single-host QoS kernel's")
    torch.testing.assert_close(tk, tp, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(pk, pp, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(pk.sum(2, keepdim=True), p1, rtol=1e-6, atol=0.0)
    check(bool(torch.isfinite(pk).all()), f"{name}: non-finite delays")
    err = float((tk - tp).abs().max())
    ms = median_ms(lambda: kcong.qos_congestion_cascade_hosts(*args), reps)
    single_ms = median_ms(lambda: kcong.qos_congestion_cascade(t, bits, qos, stts, disc, w), reps)
    plain_ms = median_ms(
        lambda: kref.qos_cascade_dyn(t, bits, stts, qos, disc, w, hosts=hosts,
                                     n_hosts=n_hosts),
        max(3, reps // 4),
    )
    n_stages, n_classes = int(stts.shape[0]), int(w.shape[1])
    k = cascade_ctas(t)
    merges = check_mirror(name, fk, (tp, ip, pp), kref.qos_cascade_partitioned(
        t, bits, stts, qos, disc, w, k, hosts=hosts, n_hosts=n_hosts))
    bms, by = qos_bound(t, bits, disc, n_classes, QOS_HOSTS_BYTES_PER_EVENT,
                        n_stages * n_hosts * n_classes)
    row = dict(shape=list(t.shape), stages=n_stages, hosts=n_hosts, classes=n_classes,
               disciplines=disc.tolist(), ctas=k, pad_share=pad_share(t), **merges, ms=ms,
               single_host_ms=single_ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, max_abs_err=err,
               psd_max_rel_err=float(((pk - pp).abs() / pp.abs().clamp(min=1e-30)).max()),
               delay_ns_per_host_class=pk.sum((0, 1)).tolist())
    print(f"[kernel] {name}: {json.dumps(row)}")
    return row


def qos_kernel_phase(dev, shape=(32, 131072)):
    """Phase 3, QoS part: the QoS kernels vs their plain versions at
    synthetic shapes (``shape`` the full-size batch)."""
    rows = []
    flat = qos_chain(("wfq", "priority", "fifo")).flatten()
    stts, disc, w = qos_tables(flat, dev)
    for ties in (False, True):
        t, bits, qos = qos_inputs(flat, 4, 3000, 7, ties, dev)
        name = f"qos_ragged_mixed_{'ties' if ties else 'tie_free'}"
        rows.append(compare_qos(name, t, bits, qos, stts, disc, w)[0])
    for discs in (("wfq",) * 3, ("priority",) * 3):
        flat = qos_chain(discs).flatten()
        stts, disc, w = qos_tables(flat, dev)
        for ties in (False, True):
            t, bits, qos = qos_inputs(flat, *shape, 8, ties, dev)
            name = f"qos_{discs[0]}x3_{'ties' if ties else 'tie_free'}"
            rows.append(compare_qos(name, t, bits, qos, stts, disc, w, reps=10)[0])
    fig = figure1_topology()
    fig3 = Topology(fig.pools, fig.switches, fig.rc_latency_ns, fig.rc_bandwidth_gbps,
                    fig.rc_stt_ns, fig.local_dram_latency_ns, n_qos_classes=3).flatten()
    stts, disc, w = qos_tables(fig3, dev)
    t, _ = synthetic_times(*shape, 9, dev)
    rng = np.random.default_rng(9)
    bits_pool = plan_cascade(fig3)[0]
    bits = torch.from_numpy(
        bits_pool[rng.integers(0, fig3.n_pools, shape)].astype(np.int32)).to(dev)
    qos = torch.from_numpy(rng.integers(0, 3, shape).astype(np.int32)).to(dev)
    rows.append(compare_qos_fifo("qos_figure1_all_fifo", t, bits, qos, stts, disc, w))
    # stages (wfq, wfq with zero service, priority, fifo): the fold after
    # stage 0 is elided, so the row is out of order at the unscanned stage 1
    # and the kernel's own pass for the fold's runs must run there (4 CTAs a
    # row)
    flat = qos_chain(("priority", "wfq", "wfq")).flatten()
    stts, disc, w = qos_tables(flat, dev)
    stts[1] = 0.0
    t, bits, qos = qos_inputs(flat, 8, 16384, 10, True, dev)
    rows.append(compare_qos("qos_zero_service_ties", t, bits, qos, stts, disc, w)[0])
    return rows


def qos_hosts_kernel_phase(dev):
    """Phase 3, host-segmented QoS part: pooled_topology(n_hosts=8) under
    priority with 2 classes, tie-heavy, in one row of 2**20 events (the most
    CTAs a row) and in 256 rows of 4096 (one CTA a row); and 16 hosts, 32
    (host, class) slots, more than the kernel's per-thread columns."""
    rows = []
    for name, hosts_n, (b, n), ties, seed in (
        ("qos_hosts_pooled8_ties", 8, (32, 131072), True, 11),
        ("qos_hosts_pooled8_one_row", 8, (1, 1048576), False, 12),
        ("qos_hosts_pooled8_many_rows", 8, (256, 4096), False, 13),
        ("qos_hosts_pooled16_ties", 16, (8, 16384), True, 14),
    ):
        flat = pooled_topology(n_hosts=hosts_n, discipline="priority",
                               class_weights=(1.0, 1.0)).flatten()
        stts, disc, w = qos_tables(flat, dev)
        t, bits, hosts, _ = fabric_inputs(flat, b, n, seed, dev, ties=ties)
        qos = torch.from_numpy(
            np.random.default_rng(seed).integers(0, 2, (b, n)).astype(np.int32)).to(dev)
        rows.append(compare_qos_hosts(name, t, bits, qos, hosts, stts, disc, w, flat.n_hosts,
                                      reps=10))
    return rows


def staged_batch(traces, flat, dev, b_bucket=None, n_bucket=None):
    """A batch's cascade inputs, staged exactly as the analyzer stages them
    (time-sorted rows, pads at finfo.max/4 with no route), with each
    event's virtual pool and host; ``b_bucket`` rows of ``n_bucket`` events
    (default: the analyzer's buckets of this batch)."""
    n_bucket = n_bucket or bucket_pow2(max(tr.n for tr in traces))
    b_bucket = b_bucket or bucket_pow2(len(traces), floor=1)
    buf = EventStager(np.float32).stage(traces, b_bucket, n_bucket)
    valid = torch.from_numpy(buf["valid"]).to(dev)
    pool = torch.from_numpy(buf["pool"]).to(dev).long()
    hosts = torch.from_numpy(buf["host"]).to(dev)
    vp = hosts.long() * flat.n_pools + pool
    big = torch.finfo(torch.float32).max / 4
    t_cur = torch.where(valid, torch.from_numpy(buf["t"]).to(dev), big).contiguous()
    qos = torch.where(valid, torch.from_numpy(buf["qos"]).to(dev), 0).contiguous()
    out = dict(t=t_cur, hosts=hosts.contiguous(), vp=vp, valid=valid, qos=qos)
    if flat.n_switches <= kcong.MAX_STAGES:
        bits_pool, _, order = plan_cascade(flat)
        out["bits"] = torch.where(valid, torch.from_numpy(bits_pool).to(dev)[vp], 0).contiguous()
        out["stts"] = torch.tensor(flat.switch_stt_ns[list(order)], dtype=torch.float32,
                                   device=dev)
    return out


EXPAND_ROWS = []  # every compare_expand row, for the kernels line


def compare_expand(name, traces, flat, qos, dev, reps=20):
    """The expansion kernel against its plain version (ref.expand_events,
    on the card too) on the same CUDA columns, staged from ``traces`` as the
    default dispatch stages them for ``flat`` (a host column when it has
    several hosts; a QoS column with ``qos``), at the analyzer's buckets:
    every plane bitwise the plain version's and the host fill's
    (EventStager.stage), then both timed on the card beside the bound (each
    real event's columns read once, every slot of every plane written
    once)."""
    hosts = flat.n_hosts > 1
    b_bucket = bucket_pow2(len(traces), floor=1)
    n_bucket = bucket_pow2(max(tr.n for tr in traces))
    slot = EventStager(np.float32).stage_compact(
        traces, b_bucket, flat.n_hosts * flat.n_pools, hosts=hosts, qos=qos, device=dev)
    words = slot["words"][: slot["n_words"]].to(dev)
    col = EventStager.compact_columns(slot, words)
    args = (col["t"], col["offsets"], col["pool"], col["bytes"], col["weight"],
            col.get("host"), col.get("qos"), n_bucket, slot["longest"])
    n0 = kexpand.expand_launches
    got = kops.expand_events(*args)
    check(kexpand.expand_launches == n0 + 1, f"{name}: the kernel did not launch once")
    plain = kref.expand_events(*args)
    full = EventStager(np.float32).stage(traces, b_bucket, n_bucket, qos=qos)
    torch.cuda.synchronize()

    def bits(x):
        return x if x.dtype == torch.bool else x.view(torch.int32)

    planes = ("t", "pool", "bytes", "weight", "host", "qos", "valid")
    for plane, g, p in zip(planes, got, plain):
        check((g is None) == (p is None) == ((plane == "host" and not hosts)
                                              or (plane == "qos" and not qos)),
              f"{name}: the {plane} plane is made where it should not be, or not made")
        if g is None:
            continue
        host_fill = torch.from_numpy(full[plane]).to(dev)
        check(torch.equal(bits(g), bits(p)), f"{name}: the {plane} plane differs from the "
              "plain version's")
        check(torch.equal(bits(g), bits(host_fill)), f"{name}: the {plane} plane differs from "
              "the host fill's")
    del got, plain, full
    ms = device_ms(lambda: kops.expand_events(*args), 2 * reps)
    plain_ms = median_ms(lambda: kref.expand_events(*args), max(3, reps // 4))
    events = int(slot["offsets"][-1])
    n_planes = 4 + hosts + qos
    nbytes = EXPAND_WORD_BYTES * (n_planes * events + b_bucket + 1) + b_bucket * n_bucket * (
        EXPAND_WORD_BYTES * n_planes + 1)
    bms, by = bound_ms(nbytes, 0)
    row = dict(shape=[b_bucket, n_bucket], events=events,
               real_share=events / (b_bucket * n_bucket), planes=n_planes + 1, ms=ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by, bound_share=bms / ms,
               gb_per_s=nbytes / (ms / MS_PER_S) / 1e9, h2d_bytes=4 * slot["n_words"],
               max_abs_err=0.0)
    print(f"[kernel] {name}: {json.dumps(row)}")
    EXPAND_ROWS.append(row)
    return row


def expand_kernel_phase(dev):
    """The expansion on a ragged QoS batch of 3 hosts (an empty row, a
    one-event row, rows past the batch) and at the pooled fabric's width:
    33 time-sorted rows of POOL8_ROWS events on 8 hosts, in [64, 524288]
    planes.  Returns the wide batch's row."""
    rng = np.random.default_rng(17)

    def traces(lengths, n_hosts, n_classes):
        out = []
        for n in lengths:
            out.append(MemEvents(
                t_ns=np.sort(rng.uniform(0.0, 4e6, n)), pool=rng.integers(0, 4, n).astype(np.int32),
                bytes_=rng.choice([64.0, 128.0, 4096.0], n), is_write=rng.random(n) < 0.3,
                region=np.zeros(n, np.int32), weight=rng.uniform(0.5, 2.0, n),
                host=rng.integers(0, n_hosts, n).astype(np.int32),
                qos=rng.integers(0, n_classes, n).astype(np.int32)))
        return out

    topo = figure1_topology()
    fig3 = Topology(topo.pools, topo.switches, topo.rc_latency_ns, topo.rc_bandwidth_gbps,
                    topo.rc_stt_ns, topo.local_dram_latency_ns, n_hosts=3).flatten()
    compare_expand("expand_ragged_qos", traces((2999, 0, 1, 3000, 1234), 3, 3), fig3, True, dev)
    return compare_expand("expand_pool8_width", traces(POOL8_ROWS, FABRIC_HOSTS, 1),
                          pooled_topology(n_hosts=FABRIC_HOSTS).flatten(), False, dev, reps=10)


def oracle(flat, traces, n_windows=128, bw_window_ns=10_000.0, scales=None):
    """analyze_ref (f64) over the epochs, each with the analyzer's
    effective span-scaled window and its latency-scale row (``scales``,
    None entries or None: unscaled); summed totals and per-host arrays."""
    tot = None
    for i, tr in enumerate(traces):
        span = max(float(tr.t_ns.max()) + 1.0, bw_window_ns)
        bd = analyze_ref(flat, tr, bw_window_ns=max(span / n_windows, 1.0),
                         n_windows=n_windows, lat_scale=None if scales is None else scales[i])
        tot = bd if tot is None else tot + bd
    return tot


def check_totals(tag, got, want, steps, keys=("latency_s", "congestion_s", "bandwidth_s")):
    """Report totals (s) against the oracle's per-step totals (ns) times
    the steps, at the fused cascade's bar."""
    tol = {"latency_s": (1e-4, 1e-3), "congestion_s": (1e-3, 1e-2),
           "bandwidth_s": (1e-2, 1.0)}
    tol = {k: tol[k] for k in keys}
    ref = {"latency_s": want.latency_ns, "congestion_s": want.congestion_ns,
           "bandwidth_s": want.bandwidth_ns}
    for k, (rel, absol) in tol.items():
        g, w = s_to_ns(getattr(got, k)), steps * ref[k]
        check(np.isfinite(g), f"{tag} {k} is not finite")
        check(abs(g - w) <= max(rel * abs(w), absol),
              f"{tag} {k}: {g} ns vs analyze_ref {w} ns")
        print(f"[{tag}] {k}: {g!r} ns, analyze_ref {w!r} ns, "
              f"rel err {abs(g - w) / max(abs(w), 1e-30):.3e}")


def fabric_session(n_hosts, load, events_per_access, dev, classes=None, migration=None,
                   cache=None, pipeline=False, engine=None, async_analysis=True, **topo_kw):
    """n_hosts trace-only qwen3-0.6b tenants pooling their KV caches, tenant
    h in QoS class ``classes[h]`` (0 without ``classes``), with
    ``migration``, ``cache``, ``pipeline``, ``engine`` and
    ``async_analysis`` (the session's default: overlapped rounds) given to
    the session."""
    tenants = []
    for h in range(n_hosts):
        regions, phases = build_regions_and_phases(CONFIG, **load)
        tenants.append(Tenant(f"tenant{h}", phases, regions, ClassMapPolicy(FABRIC_POLICY),
                              qos_class=classes[h] if classes else 0))
    return FabricSession(
        pooled_topology(n_hosts=n_hosts, **topo_kw), tenants, epoch=EpochSchedule("layer"),
        hw=H100_SXM, coherency=CoherencyConfig(shared_classes=("kvcache",)),
        max_events_per_access=events_per_access, device=dev, migration=migration, cache=cache,
        pipeline=pipeline, engine=engine, async_analysis=async_analysis,
    )


class Timed:
    """Wrap ``fn`` and record the host seconds of each call; with ``keep``
    also keep each call's result."""

    def __init__(self, fn, keep=False):
        self.fn, self.keep, self.calls, self.out = fn, keep, [], []

    @property
    def seconds(self) -> float:
        return float(sum(self.calls))

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        self.calls.append(time.perf_counter() - t0)
        if self.keep:
            self.out.append(out)
        return out


EXPAND_LAUNCHED = [0]  # the expansion's launches before the last reset_counts


def reset_counts():
    kcong.launches = kcong.hosts_launches = kcong.scan_launches = 0
    kcong.qos_launches = kcong.qos_hosts_launches = 0
    kssd.ssd_launches = 0
    kflash.flash_launches = 0
    EXPAND_LAUNCHED[0] += kexpand.expand_launches
    kexpand.expand_launches = 0
    kops.plain_launches = 0


def counts():
    """The launches since reset_counts by kernel; ``expand`` is the
    expansion's, one a default-path dispatch."""
    return dict(cascade=kcong.launches, hosts=kcong.hosts_launches,
                scan=kcong.scan_launches, qos=kcong.qos_launches,
                qos_hosts=kcong.qos_hosts_launches, ssd=kssd.ssd_launches,
                flash=kflash.flash_launches, expand=kexpand.expand_launches,
                plain=kops.plain_launches)


def check_launches(tag, c, kernel, want, **also):
    """Exactly ``want`` launches of ``kernel`` (and ``also[k]`` of kernel k)
    and none of anything else."""
    wants = {kernel: want, **also}
    for k, w in wants.items():
        check(c[k] == w, f"{tag}: {k} launched {c[k]} times, want {w}")
    others = {k: v for k, v in c.items() if k not in wants and v}
    check(not others, f"{tag}: other kernels or the plain path ran: {others}")


def profile_batch(tag, an, traces, rows=12):
    """Host staging on the host clock, as the default dispatch stages (the
    compact slot of the batch's real events), then one analyze_batch under
    torch.profiler (the ``rows`` ops with the most device time)."""
    stager = EventStager(np.float32)
    H, P = an.flat.n_hosts, an.flat.n_pools
    shape = (bucket_pow2(len(traces), floor=1), bucket_pow2(max(tr.n for tr in traces)))

    def stage():
        return stager.stage_compact(traces, shape[0], H * P, hosts=H > 1, qos=an.qos_on,
                                    device=an.device)

    stage()  # first call allocates the slot
    t0 = time.perf_counter()
    slot = stage()
    print(f"[{tag}] host staging {time.perf_counter() - t0:.6f} s per batch {list(shape)} "
          f"(compact: {4 * slot['n_words']} bytes)")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        an.analyze_batch(traces)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
    print(f"[{tag}] analyze_batch {batch_s:.6f} s under the profiler")
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=rows))


def main_step(dev):
    """The main paths' attached program: a bf16 stand-in for the qwen3-0.6b
    training step (the config's SwiGLU MLP products, random weights from
    seed 0) and its input."""
    gen = torch.Generator(device=dev).manual_seed(0)
    d, f, bf16 = CONFIG.d_model, CONFIG.d_ff, torch.bfloat16
    weights = [
        (
            torch.randn(d, f, generator=gen, device=dev, dtype=bf16) * d ** -0.5,
            torch.randn(d, f, generator=gen, device=dev, dtype=bf16) * d ** -0.5,
            torch.randn(f, d, generator=gen, device=dev, dtype=bf16) * f ** -0.5,
        )
        for _ in range(CONFIG.n_layers)
    ]
    x = torch.randn(8 * 4096, d, generator=gen, device=dev, dtype=bf16)

    def step(h):
        # stand-in for the model: the config's SwiGLU MLP products, bf16
        for wi, wu, wo in weights:
            h = h + (torch.nn.functional.silu(h @ wi) * (h @ wu)) @ wo
        return h

    return step, x


def attach_main(topology, step, cfg=CONFIG, **sim_kw):
    """CXLMemSim attached to ``step`` with ``cfg``'s (qwen3-0.6b's)
    layer-epoch trace (8 x 4096 tokens) on ``topology``, with ``sim_kw``
    given to it."""
    regions, phases = build_regions_and_phases(cfg, "train", batch=8, seq=4096)
    sim = CXLMemSim(
        topology, ClassMapPolicy(POLICY), epoch=EpochSchedule("layer"),
        hw=H100_SXM, max_events_per_access=1024, check_capacity=False, device="cuda", **sim_kw,
    )
    return sim.attach(step, phases, regions)


def slice1_main_path(dev, step, x):
    """Phase 4: the attached qwen3-0.6b training step on figure1."""
    prog = attach_main(figure1_topology(), step)
    traces = prog.epoch_traces()
    n_max = max(tr.n for tr in traces)
    print(f"[main] {len(traces)} epochs, up to {n_max} events, "
          f"{sum(tr.n for tr in traces)} events per step")
    b = staged_batch(traces, prog.sim.flat, dev)
    main_row = compare("main_batch", b["t"], b["bits"], b["stts"])
    compare_expand("main_expand", traces, prog.sim.flat, False, dev)

    # one warm-up step takes the first-use costs (staging planes, caching
    # allocator, GEMM setup) out of the 3 measured steps
    prog.step(x)
    warm_analyzer_s, warm_native_s = prog.report.analyzer_s, prog.report.native_s
    reset_counts()
    rep = prog.run(3, x)
    c = counts()
    check_launches("main", c, "cascade", 3, expand=3)

    want = oracle(prog.sim.flat, traces)
    check_totals("main", rep, want, rep.steps)
    # both switches queue; the RC cannot: every event through it has just
    # left switch0, spaced >= 2 ns apart, and the RC's STT is 0.5 ns
    names = prog.sim.flat.switch_names
    psc = dict(zip(names, rep.per_switch_congestion_ns.tolist()))
    check(psc["switch0"] > 0 and psc["switch1"] > 0, f"a switch never queued: {psc}")
    print(f"[main] per-switch congestion ns {json.dumps(psc)}")
    print(f"[main] summary {json.dumps(rep.summary())}")
    print(f"[main] analyzer {(rep.analyzer_s - warm_analyzer_s) / 3:.6f} s/step and "
          f"native {(rep.native_s - warm_native_s) / 3:.6f} s/step over the 3 "
          f"measured steps; warm-up step analyzer {warm_analyzer_s:.6f} s, "
          f"native {warm_native_s:.6f} s")
    profile_batch("profile", prog._analyzer, traces)
    per_step = dict(native_s=(rep.native_s - warm_native_s) / 3,
                    analyzer_s=(rep.analyzer_s - warm_analyzer_s) / 3)
    return main_row, c["cascade"], rep, want, per_step


def fabric_main_path(dev):
    """Phase 5: the 8-tenant KV-pooling fabric through FabricSession,
    synchronous (phase 15's engine-fabric8 runs it under the default)."""
    t0 = time.perf_counter()
    sess = fabric_session(FABRIC_HOSTS, FABRIC_LOAD, FABRIC_EVENTS_PER_ACCESS, "cuda",
                          async_analysis=False)
    merge_s = sess._merged_round = Timed(sess._merged_round)
    check(sess._analyzer.fused, "the 8-host fabric must run the fused cascade")
    print(f"[fabric] {sess.flat.n_switches} stages "
          f"({', '.join(sess.flat.switch_names)}), session set-up "
          f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    sess.round()  # warm-up: tracing, merging, first-use costs
    warm = sess.report
    warm_s, warm_analyzer_s = time.perf_counter() - t0, warm.analyzer_s
    merged = sess._round_cache[0]
    n_max = max(tr.n for tr in merged)
    print(f"[fabric] {len(merged)} merged epochs, up to {n_max} events, "
          f"{sum(tr.n for tr in merged)} events per round; warm-up round {warm_s:.3f} s "
          f"(merge {merge_s.calls[0]:.3f} s, analyzer {warm_analyzer_s:.6f} s)")

    reset_counts()
    rep = sess.run(3)
    c = counts()
    check_launches("fabric", c, "hosts", 3, expand=3)
    check(rep.rounds == 4 and rep.bi_messages > 0, f"rounds {rep.rounds}, BI {rep.bi_messages}")

    flat = sess.flat
    ref = oracle(flat, merged)
    check_totals("fabric", rep, ref, rep.rounds)
    lat_h = np.array([s_to_ns(h.latency_s) for h in rep.hosts])
    cong_h = np.array([s_to_ns(h.congestion_s) for h in rep.hosts])
    bw_h = np.array([s_to_ns(h.bandwidth_s) for h in rep.hosts])
    np.testing.assert_allclose(lat_h, rep.rounds * ref.per_host_latency_ns, rtol=1e-4)
    np.testing.assert_allclose(cong_h, rep.rounds * ref.per_host_congestion_ns, rtol=5e-3)
    for name, per_host, total in (("latency", lat_h, rep.latency_s),
                                  ("congestion", cong_h, rep.congestion_s),
                                  ("bandwidth", bw_h, rep.bandwidth_s)):
        check(abs(per_host.sum() - s_to_ns(total)) <= max(1e-4 * s_to_ns(total), 1e-2),
              f"per-host {name} {per_host.sum()} ns does not close on {s_to_ns(total)} ns")
    psc = dict(zip(flat.switch_names, rep.per_switch_congestion_ns.tolist()))
    check(psc["fabric_sw"] > 0, f"the shared switch never queued: {psc}")
    print(f"[fabric] per-host latency ns {lat_h.tolist()}")
    print(f"[fabric] per-host congestion ns {cong_h.tolist()}, analyze_ref "
          f"{(rep.rounds * ref.per_host_congestion_ns).tolist()}")
    print(f"[fabric] per-switch congestion ns {json.dumps(psc)}")
    print(f"[fabric] bi_messages {rep.bi_messages!r}, coherency {rep.coherency_s!r} s")
    print(f"[fabric] summary {json.dumps(rep.summary())}")
    print(f"[fabric] analyzer {(rep.analyzer_s - warm_analyzer_s) / 3:.6f} s/round over "
          f"the 3 measured rounds; merge (replayed) "
          f"{float(np.mean(merge_s.calls[1:])):.6f} s/round")

    b = staged_batch(merged, flat, dev)
    row = compare_hosts("fabric_batch", b["t"], b["bits"], b["hosts"], b["stts"],
                        flat.n_hosts)
    compare_expand("fabric_expand", merged, flat, False, dev)
    profile_batch("fabric-profile", sess._analyzer, merged)
    return row, c["hosts"], rep


def wide_fabric_path(dev):
    """Phase 6: 32 hosts, 33 stages: the unfused per-stage loop,
    synchronous."""
    t0 = time.perf_counter()
    sess = fabric_session(WIDE_HOSTS, WIDE_LOAD, WIDE_EVENTS_PER_ACCESS, "cuda",
                          async_analysis=False)
    merge_s = sess._merged_round = Timed(sess._merged_round)
    check(not sess._analyzer.fused, "the 32-host fabric must fall back to the unfused loop")
    stages = sess.flat.n_switches
    print(f"[wide] {stages} stages, session set-up {time.perf_counter() - t0:.3f} s")
    reset_counts()
    t0 = time.perf_counter()
    rep = sess.run(2)
    wall = time.perf_counter() - t0
    c = counts()
    merged = sess._round_cache[0]
    print(f"[wide] {len(merged)} merged epochs, up to {max(tr.n for tr in merged)} "
          f"events, {sum(tr.n for tr in merged)} per round; merge {merge_s.calls[0]:.3f} s "
          f"(first round)")
    check_launches("wide", c, "scan", stages * 2, expand=2)
    flat = sess.flat
    ref = oracle(flat, merged)
    for k, rel, absol in (("latency", 1e-4, 1e-3), ("congestion", 1e-3, 1e-3)):
        g = s_to_ns(getattr(rep, f"{k}_s"))
        w = rep.rounds * getattr(ref, f"{k}_ns")
        check(abs(g - w) <= max(rel * abs(w), absol), f"wide {k}: {g} ns vs {w} ns")
        print(f"[wide] {k}: {g!r} ns, analyze_ref {w!r} ns, "
              f"rel err {abs(g - w) / max(abs(w), 1e-30):.3e}")
    check(rep.congestion_s > 0 and len(rep.hosts) == WIDE_HOSTS, "wide fabric never queued")
    print(f"[wide] analyzer {rep.analyzer_s / 2:.6f} s/round, 2 rounds in {wall:.3f} s")

    b = staged_batch(merged, flat, dev)
    s0 = int(flat.stage_order()[0])
    routed = torch.from_numpy(flat.route[:, s0] > 0).to(dev)
    mask = (routed[b["vp"]] & b["valid"]).contiguous()
    stt = float(np.float32(flat.switch_stt_ns[s0]))
    name = f"wide_stage_{flat.switch_names[s0]}"
    row = compare_scan(name, b["t"], mask, stt)
    check_scan_repeats(name, b["t"], mask, stt)
    del b, routed, mask
    compare_expand("wide_expand", merged, flat, False, dev)
    profile_batch("wide-profile", sess._analyzer, merged, rows=20)
    return row, c["scan"], rep


def qos_main_path(dev, step, x, fifo_rep):
    """Phase 7: phase 4 on figure1 re-declared with strict-priority switches
    and 2 classes."""
    fig = figure1_topology()
    topo = Topology(
        fig.pools, [dataclasses.replace(sw, discipline="priority") for sw in fig.switches],
        fig.rc_latency_ns, fig.rc_bandwidth_gbps, fig.rc_stt_ns, fig.local_dram_latency_ns,
        n_qos_classes=2,
    )
    prog = attach_main(topo, step)
    flat = prog.sim.flat
    check(flat.has_qos and prog._analyzer.qos_on, "qos-main must take the QoS cascade")
    traces = prog.epoch_traces()
    b = staged_batch(traces, flat, dev)
    stts, disc, w = qos_tables(flat, dev)
    row, _ = compare_qos("qos_main_batch", b["t"], b["bits"], b["qos"], stts, disc, w)
    compare_expand("qos_main_expand", traces, flat, True, dev)
    prog.step(x)
    warm_analyzer_s = prog.report.analyzer_s
    reset_counts()
    rep = prog.run(3, x)
    c = counts()
    check_launches("qos-main", c, "qos", 3, expand=3)
    check_totals("qos-main", rep, oracle(flat, traces), rep.steps)
    for k in ("latency_s", "congestion_s"):
        g, w_ = getattr(rep, k), getattr(fifo_rep, k)
        check(abs(g - w_) <= 1e-6 * abs(w_), f"qos-main {k} {g!r} != phase 4's {w_!r}")
    pcc = rep.per_class_congestion_ns
    check(pcc.shape == (2,) and pcc[1] == 0.0, f"class 1 carries congestion: {pcc}")
    check(abs(pcc.sum() - s_to_ns(rep.congestion_s)) <= 1e-6 * s_to_ns(rep.congestion_s),
          f"per-class congestion {pcc} does not close on {s_to_ns(rep.congestion_s)} ns")
    print(f"[qos-main] equal to phase 4: latency {rep.latency_s!r} s, congestion "
          f"{rep.congestion_s!r} s (phase 4: {fifo_rep.congestion_s!r} s), bandwidth "
          f"{rep.bandwidth_s!r} s (phase 4: {fifo_rep.bandwidth_s!r} s)")
    print(f"[qos-main] per-class congestion ns {pcc.tolist()}")
    print(f"[qos-main] analyzer {(rep.analyzer_s - warm_analyzer_s) / 3:.6f} s/step over "
          f"the 3 measured steps; warm-up step analyzer {warm_analyzer_s:.6f} s")
    profile_batch("qos-main-profile", prog._analyzer, traces)
    return row, c["qos"], rep


def qos_fabric_session(tag, dev, fifo_rep, discipline, weights, rounds):
    """Phase 8: phase 5's tenants in two classes on a QoS fabric,
    synchronous.  Under
    priority class 0 must gain on phase 5's FIFO run; WFQ's per-class
    servers run at their weight's share of the switch whether or not the
    other class is busy, so there it is only printed."""
    t0 = time.perf_counter()
    sess = fabric_session(FABRIC_HOSTS, FABRIC_LOAD, FABRIC_EVENTS_PER_ACCESS, "cuda",
                          classes=FABRIC_CLASSES, discipline=discipline,
                          class_weights=weights, async_analysis=False)
    merge_s = sess._merged_round = Timed(sess._merged_round)
    check(sess._analyzer.fused and sess._analyzer.qos_on,
          f"{tag}: the QoS fabric must run the fused QoS cascade")
    sess.round()  # warm-up
    warm_s, warm_analyzer_s = time.perf_counter() - t0, sess.report.analyzer_s
    reset_counts()
    rep = sess.run(rounds)
    c = counts()
    check_launches(tag, c, "qos_hosts", rounds, expand=rounds)
    merged = sess._round_cache[0]
    flat = sess.flat
    ref = oracle(flat, merged)
    check_totals(tag, rep, ref, rep.rounds)
    lat_h = np.array([s_to_ns(h.latency_s) for h in rep.hosts])
    cong_h = np.array([s_to_ns(h.congestion_s) for h in rep.hosts])
    np.testing.assert_allclose(lat_h, rep.rounds * ref.per_host_latency_ns, rtol=1e-4)
    np.testing.assert_allclose(cong_h, rep.rounds * ref.per_host_congestion_ns, rtol=5e-3)
    pcc = rep.per_class_congestion_ns
    np.testing.assert_allclose(pcc, rep.rounds * ref.per_class_congestion_ns, rtol=5e-3)
    cong = s_to_ns(rep.congestion_s)
    check(abs(pcc.sum() - cong) <= 1e-6 * cong,
          f"{tag}: per-class congestion {pcc} does not close on {cong} ns")
    fifo_h = np.array([s_to_ns(h.congestion_s) / fifo_rep.rounds for h in fifo_rep.hosts])
    qos_h = cong_h / rep.rounds
    crit = [h for h, cls in enumerate(FABRIC_CLASSES) if cls == 0]
    # identical tenants tie exactly and ties queue the lower host first, so
    # host 0 waits only behind itself under FIFO too: no class-0 tenant may
    # lose, and together they must gain
    check(discipline != "priority"
          or (all(qos_h[h] <= fifo_h[h] * (1 + 1e-6) for h in crit)
              and qos_h[crit].sum() < fifo_h[crit].sum()),
          f"{tag}: class 0 did not gain: {qos_h[crit]} vs FIFO {fifo_h[crit]} ns/round")
    print(f"[{tag}] class-0 tenants' congestion per round {qos_h[crit].tolist()} ns, "
          f"under FIFO (phase 5) {fifo_h[crit].tolist()} ns")
    print(f"[{tag}] per-host congestion ns/round {qos_h.tolist()}")
    print(f"[{tag}] per-class congestion ns {pcc.tolist()}, analyze_ref "
          f"{(rep.rounds * ref.per_class_congestion_ns).tolist()}, shares "
          f"{rep.qos_delay_shares()}")
    print(f"[{tag}] analyzer {(rep.analyzer_s - warm_analyzer_s) / rounds:.6f} s/round over "
          f"the {rounds} measured rounds; warm-up round {warm_s:.3f} s (merge "
          f"{merge_s.calls[0]:.3f} s, analyzer {warm_analyzer_s:.6f} s)")
    return sess, merged, c["qos_hosts"]


def qos_fabric_path(dev, fifo_rep):
    """Phase 8: the priority fabric (3 rounds), its batch against the plain
    version, then the WFQ fabric (2 rounds)."""
    sess, merged, launches = qos_fabric_session(
        "qos-fabric", dev, fifo_rep, "priority", (1.0, 1.0), 3)
    flat = sess.flat
    b = staged_batch(merged, flat, dev)
    stts, disc, w = qos_tables(flat, dev)
    row = compare_qos_hosts("qos_fabric_batch", b["t"], b["bits"], b["qos"], b["hosts"],
                            stts, disc, w, flat.n_hosts)
    profile_batch("qos-fabric-profile", sess._analyzer, merged)
    del sess, merged, b
    qos_fabric_session("qos-fabric-wfq", dev, fifo_rep, "wfq", (4.0, 1.0), 2)
    return row, launches


# --------------------------------------------------------------------------- #
# Migration, the device cache and the model zoo's memory programs
# --------------------------------------------------------------------------- #


def recording_cascade():
    """Record the slot indices of every FIFO cascade the analyzer runs;
    returns (records, restore).  The ops entry point is wrapped, so the
    kernels' launch counts are untouched."""
    inner = kops.congestion_cascade
    records = []

    def recorder(t, bits, stts, *args, **kwargs):
        out = inner(t, bits, stts, *args, **kwargs)
        records.append(out[1].clone())
        return out

    def restore():
        kops.congestion_cascade = inner

    kops.congestion_cascade = recorder
    return records, restore


def totals(rep):
    """A report's delay totals and per-pool / per-switch arrays."""
    return {k: np.array(getattr(rep, k), copy=True) for k in DELAY_KEYS}


def delta(after, before):
    """The three delay totals between two :func:`totals` snapshots."""
    return types.SimpleNamespace(**{k: float(after[k]) - float(before[k])
                                    for k in ("latency_s", "congestion_s", "bandwidth_s")})


def check_like(tag, got, want, latency=True):
    """Congestion (and, with ``latency``, latency), totals and arrays,
    bitwise equal to ``want``'s; bandwidth to rel 1e-6 (its window sums are
    f32 scatter-adds, whose atomics add in a run-dependent order on the
    card).  Returns the bandwidth's relative difference."""
    exact = [k for k in DELAY_KEYS if "bandwidth" not in k and (latency or "latency" not in k)]
    for k in exact:
        check(np.array_equal(got[k], want[k]), f"{tag}: {k} {got[k]!r} != {want[k]!r}")
    g, w = float(got["bandwidth_s"]), float(want["bandwidth_s"])
    rel = abs(g - w) / max(abs(w), 1e-30)
    check(rel <= 1e-6, f"{tag}: bandwidth {g!r} s vs {w!r} s, rel {rel:.3e}")
    np.testing.assert_allclose(got["per_switch_bandwidth_ns"], want["per_switch_bandwidth_ns"],
                               rtol=1e-6)
    print(f"[{tag}] {', '.join(exact)} bitwise equal; bandwidth {g!r} s against {w!r} s "
          f"(rel {rel:.3e})")
    return rel


def check_slots(tag, got, want):
    """Every cascade call's slot indices bitwise equal to ``want``'s."""
    check(len(got) == len(want), f"{tag}: {len(got)} cascade calls, want {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.shape == b.shape and bool(torch.equal(a, b)),
              f"{tag}: the slot indices of cascade call {i} differ")
    print(f"[{tag}] slot indices of all {len(got)} cascade calls bitwise equal")


def attach_migrating(step, migration=None, cache=None):
    """Phase 4's program and placement with ``migration`` (a MigrationConfig:
    a MigrationSimulator over the placed regions, whose homes are then the
    policy's) and ``cache``, its pre-analysis stages timed and each analyzed
    batch (epochs and scale rows) kept."""
    regions, phases = build_regions_and_phases(CONFIG, "train", batch=8, seq=4096)
    topology = figure1_topology()
    sim_kw = {}
    if migration is not None:
        flat = topology.flatten()
        ClassMapPolicy(POLICY).place(regions, flat)
        sim_kw["migration"] = MigrationSimulator(migration, regions, flat)
    # synchronous: each analyzed batch is kept through analyze_batch, which
    # the engine's overlapped path bypasses (it calls launch_batch)
    sim = CXLMemSim(
        topology, ClassMapPolicy(POLICY), epoch=EpochSchedule("layer"), hw=H100_SXM,
        max_events_per_access=1024, check_capacity=False, device="cuda", cache=cache,
        async_analysis=False, **sim_kw,
    )
    prog = sim.attach(step, phases, regions)
    timers = {"pre": Timed(prog._epoch_batch), "synthesis": Timed(prog._traces)}
    prog._epoch_batch, prog._traces = timers["pre"], timers["synthesis"]
    if migration is not None:
        m = prog.sim.migration
        timers["migration"] = m.observe_and_migrate = Timed(m.observe_and_migrate)
    if prog._cache is not None:
        timers["cache"] = prog._cache.observe_scale = Timed(prog._cache.observe_scale)
    batches = []
    analyze = prog._analyzer.analyze_batch

    def kept(traces, lat_scales=None):
        batches.append((list(traces), lat_scales))
        return analyze(traces, lat_scales)

    prog._analyzer.analyze_batch = kept
    return prog, timers, batches


def run_migrating(tag, step, x, steps=3, **kw):
    """One warm-up step and ``steps`` measured of :func:`attach_migrating`,
    every cascade call's slot indices recorded."""
    prog, timers, batches = attach_migrating(step, **kw)
    records, restore = recording_cascade()
    try:
        prog.step(x)
        warm = {k: t.seconds for k, t in timers.items()}
        warm_rep = totals(prog.report)
        warm_an, warm_native = prog.report.analyzer_s, prog.report.native_s
        reset_counts()
        prog.run(steps, x)
        c = counts()
    finally:
        restore()
    check_launches(tag, c, "cascade", steps, expand=steps)
    rep = prog.report
    per_step = {k: (t.seconds - warm[k]) / steps for k, t in timers.items()}
    parts = ", ".join(f"{k} {v:.6f}" for k, v in per_step.items() if k != "pre")
    print(f"[{tag}] analyzer {(rep.analyzer_s - warm_an) / steps:.6f} s/step, native "
          f"{(rep.native_s - warm_native) / steps:.6f} s/step, pre-analysis "
          f"{per_step['pre']:.6f} s/step on the host ({parts}) over the {steps} measured "
          f"steps; warm-up step analyzer {warm_an:.6f} s, pre-analysis {warm['pre']:.6f} s; "
          f"bandwidth {rep.bandwidth_s!r} s")
    return prog, c["cascade"], records, batches, warm_rep


def migration_cache_path(step, x, main_rep):
    """Phase 11: phase 4's program with software migration and a 1 GiB
    device cache against the oracle; then phase 4's program without them,
    with the cache alone, with a zero-capacity cache and with migration
    'off', each against phase 4's report, cascade call by cascade call."""
    prog, launches, _, batches, warm_rep = run_migrating(
        "migration", step, x, migration=MAIN_MIGRATION, cache=CACHE)
    m, rep = prog.sim.migration, prog.report
    check(m.promotions >= 1 and m.demotions >= 1,
          f"migration: {m.promotions} promotions, {m.demotions} demotions in 4 steps")
    check(0.0 < rep.cache_hit_fraction <= 1.0, f"hit fraction {rep.cache_hit_fraction}")
    measured = batches[1:]
    check(any(sc is not None and (sc < 1).any() for _, scs in measured for sc in scs),
          "the cache never scaled an epoch's latency")
    # the oracle on the 3 measured steps' own epochs and scale rows
    t0 = time.perf_counter()
    want = None
    for traces, scales in measured:
        bd = oracle(prog.sim.flat, traces, scales=scales)
        want = bd if want is None else want + bd
    check_totals("migration", delta(totals(rep), warm_rep), want, 1)
    last = measured[-1][0]
    print(f"[migration] moved {rep.migration_moved_bytes!r} bytes, promotions {m.promotions}, "
          f"demotions {m.demotions}, hit fraction {rep.cache_hit_fraction!r} over 4 steps; "
          f"{len(last)} epochs, up to {max(tr.n for tr in last)} events, "
          f"{sum(tr.n for tr in last)} in the last step (analyze_ref "
          f"{time.perf_counter() - t0:.1f} s)")
    print(f"[migration] summary {json.dumps(rep.summary())}")

    # the scale rows move latency only: with no cache, the cache alone, a
    # zero-capacity cache or migration off, congestion and every slot index
    # are phase 4's program's, and but for the cache alone, latency too
    phase4 = totals(main_rep)
    spread = []
    prog0, n, slots0, _, _ = run_migrating("no-cache", step, x)
    launches += n
    spread.append(check_like("no-cache vs phase 4", totals(prog0.report), phase4))
    for tag, kw in (("cache-only", dict(cache=CACHE)),
                    ("cache0", dict(cache=dataclasses.replace(CACHE, capacity_bytes=0))),
                    ("migration-off",
                     dict(migration=dataclasses.replace(MAIN_MIGRATION, mode="off")))):
        p, n, slots, _, _ = run_migrating(tag, step, x, **kw)
        launches += n
        got = totals(p.report)
        cached = tag == "cache-only"
        spread.append(check_like(f"{tag} vs phase 4", got, phase4, latency=not cached))
        check_slots(f"{tag} vs no-cache", slots, slots0)
        if cached:
            check(0.0 < p.report.cache_hit_fraction and got["latency_s"] < phase4["latency_s"],
                  f"cache-only: hit fraction {p.report.cache_hit_fraction}, latency "
                  f"{got['latency_s']} s against {phase4['latency_s']} s")
        elif tag == "cache0":
            check(p.report.cache_hit_fraction == 0.0, "a zero-capacity cache hit")
        print(f"[{tag}] latency {float(got['latency_s'])!r} s (phase 4: "
              f"{float(phase4['latency_s'])!r} s), hit fraction {p.report.cache_hit_fraction!r}")
    print(f"[migration] bandwidth across the five runs of phase 4's program: largest "
          f"relative difference from phase 4's {max(spread):.3e}")
    return launches


def fabric_migration_path():
    """Phase 12: fabric8 with migration on one shared local budget and the
    1 GiB cache, warmed by the merged stream: 1 + 2 rounds (no replay),
    synchronous."""
    t0 = time.perf_counter()
    sess = fabric_session(FABRIC_HOSTS, FABRIC_LOAD, FABRIC_EVENTS_PER_ACCESS, "cuda",
                          migration=FABRIC_MIGRATION, cache=CACHE, async_analysis=False)
    check(len({id(s._budget) for s in sess._migration}) == 1,
          "the tenants' local budgets differ")
    timers = {
        "pre": Timed(sess._merged_round, keep=True),
        "synthesis": Timed(sess._tenant_epochs),
        "cache": Timed(sess._cache.observe_scale),
    }
    sess._merged_round, sess._tenant_epochs = timers["pre"], timers["synthesis"]
    sess._cache.observe_scale = timers["cache"]
    mig = [Timed(s.observe_and_migrate) for s in sess._migration]
    for s, t in zip(sess._migration, mig):
        s.observe_and_migrate = t
    sess.round()  # warm-up
    warm_s, warm_an = time.perf_counter() - t0, sess.report.analyzer_s
    print(f"[fabric-migration] set-up and warm-up round {warm_s:.3f} s (pre-analysis "
          f"{timers['pre'].seconds:.3f} s, analyzer {warm_an:.6f} s)")
    warm = {k: t.seconds for k, t in timers.items()}
    warm_mig = sum(t.seconds for t in mig)
    reset_counts()
    sess.round()
    snap = totals(sess.report)
    hosts0 = [(h.latency_s, h.congestion_s) for h in sess.report.hosts]
    sess.round()
    c = counts()
    check_launches("fabric-migration", c, "hosts", 2, expand=2)
    check(sess._round_cache is None, "the round replay must stay off")
    rep = sess.report
    n = 2
    per = {k: (t.seconds - warm[k]) / n for k, t in timers.items()}
    per["migration"] = (sum(t.seconds for t in mig) - warm_mig) / n
    merged, _, scales = timers["pre"].out[-1]
    print(f"[fabric-migration] analyzer {(rep.analyzer_s - warm_an) / n:.6f} s/round, "
          f"pre-analysis {per['pre']:.6f} s/round on the host (synthesis "
          f"{per['synthesis']:.6f}, migration {per['migration']:.6f}, cache "
          f"{per['cache']:.6f}, the rest coherency and the merge) over the {n} measured "
          f"rounds; {len(merged)} merged epochs, up to {max(tr.n for tr in merged)} events, "
          f"{sum(tr.n for tr in merged)} in the last")
    # the oracle on the last round's own merged epochs and scale rows
    t0 = time.perf_counter()
    ref = oracle(sess.flat, merged, scales=scales)
    check_totals("fabric-migration", delta(totals(rep), snap), ref, 1)
    lat_h = np.array([s_to_ns(h.latency_s - h0[0]) for h, h0 in zip(rep.hosts, hosts0)])
    cong_h = np.array([s_to_ns(h.congestion_s - h0[1]) for h, h0 in zip(rep.hosts, hosts0)])
    np.testing.assert_allclose(lat_h, ref.per_host_latency_ns, rtol=1e-4)
    np.testing.assert_allclose(cong_h, ref.per_host_congestion_ns, rtol=5e-3)
    promos = sum(s.promotions for s in sess._migration)
    demos = sum(s.demotions for s in sess._migration)
    check(promos >= 1 and demos >= 1, f"fabric migration: {promos} promotions, {demos} demotions")
    check(0.0 < rep.cache_hit_fraction <= 1.0, f"hit fraction {rep.cache_hit_fraction}")
    print(f"[fabric-migration] last round per-host latency ns {lat_h.tolist()}, congestion ns "
          f"{cong_h.tolist()}, analyze_ref {ref.per_host_congestion_ns.tolist()} "
          f"({time.perf_counter() - t0:.1f} s)")
    print(f"[fabric-migration] moved {rep.migration_moved_bytes!r} bytes, promotions {promos}, "
          f"demotions {demos}, hit fraction {rep.cache_hit_fraction!r} over 3 rounds")
    print(f"[fabric-migration] summary {json.dumps(rep.summary())}")
    return c["hosts"]


def zoo_topology() -> Topology:
    """Figure 1 with every CXL pool's capacity raised to 1 TiB (latencies,
    bandwidths and switches as they are), so that the largest model's
    weights fit one pool."""
    fig = figure1_topology()
    pools = [p if p.is_local else dataclasses.replace(p, capacity_bytes=ZOO_POOL_BYTES)
             for p in fig.pools]
    return Topology(pools, fig.switches, fig.rc_latency_ns, fig.rc_bandwidth_gbps,
                    fig.rc_stt_ns, fig.local_dram_latency_ns)


def zoo_step(tag, cfg, kind, topology, epoch, step, x):
    """One arch's program attached to ``step``: 1 + 1 steps, one cascade
    launch in the measured step; returns (program, its epochs, the measured
    step's totals, launches)."""
    regions, phases = build_regions_and_phases(cfg, kind, batch=8, seq=4096,
                                               param_dtype_bytes=2)
    sim = CXLMemSim(topology, ClassMapPolicy(ZOO_POLICY), epoch=epoch, hw=H100_SXM,
                    max_events_per_access=1024, device="cuda")
    prog = sim.attach(step, phases, regions)
    traces = prog.epoch_traces()
    prog.step(x)  # warm-up
    warm, warm_an = totals(prog.report), prog.report.analyzer_s
    reset_counts()
    prog.step(x)
    prog.flush()  # the step's batch is analyzed on the engine's thread
    c = counts()
    check_launches(tag, c, "cascade", 1, expand=1)
    got = delta(totals(prog.report), warm)
    got.analyzer_s = prog.report.analyzer_s - warm_an
    return prog, traces, got, c["cascade"]


def model_zoo_path(step, x):
    """Phase 13: each arch's published memory program (decode at 8 x 4096
    tokens, prefill for the encoder-only arch; bf16 weights in cxl_pool1)
    attached to phase 4's stand-in step in layer epochs: 1 + 1 steps each,
    one cascade a step, totals against the oracle.  Layer epochs that reach
    2**23 ns hold latency and bandwidth to the oracle and congestion to the
    plain version on the same epochs (the f32 arithmetic both packages
    share), and the program runs again in quantum epochs of 2**22 ns."""
    topology = zoo_topology()
    launches = 0
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        kind = "prefill" if cfg.family == "audio" else "decode"
        tag = f"zoo {arch}"
        prog, traces, got, n = zoo_step(tag, cfg, kind, topology, EpochSchedule("layer"),
                                        step, x)
        launches += n
        flat = prog.sim.flat
        ref = oracle(flat, traces)
        span_ns = max(float(tr.t_ns.max()) for tr in traces)
        if span_ns < F32_EXACT_NS:
            check_totals(tag, got, ref, 1)
        else:
            check_totals(tag, got, ref, 1, keys=("latency_s", "bandwidth_s"))
            plain = EpochAnalyzer(flat, device="cpu").analyze_batch(traces)
            g_ns = s_to_ns(got.congestion_s)
            check(abs(g_ns - plain.congestion_ns) <= 1e-5 * abs(plain.congestion_ns),
                  f"{tag}: congestion {g_ns} ns vs the plain version's {plain.congestion_ns} ns")
            print(f"[{tag}] layer epochs up to {span_ns!r} ns, past 2**23: congestion "
                  f"{g_ns!r} ns on the card, {plain.congestion_ns!r} ns by the plain version, "
                  f"analyze_ref {ref.congestion_ns!r} ns (f32 epoch-relative times)")
            qprog, qtraces, qgot, n = zoo_step(
                f"{tag} quantum", cfg, kind, topology,
                EpochSchedule("quantum", quantum_ns=ZOO_QUANTUM_NS), step, x)
            launches += n
            check_totals(f"{tag} quantum", qgot, oracle(qprog.sim.flat, qtraces), 1)
            print(f"[{tag} quantum] {len(qtraces)} epochs of 2**22 ns, up to "
                  f"{max(tr.n for tr in qtraces)} events; analyzer {qgot.analyzer_s:.6f} s/step; "
                  f"latency {qgot.latency_s!r} s, congestion {qgot.congestion_s!r} s, "
                  f"bandwidth {qgot.bandwidth_s!r} s")
        pc = cfg.param_counts()
        weights = sum(r.nbytes for r in prog.regions if r.tensor_class == "param")
        print(f"[zoo] {arch} ({cfg.family}, {kind}): total {pc['total']!r} active "
              f"{pc['active']!r} parameters, {weights!r} weight bytes in "
              f"{ZOO_POLICY['param']}; {len(traces)} epochs, up to "
              f"{max(tr.n for tr in traces)} events, {sum(tr.n for tr in traces)} per step; "
              f"analyzer {got.analyzer_s:.6f} s/step; latency {got.latency_s!r} s, "
              f"congestion {got.congestion_s!r} s, bandwidth {got.bandwidth_s!r} s")
    return launches


# --------------------------------------------------------------------------- #
# Mamba2 serving (mamba2-2.7b): the SSD kernel and the attached model
# --------------------------------------------------------------------------- #


def ssd_inputs(B, L, H, P, N, seed, dtype, dev):
    """tests/test_kernels.py's distributions, drawn with numpy from ``seed``;
    x in ``dtype``, the rest f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = (np.logaddexp(0.0, rng.standard_normal((B, L, H))) * 0.1).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((B, L, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, L, N)) * 0.5).astype(np.float32)
    out = [torch.from_numpy(a).to(dev) for a in (x, dt, A, Bm, Cm)]
    out[0] = out[0].to(dtype)
    return out


def ssd_bound(x, Bm, chunk):
    """Bound of one SSD call: x, dt, A, B, C read once and y written once,
    against the chunked algorithm's f32 FLOPs: C·Bᵀ on and below the
    diagonal once per (batch row, chunk), as B and C are one group shared
    by every head; W·x on and below the diagonal, C·h and the state update
    per head.  The FLOPs are timed at the tensor cores' 3xTF32 rate (three
    TF32 products at 495 TFLOP/s for each f32 one): the kernel's route,
    which meets the f32 bar, and faster than the f32 CUDA cores, whose
    time for the same FLOPs is returned beside it."""
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    nbytes = 2 * x.numel() * x.element_size() + 4 * (B * L * H + H + 2 * B * L * N)
    c = min(chunk, L)
    flops = B * (L // c) * c * (c + 1) * N + B * H * (L // c) * (c * (c + 1) * P + 4 * c * N * P)
    return bound_ms(nbytes, flops, TF32X3_OPS_PER_S), flops / F32_OPS_PER_S * MS_PER_S


def compare_ssd(name, x, dt, A, Bm, Cm, chunk, reps=10, naive=False):
    """SSD kernel vs the plain chunked version (and, with ``naive``, the
    sequential recurrence) on the same CUDA inputs.  f32: max abs error
    within 2e-5 of the output's largest magnitude (sums of up to chunk + N
    f32 products in another order); bf16 y: that f32 allowance plus one
    bf16 rounding (rtol 2**-7), as both round nearly equal f32 values
    once."""
    yk = kssd.ssd_scan(x, dt, A, Bm, Cm, chunk)
    yp = kref.ssd_chunked(x, dt, A, Bm, Cm, chunk=min(chunk, x.shape[1]))
    torch.cuda.synchronize()
    check(yk.dtype == x.dtype and yk.shape == x.shape, f"{name}: y {yk.dtype} {tuple(yk.shape)}")
    check(bool(torch.isfinite(yk).all()), f"{name}: non-finite outputs")
    err = float((yk.float() - yp.float()).abs().max())
    scale = float(yp.float().abs().max())
    if x.dtype == torch.float32:
        check(err <= 2e-5 * scale, f"{name}: max abs error {err} over 2e-5 x {scale}")
    else:
        torch.testing.assert_close(yk.float(), yp.float(), rtol=2 ** -7, atol=2e-5 * scale)
    row = dict(shape=list(x.shape), N=int(Bm.shape[-1]), chunk=chunk, dtype=str(x.dtype),
               max_abs_err=err, max_abs_y=scale)
    if naive:
        yn = kref.ssd_naive(x, dt, A, Bm, Cm)
        nerr = float((yk.float() - yn.float()).abs().max())
        check(nerr <= 2e-4 * max(1.0, scale), f"{name}: {nerr} from ssd_naive")
        row["naive_max_abs_err"] = nerr
    row["ms"] = median_ms(lambda: kssd.ssd_scan(x, dt, A, Bm, Cm, chunk), reps)
    row["plain_ms"] = median_ms(
        lambda: kref.ssd_chunked(x, dt, A, Bm, Cm, chunk=min(chunk, x.shape[1])),
        max(3, reps // 4))
    (row["bound_ms"], row["bound_by"]), row["f32_cuda_core_ms"] = ssd_bound(x, Bm, chunk)
    print(f"[kernel] {name}: {json.dumps(row)}")
    return row


def ssd_kernel_phase(dev):
    """Phase 9a: the SSD kernel at the reference's test cases (f32, the
    first also against the sequential recurrence) and at the prefill shape
    [8, 4096, 80, 64], N=128, chunk=128, in bf16 (the model path's x) and
    f32."""
    rows = []
    for i, (B, L, H, P, N, chunk) in enumerate(SSD_CASES):
        args = ssd_inputs(B, L, H, P, N, L + H, torch.float32, dev)
        rows.append(compare_ssd(f"ssd_case{i}", *args, chunk, naive=i == 0))
    H, P, N = M2_CONFIG.ssm_heads, M2_CONFIG.ssm_d_head, M2_CONFIG.ssm_state
    full = {}
    for dtype in (torch.bfloat16, torch.float32):
        args = ssd_inputs(SERVE_BATCH, SERVE_SEQ, H, P, N, 0, dtype, dev)
        full[dtype] = compare_ssd(f"ssd_prefill_{str(dtype)[6:]}", *args,
                                  M2_CONFIG.ssm_chunk)
        del args
    # a layout that does not fit one block's shared memory is refused, not launched
    launches0 = kssd.ssd_launches
    wide = ssd_inputs(1, 128, 1, 128, 256, 0, torch.float32, dev)
    try:
        kssd.ssd_scan(*wide, 128)
    except ValueError as e:
        print(f"[kernel] ssd_scan refuses P=128, N=256, chunk=128: {e}")
    else:
        check(False, "ssd_scan launched P=128, N=256, chunk=128")
    check(kssd.ssd_launches == launches0, "ssd_scan counted a refused launch")
    return rows + list(full.values()), full[torch.bfloat16]


def seq_errs(got, want) -> list:
    """Each sequence's max abs difference over its max abs value."""
    got, want = got.double(), want.double()
    return ((got - want).abs().amax(-1) / want.abs().amax(-1)).tolist()


def roundtrip(cfg, tokens, dev, pad_to=None):
    """Prefill S-1 tokens (the KV cache padded to ``pad_to``) and decode the
    last against the last-position logits of a prefill of all S (for
    mamba2: kernel plus _final_state against the kernel-free decode
    recurrence); returns each sequence's error."""
    model = Model(cfg, device=dev, seed=0)
    decode = make_decode_step(cfg)
    want, _, _ = make_prefill_step(cfg)(model, {"tokens": tokens})
    _, caches, clen = make_prefill_step(cfg, pad_to=pad_to)(model, {"tokens": tokens[:, :-1]})
    got, _, _ = decode(model, {"token": tokens[:, -1:], "caches": caches, "cache_len": clen})
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"roundtrip {cfg.name}: non-finite logits")
    return seq_errs(got, want)


def mamba2_serving_path(dev):
    """Phase 9b: mamba2-2.7b on the card: the prefill/decode roundtrip, 8
    requests served (one prefill, 16 decodes), then the prefill and decode
    steps attached to CXLMemSim with the weights in CXL pool 1."""
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, M2_CONFIG.vocab_size, (SERVE_BATCH, SERVE_SEQ), generator=gen,
                           device=dev)
    layers, bar = ROUNDTRIP_F32
    f32 = dict(dtype=torch.float32, cache_dtype=torch.float32)
    t0 = time.perf_counter()
    errs = roundtrip(dataclasses.replace(M2_CONFIG, n_layers=layers, **f32), tokens, dev)
    print(f"[mamba2] roundtrip float32 at {layers} layers: per-sequence rel {errs} "
          f"(bar {bar} on each) in {time.perf_counter() - t0:.3f} s")
    check(max(errs) < bar, f"roundtrip float32 at {layers} layers: {max(errs)} >= {bar}")

    layers, bar, guard = ROUNDTRIP_BF16
    t0 = time.perf_counter()
    errs = roundtrip(dataclasses.replace(M2_CONFIG, n_layers=layers), tokens, dev)
    med = float(np.median(errs))
    print(f"[mamba2] roundtrip bfloat16 at {layers} layers: per-sequence rel {errs}, median "
          f"{med!r} (bar {bar}), max {max(errs)!r} (guard {guard}) in "
          f"{time.perf_counter() - t0:.3f} s")
    check(med < bar and max(errs) < guard,
          f"roundtrip bfloat16 at {layers} layers: median {med}, max {max(errs)}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = Model(M2_CONFIG, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == M2_CONFIG.param_counts()["total"], f"{n_params} parameters")
    print(f"[mamba2] {M2_CONFIG.name}: {n_params} f32 parameters on the card in "
          f"{time.perf_counter() - t0:.3f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prefill, decode = make_prefill_step(M2_CONFIG), make_decode_step(M2_CONFIG)
    batch = {"tokens": tokens}

    # serve: one prefill of the 8 requests, then 16 decode steps, greedy
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, caches, clen = prefill(model, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(logits.shape == (SERVE_BATCH, M2_CONFIG.vocab_size)
          and bool(torch.isfinite(logits).all()), "prefill logits")
    check(caches["ssm_state"].shape == (M2_CONFIG.n_groups, 1, SERVE_BATCH,
                                        M2_CONFIG.ssm_heads, M2_CONFIG.ssm_state,
                                        M2_CONFIG.ssm_d_head), "ssm cache shape")
    state = {"token": logits.argmax(-1, keepdim=True), "caches": caches, "cache_len": clen}
    t0 = time.perf_counter()
    for _ in range(SERVE_DECODES):
        step_logits, new_caches, new_len = decode(model, state)
        state = {"token": step_logits.argmax(-1, keepdim=True), "caches": new_caches,
                 "cache_len": new_len}
    torch.cuda.synchronize()
    decode_s = (time.perf_counter() - t0) / SERVE_DECODES
    check(state["cache_len"] == SERVE_SEQ + SERVE_DECODES
          and bool(torch.isfinite(step_logits).all()), "decode logits")
    print(f"[mamba2] served {SERVE_BATCH} x {SERVE_SEQ} tokens: prefill {prefill_s:.6f} s "
          f"(first call), then {SERVE_DECODES} decode steps at {decode_s:.6f} s each; "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # attached prefill: the paper's offload scenario for a serving job
    regions, phases = build_regions_and_phases(M2_CONFIG, "prefill", batch=SERVE_BATCH,
                                               seq=SERVE_SEQ)
    sim = CXLMemSim(figure1_topology(), ClassMapPolicy(M2_POLICY), epoch=EpochSchedule("layer"),
                    hw=H100_SXM, max_events_per_access=1024, device=dev)
    prog = sim.attach(prefill, phases, regions)
    traces = prog.epoch_traces()
    print(f"[mamba2-prefill] {len(traces)} epochs, up to {max(tr.n for tr in traces)} events, "
          f"{sum(tr.n for tr in traces)} events per step")
    prog.step(model, batch)  # warm-up
    warm = prog.report
    warm_analyzer_s, warm_native_s = warm.analyzer_s, warm.native_s
    reset_counts()
    rep = prog.run(3, model, batch)
    c = counts()
    check_launches("mamba2-prefill", c, "ssd", 3 * M2_CONFIG.n_layers, cascade=3, expand=3)
    prefill_launches = c["ssd"]
    check_totals("mamba2-prefill", rep, oracle(prog.sim.flat, traces), rep.steps)
    print(f"[mamba2-prefill] summary {json.dumps(rep.summary())}")
    print(f"[mamba2-prefill] analyzer {(rep.analyzer_s - warm_analyzer_s) / 3:.6f} s/step and "
          f"native {(rep.native_s - warm_native_s) / 3:.6f} s/step over the 3 measured "
          f"steps; warm-up step analyzer {warm_analyzer_s:.6f} s, native {warm_native_s:.6f} s")

    # attached decode from the prefill's caches
    regions, phases = build_regions_and_phases(M2_CONFIG, "decode", batch=SERVE_BATCH, seq=1,
                                               cache_len=SERVE_SEQ)
    state = {"token": logits.argmax(-1, keepdim=True), "caches": caches, "cache_len": clen}
    attached_decode_modes("mamba2-decode", lambda **kw: CXLMemSim(
        figure1_topology(), ClassMapPolicy(M2_POLICY), epoch=EpochSchedule("layer"),
        hw=H100_SXM, max_events_per_access=1024, device=dev, **kw).attach(decode, phases, regions),
        (model, state))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prefill(model, batch)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=12))
    return prefill_launches


# the GIL probe of the attached decodes: the interpreter's thread switch
# interval cut from CPython's 5 ms, so a thread waiting for the GIL gets it
# back sooner from one that holds it
PROBE_SWITCH_S = 1e-4


def overlap_s(spans, marks) -> float:
    """Seconds of the ``(start, end)`` spans that the marks' spans cover."""
    return sum(max(0.0, min(b, m[2]) - max(a, m[1])) for a, b in spans for m in marks)


def attached_decode_modes(tag, attach, args, steps=8):
    """The attached decode step, one program from ``attach(**sim_kw)`` in
    each of three modes in turn, in one process, 1 warm-up and ``steps``
    measured steps each: synchronous (``async_analysis=False``), the
    default (asynchronous on the shared engine), and the default again with
    the thread switch interval at ``PROBE_SWITCH_S`` (the GIL probe).  Per
    mode: one cascade launch a step and nothing else, totals against
    ``analyze_ref``, and the two asynchronous runs' totals against the
    synchronous run's (phase 15's bars).  Prints per mode the mean native
    step and its ratio to the synchronous run's; of each native step, the
    wall and the submitting thread's CPU seconds (``time.thread_time``)
    until its kernels are launched, then the wait for the card; and the
    native seconds that the dispatcher's launches and finishes overlapped.
    Returns the default run's report and the cascade's launches."""
    reps, native, cascade = {}, {}, 0
    for mode, kw, switch in (("sync", dict(async_analysis=False), None), ("default", {}, None),
                             ("default, switch 0.1 ms", {}, PROBE_SWITCH_S)):
        prog = attach(**kw)
        check((prog._handle is not None) == (mode != "sync"), f"{tag} {mode}: asynchronous")
        traces = prog.epoch_traces()
        marks, spans, split = [], [], []
        dispatch_timeline(prog._analyzer, marks)
        inner = prog.step_fn

        def timed(*a, inner=inner, spans=spans, split=split, **k):
            t0, c0 = time.perf_counter(), time.thread_time()
            out = inner(*a, **k)
            t1, c1 = time.perf_counter(), time.thread_time()
            torch.cuda.synchronize()
            spans.append((t0, time.perf_counter()))
            split.append((t1 - t0, c1 - c0, spans[-1][1] - t1))
            return out

        prog.step_fn = timed
        interval = sys.getswitchinterval()
        if switch is not None:
            sys.setswitchinterval(switch)
        try:
            prog.step(*args)  # warm-up
            warm_an, warm_native = prog.report.analyzer_s, prog.report.native_s
            spans.clear(), split.clear(), marks.clear()
            reset_counts()
            rep = prog.run(steps, *args)
        finally:
            sys.setswitchinterval(interval)
        prog.close()
        c = counts()
        check_launches(f"{tag} {mode}", c, "cascade", steps, expand=steps)
        cascade += c["cascade"]
        check_totals(f"{tag} {mode}", rep, oracle(prog.sim.flat, traces), rep.steps)
        if mode != "sync":
            check_equal_phase(f"{tag} {mode} vs sync", rep, reps["sync"], "9/10 sync")
        reps[mode], native[mode] = rep, (rep.native_s - warm_native) / steps
        launch_s, launch_cpu, wait_s = np.mean(split, axis=0)
        print(f"[{tag}] {mode}: native {native[mode]:.6f} s/step (ratio to sync "
              f"{native[mode] / native['sync']:.4f}), analyzer "
              f"{(rep.analyzer_s - warm_an) / steps:.6f} s/step over the {steps} measured "
              f"steps (warm-up step native {warm_native:.6f} s, analyzer {warm_an:.6f} s); a "
              f"native step: launching {launch_s:.6f} s ({launch_cpu:.6f} s of the submitting "
              f"thread's CPU), then waiting for the card {wait_s:.6f} s; the dispatcher's "
              f"spans over the native steps {overlap_s(spans, marks) / steps:.6f} s/step")
    print(f"[{tag}] summary {json.dumps(reps['default'].summary())}")
    return reps["default"], cascade


# --------------------------------------------------------------------------- #
# Dense serving (qwen3-0.6b): the flash attention kernel and the served model
# --------------------------------------------------------------------------- #


def attn_inputs(B, H, Hk, Sq, Sk, D, seed, dtype, dev):
    """q, k, v standard normal, drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    shapes = ((B, H, Sq, D), (B, Hk, Sk, D), (B, Hk, Sk, D))
    return [torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(dev).to(dtype)
            for sh in shapes]


def flash_bound(q, k, causal, q_offset):
    """Bound of one attention call: q, k, v read once and o written once,
    against 4·D FLOPs per visible (query, key) pair and head over the peak
    rate for the inputs' type: bf16 on the tensor cores, f32 on the CUDA
    cores (the f32 CUDA-core time is returned beside it)."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    rows = torch.arange(Sq, dtype=torch.float64) + q_offset
    visible = (rows + 1).clamp(0, Sk).sum() if causal else torch.tensor(float(Sq * Sk))
    flops = 4.0 * D * B * H * float(visible)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * MS_PER_S
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    t_ops = flops / rate * MS_PER_S
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bound, flops, flops / F32_OPS_PER_S * MS_PER_S


def compare_flash(name, q, k, v, causal, q_offset, reps=10, library=False, at_cases=True):
    """Flash kernel vs the plain full-matrix version on the same CUDA
    inputs, at ``attn_bar``'s bar; away from ATTN_CASES a planted fault (the
    last visible KV tile skipped) must fail that bar."""
    o = kflash.flash_attention(q, k, v, q_offset=q_offset, causal=causal)
    want = kref.mha_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    check(o.dtype == q.dtype and o.shape == q.shape, f"{name}: o {o.dtype} {tuple(o.shape)}")
    check(bool(torch.isfinite(o).all()), f"{name}: non-finite outputs")
    bar = attn_bar(want, q.dtype, at_cases)
    torch.testing.assert_close(o.float(), want.float(), **bar)
    fault_err = None if at_cases else check_bar_rejects_a_skipped_tile(
        name, q, k, v, causal, q_offset, want, bar)
    err = float((o.float() - want.float()).abs().max())
    (bms, by), flops, f32_ms = flash_bound(q, k, causal, q_offset)
    row = dict(shape=[list(q.shape), list(k.shape)], causal=causal, q_offset=q_offset,
               dtype=str(q.dtype), max_abs_err=err, bar=bar, fault_max_abs_err=fault_err,
               flops=flops, bound_ms=bms, bound_by=by, f32_cuda_core_ms=f32_ms)
    # device times (calls back to back on the card); call_ms is the
    # latency of one call on the host's clock, wrapper and launches included
    kern = lambda: kflash.flash_attention(q, k, v, q_offset=q_offset, causal=causal)  # noqa: E731
    row["ms"], row["call_ms"] = device_ms(kern, reps), median_ms(kern, reps)
    row["plain_ms"] = device_ms(
        lambda: kref.mha_attention(q, k, v, causal=causal, q_offset=q_offset), max(3, reps // 4))
    if library:
        # the yardstick only: one PyTorch call computing the same function,
        # checked at tests/test_kernels.py's bar (its bf16 backends round the
        # softmax weights to bf16 before the product with v); how many of
        # its outputs the kernel's bar would reject is printed, not checked
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = sdpa(q, k, v, is_causal=causal, enable_gqa=True)
        tol = ATTN_TOL[q.dtype]
        torch.testing.assert_close(lib.float(), o.float(), rtol=tol, atol=tol)
        row["library_over_bar"] = int((~torch.isclose(lib.float(), want.float(), **bar)).sum())
        del lib
        row["library_ms"] = device_ms(lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True),
                                      4 * reps)
    del want
    print(f"[kernel] {name}: {json.dumps(row)}")
    return row


def flash_kernel_phase(dev):
    """Phase 10a: the flash kernels at the reference's test cases (f32 and
    bf16), at qwen3-0.6b's prefill shape (bf16, and f32) and at its decode
    shape in f32 (the bf16 decode runs on the model's own tensors, 10c)."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for i, (B, H, Hk, Sq, Sk, D, causal, qoff) in enumerate(ATTN_CASES):
            q, k, v = attn_inputs(B, H, Hk, Sq, Sk, D, B * Sq + D, dtype, dev)
            rows.append(compare_flash(f"flash_case{i}_{str(dtype)[6:]}", q, k, v, causal, qoff))
    H, Hk, D = CONFIG.n_heads, CONFIG.n_kv_heads, CONFIG.d_head
    full = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = attn_inputs(SERVE_BATCH, H, Hk, SERVE_SEQ, SERVE_SEQ, D, 0, dtype, dev)
        full[dtype] = compare_flash(f"flash_prefill_{str(dtype)[6:]}", q, k, v, True, 0,
                                    library=dtype == torch.bfloat16, at_cases=False)
        del q, k, v
        torch.cuda.empty_cache()
    q, k, v = attn_inputs(SERVE_BATCH, H, Hk, 1, Q3_PAD_TO, D, 1, torch.float32, dev)
    check(kflash.variant(q.dtype, 1, H, Hk) == "decode", "the decode shape takes another kernel")
    rows.append(compare_flash("flash_decode_float32", q, k, v, True, SERVE_SEQ, reps=20,
                              at_cases=False))
    return rows + list(full.values()), full[torch.bfloat16]


def qwen3_kernel_on_model(model, tokens, caches, clen):
    """Phase 10c: ops.attention, the flash kernel's entry point, on the
    served model's own layer-0 tensors: its prefill q/k/v (k must equal the
    prefill's cache) against the model's chunked attention, and the decode
    shape (Sq = 1, q_offset = cache_len over the padded cache) against the
    decode block's attention.  Returns the comparison rows and the launches
    of this run."""
    cfg = model.cfg
    sub = model.blocks[0].sub0
    B, S = tokens.shape
    dims = (cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
    with torch.inference_mode():
        pos = model._positions(B, S)
        h = rms_norm(model._embed(tokens), sub.norm1)
        q, k, v = mattn._project_qkv(sub.attn, h, *dims, pos, cfg.rope_variant, cfg.qk_norm,
                                     cfg.rope_theta)
        check(torch.equal(k.to(cfg.cache_dtype), caches["kv"]["k"][0, 0, :, :, :S]),
              "layer 0's k differs from the prefill's KV cache")
        want = mattn.chunked_attention(q, k, v, causal=cfg.causal, block_q=cfg.attn_block_q,
                                       block_k=cfg.attn_block_k, window=cfg.window)
        nxt = torch.randint(0, cfg.vocab_size, (B, 1), generator=torch.Generator(
            device=tokens.device).manual_seed(2), device=tokens.device)
        h1 = rms_norm(model._embed(nxt), sub.norm1)
        q1, k1, v1 = mattn._project_qkv(sub.attn, h1, *dims, model._positions(B, 1, clen),
                                        cfg.rope_variant, cfg.qk_norm, cfg.rope_theta)
        ck = caches["kv"]["k"][0, 0].clone()
        cv = caches["kv"]["v"][0, 0].clone()
        ck[:, :, clen], cv[:, :, clen] = k1[:, :, 0], v1[:, :, 0]
        want1 = mattn.decode_attention(q1, ck, cv, clen, cfg.window)
        q, k, v, q1 = (t.contiguous() for t in (q, k, v, q1))
        torch.cuda.synchronize()
        reset_counts()
        got = kops.attention(q, k, v, q_offset=0, causal=cfg.causal)
        got1 = kops.attention(q1, ck, cv, q_offset=clen, causal=True)
        torch.cuda.synchronize()
        c = counts()
    check_launches("qwen3-attention", c, "flash", 2)
    rows = []
    for name, o, w, (qq, kk, vv, qoff) in (("flash_model_prefill", got, want, (q, k, v, 0)),
                                           ("flash_model_decode", got1, want1,
                                            (q1, ck, cv, clen))):
        check(o.dtype == cfg.dtype and bool(torch.isfinite(o).all()), f"{name}: outputs")
        bar = attn_bar(w, o.dtype, at_cases=False)
        torch.testing.assert_close(o.float(), w.float(), **bar)
        rows.append(dict(max_abs_err=float((o.float() - w.float()).abs().max()), bar=bar,
                         fault_max_abs_err=check_bar_rejects_a_skipped_tile(
                             name, qq, kk, vv, True, qoff, w, bar),
                         shape=[list(o.shape), list(kk.shape)]))
        print(f"[qwen3] ops.attention {name[6:]} on layer 0's tensors: {json.dumps(rows[-1])}")
    check(kflash.variant(q1.dtype, 1, *dims[:2]) == "decode", "decode took another kernel")
    # device times (calls back to back on the card); call_ms is the
    # latency of one call on the host's clock, wrapper and launches included
    kern = lambda: kflash.flash_attention(q1, ck, cv, q_offset=clen)  # noqa: E731
    plain = lambda: kref.mha_attention(q1, ck, cv, causal=True, q_offset=clen)  # noqa: E731
    decode_row = dict(rows[1], ms=device_ms(kern, 50), call_ms=median_ms(kern, 20),
                      plain_ms=device_ms(plain, 10), plain_call_ms=median_ms(plain, 5))
    (decode_row["bound_ms"], decode_row["bound_by"]), _, _ = flash_bound(q1, ck, True, clen)
    # the yardstick: one PyTorch call over the visible keys (the token sees them all)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kv = (ck[:, :, :clen + 1], cv[:, :, :clen + 1])
    lib = sdpa(q1, *kv, enable_gqa=True)
    tol = ATTN_TOL[q1.dtype]
    torch.testing.assert_close(lib.float(), got1.float(), rtol=tol, atol=tol)
    decode_row["library_over_bar"] = int(
        (~torch.isclose(lib.float(), want1.float(), **rows[1]["bar"])).sum())
    lib_call = lambda: sdpa(q1, *kv, enable_gqa=True)  # noqa: E731
    decode_row["library_ms"] = device_ms(lib_call, 50)
    decode_row["library_call_ms"] = median_ms(lib_call, 20)
    print(f"[kernel] flash_decode: {json.dumps(decode_row)}")
    return rows, c["flash"]


def qwen3_serving_path(dev):
    """Phase 10b-e: qwen3-0.6b on the card: the prefill/decode roundtrip, 8
    requests served (one prefill, 16 decodes), the kernel on the model's own
    tensors, then the prefill and decode steps attached to CXLMemSim with
    the KV cache in CXL pool 1."""
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, CONFIG.vocab_size, (SERVE_BATCH, SERVE_SEQ), generator=gen,
                           device=dev)
    layers, bar = Q3_ROUNDTRIP_F32
    f32 = dict(dtype=torch.float32, cache_dtype=torch.float32)
    t0 = time.perf_counter()
    errs = roundtrip(dataclasses.replace(CONFIG, n_layers=layers, **f32), tokens, dev,
                     pad_to=Q3_PAD_TO)
    print(f"[qwen3] roundtrip float32 at {layers} layers: per-sequence rel {errs} "
          f"(bar {bar} on each) in {time.perf_counter() - t0:.3f} s")
    check(max(errs) < bar, f"roundtrip float32 at {layers} layers: {max(errs)} >= {bar}")
    layers, bar = Q3_ROUNDTRIP_BF16
    t0 = time.perf_counter()
    errs = roundtrip(dataclasses.replace(CONFIG, n_layers=layers), tokens, dev,
                     pad_to=Q3_PAD_TO)
    print(f"[qwen3] roundtrip bfloat16 at {layers} layers: per-sequence rel {errs}, median "
          f"{float(np.median(errs))!r} (bar {bar} on each) in {time.perf_counter() - t0:.3f} s")
    check(max(errs) < bar, f"roundtrip bfloat16 at {layers} layers: {max(errs)} >= {bar}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = Model(CONFIG, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == CONFIG.param_counts()["total"], f"{n_params} parameters")
    print(f"[qwen3] {CONFIG.name}: {n_params} f32 parameters on the card in "
          f"{time.perf_counter() - t0:.3f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prefill = make_prefill_step(CONFIG, pad_to=Q3_PAD_TO)
    decode = make_decode_step(CONFIG)
    batch = {"tokens": tokens}

    # serve: one prefill of the 8 requests, then 16 decode steps, greedy
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, caches, clen = prefill(model, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(logits.shape == (SERVE_BATCH, CONFIG.vocab_size)
          and bool(torch.isfinite(logits).all()), "prefill logits")
    kv_shape = (CONFIG.n_groups, 1, SERVE_BATCH, CONFIG.n_kv_heads, Q3_PAD_TO, CONFIG.d_head)
    check(clen == SERVE_SEQ and caches["kv"]["k"].shape == kv_shape
          and caches["kv"]["k"].dtype == CONFIG.cache_dtype, "KV cache shape")
    rows, flash_launches = qwen3_kernel_on_model(model, tokens, caches, clen)
    state = {"token": logits.argmax(-1, keepdim=True), "caches": caches, "cache_len": clen}
    t0 = time.perf_counter()
    for _ in range(SERVE_DECODES):
        step_logits, new_caches, new_len = decode(model, state)
        state = {"token": step_logits.argmax(-1, keepdim=True), "caches": new_caches,
                 "cache_len": new_len}
    torch.cuda.synchronize()
    decode_s = (time.perf_counter() - t0) / SERVE_DECODES
    check(state["cache_len"] == Q3_PAD_TO and bool(torch.isfinite(step_logits).all())
          and bool(caches["kv"]["k"][:, :, :, :, Q3_PAD_TO - 1].any()), "decode logits")
    print(f"[qwen3] served {SERVE_BATCH} x {SERVE_SEQ} tokens: prefill {prefill_s:.6f} s "
          f"(first call), then {SERVE_DECODES} decode steps at {decode_s:.6f} s each; "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # attached prefill: the paper's KV-cache-in-the-pool case for a serving job
    regions, phases = build_regions_and_phases(CONFIG, "prefill", batch=SERVE_BATCH,
                                               seq=SERVE_SEQ)
    sim = CXLMemSim(figure1_topology(), ClassMapPolicy(Q3_POLICY), epoch=EpochSchedule("layer"),
                    hw=H100_SXM, max_events_per_access=1024, device=dev)
    prog = sim.attach(prefill, phases, regions)
    traces = prog.epoch_traces()
    print(f"[qwen3-prefill] {len(traces)} epochs, up to {max(tr.n for tr in traces)} events, "
          f"{sum(tr.n for tr in traces)} events per step")
    prog.step(model, batch)  # warm-up
    warm_analyzer_s, warm_native_s = prog.report.analyzer_s, prog.report.native_s
    reset_counts()
    rep = prog.run(3, model, batch)
    c = counts()
    check_launches("qwen3-prefill", c, "cascade", 3, expand=3)
    check_totals("qwen3-prefill", rep, oracle(prog.sim.flat, traces), rep.steps)
    print(f"[qwen3-prefill] summary {json.dumps(rep.summary())}")
    print(f"[qwen3-prefill] analyzer {(rep.analyzer_s - warm_analyzer_s) / 3:.6f} s/step and "
          f"native {(rep.native_s - warm_native_s) / 3:.6f} s/step over the 3 measured "
          f"steps; warm-up step analyzer {warm_analyzer_s:.6f} s, native {warm_native_s:.6f} s")

    # attached decode from the served prefill's caches (each step writes slot 4096 again)
    regions, phases = build_regions_and_phases(CONFIG, "decode", batch=SERVE_BATCH, seq=1,
                                               cache_len=SERVE_SEQ)
    state = {"token": logits.argmax(-1, keepdim=True), "caches": caches, "cache_len": clen}
    attached_decode_modes("qwen3-decode", lambda **kw: CXLMemSim(
        figure1_topology(), ClassMapPolicy(Q3_POLICY), epoch=EpochSchedule("layer"),
        hw=H100_SXM, max_events_per_access=1024, device=dev, **kw).attach(decode, phases, regions),
        (model, state))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prefill(model, batch)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=12))
    return rows, flash_launches


# --------------------------------------------------------------------------- #
# Phase 14: the device-resident epoch pipeline, synchronous
# --------------------------------------------------------------------------- #


def chain_pack(rows, caps, seed, dev, ties=False, fill=(0.5, 1.0), all_pad_rows=()):
    """Per-stage packed sorted runs on the card: each segment of each row
    filled to a random share in ``fill`` of its width, the rest ``+inf``
    pads with slot ``-1``.  Tie-free: every row's times are distinct
    integers (below 4 W); ``ties``: integers from a span of W/4.  Rows in
    ``all_pad_rows`` hold only pads."""
    rng = np.random.default_rng(seed)
    width = int(sum(caps))
    t = np.full((rows, width), np.inf, np.float32)
    idx = np.full((rows, width), -1, np.int32)
    for r in range(rows):
        if r in all_pad_rows:
            continue
        pool = rng.permutation(4 * width)[:width] if not ties else None
        off = 0
        for c in caps:
            m = int(c * rng.uniform(*fill)) if c else 0
            vals = rng.integers(0, max(2, width // 4), m) if ties else pool[off:off + m]
            t[r, off:off + m] = np.sort(vals).astype(np.float32)
            idx[r, off:off + m] = off + np.arange(m, dtype=np.int32)
            off += c
    return torch.from_numpy(t).to(dev), torch.from_numpy(idx).to(dev)


def compare_chain(name, t, idx, stts, caps, reps=10):
    """ops.chain_cascade on the card (the merges as torch ops, each stage's
    scan in the scan kernel over mask = idx >= 0) against its plain version
    (the reference's arange scan) on the same CUDA tensors: final times and
    slots bitwise, per-stage delays to rel 1e-6."""
    s0 = kcong.scan_launches
    tk, ik, dk = kops.chain_cascade(t, idx, stts, caps)
    launched = kcong.scan_launches - s0
    tp, ip, dp = kref.chain_cascade(t, idx, stts, caps)
    torch.cuda.synchronize()
    check(torch.equal(ik, ip), f"{name}: slots differ from the plain version")
    check(torch.equal(tk, tp), f"{name}: final times differ from the plain version "
          f"(max abs err {float((tk - tp).nan_to_num().abs().max())})")
    torch.testing.assert_close(dk, dp, rtol=1e-6, atol=0.0)
    err = float((dk - dp).abs().max())
    stages_run = sum(1 for p in range(len(caps)) if sum(caps[:p + 1]))
    check(launched == stages_run, f"{name}: {launched} scan launches, want {stages_run}")
    ms = median_ms(lambda: kops.chain_cascade(t, idx, stts, caps), reps)
    plain_ms = median_ms(lambda: kref.chain_cascade(t, idx, stts, caps), reps)
    row = dict(shape=list(t.shape), caps=list(caps), pad_share=float(torch.isinf(t).float().mean()),
               scan_launches=launched, ms=ms, plain_ms=plain_ms, max_abs_err=err,
               delay_ns=[float(x) for x in dk.sum(0)])
    print(f"[pipeline] {name}: {json.dumps(row)}")
    return row


def chain_kernel_phase(dev, traces, flat):
    """The chain cascade on main's own packed batch and on synthetic packs
    at main's caps: tie-free, tie-heavy, mostly pads, with an empty stage,
    and with all-pad rows."""
    plan = plan_chain(flat)
    n_bucket = bucket_pow2(max(tr.n for tr in traces))
    b_bucket = bucket_pow2(len(traces), floor=1)
    _, pack, caps = EventStager(np.float32).stage_packed(
        traces, b_bucket, n_bucket, plan.enter_stage, len(plan.stage_order))
    stts = tuple(float(x) for x in np.asarray(flat.switch_stt_ns, np.float32)[
        list(plan.stage_order)])
    print(f"[pipeline] main's packed batch: caps {list(caps)}, stage order "
          f"{list(plan.stage_order)}, STTs {list(stts)}")
    rows = [compare_chain("chain_main_batch", torch.from_numpy(pack["t"]).to(dev),
                          torch.from_numpy(pack["idx"]).to(dev), stts, caps)]
    empty = (caps[0], 0, caps[2] + caps[1])
    for name, cs, kw in (
        ("chain_tie_free", caps, dict()),
        ("chain_ties", caps, dict(ties=True)),
        ("chain_pad_tails", caps, dict(fill=(0.0, 0.1))),
        ("chain_empty_stage", empty, dict()),
        ("chain_all_pad_rows", caps, dict(all_pad_rows=(0, 7, 31))),
    ):
        t, idx = chain_pack(32, cs, 40 + len(rows), dev, **kw)
        rows.append(compare_chain(name, t, idx, stts, cs))
    return rows


def pinned_planes(an) -> bool:
    """Every host plane the pipeline analyzer's stager holds is page-locked."""
    sets = list(an._stager._bufs.values()) + list(an._stager._pack_bufs.values())
    return bool(sets) and all(torch.from_numpy(a).is_pinned()
                              for s in sets for k, a in s.items() if k != "span")


def split(rep, before, n):
    """The dispatch split per step or round since the ``before`` snapshot."""
    keys = ("analyzer_s", "stage_s", "transfer_s", "compile_s", "compute_s")
    return {k: (getattr(rep, k) - before[k]) / n for k in keys}


def snapshot(rep):
    return {k: getattr(rep, k) for k in ("analyzer_s", "stage_s", "transfer_s", "compile_s",
                                         "compute_s", "aot_cache_hits")}


def per_unit(rep):
    return rep.rounds if hasattr(rep, "rounds") else rep.steps


def check_against(tag, got, want, hosts=False, classes=False):
    """A pipeline run's totals per step or round against its non-pipeline
    phase's, at the fabric bars (latency rel 1e-4, congestion 1e-3,
    bandwidth 1e-2; per host latency 1e-4 and congestion 5e-3; per class
    congestion 5e-3)."""
    ng, nw = per_unit(got), per_unit(want)
    for k, rel in (("latency_s", 1e-4), ("congestion_s", 1e-3), ("bandwidth_s", 1e-2)):
        g, w = getattr(got, k) / ng, getattr(want, k) / nw
        check(abs(g - w) <= rel * abs(w), f"{tag} {k}: {g!r} vs {w!r} per step or round")
        print(f"[{tag}] {k} per step or round {g!r}, without the pipeline {w!r}, "
              f"rel {abs(g - w) / max(abs(w), 1e-30):.3e}")
    if hosts:
        for k, rel in (("latency_s", 1e-4), ("congestion_s", 5e-3)):
            g = np.array([getattr(h, k) for h in got.hosts]) / ng
            w = np.array([getattr(h, k) for h in want.hosts]) / nw
            np.testing.assert_allclose(g, w, rtol=rel)
    if classes:
        np.testing.assert_allclose(got.per_class_congestion_ns / ng,
                                   want.per_class_congestion_ns / nw, rtol=5e-3)


def profile_pipeline(tag, an, traces, rows=14):
    """One pipeline batch under torch.profiler: its H2D copies from pinned
    planes on the side stream, the merges and the kernels."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        an.analyze_batch(traces)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
    st = an.last_dispatch
    print(f"[{tag}] analyze_batch {batch_s:.6f} s under the profiler, split "
          f"{json.dumps(dataclasses.asdict(st))}")
    events = prof.key_averages()
    h2d = [e for e in events if "HtoD" in e.key]
    copies = [e for e in events if "Memcpy" in e.key]
    print(f"[{tag}] profiler rows with device time: "
          f"{sum(1 for e in events if e.device_time_total > 0)}; copy rows: "
          f"{[(e.key, e.count) for e in copies]}")
    for e in h2d:
        print(f"[{tag}] H2D {e.key}: {e.count} copies, {e.device_time_total / 1e3:.3f} ms "
              f"on the card (profiler)")
    print(f"[{tag}] H2D by the copy stream's events: {s_to_ms(st.transfer_s):.3f} ms"
          + ("" if h2d else "; the profiler recorded no H2D row"))
    print(events.table(sort_by="device_time_total", row_limit=rows))


def pipeline_main_path(dev, step, x, main_rep, main_ref):
    """Phase 14, pipeline-main: phase 4's program with pipeline=True and
    warmup=True, synchronous, one warm-up step and 3 measured."""
    prog = attach_main(figure1_topology(), step, pipeline=True, warmup=True,
                       async_analysis=False)
    an = prog._analyzer
    check(an._chain_plan is not None and an._aot.lowerings == 1,
          "pipeline-main must take the chain path and build at attach")
    traces = prog.epoch_traces()
    prog.step(x)
    before, builds = snapshot(prog.report), an._aot.lowerings
    reset_counts()
    rep = prog.run(3, x)
    c = counts()
    check_launches("pipeline-main", c, "scan", 3 * len(an._chain_plan.stage_order))
    check(an._aot.lowerings == builds and rep.aot_cache_hits - before["aot_cache_hits"] == 3,
          f"pipeline-main rebuilt after warm-up: {an._aot.lowerings} builds, was {builds}")
    check(rep.donated_dispatches == 0, "pipeline-main reported a donation: eager PyTorch has none")
    check(pinned_planes(an), "pipeline-main's host planes are not pinned")
    check(len(an._rings) == 1, f"pipeline-main allocated {len(an._rings)} device rings, not 1")
    check_totals("pipeline-main", rep, main_ref, rep.steps)
    check(rep.steps == main_rep.steps, f"{rep.steps} steps, phase 4 ran {main_rep.steps}")
    for k, rel in (("latency_s", 1e-6), ("congestion_s", 1e-4), ("bandwidth_s", 1e-4)):
        g, w = getattr(rep, k), getattr(main_rep, k)
        print(f"[pipeline-main] {k} {g!r} s, phase 4 {w!r} s, rel "
              f"{abs(g - w) / max(abs(w), 1e-30):.3e}")
        check(abs(g - w) <= rel * abs(w), f"pipeline-main {k} {g!r} vs phase 4's {w!r}")
    sp = split(rep, before, 3)
    print(f"[pipeline-main] analyzer {sp['analyzer_s']:.6f} s/step over the 3 measured "
          f"steps; split per step {json.dumps(sp)}")
    profile_pipeline("pipeline-main-profile", an, traces)
    return c["scan"], rep


def pipeline_session_path(tag, sess, want, kernel, per_round, **checks):
    """A pipeline FabricSession: one warm-up round, one measured, against
    its non-pipeline phase's report."""
    sess.round()
    before = snapshot(sess.report)
    reset_counts()
    rep = sess.run(1)
    c = counts()
    check_launches(tag, c, kernel, per_round)
    check(sess._analyzer.pipeline and sess._analyzer._chain_plan is None
          and rep.donated_dispatches == 0, f"{tag}: must run the full-plane pipeline path")
    check(pinned_planes(sess._analyzer), f"{tag}: host planes are not pinned")
    check_against(tag, rep, want, **checks)
    print(f"[{tag}] analyzer {rep.analyzer_s - before['analyzer_s']:.6f} s/round, split "
          f"{json.dumps(split(rep, before, 1))}, builds {sess._analyzer._aot.lowerings}")
    return c[kernel]


def pipeline_path(dev, step, x, main_rep, main_ref, fabric_rep, wide_rep, qos_rep):
    """Phase 14: the chain cascade on the card against its plain version,
    then each simulator path with pipeline=True against its own phase,
    synchronous (phase 15 runs pipeline-main through an engine).  Returns
    the rows and the scan, hosts and QoS launches of the paths."""
    t0 = time.perf_counter()
    prog = attach_main(figure1_topology(), step, async_analysis=False)
    rows = chain_kernel_phase(dev, prog.epoch_traces(), prog.sim.flat)
    del prog
    scan, pipe_rep = pipeline_main_path(dev, step, x, main_rep, main_ref)
    sess = fabric_session(FABRIC_HOSTS, FABRIC_LOAD, FABRIC_EVENTS_PER_ACCESS, "cuda",
                          pipeline=True, async_analysis=False)
    hosts = pipeline_session_path("pipeline-fabric8", sess, fabric_rep, "hosts", 1, hosts=True)
    del sess
    sess = fabric_session(WIDE_HOSTS, WIDE_LOAD, WIDE_EVENTS_PER_ACCESS, "cuda", pipeline=True,
                          async_analysis=False)
    scan += pipeline_session_path("pipeline-wide32", sess, wide_rep, "scan",
                                  sess.flat.n_switches)
    del sess
    fig = figure1_topology()
    topo = Topology(
        fig.pools, [dataclasses.replace(sw, discipline="priority") for sw in fig.switches],
        fig.rc_latency_ns, fig.rc_bandwidth_gbps, fig.rc_stt_ns, fig.local_dram_latency_ns,
        n_qos_classes=2,
    )
    prog = attach_main(topo, step, pipeline=True, warmup=True, async_analysis=False)
    check(prog._analyzer._chain_plan is None, "pipeline-qos-main must leave the chain path")
    prog.step(x)
    before = snapshot(prog.report)
    reset_counts()
    rep = prog.run(1, x)
    c = counts()
    check_launches("pipeline-qos-main", c, "qos", 1)
    check_against("pipeline-qos-main", rep, qos_rep, classes=True)
    print(f"[pipeline-qos-main] analyzer {rep.analyzer_s - before['analyzer_s']:.6f} s/step, "
          f"split {json.dumps(split(rep, before, 1))}")
    print(f"[pipeline] phase 14 ran {time.perf_counter() - t0:.1f} s")
    return rows, scan, hosts, c["qos"], pipe_rep


# --------------------------------------------------------------------------- #
# Phase 15: the shared analysis engine
# --------------------------------------------------------------------------- #


class ParkAnalyzer:
    """A DES-style analyzer (``.flat`` and ``.simulate``) that holds the
    engine's dispatcher for ``sleep_s``, so the submissions behind it queue
    and coalesce."""

    def __init__(self, flat, sleep_s):
        self.flat, self.sleep_s = flat, sleep_s

    def simulate(self, tr, lat_scale=None):
        time.sleep(self.sleep_s)
        f = self.flat
        return DelayBreakdown.zero(f.n_pools, f.n_switches, f.n_hosts)


def recording_streams():
    """Record the shape of every batch and the current CUDA stream of every
    thread that enters the analyzer's cascades; returns (records, restore).
    The ops entry points are wrapped, so the kernels' launch counts are
    untouched."""
    names = ("congestion_cascade", "chain_cascade")
    inner = {n: getattr(kops, n) for n in names}
    records = []

    def wrap(name):
        def recorder(t, *args, **kwargs):
            records.append((name, list(t.shape), torch.cuda.current_stream(t.device)))
            return inner[name](t, *args, **kwargs)
        return recorder

    def restore():
        for n in names:
            setattr(kops, n, inner[n])

    for n in names:
        setattr(kops, n, wrap(n))
    return records, restore


def check_on_engine_stream(tag, records, eng):
    """Every recorded cascade ran on the engine's own stream, not on this
    thread's."""
    own = eng.stream("cuda")
    check(own is not None and records, f"{tag}: the engine made no stream or ran no cascade")
    check(all(r[2] == own for r in records) and own != torch.cuda.current_stream(),
          f"{tag}: a cascade ran off the engine's stream")


def dispatch_timeline(an, marks):
    """Append ``(kind, start, end)`` host-clock marks of each of ``an``'s
    ``launch_batch`` and each returned batch's ``finish`` to ``marks``."""
    inner = an.launch_batch

    def launch(*args, **kwargs):
        t0 = time.perf_counter()
        pending = inner(*args, **kwargs)
        marks.append(("launch", t0, time.perf_counter()))
        fin = pending.finish

        def finish():
            t1 = time.perf_counter()
            out = fin()
            marks.append(("finish", t1, time.perf_counter()))
            return out

        pending.finish = finish
        return pending

    an.launch_batch = launch


def print_timeline(tag, marks, t0):
    """The measured window's marks in ms from its start."""
    spans = " ".join(f"{k} {1e3 * (a - t0):.1f}-{1e3 * (b - t0):.1f}"
                     for k, a, b in sorted(marks, key=lambda m: m[1]) if a >= t0)
    print(f"[{tag}] timeline ms: {spans}")


def measured_steps(prog, x, steps=3, marks=None):
    """One warm-up step, then ``steps`` measured (the engine flushed at
    their end).  Returns the report, the launch counts, the wall seconds of
    the measured steps, the native and analyzer seconds they added and the
    report's :func:`snapshot` before them.  With ``marks``, each measured
    step's host-clock span is appended to it, and the window's start."""
    prog.step(x)
    before = snapshot(prog.report)  # the property flushes the warm-up step
    n0, a0 = prog.report.native_s, before["analyzer_s"]
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        ts = time.perf_counter()
        prog.step(x)
        if marks is not None:
            marks.append(("step", ts, time.perf_counter()))
    if marks is not None:
        marks.append(("start", t0, t0))
    prog.flush()
    wall = time.perf_counter() - t0
    c = counts()
    rep = prog.report
    return rep, c, wall, rep.native_s - n0, rep.analyzer_s - a0, before


def check_equal_phase(tag, rep, want, phase):
    """Totals against another phase's report over as many steps: latency
    and bandwidth to rel 1e-6, congestion to rel 1e-4."""
    check(rep.steps == want.steps, f"{tag}: {rep.steps} steps, phase {phase} ran {want.steps}")
    for k, rel in (("latency_s", 1e-6), ("congestion_s", 1e-4), ("bandwidth_s", 1e-6)):
        g, w = getattr(rep, k), getattr(want, k)
        print(f"[{tag}] {k} {g!r} s, phase {phase} {w!r} s, rel "
              f"{abs(g - w) / max(abs(w), 1e-30):.3e}")
        check(abs(g - w) <= rel * abs(w), f"{tag} {k} {g!r} vs phase {phase}'s {w!r}")


def engine_main_path(step, x, main_rep):
    """engine-main: phase 4's program, synchronous and with
    async_analysis=True on a private engine, in one process, in turns
    (sync, async, async, sync), 1 + 3 steps each (checked), then 3 more
    steps timed: the first 3 pay the first fill of the engine's second ring
    slot; the dispatch timelines printed."""
    cascade = 0
    order = ("sync", "async", "async", "sync")
    runs = {mode: [] for mode in order}
    steady = {mode: [] for mode in order}
    for mode in order:
        eng = None if mode == "sync" else AnalysisEngine()
        prog = attach_main(figure1_topology(), step, async_analysis=eng is not None, engine=eng)
        records, restore = recording_streams()
        marks = []
        dispatch_timeline(prog._analyzer, marks)
        try:
            rep, c, wall, native, analyzer, _ = measured_steps(prog, x, marks=marks)
        finally:
            restore()
        check_launches(f"engine-main {mode}", c, "cascade", 3, expand=3)
        cascade += c["cascade"]
        if eng is not None:
            check(prog._handle is not None and prog._handle.engine is eng,
                  "engine-main must analyze through its engine")
            check_on_engine_stream("engine-main", records, eng)
            check_equal_phase("engine-main", rep, main_rep, 4)
        runs[mode].append((native, analyzer, wall))
        print(f"[engine-main] {mode}: native {native:.6f} s, analyzer {analyzer:.6f} s, wall "
              f"{wall:.6f} s over the 3 measured steps")
        t0 = [m[1] for m in marks if m[0] == "start"][0]
        print_timeline(f"engine-main {mode}", [m for m in marks if m[0] != "start"], t0)
        # 3 more steps, both ring slots warm
        n0, a0 = prog.report.native_s, prog.report.analyzer_s
        marks.clear()
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(3):
            ts = time.perf_counter()
            prog.step(x)
            marks.append(("step", ts, time.perf_counter()))
        prog.flush()
        wall = time.perf_counter() - t0
        cascade += counts()["cascade"]
        native, analyzer = prog.report.native_s - n0, prog.report.analyzer_s - a0
        steady[mode].append((native, analyzer, wall))
        print(f"[engine-main] {mode} steady: native {native:.6f} s, analyzer {analyzer:.6f} s, "
              f"wall {wall:.6f} s over 3 more steps")
        print_timeline(f"engine-main {mode} steady", marks, t0)
        if eng is not None:
            prog.close()
            eng.close()
    for window, rs in (("measured", runs), ("steady", steady)):
        sync_sum = np.mean([n + a for n, a, _ in rs["sync"]])
        sync_native = np.mean([n for n, _, _ in rs["sync"]])
        native = np.mean([n for n, _, _ in rs["async"]])
        wall = np.mean([w for _, _, w in rs["async"]])
        print(f"[engine-main] {window} 3 steps, mean of two runs each: async wall "
              f"{wall:.6f} s against sync native + analyzer {sync_sum:.6f} s (ratio "
              f"{wall / sync_sum:.3f}); async native {native:.6f} s against sync "
              f"native {sync_native:.6f} s (ratio {native / sync_native:.3f})")
    return cascade


def engine_pipeline_main_path(step, x, pipe_rep):
    """engine-pipeline-main: phase 14's pipeline-main through a private
    engine, 1 + 3 steps."""
    with AnalysisEngine() as eng:
        prog = attach_main(figure1_topology(), step, pipeline=True, warmup=True, engine=eng)
        an = prog._analyzer
        check(prog._handle is not None and an._aot.lowerings == 1,
              "engine-pipeline-main must be asynchronous and build at attach")
        records, restore = recording_streams()
        try:
            rep, c, wall, native, analyzer, before = measured_steps(prog, x)
        finally:
            restore()
        check_launches("engine-pipeline-main", c, "scan", 3 * len(an._chain_plan.stage_order))
        check(an._aot.lowerings == 1, f"engine-pipeline-main built {an._aot.lowerings} times")
        stagers = list(eng._stagers.values())
        check(len(stagers) == 1 and stagers[0].pin and stagers[0].slots == 2,
              "engine-pipeline-main must stage through the engine's pinned 2-slot ring")
        check_on_engine_stream("engine-pipeline-main", records, eng)
        check_equal_phase("engine-pipeline-main", rep, pipe_rep, 14)
        print(f"[engine-pipeline-main] native {native:.6f} s, analyzer {analyzer:.6f} s, wall "
              f"{wall:.6f} s over the 3 measured steps; split per step "
              f"{json.dumps(split(rep, before, 3))}")
        prog.close()
    return c["scan"]


def engine_fabric_path(fabric_rep):
    """engine-fabric8: phase 5's fabric under the session's default,
    overlapped rounds on the shared engine, 1 + 3, against phase 5's
    synchronous rounds."""
    with fabric_session(FABRIC_HOSTS, FABRIC_LOAD, FABRIC_EVENTS_PER_ACCESS, "cuda") as sess:
        check(sess._handle is not None and sess._handle.engine is AnalysisEngine.default(),
              "engine-fabric8 must overlap its rounds on the shared engine")
        check(sess.round() is None, "an overlapped round returns no breakdown")
        before = snapshot(sess.report)
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(3):
            sess.round()
        sess.flush()
        wall = time.perf_counter() - t0
        c = counts()
        rep = sess.report
        check_launches("engine-fabric8", c, "hosts", 3, expand=3)
        check_against("engine-fabric8", rep, fabric_rep, hosts=True)
        print(f"[engine-fabric8] analyzer {(rep.analyzer_s - before['analyzer_s']) / 3:.6f} "
              f"s/round, wall {wall / 3:.6f} s/round over the 3 measured rounds")
    return c["hosts"]


COALESCED_LAYERS = (28, 24, 20, 12)  # engine-coalesced's sessions: qwen3-0.6b cut in depth


def engine_coalesced_path(dev, step, x, layers=COALESCED_LAYERS, park_s=2.0):
    """engine-coalesced: phase 4's program cut to each of ``layers`` layers,
    one session each on one engine; their steps' submissions queue behind a
    parked dispatcher and go out as one stacked dispatch: one cascade launch
    over all rows, each session held to its own solo analysis."""
    sessions = len(layers)
    with AnalysisEngine() as eng:
        progs = [attach_main(figure1_topology(), step, engine=eng,
                             cfg=dataclasses.replace(CONFIG, n_layers=n)) for n in layers]
        for p in progs:  # warm-up (the steps may coalesce already)
            p.step(x)
        before = [totals(p.report) for p in progs]
        an_before = [p.report.analyzer_s for p in progs]
        stats0 = eng.stats()
        park = eng.register(ParkAnalyzer(progs[0].sim.flat, park_s))
        records, restore = recording_streams()
        try:
            reset_counts()
            park.submit([MemEvents.empty()])
            for p in progs:
                p.step(x)
            for p in progs:
                p.flush()
            c = counts()
        finally:
            restore()
        park.close()
        stats = eng.stats()
        check_launches("engine-coalesced", c, "cascade", 1)
        check(stats["max_coalesced_sessions"] == sessions
              and stats["coalesced_dispatches"] == stats0["coalesced_dispatches"] + 1,
              f"engine-coalesced: engine stats {stats}, before {stats0}")
        traces = [p.epoch_traces() for p in progs]
        b_rows = bucket_pow2(max(len(tr) for tr in traces), floor=1)
        n_max = bucket_pow2(max(t.n for tr in traces for t in tr))
        shape = [bucket_pow2(sessions, floor=1) * b_rows, n_max]
        check([r[1] for r in records] == [shape],
              f"engine-coalesced: cascade calls {[r[1] for r in records]}, want one of {shape}")
        check_on_engine_stream("engine-coalesced", records, eng)
        # each session's coalesced step against its own solo analysis of the
        # same epochs, at tests/test_engine.py's coalescing bars; the solo
        # latencies differ pairwise by more than the bar, so rows summed
        # into the wrong session, or one session's totals given to all, fail
        solo = [p._analyzer.analyze_batch(tr) for p, tr in zip(progs, traces)]
        lat = [v.latency_ns for v in solo]
        check(all(abs(lat[i] - lat[j]) > 1e-3 * lat[j] for i in range(sessions) for j in range(i)),
              f"engine-coalesced: the sessions' solo latencies {lat} do not tell them apart")
        for i, (p, b, want) in enumerate(zip(progs, before, solo)):
            d = delta(totals(p.report), b)
            check(p.report.coalesced_group_size == sessions,
                  f"session {i}: group size {p.report.coalesced_group_size}")
            for k, w, rel in (("latency_s", want.latency_ns, 1e-6),
                              ("congestion_s", want.congestion_ns, 1e-5),
                              ("bandwidth_s", want.bandwidth_ns, 1e-5)):
                g = s_to_ns(getattr(d, k))
                check(abs(g - w) <= rel * abs(w),
                      f"engine-coalesced session {i} {k}: {g!r} ns vs solo {w!r} ns")
            print(f"[engine-coalesced] session {i} ({layers[i]} layers, {len(traces[i])} "
                  f"epochs): latency {s_to_ns(d.latency_s)!r} ns, congestion "
                  f"{s_to_ns(d.congestion_s)!r} ns, bandwidth {s_to_ns(d.bandwidth_s)!r} ns; "
                  f"solo {want.latency_ns!r}, {want.congestion_ns!r}, {want.bandwidth_ns!r}")
        shares = [p.report.analyzer_s - a for p, a in zip(progs, an_before)]
        print(f"[engine-coalesced] the stacked dispatch {sum(shares):.6f} s (shares "
              f"{[round(v, 6) for v in shares]}); solo analyzer steps before it "
              f"{[round(a, 6) for a in an_before]} s")
        for p in progs:
            p.close()
    # the group's cascade, on the rows the stacked dispatch built, against
    # the sessions' solo batches
    flat = progs[0].sim.flat
    parts = [staged_batch(tr, flat, dev, b_rows, n_max) for tr in traces]
    t4 = torch.cat([b["t"] for b in parts])
    bits4 = torch.cat([b["bits"] for b in parts])
    row = compare("coalesced_batch", t4, bits4, parts[0]["stts"], reps=10)
    solo_ms = []
    for tr in traces:
        b = staged_batch(tr, flat, dev)
        solo_ms.append(median_ms(lambda: kcong.congestion_cascade(b["t"], b["bits"], b["stts"]),
                                 10))
    print(f"[engine-coalesced] cascade over {list(t4.shape)}: {row['ms']:.6f} ms, against "
          f"{sessions} solo batches: {sum(solo_ms):.6f} ms "
          f"({[round(v, 6) for v in solo_ms]} ms)")
    return row, c["cascade"]


def engine_path(dev, step, x, main_rep, pipe_rep, fabric_rep, main_ref, stand_in):
    """Phase 15: the shared analysis engine on the card, then train-main
    synchronously and under the default.  Returns the coalesced batch's
    cascade row and the cascade, scan and hosts launches of its paths."""
    t0 = time.perf_counter()
    cascade = engine_main_path(step, x, main_rep)
    scan = engine_pipeline_main_path(step, x, pipe_rep)
    hosts = engine_fabric_path(fabric_rep)
    row, coalesced = engine_coalesced_path(dev, step, x)
    t1 = time.perf_counter()
    train = engine_train_main_path(dev, main_rep, main_ref, stand_in)
    torch.cuda.empty_cache()
    print(f"[engine] phase 15 ran {time.perf_counter() - t0:.1f} s: train-main (sync and "
          f"default) {time.perf_counter() - t1:.1f}")
    return row, cascade + coalesced + train, scan, hosts


# --------------------------------------------------------------------------- #
# Phase 16: scenario sweeps and the fleet
# --------------------------------------------------------------------------- #

SWEEP_EVENTS_PER_ACCESS = 1024  # phase 4's program
FLEET_RACKS, FLEET_HOSTS, FLEET_TENANTS = 32, 4, 192  # benchmarks/fleet_scaling.py's full scale
FLEET_FRACTIONS = np.linspace(0.0, 1.0, 8)
FLEET_SLOW = dict(pools={"shared_pool": {"latency_ns": 400.0}},
                  switches={"fabric_sw": {"stt_ns": 4.0}})


def sweep_program():
    """Phase 4's program: qwen3-0.6b's training regions and phases at batch
    8, seq 4096."""
    return build_regions_and_phases(CONFIG, "train", batch=8, seq=4096)


def sweep_suite(regions, phases, dev="cuda", **kw):
    """A ScenarioSuite on Figure 1 over phase 4's program, layer epochs."""
    return ScenarioSuite(figure1_topology(), regions, phases, hw=H100_SXM,
                         max_events_per_access=SWEEP_EVENTS_PER_ACCESS, epoch_mode="layer",
                         device=dev, **kw)


def sweep_scenarios(regions):
    """benchmarks/scenario_sweep.py's axes: 4 policies x 4 overrides x 2
    granularities x 2 caches = 64 scenarios."""
    total = int(sum(r.nbytes for r in regions))
    policies = {
        "local": LocalOnlyPolicy(),
        "classmap": ClassMapPolicy(POLICY),
        "interleave": InterleavePolicy(["cxl_pool2", "cxl_pool3"], weights=[1, 2]),
        "hot": HotnessTieredPolicy("cxl_pool1", local_budget_bytes=total // 2),
    }
    overrides = {
        "base": None,
        "far420": TopologyOverride(pools={"cxl_pool2": {"latency_ns": 420.0},
                                          "cxl_pool3": {"latency_ns": 420.0}}),
        "stt30": TopologyOverride(switches={"switch1": {"stt_ns": 30.0}}),
        "thin": TopologyOverride(switches={"switch0": {"bandwidth_gbps": 1.0},
                                           "switch1": {"bandwidth_gbps": 0.5}}),
    }
    caches = {"nocache": None, "cache": CACHE}
    return ScenarioSuite.cartesian(policies, overrides, caches,
                                   granularities=[CACHELINE_BYTES, PAGE_BYTES])


def timed_cascades(name):
    """Wrap the ops entry point ``name`` so each call on the card is timed
    by CUDA events around it and its inputs kept (the first call's); the
    kernels' launch counts are untouched.  Returns (records, restore)."""
    inner = getattr(kops, name)
    records = []

    def timed(t, *args, **kwargs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner(t, *args, **kwargs)
        b.record()
        keep = None if records else (t.clone(), [x.clone() if torch.is_tensor(x) else x
                                                 for x in args], dict(kwargs))
        records.append((list(t.shape), a, b, keep))
        return out

    def restore():
        setattr(kops, name, inner)

    setattr(kops, name, timed)
    return records, restore


def cascade_ms(records) -> list:
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for _, a, b, _ in records]


class CountedCacheModel(tscenario.DeviceCacheModel):
    """The sweep's device-cache model, counting its tag simulations (one
    model a distinct key) and their host seconds."""

    made = 0
    seconds = 0.0

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        CountedCacheModel.made += 1

    def observe_scale(self, trace):
        t0 = time.perf_counter()
        out = super().observe_scale(trace)
        CountedCacheModel.seconds += time.perf_counter() - t0
        return out


def counted_tag_runs(fn):
    """Run ``fn`` with the sweep's cache model counted; returns (fn's
    result, tag simulations, their host seconds)."""
    CountedCacheModel.made, CountedCacheModel.seconds = 0, 0.0
    plain, tscenario.DeviceCacheModel = tscenario.DeviceCacheModel, CountedCacheModel
    try:
        out = fn()
    finally:
        tscenario.DeviceCacheModel = plain
    return out, CountedCacheModel.made, CountedCacheModel.seconds


def solo_sweep(regions, phases, scens, stack):
    """Each scenario through the port's own solo path on the card: place,
    synthesize, the cache's scale rows (one tag simulation a distinct
    granule, placement, cache and latency leaves, as the suite keys them),
    then EpochAnalyzer(stack.member(k)).analyze_batch.  Returns the
    breakdowns, the seconds of the K analyze_batch calls, the tag
    simulations and their seconds."""
    out, analyze_s, scales, tag_s = [], 0.0, {}, 0.0
    for k, s in enumerate(scens):
        flat_k = stack.member(k)
        s.policy.place(regions, flat_k)
        g = s.policy.granularity_bytes
        traces, _, _ = synthesize_step_trace(
            phases, regions, hw=H100_SXM, granularity_bytes=g,
            max_events_per_access=SWEEP_EVENTS_PER_ACCESS, epoch_mode="layer")
        rows = None
        if s.cache is not None:
            key = (g, regions.pool_vector().tobytes(), s.cache,
                   stack.pool_latency_ns[k].tobytes(), stack.pool_media_latency_ns[k].tobytes(),
                   float(stack.local_latency_ns[k]))
            if key not in scales:
                t0 = time.perf_counter()
                model = DeviceCacheModel(s.cache, flat_k, [regions])
                scales[key] = [model.observe_scale(tr) for tr in traces]
                tag_s += time.perf_counter() - t0
            rows = scales[key]
        an = EpochAnalyzer(flat_k, device="cuda")
        t0 = time.perf_counter()
        out.append(an.analyze_batch(traces, rows))
        analyze_s += time.perf_counter() - t0
    return out, analyze_s, len(scales), tag_s


def oracle_of(regions, phases, scenario, flat_k):
    """analyze_ref (f64) over one scenario's placed epochs with its cache
    scale rows."""
    scenario.policy.place(regions, flat_k)
    traces, _, _ = synthesize_step_trace(
        phases, regions, hw=H100_SXM, granularity_bytes=scenario.policy.granularity_bytes,
        max_events_per_access=SWEEP_EVENTS_PER_ACCESS, epoch_mode="layer")
    scales = None
    if scenario.cache is not None:
        model = DeviceCacheModel(scenario.cache, flat_k, [regions])
        scales = [model.observe_scale(tr) for tr in traces]
    return oracle(flat_k, traces, scales=scales)


def check_rel(tag, got, want, bars):
    """Each of ``bars`` (field -> (rel, abs ns)) of two breakdowns."""
    for f, (rel, absol) in bars.items():
        g, w = getattr(got, f), getattr(want, f)
        check(np.isfinite(g) and abs(g - w) <= max(rel * abs(w), absol),
              f"{tag} {f}: {g!r} vs {w!r}")


def sweep_main_path(dev):
    """sweep-main: 64 scenarios of phase 4's program in one dispatch, two
    cascade launches (one per STT row); every scenario against its solo
    analysis on the card, 8 against analyze_ref."""
    t0 = time.perf_counter()
    regions, phases = sweep_program()
    suite = sweep_suite(regions, phases)
    scens = sweep_scenarios(regions)
    records, restore = timed_cascades("congestion_cascade")
    torch.cuda.reset_peak_memory_stats()
    try:
        reset_counts()
        t1 = time.perf_counter()
        res, tags, tag_s = counted_tag_runs(lambda: suite.run(scens))
        wall = time.perf_counter() - t1
        c = counts()
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated()
    check_launches("sweep-main", c, "cascade", 2)
    check(suite.dispatch_count == 1, f"sweep-main: {suite.dispatch_count} dispatches")
    check(len(records) == 2, f"sweep-main: {len(records)} cascade calls")
    ms = cascade_ms(records)
    print(f"[sweep-main] {len(scens)} scenarios, 1 dispatch, {suite.last_unique_cascades} unique "
          f"cascades in {c['cascade']} launches over {[r[0] for r in records]}; "
          f"{tags} tag simulations, {tag_s:.6f} s on the host; stage {res.stage_s:.6f} s, "
          f"transfer {res.transfer_s:.6f} s, compute {res.compute_s:.6f} s; cascades "
          f"{[round(m, 6) for m in ms]} ms on the card; peak device memory "
          f"{peak / 2**30:.3f} GiB; wall {wall:.6f} s")
    reset_counts()
    t1 = time.perf_counter()
    res2 = suite.run(scens)
    wall2 = time.perf_counter() - t1
    c2 = counts()
    check_launches("sweep-main warm", c2, "cascade", 2)
    for a, b in zip(res.breakdowns, res2.breakdowns):
        check_rel("sweep-main warm run", b, a, {f: (1e-6, 0.0) for f in
                  ("latency_ns", "congestion_ns", "bandwidth_ns")})
    print(f"[sweep-main] warm second run: wall {wall2:.6f} s (stage {res2.stage_s:.6f}, "
          f"transfer {res2.transfer_s:.6f}, compute {res2.compute_s:.6f})")

    # every scenario against the port's own solo path on the card
    stack = flatten_stack(suite.topology, [s.topology for s in scens])
    solo_regions, _ = sweep_program()
    solo, solo_s, solo_tags, solo_tag_s = solo_sweep(solo_regions, phases, scens, stack)
    bitwise = 0
    for k, (g, w) in enumerate(zip(res.breakdowns, solo)):
        check_rel(f"sweep-main {scens[k].name} vs solo", g, w,
                  {f: (1e-6, 0.0) for f in ("latency_ns", "congestion_ns", "bandwidth_ns")})
        bitwise += g.congestion_ns == w.congestion_ns
    worst = {f: max(abs(getattr(g, f) - getattr(w, f)) / max(abs(getattr(w, f)), 1e-30)
                    for g, w in zip(res.breakdowns, solo))
             for f in ("latency_ns", "congestion_ns", "bandwidth_ns")}
    print(f"[sweep-main] every scenario within rel 1e-6 of its solo analysis (largest "
          f"{json.dumps(worst)}); congestion bitwise in {bitwise} of {len(scens)}; the K solo "
          f"analyze_batch calls {solo_s:.6f} s, their {solo_tags} tag simulations "
          f"{solo_tag_s:.6f} s")
    # 8 scenarios against analyze_ref at the main path's bars; between them
    # every policy, override, granularity and cache
    pols, ovs = ("local", "classmap", "interleave", "hot"), ("base", "far420", "stt30", "thin")
    grans, caches = (CACHELINE_BYTES, PAGE_BYTES), ("nocache", "cache")
    picks = [f"{ovs[(i + i // 4) % 4]}/{pols[i % 4]}/g{grans[i % 2]}/{caches[(i // 2) % 2]}"
             for i in range(8)]
    names = [s.name for s in scens]
    bars = {"latency_ns": (1e-4, 1e-3), "congestion_ns": (1e-3, 1e-2),
            "bandwidth_ns": (1e-2, 1.0)}
    for name in picks:
        k = names.index(name)
        want = oracle_of(solo_regions, phases, scens[k], stack.member(k))
        check_rel(f"sweep-main {name} vs analyze_ref", res.breakdowns[k], want, bars)
        g = res.breakdowns[k]
        print(f"[sweep-main] {name}: latency {g.latency_ns!r}, congestion {g.congestion_ns!r}, "
              f"bandwidth {g.bandwidth_ns!r} ns; analyze_ref {want.latency_ns!r}, "
              f"{want.congestion_ns!r}, {want.bandwidth_ns!r}")
    best = res.best()
    print(f"[sweep-main] best feasible {names[best]} (slowdown "
          f"{float(res.slowdowns()[best])!r}); phase {time.perf_counter() - t0:.1f} s")
    t, args, kw = records[0][3]
    row = compare("sweep_group", t, args[0], args[1], reps=10)
    return row, c["cascade"] + c2["cascade"], res, scens


def sweep_qos_path(dev, main_res, main_scens):
    """sweep-qos: phase 4's policy under FIFO, priority, WFQ 4:1 and WFQ 1:4
    with the optimizer state and gradients in class 1: one dispatch, one
    single-host QoS launch per discipline and weight row."""
    regions, phases = sweep_program()
    rq = {r.name: 1 for r in regions if r.tensor_class in ("opt_state", "grad")}
    suite = sweep_suite(regions, phases, region_qos=rq)
    specs = [QosSpec(discipline="fifo"), QosSpec(discipline="priority"),
             QosSpec(discipline="wfq", class_weights=(4.0, 1.0)),
             QosSpec(discipline="wfq", class_weights=(1.0, 4.0))]
    scens = [Scenario(ClassMapPolicy(POLICY), qos=q, name=q.describe()) for q in specs]
    records, restore = timed_cascades("qos_congestion_cascade")
    try:
        reset_counts()
        t0 = time.perf_counter()
        res = suite.run(scens)
        wall = time.perf_counter() - t0
        c = counts()
    finally:
        restore()
    check_launches("sweep-qos", c, "qos", 4)
    check(suite.dispatch_count == 1 and res.qos_classes == 2,
          f"sweep-qos: {suite.dispatch_count} dispatches, {res.qos_classes} classes")
    ms = cascade_ms(records)
    fifo, prio, wfq41, wfq14 = res.breakdowns
    off = main_res.breakdowns[[s.name for s in main_scens].index(
        f"base/classmap/g{CACHELINE_BYTES}/nocache")]
    # tests/test_qos_cascade.py:470's bars
    qos_bars = {"congestion_ns": (1e-5, 4.0), "latency_ns": (1e-5, 0.0),
                "bandwidth_ns": (1e-4, 1.0)}
    check_rel("sweep-qos FIFO vs QoS off", fifo, off, qos_bars)
    # class 0 (params, activations) stays in local DRAM under phase 4's
    # policy and never queues: class 1 holds all the congestion, priority
    # equals FIFO, and WFQ stretches class 1's service by W / w_1
    for b, name in zip(res.breakdowns, ("fifo", "priority", "wfq 4:1", "wfq 1:4")):
        check(b.per_class_congestion_ns[0] == 0.0,
              f"sweep-qos {name}: class 0 queued {b.per_class_congestion_ns.tolist()}")
    check_rel("sweep-qos priority vs FIFO", prio, fifo, qos_bars)
    check(fifo.congestion_ns < wfq14.congestion_ns < wfq41.congestion_ns,
          f"sweep-qos: congestion FIFO {fifo.congestion_ns}, WFQ 1:4 {wfq14.congestion_ns}, "
          f"WFQ 4:1 {wfq41.congestion_ns}")
    for row in res.table():
        print(f"[sweep-qos] {row['scenario']}: congestion {row['congestion_ms']!r} ms, shares "
              f"{row['qos_delay_shares']}")
    print(f"[sweep-qos] 1 dispatch, {c['qos']} QoS launches over {[r[0] for r in records]} "
          f"({[round(m, 6) for m in ms]} ms on the card), wall {wall:.6f} s; FIFO against "
          f"QoS off: congestion {fifo.congestion_ns!r} / {off.congestion_ns!r}, latency "
          f"{fifo.latency_ns!r} / {off.latency_ns!r}, bandwidth {fifo.bandwidth_ns!r} / "
          f"{off.bandwidth_ns!r} ns")
    t, args, kw = records[0][3]
    row, _ = compare_qos("sweep_qos_group", t, args[0], args[2], args[1], args[3], args[4],
                         reps=10)
    return row, c["qos"]


def fleet_tenants():
    return [synthetic_tenant(f"t{i}", seed=i, gib=10.0) for i in range(FLEET_TENANTS)]


def check_planes(tag, reports, fleet, placements_of):
    """Every rack plane of ``reports`` against a solo analyze_batch of its
    rack's rows on the card (fleet_scaling.py's sequential_eval): totals at
    the main path's bars, per-host latency and congestion at rtol 1e-4 /
    5e-3."""
    an = EpochAnalyzer(fleet.flat, bw_window_ns=fleet.bw_window_ns, n_windows=fleet.n_windows,
                       device="cuda")
    bars = {"latency_ns": (1e-4, 1e-3), "congestion_ns": (1e-3, 1e-2),
            "bandwidth_ns": (1e-2, 1.0)}
    t0 = time.perf_counter()
    n = 0
    for rep, placements in zip(reports, placements_of):
        traces, _ = fleet._rack_timelines(placements)
        for r, rows in enumerate(traces):
            solo = an.analyze_batch(rows)
            got = rep.breakdowns[r]
            check_rel(f"{tag} rack {r} at {rep.offload_fraction}", got, solo, bars)
            np.testing.assert_allclose(got.per_host_latency_ns, solo.per_host_latency_ns,
                                       rtol=1e-4, atol=1e-3)
            np.testing.assert_allclose(got.per_host_congestion_ns,
                                       solo.per_host_congestion_ns, rtol=5e-3, atol=1e-2)
            n += 1
    return n, time.perf_counter() - t0


def fleet_frontier_path(dev):
    """fleet-frontier: 32 racks of 4 hosts, 192 tenants, 8 offload
    fractions in one dispatch over 256 rack planes: one host-segmented
    cascade launch."""
    tenants = fleet_tenants()
    fleet = FleetSim(FLEET_RACKS, hosts_per_rack=FLEET_HOSTS, hw=H100_SXM, device="cuda")
    records, restore = timed_cascades("congestion_cascade")
    try:
        reset_counts()
        t0 = time.perf_counter()
        pts = fleet.frontier(tenants, offload_fractions=FLEET_FRACTIONS)
        wall = time.perf_counter() - t0
        c = counts()
    finally:
        restore()
    check_launches("fleet-frontier", c, "hosts", 1)
    check(fleet.dispatch_count == 1, f"fleet-frontier: {fleet.dispatch_count} dispatches")
    ms = cascade_ms(records)
    st = fleet.last_dispatch
    print(f"[fleet-frontier] {FLEET_RACKS * FLEET_HOSTS} hosts, {FLEET_TENANTS} tenants, "
          f"{len(pts)} fractions: 1 dispatch over {st.rows} rack planes, {c['hosts']} hosts "
          f"launch over {[r[0] for r in records]} ({[round(m, 6) for m in ms]} ms on the "
          f"card); stage {st.stage_s:.6f} s, transfer {st.transfer_s:.6f} s, compute "
          f"{st.compute_s:.6f} s; wall {wall:.6f} s")
    gb = [p.stranded_recovered_gb for p in pts]
    check(gb[0] == 0.0 and all(b >= a for a, b in zip(gb, gb[1:])),
          f"fleet-frontier: stranded GB {gb}")
    for p in pts:
        print(f"[fleet-frontier] offload {p.offload_fraction:.4f}: stranded "
              f"{p.stranded_recovered_gb!r} GB, p99 slowdown {p.p99_slowdown!r}, mean "
              f"{p.mean_slowdown!r}")
    n, solo_s = check_planes("fleet-frontier", [p.report for p in pts], fleet,
                             [p.report.placements for p in pts])
    print(f"[fleet-frontier] all {n} planes within the bars of their solo analyses "
          f"({solo_s:.6f} s for the {n} solo analyze_batch calls)")
    t, args, kw = records[0][3]
    row = compare_hosts("fleet_frontier_batch", t, args[0], kw["hosts"], args[1],
                        kw["n_hosts"], reps=10)
    return row, c["hosts"]


def fleet_hetero_qos_path(dev):
    """fleet-hetero-qos: the same tenants alternating between QoS classes 0
    and 1, racks alternating between the base and a slow expander (400 ns,
    STT 4 ns) and between WFQ 4:1 and priority: two host-segmented QoS
    launches, every rack held to the same fleet on the CPU."""
    tenants = [dataclasses.replace(t, qos_class=i % 2) for i, t in enumerate(fleet_tenants())]
    kw = dict(
        hosts_per_rack=FLEET_HOSTS, hw=H100_SXM,
        rack_overrides=[None if r % 2 == 0 else TopologyOverride(**FLEET_SLOW)
                        for r in range(FLEET_RACKS)],
        rack_qos=[QosSpec(discipline="wfq", class_weights=(4.0, 1.0)) if r % 2 == 0
                  else QosSpec(discipline="priority") for r in range(FLEET_RACKS)],
    )
    fleet = FleetSim(FLEET_RACKS, device="cuda", **kw)
    records, restore = timed_cascades("qos_congestion_cascade")
    try:
        reset_counts()
        t0 = time.perf_counter()
        rep = fleet.simulate(tenants, policy="round_robin", offload_fraction=1.0)
        wall = time.perf_counter() - t0
        c = counts()
    finally:
        restore()
    check_launches("fleet-hetero-qos", c, "qos_hosts", 2)
    ms = cascade_ms(records)
    t0 = time.perf_counter()
    twin = FleetSim(FLEET_RACKS, device="cpu", **kw).simulate(
        tenants, policy="round_robin", offload_fraction=1.0)
    cpu_s = time.perf_counter() - t0
    bars = {"latency_ns": (1e-4, 1e-3), "congestion_ns": (1e-3, 1e-2),
            "bandwidth_ns": (1e-2, 1.0)}
    for r, (g, w) in enumerate(zip(rep.breakdowns, twin.breakdowns)):
        check_rel(f"fleet-hetero-qos rack {r} vs CPU", g, w, bars)
        np.testing.assert_allclose(g.per_host_latency_ns, w.per_host_latency_ns, rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(g.per_host_congestion_ns, w.per_host_congestion_ns,
                                   rtol=5e-3, atol=1e-2)
        np.testing.assert_allclose(g.per_class_congestion_ns, w.per_class_congestion_ns,
                                   rtol=5e-3, atol=1e-2)
    check(rep.stranded_recovered_bytes == twin.stranded_recovered_bytes,
          "fleet-hetero-qos: stranded bytes differ from the CPU run")
    # latency per event, slow racks over base racks (the delays themselves
    # are bandwidth-led, and the racks hold different tenants)
    lat = [sum(b.latency_ns for b in rep.breakdowns[i::2]) for i in (0, 1)]
    n_ev = [sum(tr.n for rows in fleet._rack_timelines(rep.placements)[0][i::2] for tr in rows)
            for i in (0, 1)]
    slow = (lat[1] / n_ev[1]) / (lat[0] / n_ev[0])
    check(slow > 1.0, f"fleet-hetero-qos: the slow racks' latency per event {slow}x the base's")
    print(f"[fleet-hetero-qos] {c['qos_hosts']} host-segmented QoS launches over "
          f"{[r[0] for r in records]} ({[round(m, 6) for m in ms]} ms on the card), wall "
          f"{wall:.6f} s (the CPU twin {cpu_s:.6f} s); every rack within the fabric bars of "
          f"the CPU run; p99 slowdown {rep.p99_slowdown()!r}, mean {rep.mean_slowdown()!r}; "
          f"the slow racks' latency per event {slow:.4f}x the base racks'; per-class congestion "
          f"{np.sum([b.per_class_congestion_ns for b in rep.breakdowns], axis=0).tolist()} ns")
    t, args, kw_ = records[0][3]
    row = compare_qos_hosts("fleet_hetero_qos_batch", t, args[0], args[2], kw_["hosts"],
                            args[1], args[3], args[4], kw_["n_hosts"], reps=10)
    return row, c["qos_hosts"]


def sweep_fleet_path(dev):
    """Phase 16: scenario sweeps and the fleet on the card.  Returns the
    cells' kernel rows and their launches by kernel."""
    t0 = time.perf_counter()
    sweep_row, cascade, res, scens = sweep_main_path(dev)
    t1 = time.perf_counter()
    qos_row, qos = sweep_qos_path(dev, res, scens)
    del res
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    fleet_row, hosts = fleet_frontier_path(dev)
    t3 = time.perf_counter()
    hetero_row, qos_hosts = fleet_hetero_qos_path(dev)
    print(f"[sweep-fleet] phase 16 ran {time.perf_counter() - t0:.1f} s: sweep-main "
          f"{t1 - t0:.1f}, sweep-qos {t2 - t1:.1f}, fleet-frontier {t3 - t2:.1f}, "
          f"fleet-hetero-qos {time.perf_counter() - t3:.1f}")
    return (sweep_row, qos_row, fleet_row, hetero_row), dict(
        cascade=cascade, qos=qos, hosts=hosts, qos_hosts=qos_hosts)


# --------------------------------------------------------------------------- #
# Training: the model's own qwen3-0.6b train step
# --------------------------------------------------------------------------- #

TRAIN_SMALL = dict(batch=8, seq=128, steps=3)  # card against CPU, qwen3-0.6b's SMOKE at f32
TRAIN_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10)  # the small run's schedule
# the same f32 loss on the same weights and batches, reduced in another
# order on the card (the head's chunks, cuBLAS' sums)
TRAIN_LOSS_REL = 1e-5
TRAIN_MAIN = dict(batch=8, seq=4096, steps=3)  # main's program: 1 warm-up + 3 measured steps


def expect_refusal(tag, fn, match):
    """``fn()`` must raise NotImplementedError naming ``match``."""
    try:
        fn()
    except NotImplementedError as e:
        check(match in str(e), f"{tag}: refused, but not for {match!r}: {e}")
        print(f"[train-refusals] {tag}: {e}")
        return
    check(False, f"{tag}: ran, want NotImplementedError ({match})")


def train_card_vs_cpu(tag, cfg, dev, compress=False):
    """``cfg`` at f32, one seeded model's weights carried to the card and
    kept on the CPU, 3 train steps on each (int8 error-feedback compression
    of the gradients with ``compress``) from the same SyntheticPipeline
    batches: losses to rel 1e-5, and the parameters after the steps within
    2 x the sum of the steps' lr (AdamW's first update is about
    lr·sign(g): an element whose gradient is near 0 and changes sign
    between the two devices moves by up to 2·lr)."""
    cfg = dataclasses.replace(cfg, dtype=torch.float32, cache_dtype=torch.float32)
    opt = AdamWConfig(**TRAIN_OPT)
    cpu = Model(cfg, device="cpu", seed=0)
    card = model_params_from_arrays(cfg, params_to_arrays(cpu), device=dev)
    runs = {}
    for where, model, d in (("card", card, dev), ("cpu", cpu, torch.device("cpu"))):
        step = make_train_step(cfg, opt, compress_grads=compress, device=d)
        pipe = SyntheticPipeline(cfg, TRAIN_SMALL["batch"], TRAIN_SMALL["seq"], seed=0, device=d)
        state = {"adam": adamw_init(model, opt), "ef": init_error_state(model) if compress else {}}
        metrics = []
        for s in range(TRAIN_SMALL["steps"]):
            model, state, m = step(model, state, pipe.device_batch(s))
            metrics.append({k: float(v) for k, v in m.items()})
        runs[where] = (model, metrics)
    lrs = []
    for s, (a, b) in enumerate(zip(runs["card"][1], runs["cpu"][1])):
        rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        check(rel <= TRAIN_LOSS_REL, f"{tag} step {s}: loss {a['loss']!r} on the card, "
              f"{b['loss']!r} on the CPU, rel {rel:.3e}")
        print(f"[{tag}] step {s}: loss {a['loss']!r} card, {b['loss']!r} cpu (rel "
              f"{rel:.3e}); aux {a['aux']!r} / {b['aux']!r}; grad_norm {a['grad_norm']!r} / "
              f"{b['grad_norm']!r}; lr {a['lr']!r}")
        lrs.append(b["lr"])
    atol = 2 * sum(lrs) + 1e-6
    worst, over = 0.0, 0
    cpu_params = dict(runs["cpu"][0].named_parameters())
    for name, p in runs["card"][0].named_parameters():
        diff = (p.detach().cpu() - cpu_params[name].detach()).abs()
        worst = max(worst, float(diff.max()))
        over += int((diff > 1e-3 * lrs[0]).sum())
    check(worst <= atol, f"{tag}: parameters part by {worst!r}, over {atol!r}")
    n = sum(p.numel() for p in cpu_params.values())
    print(f"[{tag}] parameters after {len(lrs)} steps within {worst!r} (bar {atol!r}); "
          f"{over} of {n} elements part by more than 1e-3·lr")


def train_small_path(dev):
    """Phase 17a: qwen3-0.6b's SMOKE, the card against the CPU
    (:func:`train_card_vs_cpu`)."""
    train_card_vs_cpu("train-small", Q3_SMOKE, dev)


def train_main_run(tag, prog, model, state, pipe, first):
    """1 warm-up and ``TRAIN_MAIN['steps']`` measured train steps through
    ``prog`` on the pipeline's batches ``first``, ``first + 1``, ...: the
    engine flushed after the warm-up and after the measured steps, each
    measured step's native seconds read as the step returns (the submitting
    thread's own clock), each dispatch's launch and finish marked.  Returns
    the model, state and a record of the run."""
    marks = []
    dispatch_timeline(prog._analyzer, marks)
    losses = []
    model, state, m = prog.step(model, state, pipe.device_batch(first))
    losses.append(float(m["loss"]))
    warm = prog.report  # flushes the warm-up step
    warm_native, warm_analyzer = warm.native_s, warm.analyzer_s
    marks.clear()
    reset_counts()
    native, steps, last = [], [], warm_native
    t0 = time.perf_counter()
    for s in range(1, 1 + TRAIN_MAIN["steps"]):
        ts = time.perf_counter()
        model, state, m = prog.step(model, state, pipe.device_batch(first + s))
        te = time.perf_counter()
        with prog._report_lock:  # written by this thread only: no flush needed
            now = prog._report.native_s
        native.append(now - last)
        last = now
        steps.append((ts, te))
        losses.append(float(m["loss"]))
    prog.flush()
    wall = time.perf_counter() - t0
    c = counts()
    rep = prog.report
    check_launches(tag, c, "cascade", TRAIN_MAIN["steps"], expand=TRAIN_MAIN["steps"])
    launches = sorted(m_ for m_ in marks if m_[0] == "launch")
    finishes = sorted(m_ for m_ in marks if m_[0] == "finish")
    check(len(launches) == len(finishes) == TRAIN_MAIN["steps"],
          f"{tag}: {len(launches)} dispatches launched, {len(finishes)} finished")
    return model, state, dict(
        prog=prog, rep=rep, c=c, losses=losses, m=m, native=native, steps=steps, t0=t0,
        wall=wall, launches=launches, finishes=finishes, warm_native=warm_native,
        warm_analyzer=warm_analyzer,
        analyzer=(rep.analyzer_s - warm_analyzer) / TRAIN_MAIN["steps"])


def engine_train_main_path(dev, main_rep, main_ref, stand_in):
    """engine-train-main (phase 15) and train-main (phase 17b): qwen3-0.6b's
    own train step at its published widths (bf16 compute, f32 master
    parameters and AdamW moments, remat), 8 x 4096-token SyntheticPipeline
    batches, attached to main's program, policy and Figure 1 topology
    twice, 1 warm-up and 3 measured steps each: with
    ``async_analysis=False``, then under the default (asynchronous, the
    shared engine), the model training on through both.  Bars: one cascade
    launch a step and nothing else; both runs' totals equal (latency and
    bandwidth rel 1e-6, congestion 1e-4) and phase 4's, within phase 4's
    bars of analyze_ref; the default run's mean native step within 1.10 of
    the synchronous run's, and each of its dispatches launched after its
    own step began and before it returned (the analysis overlaps the
    native step); every loss
    finite, the first within 1.0 of ln(vocab).  Then one unattached step
    under the profiler.  Returns the cascade's launches."""
    check(CONFIG.remat and CONFIG.dtype == torch.bfloat16, "train-main: want bf16 with remat")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(CONFIG, device=dev, seed=0)
    opt = AdamWConfig()
    state = {"adam": adamw_init(model, opt), "ef": {}}
    train_step = make_train_step(CONFIG, opt, device=dev)
    pipe = SyntheticPipeline(CONFIG, TRAIN_MAIN["batch"], TRAIN_MAIN["seq"], seed=0, device=dev)
    runs = {}
    first = 0
    for mode, kw in (("sync", dict(async_analysis=False)), ("default", {})):
        prog = attach_main(figure1_topology(), train_step, **kw)
        asy = prog._handle is not None
        check(asy == (mode == "default") and prog.sim.async_analysis == asy
              and (not asy or prog._handle.engine is AnalysisEngine.default()),
              f"train-main {mode}: asynchronous {asy}")
        if mode == "sync":
            print(f"[train-main] {sum(p.numel() for p in model.parameters())} parameters, "
                  f"{len(prog.epoch_traces())} epochs a step, set-up "
                  f"{time.perf_counter() - t0:.3f} s")
        model, state, r = train_main_run(f"train-main {mode}", prog, model, state, pipe, first)
        prog.close()
        first += 1 + TRAIN_MAIN["steps"]
        runs[mode] = r
        rep = r["rep"]
        check(rep.steps == main_rep.steps, f"train-main {mode} {rep.steps} steps")
        check_totals(f"train-main {mode}", rep, main_ref, rep.steps)
        check_like(f"train-main {mode} vs phase 4", totals(rep), totals(main_rep))
    sync, dflt = runs["sync"], runs["default"]
    check_equal_phase("train-main default vs sync", dflt["rep"], sync["rep"], "15 sync")
    ratios = [a / b for a, b in zip(dflt["native"], sync["native"])]
    mean_ratio = float(np.mean(dflt["native"]) / np.mean(sync["native"]))
    sync_sum = float(np.sum(sync["native"])) + sync["analyzer"] * TRAIN_MAIN["steps"]
    for k in range(TRAIN_MAIN["steps"]):
        ts, te = dflt["steps"][k]
        la, fi = dflt["launches"][k], dflt["finishes"][k]
        print(f"[train-main] step {k + 1}: native {dflt['native'][k]:.6f} s (sync "
              f"{sync['native'][k]:.6f} s, ratio {ratios[k]:.4f}); the step {1e3 * (ts - dflt['t0']):.1f}-"
              f"{1e3 * (te - dflt['t0']):.1f} ms, its dispatch launched "
              f"{1e3 * (la[1] - dflt['t0']):.1f}-{1e3 * (la[2] - dflt['t0']):.1f} ms, finished "
              f"{1e3 * (fi[1] - dflt['t0']):.1f}-{1e3 * (fi[2] - dflt['t0']):.1f} ms")
        check(ts <= la[1] <= te,
              f"train-main step {k + 1}: its dispatch was not launched during the step")
    print(f"[train-main] default (asynchronous): native {float(np.sum(dflt['native'])):.6f} s, "
          f"wall {dflt['wall']:.6f} s over the 3 measured steps, against sync native + "
          f"analyzer {sync_sum:.6f} s (wall ratio {dflt['wall'] / sync_sum:.4f}); mean native "
          f"ratio {mean_ratio:.4f} (bar 1.10); analyzer {dflt['analyzer']:.6f} s/step "
          f"(sync {sync['analyzer']:.6f}); sync wall {sync['wall']:.6f} s")
    check(mean_ratio <= 1.10, f"train-main: asynchronous native {mean_ratio:.4f}x the sync run's")
    rep = dflt["rep"]
    losses = sync["losses"] + dflt["losses"]
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"train-main: a loss is not finite: {losses}")
    ln_v = float(np.log(CONFIG.vocab_size))
    check(abs(losses[0] - ln_v) <= 1.0, f"train-main: first loss {losses[0]!r}, ln V {ln_v!r}")
    native = float(np.mean(dflt["native"]))
    m = dflt["m"]
    print(f"[train-main] losses {losses} (ln V = {ln_v!r}); lr {float(m['lr'])!r}, grad_norm "
          f"{float(m['grad_norm'])!r}")
    print(f"[train-main] native {native:.6f} s/step and analyzer {dflt['analyzer']:.6f} s/step "
          f"over the {TRAIN_MAIN['steps']} measured steps under the default (warm-up step "
          f"native {dflt['warm_native']:.6f} s, analyzer {dflt['warm_analyzer']:.6f} s); phase "
          f"4's stand-in native {stand_in['native_s']:.6f} s/step, analyzer "
          f"{stand_in['analyzer_s']:.6f} s/step; simulated slowdown {rep.slowdown!r}")
    print(f"[train-main] peak device memory {peak} bytes ({peak / 2**30:.3f} GiB) over the "
          f"model, optimizer state and 8 steps")
    # one more step, unattached, under the profiler: the device time by op
    batch = pipe.device_batch(first)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        model, state, m = train_step(model, state, batch)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t1
    check(np.isfinite(float(m["loss"])), "train-main: the profiled step's loss is not finite")
    print(f"[train-main] one step under torch.profiler {prof_s:.6f} s")
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=20))
    return sync["c"]["cascade"] + dflt["c"]["cascade"]


def train_refusals(dev):
    """Phase 17c: the kernels have no backward: ops.ssd and ops.attention on
    CUDA tensors that require grad raise before any launch, and so does
    building a train step for mamba2 on the card."""
    before = counts()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(1, 128, 2, 64, generator=g, device=dev, requires_grad=True)
    dt = torch.full((1, 128, 2), 0.1, device=dev)
    bm = torch.randn(1, 128, 16, generator=g, device=dev)
    A = -torch.ones(2, device=dev)
    q = torch.randn(1, 4, 128, 64, generator=g, device=dev, requires_grad=True)
    kv = torch.randn(1, 2, 128, 64, generator=g, device=dev)
    expect_refusal("ops.ssd", lambda: kops.ssd(x, dt, A, bm, bm, chunk=64),
                   "SSD backward kernel")
    expect_refusal("ops.attention", lambda: kops.attention(q, kv, kv),
                   "flash attention backward kernel")
    expect_refusal("make_train_step(mamba2-2.7b)",
                   lambda: make_train_step(M2_CONFIG, AdamWConfig(), device=dev),
                   "SSD backward kernel")
    check(counts() == before, f"train-refusals launched: {before} -> {counts()}")


def train_path(dev):
    """Phase 17: training (train-main, 17b, runs in phase 15 beside its
    synchronous twin: :func:`engine_train_main_path`)."""
    t0 = time.perf_counter()
    train_small_path(dev)
    t1 = time.perf_counter()
    train_refusals(dev)
    print(f"[train] phase 17 ran {time.perf_counter() - t0:.1f} s: train-small {t1 - t0:.1f} "
          f"(train-main ran in phase 15)")


# --------------------------------------------------------------------------- #
# The MoE and hybrid families: granite-moe-3b-a800m, llama4-maverick, jamba
# --------------------------------------------------------------------------- #

MOE_ARCHS = ("granite-moe-3b-a800m", "llama4-maverick-400b-a17b")
# SMOKE models, card against CPU: 2 sequences of 64 tokens; jamba also
# under LONG's sliding-window attention, at a window that bites in 64
# tokens (LONG's own 4096 would not)
MOE_SMALL = dict(batch=2, seq=64, window=16)
MODEL_RTOL = 1e-4  # logits and aux, card against CPU at f32 (tests/test_torch_moe.py)
ROUNDTRIP_BAR = 5e-4  # lossless prefill S-1 + decode against prefill S (tests/test_arch_smoke.py)
# a token routed differently on the two devices must be a near-tie: the
# CPU's probability of its own choice above its probability of the card's
# choice by at most this many f32 ulps
NEAR_TIE_ULPS = 16
# the three dispatches on one layer at granite's widths, card against CPU:
# 2 groups of 128 tokens, lossless (cf = E/k) and lossy (granite's 1.25)
DISPATCH_TOKENS, DISPATCH_GROUP = 256, 128
DISPATCH_TOL = (2e-5, 2e-5)  # rtol, atol: tests/test_moe.py's bar
# serve-moe: granite's prefill/decode roundtrip at f32 in the dense
# dispatch (lossless; at lossless capacity the einsum one would need a
# [8, 4096, 40, 32768] dispatch tensor), all 32 layers, every sequence
MOE_ROUNDTRIP_F32 = (32, 5e-4)
# train-moe: 1 warm-up + 3 measured steps of 4 x 4096 tokens.  Cut from 8
# x 4096, where the first step's backward ran out of the card's memory
# beside the 52.8 GB of f32 parameters, gradients and AdamW moments
# (PERF.md §6)
MOE_TRAIN = dict(batch=4, seq=4096)
JAMBA_LAYERS = 8  # jamba cut to one of its 4 groups (7 Mamba2 + 1 attention sublayer)
JAMBA_DECODES = 8


def recorded(fn, keep_probs=False):
    """``fn()`` with every MoE routing it runs recorded (``models.moe.route``
    wrapped, then restored): (result, records), each record ``(probs or
    None, Routing)``."""
    inner = mmoe.route
    records = []

    def recorder(probs, top_k, cap):
        r = inner(probs, top_k, cap)
        records.append((probs.detach().cpu() if keep_probs else None, r))
        return r

    mmoe.route = recorder
    try:
        return fn(), records
    finally:
        mmoe.route = inner


def route_flips(tag, card, cpu):
    """Two runs' routings call by call: each token whose experts differ
    must be a near-tie in the CPU's probabilities (its own choice above the
    card's by at most NEAR_TIE_ULPS ulps).  Prints and returns the flipped
    tokens as (routing call, flat token index) pairs."""
    check(len(card) == len(cpu), f"{tag}: {len(card)} routings on the card, {len(cpu)} on the CPU")
    flips = []
    for call, ((_, rc), (probs, rp)) in enumerate(zip(card, cpu)):
        idx_c = rc.idx.cpu()
        check(idx_c.shape == rp.idx.shape, f"{tag}: routing {call}'s shapes differ")
        gs = idx_c.shape[1]
        for g, s in (idx_c != rp.idx).any(-1).nonzero().tolist():
            j = int((idx_c[g, s] != rp.idx[g, s]).nonzero()[0])
            mine, theirs = int(rp.idx[g, s, j]), int(idx_c[g, s, j])
            p_mine, p_theirs = float(probs[g, s, mine]), float(probs[g, s, theirs])
            ulps = (p_mine - p_theirs) / float(np.spacing(np.float32(p_mine)))
            print(f"[{tag}] route flip in routing {call}, token {g * gs + s}, place {j}: the CPU's "
                  f"expert {mine} at {p_mine!r}, the card's {theirs} at {p_theirs!r} "
                  f"({ulps:.1f} ulps)")
            check(0.0 <= ulps <= NEAR_TIE_ULPS, f"{tag}: a route flipped across {ulps} ulps")
            flips.append((call, g * gs + s))
    return flips


def drop_share(records):
    """The share of routes past their expert's capacity in ``records``."""
    kept = sum(int(r.keep.sum()) for _, r in records)
    total = sum(r.keep.numel() for _, r in records)
    return 1.0 - kept / total, total


def check_rows(tag, got, want, rtol, atol):
    """``got`` against ``want`` (CPU tensors) elementwise at rtol / atol;
    returns the largest difference."""
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    over = int((diff > atol + rtol * want.abs()).sum())
    check(over == 0, f"{tag}: {over} elements part by more than {rtol} / {atol}, the most "
          f"{float(diff.max())!r}")
    return float(diff.max())


def moe_small_model(tag, cfg, dev):
    """Phase 18a: one seeded SMOKE model at f32 on the card and the CPU:
    forward logits and aux with every routing compared (a sequence holding
    a flipped near-tie is left out of the logits bar), then the lossless
    prefill S-1 plus one decode against the forward of S on the card."""
    cfg = dataclasses.replace(cfg, dtype=torch.float32, cache_dtype=torch.float32)
    cpu = Model(cfg, device="cpu", seed=0)
    weights = params_to_arrays(cpu)
    card = model_params_from_arrays(cfg, weights, device=dev)
    B, S = MOE_SMALL["batch"], MOE_SMALL["seq"]
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(3))
    out = {}
    for where, model, t in (("card", card, toks.to(dev)), ("cpu", cpu, toks)):
        with torch.inference_mode():
            (logits, aux), records = recorded(lambda: model(t), keep_probs=True)
        out[where] = (logits.cpu(), float(aux), records)
    flips = route_flips(tag, out["card"][2], out["cpu"][2])
    rows = sorted({tok // S for _, tok in flips})
    keep = [b for b in range(B) if b not in rows]
    want = out["cpu"][0][keep]
    err = check_rows(f"{tag} logits", out["card"][0][keep], want, MODEL_RTOL,
                     MODEL_RTOL * float(want.abs().max()))
    a, b = out["card"][1], out["cpu"][1]
    if not flips:
        check(abs(a - b) <= MODEL_RTOL * abs(b), f"{tag}: aux {a!r} on the card, {b!r} on the CPU")
    print(f"[{tag}] forward: logits within {err!r} of the CPU's on {len(keep)} of {B} "
          f"sequences; aux {a!r} card, {b!r} cpu; {len(out['cpu'][2])} MoE routings, "
          f"{len(flips)} route flips")
    # the lossless roundtrip on the card (tests/test_arch_smoke.py:64-90)
    n_exp = float(max(cfg.n_experts, 1))
    lossless = dataclasses.replace(cfg, capacity_factor=n_exp, decode_capacity_factor=n_exp)
    model = model_params_from_arrays(lossless, weights, device=dev)
    t = toks.to(dev)
    full, _, _ = make_prefill_step(lossless)(model, {"tokens": t})
    _, caches, clen = make_prefill_step(lossless, pad_to=S + 4)(model, {"tokens": t[:, :-1]})
    dec, _, _ = make_decode_step(lossless)(
        model, {"token": t[:, -1:], "caches": caches, "cache_len": clen})
    errs = seq_errs(dec, full)
    check(max(errs) < ROUNDTRIP_BAR, f"{tag}: roundtrip {errs} >= {ROUNDTRIP_BAR}")
    print(f"[{tag}] lossless roundtrip on the card: per-sequence rel {errs} (bar "
          f"{ROUNDTRIP_BAR})")


def moe_dispatch_path(dev):
    """Phase 18a: the three dispatches on one MoE layer at granite's widths
    (d 1536, 40 experts of 512, top-8; f32, 256 tokens in 2 groups), each
    on the card against the CPU at a lossless and a lossy capacity, the
    routes compared first; on the card the three agree at the lossless
    capacity, and at the lossy one the scatter dispatch equals the einsum
    one, which drops routes, while the dense one drops none."""
    cfg = get_config("granite-moe-3b-a800m")
    gen = torch.Generator().manual_seed(4)
    p_cpu = mmoe.init_moe(gen, cfg.d_model, cfg.moe_d_ff, cfg.n_experts)
    p_card = {k: v.to(dev) for k, v in p_cpu.items()}
    x = torch.randn(1, DISPATCH_TOKENS, cfg.d_model, generator=gen)
    rtol, atol = DISPATCH_TOL
    outs = {}
    for cf_tag, cf in (("lossless", cfg.n_experts / cfg.top_k), ("lossy", cfg.capacity_factor)):
        C = mmoe.capacity(DISPATCH_GROUP, cfg.top_k, cf, cfg.n_experts)
        for d in mmoe.DISPATCHES:
            tag = f"moe-dispatch {d} {cf_tag}"
            res = {}
            for where, p, xx in (("card", p_card, x.to(dev)), ("cpu", p_cpu, x)):
                with torch.inference_mode():
                    (o, aux), records = recorded(
                        lambda: mmoe.moe_block(p, xx, cfg.top_k, cf, d, DISPATCH_GROUP),
                        keep_probs=True)
                res[where] = (o[0].cpu(), float(aux), records)
            flips = {tok for _, tok in route_flips(tag, res["card"][2], res["cpu"][2])}
            keep = [s for s in range(DISPATCH_TOKENS) if s not in flips]
            err = check_rows(tag, res["card"][0][keep], res["cpu"][0][keep], rtol, atol)
            share, n = drop_share(res["card"][2])
            print(f"[{tag}] C = {C}: the card within {err!r} of the CPU on {len(keep)} of "
                  f"{DISPATCH_TOKENS} tokens ({len(flips)} route flips); aux {res['card'][1]!r} / "
                  f"{res['cpu'][1]!r}; {share!r} of {n} routes past capacity")
            outs[(cf_tag, d)] = res["card"][0]
    base = outs[("lossless", "einsum")]
    for d in ("scatter", "dense"):
        check_rows(f"moe-dispatch lossless {d} vs einsum", outs[("lossless", d)], base, rtol, atol)
    check_rows("moe-dispatch lossy scatter vs einsum", outs[("lossy", "scatter")],
               outs[("lossy", "einsum")], rtol, atol)
    check_rows("moe-dispatch lossy dense vs lossless", outs[("lossy", "dense")], base, rtol, atol)
    check(float(outs[("lossy", "einsum")].norm()) < float(base.norm()),
          "moe-dispatch: the lossy capacity dropped nothing")
    print("[moe-dispatch] on the card the three dispatches agree at the lossless capacity; "
          "lossy, scatter equals einsum and dense drops nothing")


def moe_small_path(dev):
    """Phase 18a: the SMOKE models and the three dispatches, card against
    CPU, and SMOKE training on granite and llama4 with and without the int8
    compression."""
    for arch in MOE_ARCHS + ("jamba-v0.1-52b",):
        moe_small_model(f"moe-small {arch}", get_smoke(arch), dev)
    moe_small_model("moe-small jamba-v0.1-52b window", dataclasses.replace(
        get_smoke("jamba-v0.1-52b"), window=MOE_SMALL["window"]), dev)
    moe_dispatch_path(dev)
    for arch in MOE_ARCHS:
        for compress in (False, True):
            train_card_vs_cpu(f"moe-train-small {arch}{' ef-int8' if compress else ''}",
                              get_smoke(arch), dev, compress=compress)


def check_program(tag, prog, traces, rep, steps, launches):
    """An attached program's totals over ``steps`` against analyze_ref.  If
    its epochs reach 2**23 ns, as phase 13: latency and bandwidth against
    analyze_ref, congestion against the plain version on the same epochs;
    returns whether they did (the caller then runs the program again in
    quantum epochs)."""
    flat = prog.sim.flat
    ref = oracle(flat, traces)
    span_ns = max(float(tr.t_ns.max()) for tr in traces)
    if span_ns >= F32_EXACT_NS:
        PAST_F32_EXACT.append(tag)
    print(f"[{tag}] {len(traces)} epochs, up to {max(tr.n for tr in traces)} events, "
          f"{sum(tr.n for tr in traces)} per step, spanning up to {span_ns!r} ns; {launches}")
    if span_ns < F32_EXACT_NS:
        check_totals(tag, rep, ref, steps)
        return False
    check_totals(tag, rep, ref, steps, keys=("latency_s", "bandwidth_s"))
    plain = EpochAnalyzer(flat, device="cpu").analyze_batch(traces)
    g_ns, want = s_to_ns(rep.congestion_s), steps * plain.congestion_ns
    check(abs(g_ns - want) <= 1e-5 * abs(want),
          f"{tag}: congestion {g_ns} ns vs the plain version's {want} ns")
    print(f"[{tag}] layer epochs past 2**23 ns: congestion {g_ns!r} ns on the card, {want!r} ns "
          f"by the plain version, analyze_ref {steps * ref.congestion_ns!r} ns (f32 "
          f"epoch-relative times)")
    return True


def attach_program(cfg, kind, step, policy, epoch=None, **program):
    """``cfg``'s own ``kind`` program on Figure 1 under ``policy``,
    attached to ``step`` (layer epochs unless ``epoch``)."""
    regions, phases = build_regions_and_phases(cfg, kind, **program)
    sim = CXLMemSim(figure1_topology(), ClassMapPolicy(policy),
                    epoch=epoch or EpochSchedule("layer"), hw=H100_SXM,
                    max_events_per_access=1024, check_capacity=False, device="cuda")
    return sim.attach(step, phases, regions)


def attached_serving(tag, cfg, kind, step, args, steps, want, program):
    """``step`` attached to ``cfg``'s ``kind`` program with the weights in
    cxl_pool1: 1 warm-up step and ``steps`` measured, exactly ``want``
    launches (``{kernel: count}``, the cascade's one a step), totals against
    analyze_ref (and, past 2**23 ns, 1 + 1 steps again in quantum epochs).
    Returns the launches."""
    prog = attach_program(cfg, kind, step, ZOO_POLICY, **program)
    traces = prog.epoch_traces()
    prog.step(*args)  # warm-up
    warm_an, warm_native = prog.report.analyzer_s, prog.report.native_s
    reset_counts()
    rep = prog.run(steps, *args)
    c = counts()
    check_launches(tag, c, "cascade", steps, expand=steps, **want)
    total = {k: v for k, v in c.items() if v}
    if check_program(tag, prog, traces, rep, rep.steps, total):
        q = attach_program(cfg, kind, step, ZOO_POLICY,
                           epoch=EpochSchedule("quantum", quantum_ns=ZOO_QUANTUM_NS), **program)
        qtraces = q.epoch_traces()
        q.step(*args)
        q.flush()
        reset_counts()
        qrep = q.run(1, *args)
        qc = counts()
        check_launches(f"{tag} quantum", qc, "cascade", 1, expand=1,
                       **{k: v // steps for k, v in want.items()})
        check_totals(f"{tag} quantum", qrep, oracle(q.sim.flat, qtraces), qrep.steps)
        print(f"[{tag} quantum] {len(qtraces)} epochs of 2**22 ns, up to "
              f"{max(tr.n for tr in qtraces)} events")
        for k, v in qc.items():
            c[k] += v
    print(f"[{tag}] analyzer {(rep.analyzer_s - warm_an) / steps:.6f} s/step and native "
          f"{(rep.native_s - warm_native) / steps:.6f} s/step over the {steps} measured steps; "
          f"warm-up step analyzer {warm_an:.6f} s, native {warm_native:.6f} s; simulated "
          f"slowdown {rep.slowdown!r}")
    return c


def serve_and_drops(tag, cfg, model, tokens, pad_to, decodes):
    """One prefill of ``tokens`` and ``decodes`` greedy decode steps, every
    routing recorded: prints the times, the peak memory and the share of
    routes past capacity in the prefill and in the first decode.  Returns
    (logits, caches, cache_len) of the prefill."""
    prefill, decode = make_prefill_step(cfg, pad_to=pad_to), make_decode_step(cfg)
    torch.cuda.reset_peak_memory_stats()

    seconds = {}

    def serve():
        t0 = time.perf_counter()
        out = prefill(model, {"tokens": tokens})
        torch.cuda.synchronize()
        seconds["prefill"] = time.perf_counter() - t0
        state = {"token": out[0].argmax(-1, keepdim=True), "caches": out[1], "cache_len": out[2]}
        t0 = time.perf_counter()
        for _ in range(decodes):
            step_logits, new_caches, new_len = decode(model, state)
            state = {"token": step_logits.argmax(-1, keepdim=True), "caches": new_caches,
                     "cache_len": new_len}
        torch.cuda.synchronize()
        seconds["decode"] = (time.perf_counter() - t0) / decodes
        return out, state, step_logits

    ((logits, caches, clen), state, step_logits), records = recorded(serve)
    n_prefill = len(records) // (1 + decodes)  # MoE layers a pass
    B, S = tokens.shape
    check(logits.shape == (B, cfg.vocab_size) and bool(torch.isfinite(logits).all())
          and bool(torch.isfinite(step_logits).all()), f"{tag}: non-finite logits")
    check(state["cache_len"] == S + decodes, f"{tag}: cache length {state['cache_len']}")
    pre, n_pre = drop_share(records[:n_prefill])
    dec, n_dec = drop_share(records[n_prefill:2 * n_prefill])
    c_pre = mmoe.capacity(min(cfg.moe_group_tokens, B * S), cfg.top_k, cfg.capacity_factor,
                          cfg.n_experts)
    c_dec = mmoe.capacity(min(cfg.moe_group_tokens, B), cfg.top_k, cfg.decode_capacity_factor,
                          cfg.n_experts)
    print(f"[{tag}] served {B} x {S} tokens: prefill {seconds['prefill']:.6f} s (first call), "
          f"then {decodes} decode steps at {seconds['decode']:.6f} s each; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"[{tag}] routes past capacity: prefill {pre!r} of {n_pre} (C = {c_pre} a group of "
          f"{min(cfg.moe_group_tokens, B * S)}, capacity_factor {cfg.capacity_factor}); first "
          f"decode {dec!r} of {n_dec} (C = {c_dec} a group of {B}, decode_capacity_factor "
          f"{cfg.decode_capacity_factor}); {n_prefill} MoE layers a pass")
    layers = [(drop_share([rec])[0], int(torch.bincount(rec[1].idx.reshape(-1),
                                                        minlength=cfg.n_experts).max()))
              for rec in records[:n_prefill]]
    print(f"[{tag}] the prefill's MoE layers in order, (share past capacity, the busiest "
          f"expert's routes in the batch; a mean of {B * S * cfg.top_k / cfg.n_experts!r}): "
          f"{[(round(d, 4), m) for d, m in layers]}")
    return logits, caches, clen


def serve_moe_path(dev):
    """Phase 18b, serve-moe: granite-moe-3b-a800m at its published widths
    and depth (bf16 compute over f32 weights from seed 0): the f32 roundtrip
    in the dense dispatch, 8 x 4096 tokens served (prefill padded to 4112,
    16 decodes), then the prefill (1 + 3) and decode (1 + 8) steps attached
    to granite's own prefill and decode programs with the weights in
    cxl_pool1.  Returns the cascade's launches."""
    cfg = get_config("granite-moe-3b-a800m")
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_SEQ), generator=gen, device=dev)
    layers, bar = MOE_ROUNDTRIP_F32
    f32 = dict(dtype=torch.float32, cache_dtype=torch.float32, moe_dispatch="dense")
    t0 = time.perf_counter()
    errs = roundtrip(dataclasses.replace(cfg, n_layers=layers, **f32), tokens, dev,
                     pad_to=Q3_PAD_TO)
    print(f"[serve-moe] roundtrip float32 (dense dispatch) at {layers} layers: per-sequence rel "
          f"{errs} (bar {bar} on each) in {time.perf_counter() - t0:.3f} s")
    check(max(errs) < bar, f"serve-moe roundtrip at {layers} layers: {max(errs)} >= {bar}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    pc = cfg.param_counts()
    check(n_params == pc["total"], f"serve-moe: {n_params} parameters, want {pc['total']}")
    print(f"[serve-moe] {cfg.name}: {n_params} f32 parameters ({pc['active']!r} active) on the "
          f"card in {time.perf_counter() - t0:.3f} s; dispatch {cfg.moe_dispatch!r}")
    logits, caches, clen = serve_and_drops("serve-moe", cfg, model, tokens, Q3_PAD_TO,
                                           SERVE_DECODES)
    batch = {"tokens": tokens}
    c = attached_serving("moe-prefill", cfg, "prefill", make_prefill_step(cfg, pad_to=Q3_PAD_TO),
                         (model, batch), 3, {}, dict(batch=SERVE_BATCH, seq=SERVE_SEQ))
    state = {"token": logits.argmax(-1, keepdim=True), "caches": caches, "cache_len": clen}
    c_dec = attached_serving("moe-decode", cfg, "decode", make_decode_step(cfg), (model, state),
                             8, {}, dict(batch=SERVE_BATCH, seq=1, cache_len=SERVE_SEQ))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        make_prefill_step(cfg, pad_to=Q3_PAD_TO)(model, batch)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=30))
    return c["cascade"] + c_dec["cascade"]


def train_full_path(tag, cfg, dev, batch, seq, stand_in):
    """``cfg``'s own train step at its published widths (bf16 compute over
    f32 master parameters and AdamW moments, remat, the head in 4096-token
    chunks) on ``batch`` x ``seq``-token SyntheticPipeline batches
    (embeddings for a model without an embedding table), attached to
    ``cfg``'s own train program at that size under main's policy on Figure
    1: 1 warm-up and 3 measured steps, one cascade launch a step and
    nothing else; totals against analyze_ref (layer epochs past 2**23 ns:
    as phase 13, then 1 + 1 steps in quantum epochs); every loss finite,
    the first within 1.0 of ln(vocab).  Prints native and analyzer seconds,
    the model-FLOP rate and the peak memory.  Returns the cascade's
    launches."""
    check(cfg.remat and cfg.dtype == torch.bfloat16, f"{tag}: want bf16 with remat")
    steps = 3
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=0)
    opt = AdamWConfig()
    state = {"adam": adamw_init(model, opt), "ef": {}}
    train_step = make_train_step(cfg, opt, device=dev)
    pipe = SyntheticPipeline(cfg, batch, seq, seed=0, device=dev)
    program = dict(batch=batch, seq=seq)
    prog = attach_program(cfg, "train", train_step, POLICY, **program)
    traces = prog.epoch_traces()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.param_counts()["total"], f"{tag}: {n_params} parameters")
    print(f"[{tag}] {cfg.name}: {n_params} parameters, {batch} x {seq} "
          f"{'tokens' if cfg.embed_inputs else 'frames of embeddings'} a step, set-up "
          f"{time.perf_counter() - t0:.3f} s")
    metrics = []
    model, state, m = prog.step(model, state, pipe.device_batch(0))
    metrics.append({k: float(v) for k, v in m.items()})
    warm_native, warm_analyzer = prog.report.native_s, prog.report.analyzer_s
    reset_counts()
    for s in range(1, 1 + steps):
        model, state, m = prog.step(model, state, pipe.device_batch(s))
        metrics.append({k: float(v) for k, v in m.items()})
    prog.flush()
    c = counts()
    check_launches(tag, c, "cascade", steps, expand=steps)
    rep = prog.report
    peak = torch.cuda.max_memory_allocated()
    launches = c["cascade"]
    if check_program(tag, prog, traces, rep, rep.steps, {"cascade": launches}):
        q = attach_program(cfg, "train", train_step, POLICY,
                           epoch=EpochSchedule("quantum", quantum_ns=ZOO_QUANTUM_NS), **program)
        qtraces = q.epoch_traces()
        n = 1 + steps
        model, state, _ = q.step(model, state, pipe.device_batch(n))
        q.flush()
        reset_counts()
        model, state, m = q.step(model, state, pipe.device_batch(n + 1))
        q.flush()
        check_launches(f"{tag} quantum", counts(), "cascade", 1, expand=1)
        launches += 1
        check_totals(f"{tag} quantum", q.report, oracle(q.sim.flat, qtraces), q.report.steps)
        print(f"[{tag} quantum] {len(qtraces)} epochs of 2**22 ns, up to "
              f"{max(tr.n for tr in qtraces)} events; loss {float(m['loss'])!r}")
        q.close()
    prog.close()
    losses = [x["loss"] for x in metrics]
    check(all(np.isfinite(losses)), f"{tag}: a loss is not finite: {losses}")
    ln_v = float(np.log(cfg.vocab_size))
    check(abs(losses[0] - ln_v) <= 1.0, f"{tag}: first loss {losses[0]!r}, ln V {ln_v!r}")
    native = (rep.native_s - warm_native) / steps
    analyzer = (rep.analyzer_s - warm_analyzer) / steps
    flops = cfg.model_flops("train", batch, seq)
    print(f"[{tag}] losses {losses} = ce {[x['ce'] for x in metrics]} + 0.01 x aux "
          f"{[x['aux'] for x in metrics]} (ln V = {ln_v!r}); lr {metrics[-1]['lr']!r}, grad_norm "
          f"{metrics[-1]['grad_norm']!r}")
    print(f"[{tag}] native {native:.6f} s/step and analyzer {analyzer:.6f} s/step over the "
          f"{steps} measured steps (warm-up step native {warm_native:.6f} s, "
          f"analyzer {warm_analyzer:.6f} s); phase 4's stand-in native "
          f"{stand_in['native_s']:.6f} s/step; simulated slowdown {rep.slowdown!r}")
    print(f"[{tag}] model FLOPs {flops!r} a step (6 x {cfg.param_counts()['active']!r} active "
          f"x {batch * seq} tokens): {flops / native / 1e12!r} TFLOP/s, "
          f"{flops / native / BF16_OPS_PER_S!r} of the dense bf16 peak")
    print(f"[{tag}] peak device memory {peak} bytes ({peak / 2**30:.3f} GiB) over the model, "
          f"optimizer state and the steps")
    return launches


def train_moe_path(dev, stand_in):
    """Phase 18c, train-moe: granite-moe-3b-a800m's own train step at its
    published widths and depth on 4 x 4096-token batches
    (:func:`train_full_path`; its layer epochs pass 2**23 ns).  Returns the
    cascade's launches."""
    cfg = get_config("granite-moe-3b-a800m")
    return train_full_path("train-moe", cfg, dev, MOE_TRAIN["batch"], MOE_TRAIN["seq"],
                           stand_in)


def jamba_path(dev):
    """Phase 18d: jamba-v0.1-52b at its published widths, cut to one of its
    4 groups (8 sublayers: 7 Mamba2, 1 attention; 4 MoE feed-forwards of 16
    experts of 14336, top-2; bf16 compute over f32 weights from seed 0): 8
    x 4096 tokens served (prefill padded to 4104, 8 decodes), then the
    prefill (1 + 3: 7 SSD calls and one cascade a step) and decode (1 + 8:
    no SSD call) steps attached to the cut config's own programs with the
    weights in cxl_pool1.  Returns the launches."""
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=JAMBA_LAYERS)
    spec = cfg.group_spec()
    check(cfg.n_groups == 1 and cfg.attn_layers_per_group == 1
          and cfg.mamba_layers_per_group == 7 and sum(f == "moe" for _, f in spec) == 4,
          f"jamba cut: {spec}")
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_SEQ), generator=gen, device=dev)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.param_counts()["total"], f"jamba: {n_params} parameters")
    print(f"[jamba] {cfg.name} cut to {cfg.n_layers} layers: {n_params} f32 parameters on the card "
          f"in {time.perf_counter() - t0:.3f} s, {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    pad_to = SERVE_SEQ + JAMBA_DECODES
    reset_counts()
    logits, caches, clen = serve_and_drops("jamba", cfg, model, tokens, pad_to, JAMBA_DECODES)
    c = counts()
    check(c["ssd"] == cfg.mamba_layers_per_group, f"jamba: served with {c['ssd']} SSD calls")
    n_ssd = c["ssd"]
    want = cfg.mamba_layers_per_group * 3
    c1 = attached_serving("jamba-prefill", cfg, "prefill", make_prefill_step(cfg, pad_to=pad_to),
                          (model, {"tokens": tokens}), 3, {"ssd": want},
                          dict(batch=SERVE_BATCH, seq=SERVE_SEQ))
    state = {"token": logits.argmax(-1, keepdim=True), "caches": caches, "cache_len": clen}
    c2 = attached_serving("jamba-decode", cfg, "decode", make_decode_step(cfg), (model, state),
                          JAMBA_DECODES, {}, dict(batch=SERVE_BATCH, seq=1, cache_len=SERVE_SEQ))
    return {"cascade": c1["cascade"] + c2["cascade"], "ssd": n_ssd + c1["ssd"] + c2["ssd"]}


def moe_hybrid_path(dev, stand_in):
    """Phase 18: the MoE and hybrid families.  llama4-maverick stays at
    SMOKE: one MoE layer's 128 experts of 8192 are 16.1e9 parameters, 64 GB
    in f32, and its 48 layers do not fit one card.  Returns the cascade's
    and the SSD kernel's launches."""
    t0 = time.perf_counter()
    moe_small_path(dev)
    t1 = time.perf_counter()
    cascade = serve_moe_path(dev)
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    cascade += train_moe_path(dev, stand_in)
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    j = jamba_path(dev)
    torch.cuda.empty_cache()
    print(f"[moe] phase 18 ran {time.perf_counter() - t0:.1f} s: small {t1 - t0:.1f}, serve-moe "
          f"{t2 - t1:.1f}, train-moe {t3 - t2:.1f}, jamba {time.perf_counter() - t3:.1f}")
    return {"cascade": cascade + j["cascade"], "ssd": j["ssd"]}


# --------------------------------------------------------------------------- #
# Phase 19: the VLM and audio families and the two remaining dense configs
# --------------------------------------------------------------------------- #

FAMILY_ARCHS = ("chatglm3-6b", "starcoder2-3b", "qwen2-vl-72b", "hubert-xlarge")
FAMILY_SMALL = dict(batch=2, seq=64)  # SMOKE models, card against CPU, f32
FAMILY_DECODES = 8
# train-starcoder2: 4 x 4096 tokens a step.  A reckoning from the widths
# put 8 x 4096 at 80-90 GiB beside the 48.5 GB of f32 parameters,
# gradients and moments (PERF.md §6), past the card's 79.2 GiB, so the batch is cut, as
# train-moe's was; hubert's 15.1 GB of state leave room for 8 x 4096
STARCODER2_TRAIN = dict(batch=4, seq=4096)
HUBERT_TRAIN = dict(batch=8, seq=4096)
QWEN2VL_LAYERS = 12  # qwen2-vl-72b cut in depth from 80 layers: widths kept
PAST_F32_EXACT = []  # the attached programs whose layer epochs reach 2**23 ns


def family_inputs(cfg, B, S, gen, dev):
    """Tokens, or ``[B, S, d_model]`` embeddings in ``cfg.dtype``, from the
    generator ``gen``, and the batch key they go under."""
    if cfg.embed_inputs:
        return "tokens", torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=gen.device
                                       ).to(dev)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=gen.device)
    return "embeds", x.to(dev, cfg.dtype)


def family_small_model(tag, cfg, dev):
    """Phase 19a: one seeded SMOKE model at f32 on the card and the CPU:
    forward logits at rtol 1e-4 (atol 1e-4 of the largest); a decoder's
    prefill of S-1 plus one decode against its forward of S under 5e-4 on
    the card; then 3 train steps on each device (:func:`train_card_vs_cpu`)."""
    cfg = dataclasses.replace(cfg, dtype=torch.float32, cache_dtype=torch.float32)
    cpu = Model(cfg, device="cpu", seed=0)
    card = model_params_from_arrays(cfg, params_to_arrays(cpu), device=dev)
    B, S = FAMILY_SMALL["batch"], FAMILY_SMALL["seq"]
    key, x = family_inputs(cfg, B, S, torch.Generator().manual_seed(3), "cpu")
    with torch.inference_mode():
        got, want = card(x.to(dev))[0].cpu(), cpu(x)[0]
    err = check_rows(f"{tag} logits", got, want, MODEL_RTOL, MODEL_RTOL * float(want.abs().max()))
    line = f"[{tag}] logits on the card within {err!r} of the CPU's (largest {float(want.abs().max())!r})"
    if cfg.family != "audio":
        xd = x.to(dev)
        _, caches, clen = make_prefill_step(cfg, pad_to=S + 4)(card, {key: xd[:, :-1]})
        one = "token" if cfg.embed_inputs else "embed"
        dec, _, _ = make_decode_step(cfg)(card, {one: xd[:, -1:], "caches": caches,
                                                 "cache_len": clen})
        full = got[:, -1]
        rel = float((dec.cpu() - full).abs().max()) / float(full.abs().max())
        check(rel < ROUNDTRIP_BAR, f"{tag}: prefill S-1 + decode parts by {rel} from forward S")
        line += f"; prefill {S - 1} + 1 decode against forward {S}: rel {rel:.3e}"
    print(line)
    train_card_vs_cpu(f"{tag} train", cfg, dev)


class ProductCount(TorchDispatchMode):
    """Counts the weight products (``aten.mm`` / ``aten.addmm``) dispatched
    while it is active, the backward's autograd thread included."""

    PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in self.PRODUCTS
        return func(*args, **(kwargs or {}))


def group_products(run):
    """``run()`` under a :class:`ProductCount`, each call of
    ``transformer.apply_group`` noting the products it ran (a group's
    forward, then its checkpoint's recomputation in the backward, which may
    stop early by raising).  Returns run's result and the per-call counts."""
    inner, per_call = mtf.apply_group, []

    def counted(*args, **kwargs):
        n0 = mode.n
        try:
            return inner(*args, **kwargs)
        finally:
            per_call.append(mode.n - n0)

    mtf.apply_group = counted
    try:
        with ProductCount() as mode:
            out = run()
    finally:
        mtf.apply_group = inner
    return out, per_call


def dots_vs_nothing(tag, cfg, dev):
    """Phase 19a: ``cfg`` at f32 on the card, 3 train steps under
    ``remat_policy_name="dots"`` and under ``"nothing"`` from one seeded
    model's weights and the same batches: losses to rel 1e-5, parameters
    within 2 x the sum of the steps' lr; the weight products of each
    group's forward and recomputation counted: the forwards equal, every
    recomputation under ``"dots"`` without a product (their outputs were
    saved) and every one under ``"nothing"`` with some; the peak memory
    above the model of each printed."""
    opt = AdamWConfig(**TRAIN_OPT)
    base = Model(dataclasses.replace(cfg, dtype=torch.float32, cache_dtype=torch.float32),
                 device="cpu", seed=0)
    weights = params_to_arrays(base)
    runs = {}
    for policy in ("dots", "nothing"):
        pcfg = dataclasses.replace(base.cfg, remat_policy_name=policy)
        model = model_params_from_arrays(pcfg, weights, device=dev)
        step = make_train_step(pcfg, opt, device=dev)
        pipe = SyntheticPipeline(pcfg, TRAIN_SMALL["batch"], TRAIN_SMALL["seq"], seed=0, device=dev)
        state = {"adam": adamw_init(model, opt), "ef": {}}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        metrics = []

        def steps():
            nonlocal model, state
            for s in range(TRAIN_SMALL["steps"]):
                model, state, m = step(model, state, pipe.device_batch(s))
                metrics.append({k: float(v) for k, v in m.items()})

        _, per_call = group_products(steps)
        runs[policy] = (model, metrics, torch.cuda.max_memory_allocated() - base_mem, per_call)
    lrs = [x["lr"] for x in runs["nothing"][1]]
    for s, (a, b) in enumerate(zip(runs["dots"][1], runs["nothing"][1])):
        rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        check(rel <= TRAIN_LOSS_REL, f"{tag} step {s}: loss {a['loss']!r} under dots, "
              f"{b['loss']!r} under nothing")
    atol = 2 * sum(lrs) + 1e-6
    ref = dict(runs["nothing"][0].named_parameters())
    worst = max(float((p - ref[k]).detach().abs().max())
                for k, p in runs["dots"][0].named_parameters())
    check(worst <= atol, f"{tag}: parameters part by {worst!r}, over {atol!r}")
    g, n_steps = cfg.n_groups, TRAIN_SMALL["steps"]
    fwd, rec = {}, {}
    for policy in ("dots", "nothing"):
        per_call = runs[policy][3]
        check(len(per_call) == 2 * g * n_steps, f"{tag} {policy}: {len(per_call)} group calls")
        fwd[policy] = [n for s in range(n_steps) for n in per_call[2 * g * s:2 * g * s + g]]
        rec[policy] = [n for s in range(n_steps) for n in per_call[2 * g * s + g:2 * g * (s + 1)]]
    check(fwd["dots"] == fwd["nothing"] and min(fwd["dots"]) > 0,
          f"{tag}: the forwards' products differ: {fwd}")
    check(max(rec["dots"]) == 0 and min(rec["nothing"]) > 0,
          f"{tag}: recomputed products under dots {rec['dots']}, nothing {rec['nothing']}")
    print(f"[{tag}] weight products over 3 steps: the groups' forwards {sum(fwd['dots'])} under "
          f"each; their recomputations {sum(rec['dots'])} under dots, {sum(rec['nothing'])} "
          f"under nothing")
    print(f"[{tag}] 3 steps under dots and nothing: losses {[x['loss'] for x in runs['dots'][1]]} "
          f"/ {[x['loss'] for x in runs['nothing'][1]]}; parameters within {worst!r} (bar "
          f"{atol!r}); peak above the model: dots {runs['dots'][2]} bytes, nothing "
          f"{runs['nothing'][2]} bytes")


def serve_full_path(tag, cfg, dev, decodes=FAMILY_DECODES):
    """``cfg`` at its published widths (bf16 compute over f32 weights from
    seed 0) serving 8 x 4096 tokens or frames: one prefill (padded for
    ``decodes``) and ``decodes`` greedy decode steps, timed, then the
    prefill (1 + 3) and, for a decoder, the decode (1 + 8) steps attached
    to ``cfg``'s own prefill and decode programs with the weights in
    cxl_pool1 (:func:`attached_serving`).  A model without an embedding
    table decodes on embeddings of the next frame.  Returns the cascade's
    launches."""
    gen = torch.Generator(device=dev).manual_seed(1)
    key, x = family_inputs(cfg, SERVE_BATCH, SERVE_SEQ, gen, dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.param_counts()["total"], f"{tag}: {n_params} parameters")
    print(f"[{tag}] {cfg.name} ({cfg.n_layers} layers): {n_params} f32 parameters on the card in "
          f"{time.perf_counter() - t0:.3f} s, {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    decoder = cfg.family != "audio"
    pad_to = SERVE_SEQ + decodes if decoder else None
    prefill = make_prefill_step(cfg, pad_to=pad_to)
    batch = {key: x}
    t0 = time.perf_counter()
    logits, caches, clen = prefill(model, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(logits.shape == (SERVE_BATCH, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          f"{tag}: prefill logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    line = f"[{tag}] served {SERVE_BATCH} x {SERVE_SEQ}: prefill {prefill_s:.6f} s (first call)"
    one = "token" if cfg.embed_inputs else "embed"

    def next_input(step_logits):
        if cfg.embed_inputs:
            return step_logits.argmax(-1, keepdim=True)
        return torch.randn((SERVE_BATCH, 1, cfg.d_model), generator=gen, device=dev).to(cfg.dtype)

    c_dec = {"cascade": 0}
    if decoder:
        decode = make_decode_step(cfg)
        state = {one: next_input(logits), "caches": caches, "cache_len": clen}
        t0 = time.perf_counter()
        for _ in range(decodes):
            step_logits, new_caches, new_len = decode(model, state)
            state = {one: next_input(step_logits), "caches": new_caches, "cache_len": new_len}
        torch.cuda.synchronize()
        dec_s = (time.perf_counter() - t0) / decodes
        check(bool(torch.isfinite(step_logits).all()) and state["cache_len"] == SERVE_SEQ + decodes,
              f"{tag}: decode logits finite {bool(torch.isfinite(step_logits).all())}, cache "
              f"length {state['cache_len']}")
        line += f", then {decodes} decode steps at {dec_s:.6f} s each"
    print(f"{line}; peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    c = attached_serving(f"{tag}-prefill", cfg, "prefill", prefill, (model, batch), 3, {},
                         dict(batch=SERVE_BATCH, seq=SERVE_SEQ))
    if decoder:
        # every attached decode writes slot 4096 (the state is not
        # advanced); the served decodes' keys above it are masked
        state = {one: next_input(logits), "caches": caches, "cache_len": clen}
        c_dec = attached_serving(f"{tag}-decode", cfg, "decode", make_decode_step(cfg),
                                 (model, state), FAMILY_DECODES, {},
                                 dict(batch=SERVE_BATCH, seq=1, cache_len=SERVE_SEQ))
    return c["cascade"] + c_dec["cascade"]


def families_path(dev, stand_in):
    """Phase 19: the VLM and audio families and chatglm3-6b / starcoder2-3b.
    Returns the cascade's launches."""
    t0 = time.perf_counter()
    past = len(PAST_F32_EXACT)
    for arch in FAMILY_ARCHS:
        family_small_model(f"family-small {arch}", get_smoke(arch), dev)
    dots_vs_nothing("family-small starcoder2-3b dots", get_smoke("starcoder2-3b"), dev)
    times = {"small": time.perf_counter() - t0}
    cascade = 0
    for tag, run in (
        ("serve-starcoder2", lambda: serve_full_path("serve-starcoder2",
                                                     get_config("starcoder2-3b"), dev)),
        ("train-starcoder2", lambda: train_full_path(
            "train-starcoder2", get_config("starcoder2-3b"), dev, STARCODER2_TRAIN["batch"],
            STARCODER2_TRAIN["seq"], stand_in)),
        ("serve-chatglm3", lambda: serve_full_path("serve-chatglm3", get_config("chatglm3-6b"),
                                                   dev)),
        ("serve-hubert", lambda: serve_full_path("serve-hubert", get_config("hubert-xlarge"),
                                                 dev)),
        ("train-hubert", lambda: train_full_path(
            "train-hubert", get_config("hubert-xlarge"), dev, HUBERT_TRAIN["batch"],
            HUBERT_TRAIN["seq"], stand_in)),
        ("serve-qwen2vl", lambda: serve_full_path(
            "serve-qwen2vl", dataclasses.replace(get_config("qwen2-vl-72b"),
                                                 n_layers=QWEN2VL_LAYERS), dev)),
    ):
        t1 = time.perf_counter()
        cascade += run()
        torch.cuda.empty_cache()
        times[tag] = time.perf_counter() - t1
    print(f"[families] programs whose layer epochs reach 2**23 ns on H100_SXM (held as "
          f"phase 13, then rerun in quantum epochs): {PAST_F32_EXACT[past:]}")
    print(f"[families] phase 19 ran {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))
    return cascade


# --------------------------------------------------------------------------- #
# Phase 20: the split over several devices
# --------------------------------------------------------------------------- #

SPLIT_REL = 1e-6  # the reference's bar for a split sweep (tests/test_fleet_sharding.py)
SPLIT_SESSIONS = 16  # main's step, then its first 30, 29, ... 16 epochs
BD_ARRAYS = ("per_pool_latency_ns", "per_switch_congestion_ns", "per_switch_bandwidth_ns",
             "per_host_latency_ns", "per_host_congestion_ns", "per_host_bandwidth_ns",
             "per_class_congestion_ns")


def bd_numbers(bds) -> dict:
    """Every number of a list of breakdowns by field: the totals and the
    arrays, each field one f64 vector over the list."""
    out = {f: np.asarray([getattr(b, f) for b in bds], np.float64)
           for f in ("latency_ns", "congestion_ns", "bandwidth_ns")}
    for f in BD_ARRAYS:
        if all(getattr(b, f) is not None for b in bds):
            out[f] = np.concatenate([np.asarray(getattr(b, f), np.float64).ravel() for b in bds])
    return out


def split_meshes():
    """A virtual mesh over cuda:0 of each size, and where the machine has
    more than one card also make_data_mesh() over the real cards."""
    meshes = [("virtual", lambda n: make_data_mesh(n, "cuda:0", virtual=True))]
    if torch.cuda.device_count() > 1:
        meshes.append(("cards", lambda n: make_data_mesh(n)))
    return meshes


def split_run(fn):
    """``fn()`` timed on the host clock to its results on the host, its
    launches counted and its fallback warnings kept; returns (result,
    seconds, counts, warnings)."""
    torch.cuda.synchronize()
    reset_counts()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
    return out, wall, counts(), [str(x.message) for x in w if "falling back" in str(x.message)]


def split_case(tag, run, numbers, stats, mesh_n, kernel, want_plain, want_split):
    """Run ``run(mesh)`` unsharded, sharded over each mesh of
    :func:`split_meshes` (``mesh_n`` entries), then unsharded again.  For
    each field of ``numbers`` (a dict of vectors): the sharded run bitwise
    the unsharded one where the two unsharded runs are bitwise to each
    other, and within rel SPLIT_REL of it in any case; each run's
    ``kernel`` launches as wanted.  Returns the launches of every run by
    kernel."""
    total = {}

    def add(c):
        for k, v in c.items():
            total[k] = total.get(k, 0) + v

    u1, wall_u1, c_u1, _ = split_run(lambda: run(None))
    add(c_u1)
    check_launches(f"split-{tag} unsharded", c_u1, kernel, want_plain)
    split = []
    for name, make in split_meshes():
        mesh = make(mesh_n)
        out, wall, c, warned = split_run(lambda: run(mesh))
        add(c)
        split.append((name, mesh, out, wall, c, warned))
    u2, wall_u2, c_u2, _ = split_run(lambda: run(None))
    add(c_u2)
    a, b = numbers(u1), numbers(u2)

    def largest(x, y):  # (numbers that differ, largest difference ns, its rel)
        d = np.abs(x - y)
        return int((d != 0).sum()), float(d.max()), float((d / np.maximum(np.abs(y), 1e-30)).max())

    twins = {f: largest(b[f], a[f]) for f in a}
    st_u = stats(u1)
    n = sum(v.size for v in a.values())
    print(f"[split-{tag}] unsharded: devices_used {st_u[0]}, shard_rows {st_u[1]}, "
          f"padded_fraction {st_u[2]!r}; wall {wall_u1:.6f} s and {wall_u2:.6f} s; "
          f"{c_u1[kernel]} {kernel} launch(es) a run; the two unsharded runs differ in "
          f"{sum(v[0] for v in twins.values())} of {n} numbers"
          + "".join(f"; {f} {v[0]}, largest {v[1]!r} ns (rel {v[2]!r})"
                    for f, v in twins.items() if v[0]))
    for name, mesh, out, wall, c, warned in split:
        st = stats(out)
        check_launches(f"split-{tag} {name} mesh", c, kernel, want_split(st))
        got = numbers(out)
        diffs = {f: largest(got[f], a[f]) for f in a}
        print(f"[split-{tag}] {name} mesh of {mesh.size} entries over "
              f"{len(set(mesh_devices(mesh)))} device(s): devices_used {st[0]}, shard_rows "
              f"{st[1]}, padded_fraction {st[2]!r}; wall {wall:.6f} s; {c[kernel]} {kernel} "
              f"launches, {c[kernel] / st[0]:.4g} a shard; against the first unsharded run "
              f"{sum(v[0] for v in diffs.values())} of {n} numbers differ"
              + "".join(f"; {f} {v[0]}, largest {v[1]!r} ns (rel {v[2]!r}; the twins "
                        f"{twins[f][1]!r} ns)" for f, v in diffs.items() if v[0])
              + f"; {warned or 'no fallback'}")
        for f, (n_diff, _, rel) in diffs.items():
            check(not n_diff or twins[f][0],
                  f"split-{tag} {name}: {f} bitwise in the unsharded twins, {n_diff} numbers "
                  "differ sharded")
            check(rel <= SPLIT_REL, f"split-{tag} {name}: {f} past rel {SPLIT_REL} ({rel!r})")
    return total


def split_analyzer(dev):
    """analyze_batch_multi of 16 sessions of main's program (its step's 31
    epochs, then its first 30 down to 16: main's [32, 131072] batch each;
    FIFO cascade) on a mesh of 8: one launch a shard over [64, 131072]
    rows."""
    prog = attach_main(figure1_topology(), lambda h: h)
    traces = prog.epoch_traces()
    prog.close()
    groups = [traces[: len(traces) - i] for i in range(SPLIT_SESSIONS)]
    an = EpochAnalyzer(prog.sim.flat, device="cuda")
    print(f"[split-analyzer] {len(groups)} sessions of {len(groups[0])} to {len(groups[-1])} "
          f"epochs, up to {max(t.n for g in groups for t in g)} events an epoch, "
          f"{sum(t.n for g in groups for t in g)} events in all")

    def run(mesh):
        out = an.analyze_batch_multi(groups, mesh=mesh)
        return out, an.last_dispatch

    def stats(res):
        st = res[1]
        return st.devices_used, st.shard_rows, st.padded_fraction

    total = split_case("analyzer", run, lambda r: bd_numbers(r[0]), stats, 8, "cascade", 1,
                       lambda st: st[0])
    check(an.sharded_dispatches == len(split_meshes()),
          f"split-analyzer: {an.sharded_dispatches} sharded dispatches")
    return total


def split_engine(dev):
    """The engine's 4 coalesced sessions of phase 15 (main's program cut to
    28, 24, 20 and 12 layers) behind a parked dispatcher, on a mesh of 4:
    one launch a shard, on the engine's own stream."""
    progs = [attach_main(figure1_topology(), lambda h: h,
                         cfg=dataclasses.replace(CONFIG, n_layers=n)) for n in COALESCED_LAYERS]
    groups = [p.epoch_traces() for p in progs]
    flat = progs[0].sim.flat
    for p in progs:
        p.close()

    def run(mesh):
        with AnalysisEngine(mesh=mesh) as eng:
            handles = [eng.register(EpochAnalyzer(flat, device="cuda")) for _ in groups]
            park = eng.register(ParkAnalyzer(flat, 1.0))
            rec, restore = recording_streams()
            try:
                park.submit([MemEvents.empty()])
                futs = [h.submit(g) for h, g in zip(handles, groups)]
                out = [f.result(600) for f in futs]
            finally:
                restore()
            park.close()
            check(all(h.last_group_size == len(groups) for h in handles),
                  f"split-engine: group sizes {[h.last_group_size for h in handles]}")
            if mesh is not None:  # every shard's cascade on the engine's stream of its card
                check(len(rec) == mesh.size,
                      f"split-engine: {len(rec)} cascade calls on a mesh of {mesh.size}")
                for _, _, stream in rec:
                    check(stream == eng.stream(stream.device)
                          and stream != torch.cuda.default_stream(stream.device),
                          f"split-engine: a shard's cascade ran off the engine's stream on "
                          f"{stream.device}")
            return out, handles[0].last_dispatch

    def stats(res):
        st = res[1]
        return st.devices_used, st.shard_rows, st.padded_fraction

    return split_case("engine", run, lambda r: bd_numbers(r[0]), stats, 4, "cascade", 1,
                      lambda st: st[0])


def split_sweeps(dev):
    """sweep-main's 64 scenarios and sweep-qos's 4 on a mesh of 8 (sweep-qos
    falls back to 4 shards): the unique cascades run once, on the mesh's
    first device, so the launches are the unsharded run's."""
    regions, phases = sweep_program()
    suite = sweep_suite(regions, phases)
    scens = sweep_scenarios(regions)

    def stats(res):
        return res.devices_used, res.shard_rows, res.padded_fraction

    total = split_case("sweep-main", lambda mesh: suite.run(scens, mesh=mesh),
                       lambda r: bd_numbers(r.breakdowns), stats, 8, "cascade", 2, lambda st: 2)
    rq = {r.name: 1 for r in regions if r.tensor_class in ("opt_state", "grad")}
    qsuite = sweep_suite(regions, phases, region_qos=rq)
    qscens = [Scenario(ClassMapPolicy(POLICY), qos=q, name=q.describe()) for q in (
        QosSpec(discipline="fifo"), QosSpec(discipline="priority"),
        QosSpec(discipline="wfq", class_weights=(4.0, 1.0)),
        QosSpec(discipline="wfq", class_weights=(1.0, 4.0)))]
    q = split_case("sweep-qos", lambda mesh: qsuite.run(qscens, mesh=mesh),
                   lambda r: bd_numbers(r.breakdowns), stats, 8, "qos", 4, lambda st: 4)
    return {k: total.get(k, 0) + q.get(k, 0) for k in set(total) | set(q)}


def split_fleets(dev):
    """fleet-frontier's 256 rack planes (hosts cascade) and fleet-hetero-qos's
    32 racks (QoS hosts cascade, two STT rows) on a mesh of 8: a launch per
    STT row and shard."""
    tenants = fleet_tenants()
    fleet = FleetSim(FLEET_RACKS, hosts_per_rack=FLEET_HOSTS, hw=H100_SXM, device="cuda")

    def numbers(pts):
        out = bd_numbers([b for p in pts for b in p.report.breakdowns])
        out["delay_ns"] = np.concatenate([p.report.delay_ns.ravel() for p in pts])
        return out

    def stats(pts):
        r = pts[0].report
        return r.devices_used, r.shard_rows, r.padded_fraction

    total = split_case("fleet-frontier", lambda mesh: fleet.frontier(
        tenants, offload_fractions=FLEET_FRACTIONS, mesh=mesh), numbers, stats, 8, "hosts", 1,
        lambda st: st[0])
    qtenants = [dataclasses.replace(t, qos_class=i % 2) for i, t in enumerate(tenants)]
    hetero = FleetSim(
        FLEET_RACKS, hosts_per_rack=FLEET_HOSTS, hw=H100_SXM, device="cuda",
        rack_overrides=[None if r % 2 == 0 else TopologyOverride(**FLEET_SLOW)
                        for r in range(FLEET_RACKS)],
        rack_qos=[QosSpec(discipline="wfq", class_weights=(4.0, 1.0)) if r % 2 == 0
                  else QosSpec(discipline="priority") for r in range(FLEET_RACKS)])
    q = split_case("fleet-hetero-qos", lambda mesh: [types.SimpleNamespace(report=hetero.simulate(
        qtenants, policy="round_robin", offload_fraction=1.0, mesh=mesh))], numbers, stats, 8,
        "qos_hosts", 2, lambda st: 2 * st[0])
    return {k: total.get(k, 0) + q.get(k, 0) for k in set(total) | set(q)}


def split_path(dev):
    """Phase 20: the split over several devices.  Returns the launches of
    its runs by kernel."""
    t0 = time.perf_counter()
    total, times = {}, {}
    for tag, fn in (("analyzer", split_analyzer), ("engine", split_engine),
                    ("sweeps", split_sweeps), ("fleets", split_fleets)):
        t1 = time.perf_counter()
        for k, v in fn(dev).items():
            total[k] = total.get(k, 0) + v
        torch.cuda.empty_cache()
        times[tag] = time.perf_counter() - t1
    print(f"[split] {torch.cuda.device_count()} card(s); phase 20 ran "
          f"{time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))
    return total


# --------------------------------------------------------------------------- #
# Phase 21: the sanitizers on the card
# --------------------------------------------------------------------------- #

SANITIZE_PARK_S = 1.5  # sanitize-coalesced: the held dispatcher's hold
WRAPPER_CALLS = 200_000  # the @axes wrapper's cost: calls a timing


def report_numbers(rep) -> dict:
    """Every delay number of a session report: the totals, the per-pool and
    per-switch arrays and, for a fabric, each host's totals."""
    out = {}
    for k in DELAY_KEYS:
        v = getattr(rep, k, None)
        if v is not None:
            out[k] = np.asarray(v, np.float64).ravel()
    for k in ("latency_s", "congestion_s", "bandwidth_s"):
        if hasattr(rep, "hosts"):
            out[f"hosts.{k}"] = np.asarray([getattr(h, k) for h in rep.hosts], np.float64)
    return out


def sanitized_twin(tag, make, warm, measure, close):
    """One path twice in this process: unsanitized, then with the system
    built inside a LockOrderSanitizer and an AxisSanitizer, warmed there,
    and measured inside a RecompileSanitizer that allows no dispatch-cache
    build and no nvcc run.  ``make()`` builds the system, ``warm(sys)``
    takes its warm-up, ``measure(sys)`` runs the measured steps and returns
    their numbers (a dict of vectors), ``close(sys)`` releases it.  The
    sanitized run's numbers must be bitwise the twin's and its launch
    counts the twin's; a lock-order cycle, a contract violation or a build
    raises out of its scope.  Returns the two runs' launches by kernel."""
    t0 = time.perf_counter()
    twin = make()
    warm(twin)
    reset_counts()
    want = measure(twin)
    c_twin = counts()
    close(twin)
    t1 = time.perf_counter()
    with LockOrderSanitizer() as lo, AxisSanitizer() as ax:
        sys_ = make()
        warm(sys_)
        with RecompileSanitizer(allowed_lowerings=0, allowed_builds=0) as rc:
            reset_counts()
            got = measure(sys_)
            c = counts()
        close(sys_)
    check(c == c_twin, f"{tag}: sanitized launches {c}, unsanitized {c_twin}")
    check(got.keys() == want.keys(), f"{tag}: numbers {sorted(got)} vs {sorted(want)}")
    for k in want:
        check(np.array_equal(got[k], want[k]),
              f"{tag} {k}: sanitized {got[k].tolist()} is not bitwise the unsanitized "
              f"{want[k].tolist()}")
    check(lo.find_cycle() is None and rc.aot_lowerings == 0 and rc.builds == 0,
          f"{tag}: a sanitizer let a cycle or a build through")
    launched = {k: v for k, v in c.items() if v}
    n_values = sum(v.size for v in want.values())
    print(f"[sanitize] {tag}: {n_values} numbers ({len(want)} fields) bitwise the unsanitized "
          f"twin's, launches "
          f"{json.dumps(launched)} in each; lock order: {lo.locks_created} locks created, "
          f"{len(lo.edges)} edges, no cycle; lowerings {rc.aot_lowerings}, nvcc runs "
          f"{rc.builds}, library loads {rc.library_loads}; armed axis checks {ax.checks}; "
          f"twin {t1 - t0:.1f} s, sanitized {time.perf_counter() - t1:.1f} s")
    for (a, b), witness in sorted(lo.edges.items()):
        print(f"[sanitize] {tag} edge {Path(a).name} -> {Path(b).name}: {witness}")
    return {k: c[k] + c_twin[k] for k in c}


def sanitize_engine_main(step, x):
    """engine-main: phase 4's program on a private engine, asynchronous, one
    warm-up step, 3 measured."""
    def make():
        eng = AnalysisEngine()
        return attach_main(figure1_topology(), step, engine=eng), eng

    def warm(s):
        s[0].step(x)
        s[0].flush()

    def measure(s):
        for _ in range(3):
            s[0].step(x)
        s[0].flush()
        check(s[0]._handle is not None and s[0]._handle.engine is s[1],
              "sanitize-engine-main must analyze through its engine")
        return report_numbers(s[0].report)

    def close(s):
        s[0].close()
        s[1].close()

    c = sanitized_twin("engine-main", make, warm, measure, close)
    check_launches("sanitize-engine-main", c, "cascade", 6, expand=6)
    return c


def sanitize_coalesced(step, x):
    """engine-coalesced: phase 15's 4 sessions (28, 24, 20 and 12 layers) on
    one engine, each warmed alone, then one step each behind a held
    dispatcher: one cascade launch over the 4 sessions' rows."""
    def make():
        eng = AnalysisEngine()
        progs = [attach_main(figure1_topology(), step, engine=eng,
                             cfg=dataclasses.replace(CONFIG, n_layers=n))
                 for n in COALESCED_LAYERS]
        return progs, eng

    def warm(s):
        for p in s[0]:  # each alone: its warm-up dispatch coalesces with none
            p.step(x)
            p.flush()

    def measure(s):
        progs, eng = s
        stats0 = eng.stats()
        park = eng.register(ParkAnalyzer(progs[0].sim.flat, SANITIZE_PARK_S))
        park.submit([MemEvents.empty()])
        for p in progs:
            p.step(x)
        for p in progs:
            p.flush()
        park.close()
        stats = eng.stats()
        check(stats["coalesced_dispatches"] == stats0["coalesced_dispatches"] + 1
              and all(p.report.coalesced_group_size == len(progs) for p in progs),
              f"sanitize-coalesced: engine stats {stats}, before {stats0}")
        return {f"s{i}.{k}": v for i, p in enumerate(progs)
                for k, v in report_numbers(p.report).items()}

    def close(s):
        for p in s[0]:
            p.close()
        s[1].close()

    c = sanitized_twin("engine-coalesced", make, warm, measure, close)
    check_launches("sanitize-coalesced", c, "cascade", 2)
    return c


def sanitize_fabric(x):
    """fabric8 under the session's default (overlapped rounds) on a private
    engine: one warm-up round, 2 measured."""
    def make():
        eng = AnalysisEngine()
        return fabric_session(FABRIC_HOSTS, FABRIC_LOAD, FABRIC_EVENTS_PER_ACCESS, "cuda",
                              engine=eng), eng

    def warm(s):
        s[0].round()
        s[0].flush()

    def measure(s):
        check(s[0]._handle is not None, "sanitize-fabric8 must overlap its rounds")
        for _ in range(2):
            s[0].round()
        s[0].flush()
        return report_numbers(s[0].report)

    def close(s):
        s[0].close()
        s[1].close()

    c = sanitized_twin("fabric8", make, warm, measure, close)
    check_launches("sanitize-fabric8", c, "hosts", 4, expand=4)
    return c


def sanitize_pipeline(step, x):
    """pipeline-main: phase 14's program (pipeline=True, warmup=True,
    synchronous), built at attach, one warm-up step, 3 measured."""
    stages = []

    def make():
        prog = attach_main(figure1_topology(), step, pipeline=True, warmup=True,
                           async_analysis=False)
        stages.append(len(prog._analyzer._chain_plan.stage_order))
        return prog

    def measure(prog):
        prog.run(3, x)
        return report_numbers(prog.report)

    c = sanitized_twin("pipeline-main", make, lambda prog: prog.step(x), measure,
                       lambda prog: prog.close())
    check_launches("sanitize-pipeline-main", c, "scan", 2 * 3 * stages[0])
    return c


def sanitize_sweep():
    """sweep-main: phase 16's 64 scenarios, a warm run, then one measured;
    compile_cache_size must not grow over the measured run."""
    deltas = []

    def make():
        regions, phases = sweep_program()
        return sweep_suite(regions, phases), sweep_scenarios(regions)

    def measure(s):
        size = s[0].compile_cache_size()
        res = s[0].run(s[1])
        deltas.append(s[0].compile_cache_size() - size)
        return bd_numbers(res.breakdowns)

    c = sanitized_twin("sweep-main", make, lambda s: s[0].run(s[1]), measure, lambda s: None)
    check_launches("sanitize-sweep-main", c, "cascade", 4)
    check(deltas == [0, 0], f"sanitize-sweep-main: compile_cache_size grew by {deltas}")
    print(f"[sanitize] sweep-main: compile_cache_size delta over the measured run {deltas} "
          "(unsanitized, sanitized)")
    return c


def transposed_dispatches(dev):
    """A transposed [B, N] batch (main's [32, 131072] shape, as [N, B]) into
    _analyze_batch, ops.congestion_cascade and ops.qos_congestion_cascade
    on CUDA tensors under AxisSanitizer: each raises AxisContractError, and
    no kernel or plain version is launched."""
    flat = figure1_topology().flatten()
    B, N = 32, 131072
    t, bits = synthetic_inputs(B, N, 2, 21, dev)
    tt = t.T.contiguous()
    V, S = flat.route.shape
    f32 = dict(dtype=torch.float32, device=dev)
    stts = torch.tensor([2.0, 1.0], **f32)
    qos = torch.zeros(B, N, dtype=torch.int32, device=dev)
    batch = dict(
        t=tt, pool=torch.zeros(B, N, dtype=torch.int32, device=dev),
        nbytes=torch.full((B, N), 64.0, **f32), weight=torch.ones(B, N, **f32), host=None,
        valid=torch.ones(B, N, dtype=torch.bool, device=dev),
        bw_window_ns=torch.full((B,), 1e3, **f32), lat_scale=torch.ones(B, V, **f32),
        bits_table=torch.zeros(V, dtype=torch.int32, device=dev),
        pool_latency_ns=torch.tensor(flat.pool_latency_ns, **f32),
        local_latency_ns=torch.tensor(flat.local_latency_ns, **f32),
        route=torch.tensor(flat.route, **f32), switch_stt_ns=torch.tensor(flat.switch_stt_ns, **f32),
        switch_bw=torch.tensor(flat.switch_bandwidth_gbps, **f32), stage_order=(0, 1),
        n_windows=128,
    )
    calls = (
        ("_analyze_batch", lambda: tan._analyze_batch(**batch)),
        ("ops.congestion_cascade", lambda: kops.congestion_cascade(tt, bits, stts)),
        ("ops.qos_congestion_cascade", lambda: kops.qos_congestion_cascade(
            tt, bits, stts, qos, torch.zeros(2, dtype=torch.int32, device=dev),
            torch.ones(2, 2, **f32))),
    )
    torch.cuda.synchronize()
    reset_counts()
    with AxisSanitizer() as ax:
        for name, call in calls:
            try:
                call()
            except AxisContractError as e:
                print(f"[sanitize] transposed {list(tt.shape)} into {name}: AxisContractError: {e}")
            else:
                check(False, f"transposed dispatch into {name} raised no AxisContractError")
    c = counts()
    check(not any(c.values()), f"a transposed dispatch launched: {c}")
    check(ax.checks == len(calls), f"{ax.checks} armed checks for {len(calls)} calls")


def wrapper_cost(dev):
    """The @axes wrapper's cost a call on CUDA tensors: the unarmed wrapper
    against the undecorated function (ops.congestion_cascade's contract on
    main's [32, 131072] batch, a body that returns at once), the best of 5
    timings of WRAPPER_CALLS calls each on the host clock; and armed."""
    t, bits = synthetic_inputs(32, 131072, 2, 22, dev)
    stts = torch.tensor([2.0, 1.0], device=dev)

    def body(t, bits, stts, merge_plan=None, hosts=None, n_hosts=1):
        return t

    wrapped = axes("B,N", bits="B,N", stts="S", hosts="B,N")(body)

    def per_call_us(fn, calls):
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(t, bits, stts)
            best = min(best, (time.perf_counter() - t0) / calls)
        return best * 1e6

    raw_us = per_call_us(body, WRAPPER_CALLS)
    off_us = per_call_us(wrapped, WRAPPER_CALLS)
    with AxisSanitizer():
        armed_us = per_call_us(wrapped, WRAPPER_CALLS // 10)
    print(f"[sanitize] @axes wrapper on CUDA tensors: unarmed {off_us - raw_us:.4f} us a call "
          f"over the undecorated function ({raw_us:.4f} vs {off_us:.4f} us a call), armed "
          f"{armed_us - raw_us:.4f} us a call over it ({armed_us:.4f} us)")


def sanitize_path(dev, step, x):
    """Phase 21: the port's sanitizers on the card.  Returns the launches of
    its runs by kernel."""
    t0 = time.perf_counter()
    total, times = {}, {}
    for tag, fn in (("engine-main", lambda: sanitize_engine_main(step, x)),
                    ("engine-coalesced", lambda: sanitize_coalesced(step, x)),
                    ("fabric8", lambda: sanitize_fabric(x)),
                    ("pipeline-main", lambda: sanitize_pipeline(step, x)),
                    ("sweep-main", sanitize_sweep)):
        t1 = time.perf_counter()
        for k, v in fn().items():
            total[k] = total.get(k, 0) + v
        times[tag] = time.perf_counter() - t1
    t1 = time.perf_counter()
    transposed_dispatches(dev)
    wrapper_cost(dev)
    times["transposed and wrapper"] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    print(f"[sanitize] phase 21 ran {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))
    return total


# --------------------------------------------------------------------------- #
# Phase 22: the six examples
# --------------------------------------------------------------------------- #

# each example's cascade on the card, and its launches in this phase's run
# of it: one a step, decode, round or stacked dispatch
# each example's kernel, its launches, and the expansion's (one a dispatch
# of the analyzer's default path; the sweeps take their own staging)
EXAMPLE_LAUNCHES = {
    "quickstart": ("cascade", 2 * 5, 2 * 5),  # run twice, 5 steps each
    "serve_offload": ("cascade", 3 * 16, 3 * 16),  # 3 policies, 16 decodes each
    "fabric_pooling": ("hosts", 5, 5),  # 5 rounds
    "migration_caching": ("cascade", 9 * 10, 9 * 10),  # 9 cells, 10 steps each
    "topology_explorer": ("cascade", 6 + 1 + 2, 0),  # 6 grid sweeps, then 1 + 2 halving rounds
    "train_100m": ("cascade", 200, 200),  # 200 steps
}


def check_example_twin(tag, card, cpu) -> int:
    """Every simulated number of the card's run against the CPU's at the
    parity test's bars (examples/_parity.py); returns how many were held."""
    bad, worst = parity.mismatches(card, cpu)
    check(not bad, f"{tag}: {len(bad)} numbers of the card's run miss the CPU run's at "
          f"their bars: {bad[:6]}")
    print(f"[examples] {tag}: {len(card)} simulated numbers within their bars of the CPU "
          f"run's, the largest rel difference {worst:.3e}")
    return len(card)


def example_train_100m(mod):
    """train_100m at its published widths on the card from a fresh
    checkpoint directory (under the temporary directory, removed after)."""
    ckpt = tempfile.mkdtemp(prefix="repro_torch_100m_")
    try:
        torch.cuda.reset_peak_memory_stats()
        out = mod.run(device="cuda", ckpt_dir=ckpt)
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    losses, sim = out["losses"], out["sim"]
    check(len(losses) == 200 and out["start_step"] == 0, f"train_100m ran {len(losses)} steps "
          f"from step {out['start_step']}")
    check(all(np.isfinite(losses)), "train_100m: a loss is not finite")
    first_mean, last_mean = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(abs(losses[0] - np.log(mod.CONFIG.vocab_size)) < 1.0,
          f"train_100m: first loss {losses[0]!r}, ln(vocab) {np.log(mod.CONFIG.vocab_size)!r}")
    check(last_mean < first_mean, f"train_100m: loss did not fall ({first_mean!r} -> "
          f"{last_mean!r}, means of the first and last 10 steps)")
    check(sim["epochs"] == 200 and sim["steps"] == 200, f"train_100m: sim {sim}")
    print(f"[examples] train_100m: {out['params']} parameters, {len(losses)} steps, loss "
          f"{losses[0]!r} -> {losses[-1]!r} (means of the first and last 10: {first_mean!r} -> "
          f"{last_mean!r}); native {sim['native_s'] / sim['steps']!r} s a step, analyzer "
          f"{sim['analyzer_s'] / sim['steps']!r} s a step (beside it), wall {out['wall_s']!r} "
          f"s with 3 checkpoints; peak {peak:.2f} GiB")
    print(f"params: {out['params'] / 1e6:.1f}M")
    return out


def profile_train_100m(mod, dev, rows=14, timed=5):
    """train_100m's model and batch (fresh weights from seed 0,
    unattached): after a warm-up step, ``timed`` steps on the host clock
    (synchronized), then one under torch.profiler: the ops with the most
    device time, and the kernels' device time against the timed steps'
    mean wall (the card's idle share) and the profiled step's own."""
    cfg = mod.CONFIG
    opt = AdamWConfig(lr=3e-4, total_steps=200, warmup_steps=20)
    model = Model(cfg, device=dev, seed=0)
    state = {"adam": adamw_init(model, opt), "ef": {}}
    step = make_train_step(cfg, opt, device=dev)
    batch = SyntheticPipeline(cfg, 8, 256, seed=0, device=dev).device_batch(0)
    model, state, _ = step(model, state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        model, state, _ = step(model, state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / timed * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model, state, _ = step(model, state, batch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    table = prof.key_averages()
    # the kernels' own rows: an op's self device time repeats its kernels'
    busy_ms = sum(e.self_device_time_total for e in table
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"[examples] train_100m, unattached: {step_ms:.3f} ms a step (mean of {timed}); one "
          f"more step under the profiler: wall {wall_s * 1e3:.3f} ms, kernels {busy_ms:.3f} ms "
          f"on the card: the card idles {1 - busy_ms / step_ms:.1%} of an unprofiled step "
          f"({1 - busy_ms / (wall_s * 1e3):.1%} of the profiled one)")
    print(table.table(sort_by="device_time_total", row_limit=rows))


def examples_path(dev):
    """Phase 22: each example's ``run()`` on the card at its own sizes
    (train_100m at its published widths), its kernel's launches counted and
    nothing else launched; every example but train_100m also run on the
    CPU and held to it.  Returns the launches by kernel."""
    t0 = time.perf_counter()
    total = {}
    for name, (kernel, want, expand) in EXAMPLE_LAUNCHES.items():
        mod = parity.load_example(f"{name}_torch")
        torch.cuda.synchronize()
        reset_counts()
        t1 = time.perf_counter()
        out = example_train_100m(mod) if name == "train_100m" else mod.run(device="cuda")
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t1
        if name == "quickstart":  # again, warm: the first run pays the process's set-up
            t1 = time.perf_counter()
            warm = mod.run(device="cuda")["report"]
            print(f"[examples] quickstart again: {time.perf_counter() - t1:.3f} s, native "
                  f"{warm.native_s / warm.steps!r} s a step (the first run "
                  f"{out['report'].native_s / out['report'].steps!r})")
        c = counts()
        # and no plain path, no other kernel
        check_launches(f"examples {name}", c, kernel, want, expand=expand)
        total[kernel] = total.get(kernel, 0) + c[kernel]
        print(f"[examples] {name}: {card_s:.3f} s on the card, {c[kernel]} {kernel} launches")
        for line in mod.report_lines(out):
            for part in line.split("\n"):
                print(f"[examples:{name}] {part}")
        if name == "serve_offload":
            first = list(out["first_logits"].values())
            check(all(torch.equal(first[0], f) for f in first[1:]),
                  "serve_offload: the policies' first decodes differ")
        if name == "quickstart":
            losses = out["losses"]
            check(all(np.isfinite(losses)) and abs(losses[0] - np.log(mod.CFG.vocab_size)) < 1.0,
                  f"quickstart: losses {losses}")
        if name == "train_100m":
            profile_train_100m(mod, dev)
        if name == "migration_caching":
            reps = [r for row in out.values() for r, _ in row.values()]
            print(f"[examples] migration_caching: native {sum(r.native_s for r in reps)!r} s, "
                  f"analyzer {sum(r.analyzer_s for r in reps)!r} s over its 9 cells")
        if name != "train_100m":
            t1 = time.perf_counter()
            cpu = mod.run(device="cpu")
            cpu_s = time.perf_counter() - t1
            n = check_example_twin(name, parity.example_numbers(name, out),
                                   parity.example_numbers(name, cpu))
            print(f"[examples] {name}: the CPU run {cpu_s:.3f} s, {n} numbers held")
        del out
        torch.cuda.empty_cache()
    print(f"[examples] phase 22 ran {time.perf_counter() - t0:.1f} s; launches {total}")
    return total


def sass_counts(path) -> str:
    """How many atomic, double-add and match instructions a built library's
    SASS holds (cuobjdump), or why it could not be read."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        out = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                             timeout=300).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"
    ops = ("ATOMS", "ATOMG", "ATOM.", "RED.", "DADD", "MATCH")
    return json.dumps({op: sum(op in line for line in out.splitlines()) for op in ops})


def cascade_batches(dev):
    """The fabric8 and qos-fabric round batches (one warm-up round each)
    against the plain versions and the partitioned mirror: the cascades
    alone, for ``--cascades``."""
    sess = fabric_session(FABRIC_HOSTS, FABRIC_LOAD, FABRIC_EVENTS_PER_ACCESS, "cuda")
    sess.round()
    sess.flush()
    b = staged_batch(sess._round_cache[0], sess.flat, dev)
    compare_hosts("fabric_batch", b["t"], b["bits"], b["hosts"], b["stts"], sess.flat.n_hosts)
    del sess, b
    sess = fabric_session(FABRIC_HOSTS, FABRIC_LOAD, FABRIC_EVENTS_PER_ACCESS, "cuda",
                          classes=FABRIC_CLASSES, discipline="priority",
                          class_weights=(1.0, 1.0))
    sess.round()
    sess.flush()
    b = staged_batch(sess._round_cache[0], sess.flat, dev)
    stts, disc, w = qos_tables(sess.flat, dev)
    compare_qos_hosts("qos_fabric_batch", b["t"], b["bits"], b["qos"], b["hosts"], stts, disc,
                      w, sess.flat.n_hosts)


def main(argv) -> int:
    cascades_only = "--cascades" in argv
    split_only = "--split" in argv
    sanitize_only = "--sanitize" in argv
    examples_only = "--examples" in argv
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # full f32 matrix products everywhere (stated, not left to defaults)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. environment ----------------------------------------------------- #
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"[env] nvidia-smi: {smi}")

    # -- 2. build, one nvcc per source, all at once ------------------------- #
    for name, res in kbuild.build_all().items():
        print(f"[build] {name}: {res.path.relative_to(ROOT)} in {res.seconds:.3f} s")
        for line in res.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line or "Compiling" in line:
                print(f"[build] {line.strip()}")
        if name in ("congestion_cascade", "qos_cascade"):
            print(f"[build] {name} SASS: {sass_counts(res.path)}")

    if split_only:
        split_path(dev)
        print(f"[done] chip_smoke --split ran {time.perf_counter() - t_start:.1f} s")
        return 0
    if sanitize_only:
        sanitize_path(dev, *main_step(dev))
        print(f"[done] chip_smoke --sanitize ran {time.perf_counter() - t_start:.1f} s")
        return 0
    if examples_only:
        examples_path(dev)
        print(f"[done] chip_smoke --examples ran {time.perf_counter() - t_start:.1f} s")
        return 0

    # -- 3. kernels vs plain at synthetic shapes ---------------------------- #
    fig = figure1_topology().flatten()
    chain = chained_topology(8).flatten()
    rows = []
    for name, (b, n), stts_np, seed in (
        ("ragged", (4, 3000), np.asarray([4.0, 2.0, 0.5]), 1),
        ("figure1", (32, 131072), fig.switch_stt_ns[list(plan_cascade(fig)[2])], 2),
        ("chain8", (8, 65536), chain.switch_stt_ns[list(plan_cascade(chain)[2])], 3),
    ):
        stts = torch.tensor(stts_np, dtype=torch.float32, device=dev)
        t, bits = synthetic_inputs(b, n, int(stts.shape[0]), seed, dev)
        rows.append(compare(name, t, bits, stts))
    topo = figure1_topology()
    fig3 = Topology(topo.pools, topo.switches, topo.rc_latency_ns, topo.rc_bandwidth_gbps,
                    topo.rc_stt_ns, topo.local_dram_latency_ns, n_hosts=3).flatten()
    host_rows = []
    pooled8 = pooled_topology(n_hosts=8).flatten()
    for name, flat, (b, n), seed, ties in (
        ("hosts_ragged_figure1x3", fig3, (4, 3000), 4, False),
        ("hosts_pooled8", pooled8, (32, 131072), 5, False),
        ("hosts_pooled8_ties", pooled8, (32, 131072), 10, True),
        ("hosts_pooled8_one_row", pooled8, (1, 1048576), 11, False),
        ("hosts_pooled8_many_rows", pooled8, (256, 4096), 12, False),
        # more hosts than the kernel's per-thread columns: per-warp rows
        ("hosts_pooled20", pooled_topology(n_hosts=20).flatten(), (8, 16384), 13, True),
    ):
        t, bits, hosts, stts = fabric_inputs(flat, b, n, seed, dev, ties=ties)
        host_rows.append(compare_hosts(name, t, bits, hosts, stts, flat.n_hosts))
    scan_rows = scan_kernel_phase(dev)
    qos_rows = qos_kernel_phase(dev)
    qos_host_rows = qos_hosts_kernel_phase(dev)
    expand_row = expand_kernel_phase(dev)
    if cascades_only:
        cascade_batches(dev)
        print(f"[done] chip_smoke --cascades ran {time.perf_counter() - t_start:.1f} s")
        return 0

    # -- 4-16. the main paths ----------------------------------------------- #
    step, x = main_step(dev)
    main_row, cascade_launches, main_rep, main_ref, stand_in = slice1_main_path(dev, step, x)
    fabric_row, hosts_launches, fabric_rep = fabric_main_path(dev)
    wide_row, scan_launches, wide_rep = wide_fabric_path(dev)
    qos_main_row, qos_launches, qos_rep = qos_main_path(dev, step, x, main_rep)
    qos_fabric_row, qos_hosts_launches = qos_fabric_path(dev, fabric_rep)
    host_rows.append(fabric_row)
    scan_rows.append(wide_row)
    ssd_rows, ssd_row = ssd_kernel_phase(dev)
    ssd_launches = mamba2_serving_path(dev)
    torch.cuda.empty_cache()
    flash_rows, flash_row = flash_kernel_phase(dev)
    model_rows, flash_launches = qwen3_serving_path(dev)
    torch.cuda.empty_cache()
    cascade_launches += migration_cache_path(step, x, main_rep)
    hosts_launches += fabric_migration_path()
    cascade_launches += model_zoo_path(step, x)
    chain_rows, scan14, hosts14, qos14, pipe_rep = pipeline_path(
        dev, step, x, main_rep, main_ref, fabric_rep, wide_rep, qos_rep)
    scan_rows += chain_rows
    scan_launches += scan14
    hosts_launches += hosts14
    qos_launches += qos14
    coalesced_row, cascade15, scan15, hosts15 = engine_path(
        dev, step, x, main_rep, pipe_rep, fabric_rep, main_ref, stand_in)
    rows.append(coalesced_row)
    cascade_launches += cascade15
    scan_launches += scan15
    hosts_launches += hosts15
    torch.cuda.empty_cache()
    (sweep_row, sweep_qos_row, fleet_row, hetero_row), c16 = sweep_fleet_path(dev)
    rows.append(sweep_row)
    qos_rows.append(sweep_qos_row)
    host_rows.append(fleet_row)
    qos_host_rows.append(hetero_row)
    cascade_launches += c16["cascade"]
    qos_launches += c16["qos"]
    hosts_launches += c16["hosts"]
    qos_hosts_launches += c16["qos_hosts"]
    del step, x
    torch.cuda.empty_cache()
    train_path(dev)
    torch.cuda.empty_cache()
    c18 = moe_hybrid_path(dev, stand_in)
    cascade_launches += c18["cascade"]
    ssd_launches += c18["ssd"]
    torch.cuda.empty_cache()
    cascade_launches += families_path(dev, stand_in)
    torch.cuda.empty_cache()

    # -- 20. the split over several devices --------------------------------- #
    c20 = split_path(dev)
    cascade_launches += c20.get("cascade", 0)
    hosts_launches += c20.get("hosts", 0)
    qos_launches += c20.get("qos", 0)
    qos_hosts_launches += c20.get("qos_hosts", 0)

    # -- 21. the sanitizers on the card ------------------------------------- #
    c21 = sanitize_path(dev, *main_step(dev))
    cascade_launches += c21.get("cascade", 0)
    hosts_launches += c21.get("hosts", 0)
    scan_launches += c21.get("scan", 0)
    torch.cuda.empty_cache()

    # -- 22. the six examples ----------------------------------------------- #
    c22 = examples_path(dev)
    cascade_launches += c22.get("cascade", 0)
    hosts_launches += c22.get("hosts", 0)

    # -- 23. the kernels line and the result -------------------------------- #
    src = "src/repro_torch/kernels/csrc/"
    ref_kernels = "src/repro/kernels/"
    reset_counts()  # the expansion's launches: every one this script made
    kernels = []
    for name, source, replaces, launches, comps, row in (
        ("congestion_cascade", "congestion_cascade.cu", ref_kernels + "congestion.py:290",
         cascade_launches, rows + [main_row], main_row),
        ("congestion_cascade_hosts", "congestion_cascade.cu", ref_kernels + "congestion.py:350",
         hosts_launches, host_rows, fabric_row),
        ("congestion_scan", "congestion_scan.cu", ref_kernels + "congestion.py:113",
         scan_launches, scan_rows, wide_row),
        ("qos_congestion_cascade", "qos_cascade.cu", ref_kernels + "congestion.py:542",
         qos_launches, qos_rows + [qos_main_row], qos_main_row),
        ("qos_congestion_cascade_hosts", "qos_cascade.cu", ref_kernels + "congestion.py:542",
         qos_hosts_launches, qos_host_rows + [qos_fabric_row], qos_fabric_row),
        ("ssd_scan", "ssd_scan.cu", ref_kernels + "ssd_scan.py:82", ssd_launches, ssd_rows,
         ssd_row),
        ("flash_attention", "flash_attention.cu", ref_kernels + "flash_attention.py:94",
         flash_launches, flash_rows + model_rows, flash_row),
        # no TPU kernel: the reference fills these planes on the host
        ("expand_events", "expand_events.cu", "src/repro/core/events.py:462",
         EXPAND_LAUNCHED[0], EXPAND_ROWS, expand_row),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src + source,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in comps),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"),
        })
    print(f"[done] chip_smoke ran {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
