#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Each phase prints one JSON line:

1. ``card``: the card's name and power limit (``nvidia-smi``), the
   PyTorch/CUDA versions, and the CUDA kernels' build from the sources
   in the checkout (one ``nvcc`` per source, all started together;
   seconds, ptxas register report); the wgmma matmul kernel must show no
   register spill, and neither may any flash attention instantiation of
   head dim <= 128 (``flash_build``: registers and spill bytes of each
   kernel and head-dim tile).
2. ``kernel``: each CUDA kernel on seeded inputs at the shapes its main
   path gives it and at large ones, held against its plain PyTorch
   version on the card (the water-fills bit for bit; flash attention and
   the SSD scan within 2e-4 abs + rel in float32, the tier of
   ``tests/test_kernels.py``, and 1e-2 in bfloat16, where that file
   allows 5e-2; a bfloat16 flash row also within one bfloat16 ulp
   of its largest output, what the H100 reads); per-call time of both
   from CUDA events, the bound (the larger of bytes over the memory rate
   and operations over the peak of the path: the type's, and for the
   float32 flash split a third of the TF32 peak) and, for every flash
   attention case, the time of one ``F.scaled_dot_product_attention``
   call on the same inputs and mask as a yardstick (the port never calls
   it).  Each flash row names the kernel variant that ran (tensor cores:
   ``mma_bf16`` or the float32 ``mma_3xtf32``; CUDA cores: ``simt``) and
   must have run the one its type and head dim select; two rows are the
   prefill shapes of danube (32 heads of 80 over 8 KV heads, window
   4096) and scout (40 heads of 128 over 8) at 1,024 tokens in float32,
   one llama-3.2-vision's cross-attention (1,024 tokens over 1,600
   patches, 32 heads of 128 over 8, no mask) in float32;
   two are at gemma-7b's attention width (16 heads of 256), in bfloat16
   and float32,
   and four at head dims of 20 and 100, on ``simt`` in both types.  Each
   SSD row names its variant (the tensor-core passes ``mma_3xtf32``, whose
   bound is at a third of the TF32 peak, or ``simt`` on the CUDA cores),
   which must be the one its widths select, the blocks each pass
   launches and its shared memory, as the C source sizes them (equal to
   ``mamba2_ssd.smem_bytes``), each pass's device time per call
   (``torch.profiler``, apart from host issue), the host's microseconds
   per call (``host_us``, no sync in the loop), and the distance of
   kernel, plain version and ``simt`` to a float64 recurrence (``f64``);
   rows on ``mma_3xtf32`` (the serve path, its single-chunk prompts of
   256 and 64 tokens, and a large case) also hold the first kernel
   (``simt``), forced, against the plain version and time it in the same
   call (``prev_ms``, ``prev_device_ms``); one row runs the serve widths
   in bfloat16, and a row at head dim 20 runs ``simt`` itself.  An
   ``ssd_plan`` line holds the C plan's shared memory to the Python one
   at every width tile.  The ``card`` line reports registers and spills
   of every SSD kernel (``ssd_build``); the serve path's float32 64 x 64
   passes may not spill.
3. ``main_path``: the fabric bench's 48-point, 8-sender incast grid
   (receiver mode x PFC x 12 burst sizes) at full width, depth cut from
   20 ms to 2 ms, through ``run_fabric_sweep`` on the card.  Every launch
   counter must move by exactly 4 (grants) / 1 (admit) per tick, and the
   float32 card run must match a float64 CPU run of the same grid within
   5e-4 relative on goodput and incast completion, with identical finite
   masks.
4. ``profile``: a 50-tick run of the same grid under ``torch.profiler``:
   kernels launched per tick, device busy share, the water-fills' device
   time per launch and the top kernels by device time.
5. ``serve``: zamba2-1.2b at full width (38 layers, d_model 2048, vocab
   32000, float32, seeded random weights) behind the Jet-admitted
   ``ServingEngine`` (4 lanes, max_len 1280): 6 requests with prompts of
   64..1024 tokens, 16 new tokens each.  Every prompt's prefill through
   the kernels must match its prefill through the plain versions within
   2e-3 of the largest magnitude (logits, Mamba2 and KV states); the
   engine run must serve 6/6 requests, launch flash attention exactly
   6 x 6 and the SSD scan 6 x 38 times, and generate the tokens of a
   plain-version engine run, except after a step whose plain top-2 logit
   margin was below 1e-3.
6. ``profile_serve``: one 1024-token prefill and 8 four-lane decode steps
   under ``torch.profiler``: kernels per decode step, device busy shares,
   and the model kernels' device time per launch; the prefill must run
   flash attention 6 times and each of the SSD scan's three passes 38
   times, by kernel name.
7. ``staged``: zamba2's shared MLP up-projection at a 1024-token prefill
   through ``ops.staged_matmul``, in float32 (the ``simt_f32`` kernel,
   within 1e-4 of the largest magnitude of ``torch.matmul``'s product in
   full float32) and in bfloat16 (the wgmma kernel in 128 x 256 tiles,
   ``wgmma_bf16_n256``, within 2e-2 of the float32 product of the same
   operands): two launches, one of each variant.
8. ``paged``: the paged KV path at zamba2-1.2b's full width.  The six
   serve prompts' KV of one shared-attention layer (from prefills through
   the kernels) is appended round-robin into one ``PagedKV`` (page 16,
   160 pages, 80 a sequence, float32), so no page table is contiguous;
   ``ops.decode_attention`` on a seeded q must match the dense ring
   decode (``ref.decode_attention_naive``, what the model's decode path
   runs) within 2e-4, the tier ``tests/test_serving.py`` and
   ``tests/test_kernels.py`` hold the paged kernel to; the two halves of
   every table, merged through their lse, must match the whole; releasing
   a sequence restores its pages, a new sequence reuses them and decodes
   right; a small pool runs out as the reference's does (``ok`` False,
   the token written into page 0); and the kernel launches once per
   decode call.
9. ``serve_danube``: h2o-danube-1.8b at full width and depth (24
   layers, d_model 2560, 32 heads / 8 KV heads of 80, window 4096, d_ff
   6912, float32, seeded random weights) through the engine as in
   ``serve`` (4 lanes, max_len 4352, a Jet pool of 32 MiB): prompts of
   64, 256, 1024 and 4224 tokens, 16 new each; the longest prompt's
   prefill rolls the 4096-slot ring and its decode wraps it.  The same
   checks as ``serve``: prefill within 2e-3 of the plain versions, every
   request served its 16 tokens, flash attention launched 24 x 4 times,
   tokens equal to the plain engine's except after a near-tie.
10. ``serve_scout``: llama4-scout-17b-a16e at full width (d_model 5120,
    40 heads / 8 KV heads of 128, 16 experts top-1 + a shared expert,
    d_ff 8192, vocab 202,048), depth cut from 48 layers to 4 (43.5 GB
    of float32 weights): prompts of 64, 256 and 1024 tokens through 4
    lanes, max_len 1040; the MoE blocks run the capacity dispatch, which
    overflows in prefill (80 slots an expert at 1,024 tokens) and in
    decode (1 slot an expert at 4 lanes, as the reference computes).
    Both prefills record every token's route: a token whose expert
    differs between them is excused only where the plain run's top-2
    router probability margin is below 1e-4, and then only the rows it
    can reach are left out of the comparison.  Then ``moe_dispatch``:
    the dispatch against ``moe_dense_ref`` (every expert on every token)
    on the first layer's MoE input of the 1,024-token prompt, within
    2e-4 of the largest magnitude, the same tokens kept and the same
    ``overflow``, both timed.  Then ``ep_moe``: the same input through
    ``moe.moe_ep`` on a one-rank NCCL mesh (data 1 x model 1: NCCL
    refuses two ranks on one card), plain and staged (FSDP experts on a
    ``data`` ring of 1): y bit-equal to ``moe_apply``'s (one rank is the
    dispatch with its all-to-alls put back), the same ``lb_loss``,
    ``overflow`` and kept set, the NCCL collectives of one profiled call
    counted by name (2 all-to-alls, 1 all-gather, 1 all-reduce), both
    timed beside ``moe_apply``.  Then ``collectives`` on that mesh:
    ``ring_allgather_matmul(frags=2)`` against ``x @ W`` at a scout
    expert's width (within 1e-4 of the largest magnitude),
    ``windowed_allgather`` equal to its input, ``compressed_psum`` on a
    seeded [5120, 8192] leaf bit-equal to the int8 round trip of x + err
    with its residual (and the bytes on the wire), and ``srq_combine``
    over the ``paged`` phase's paged-decode (o, lse) equal to its o.
11. ``serve_xlstm``: xlstm-125m at full size (12 layers: 9 mLSTM, 3
    sLSTM, d_model 768, 4 heads of 192, vocab 50,304): prompts of 64,
    128, 256 and 512 tokens (the mLSTM prefill needs whole chunks of
    128), 16 new each; no kernel is on its path.
12. ``api_vision``, ``api_musicgen``: llama-3.2-vision-11b (40 layers,
    every 5th a cross-attention layer over 1,600 image patches, d_model
    4096, 32 heads / 8 KV heads of 128, vocab 128,256; 10.1 B
    parameters) and musicgen-large (48 layers, d_model 2048, 32 heads of
    64, 4 codebooks of 2,048) at full width and depth, float32, seeded
    random weights, through the model API, not the engine (which feeds
    token prompts only): prompts of 64, 256 and 1,024 tokens (vision:
    each with its own seeded unit-normal image; musicgen: ``[1, 4, T]``
    codebook tokens), each prefilled with the kernels and with the plain
    versions (logits and every state leaf, the patch K/V ``xkv``
    included, within 2e-3) and decoded 16 greedy steps from both (tokens
    equal except after a plain top-2 margin below 1e-3); vision also
    prefills one prompt with two images as a batch of two, each row
    within 2e-3 of its one-row prefill; ``forward`` of the 256-token
    prompt (last logits against the prefill's, logits against the plain
    forward) and ``loss_fn`` on seeded targets against the plain loss,
    within 2e-3; flash attention launched 48 times a prefill or forward
    (vision: 40 self- and 8 cross-attention layers), nowhere else.
13. ``receiver_sweep`` (two lines): ``run_sweep`` on the card over
   ``benchmarks/bench_fabric.py``'s sweep axes (msg_bytes x CPU memory
   traffic x DDIO, 6 x 6 x 2) in both receiver modes, 144 points, at the
   bench's full 10 ms (10,000 ticks), then the same ranges densified to
   24 x 24 x 8 x 2 = 9,216 points: wall, ms/tick, kernels per tick and
   busy share (a 200-tick profiler window); every output within 5e-3 of
   the port's CPU float32 run (``sweep.max_rel_dev_vs_numpy`` of
   ``bench_floors.json``; bit-equal expected), DDIO's and Jet's goodput
   ranges.
14. ``routing``: ``routing_grid`` (static ECMP, weighted ECMP, adaptive,
    spray x {no failure, leaf0 -> spine0 down at 150 us}), 8 senders,
    1 MB bursts, depth cut from 20 ms to 8 ms: within 5e-4 of CPU float64
    on goodput and completion times with identical finite masks, reroute
    counts equal, 4 grants and 1 admit launch a tick; static ECMP never
    finishes under the failure while adaptive and spray do, adaptive
    reroutes and static does not; a 50-tick profiler window.
15. ``classes``: the QoS-mixed grid (legacy vs per-TC pause), the
    strict/WRR pair (LOW under 1 Gbps with strict priority, over 15 with
    WRR) and the host-gate pair (HIGH at 0.95 Gbps or more behind the
    per-class receiver gate, 0.85 or less behind the whole-link gate),
    4 ms each, each within 5e-4 of CPU float64 with the same launch
    counts, each with a 50-tick profiler window.
16. ``messages``: ``benchmarks/bench_fabric.py``'s whole messages grid
    (``message_sweep_grid``: 16/64/256 KB verbs writes x windows 4/16 x
    DCQCN/Timely/HPCC, 18 points, 8 senders into one receiver, 10 ms =
    10,000 ticks, nothing cut): per-point message counts within 8 of CPU
    float64, p50/p99/p999 within one histogram bucket + 2 us, goodput
    within 5e-4 with identical finite masks, 4 grants and 1 admit launch
    a tick; the p99 of each controller at window 16 for each size, and a
    50-tick profiler window.
17. ``faults``: the bench's faults grid (``lossy_incast_grid``: loss
    0 / 0.2 / 1 / 5 % x go-back-N / selective) and its crash case
    (selective at 0.5 % loss, ``h1_0`` down 400-600 us) as a ninth point,
    4 ms: dropped packets and retransmitted bytes within 1e-4 of CPU
    float64, message counts within 8, crash recovery within a tick,
    deadlock ticks equal, 0 dropped packets at the lossless selective
    point, and at 5 % loss selective retransmitting less than half of
    go-back-N's bytes and completing more messages; 4 grants and 1 admit
    a tick; a 50-tick profiler window.
18. ``pods``: the sparse-incidence engine on pod-scale (3-level Clos)
    grids, each at dt 1 µs through the captured graph: ``pod64`` and
    ``pod256`` (``benchmarks/bench_fabric.py:run_scale_bench``'s 2 x 2 x
    16 and 4 x 4 x 16 hosts: cross-pod incast, receiver mode x PFC, 0.2
    MB bursts, 4 ms), ``pod1024`` (4 x 16 x 16 hosts, 4 ms, a timing row
    with no CPU reference) and ``pod_storm3`` (``pod_storm_grid`` at its
    defaults: 32/64/128 KB buffers, per-TC lossless PFC, 5 ms).  pod64
    and pod_storm3 first run 250 ticks through the graph and the eager
    loop (``graph_eager`` lines, every output equal).  Every cell counts
    6 grants, 1 admit and 22 segment sums a tick on the card, equal to
    the launches captured x ticks, and records ms a tick with and
    without the capture, kernels a tick and the busy share (a 20-tick
    profile); pod64, pod256 and pod_storm3 are within 5e-4 of CPU
    float64 on the reference's pod outputs and ``uplink_util_max``, with
    identical finite masks.  Before it, an ``incast48_sparse`` line: the
    main path's grid on the sparse engine (4 grants, 1 admit, 15 segment
    sums a tick) within 5e-4 of the dense graph run.  After it, a
    ``scale`` line: busy device µs and ms a tick at 64, 256 and 1,024
    hosts, ``growth_exponent`` = log(busy256 / busy64) / log 4 and its
    ms a tick twin, both <= 1.6 (``bench_floors.json``), and the 256 ->
    1,024 exponent, recorded.
19. ``farm``: the sweep farm (``repro_torch.fabric.farm.run_farm``) on
    the card, every chunk through the captured tick.  incast64
    (``build_grid("incast")``, the reference bench's farm grid: {jet,
    ddio} x PFC {off, on} x 16 bursts 0.25-4 MB, 4 senders, 2 ms) in
    chunks of 16 and of 18 (three, and a remainder of 10 padded to 16 by
    6 repeated lanes, which replays the run captured for the chunks of
    16), two passes each, against its monolithic graph run in the same
    call: every output equal (``dev_farm_vs_mono`` exactly 0, NaN and
    inf in the same places), a graph captured per chunk shape not built
    before on the first pass and none on the second, each chunk counting
    4 grants and 1 admit a
    tick on the card, equal to the launches captured x ticks; the wall
    of the monolithic run and of each pass (recorded).
    ``farm_pod_storm3``: ``pod_storm_grid()`` in chunks of 2 and 1, equal
    to its monolithic run, 22 segment sums a tick a chunk.
    ``farm_workers``: ``run_farm("incast", quick=True)`` in chunks of 4
    through a spawn pool of 2 workers writing shards under
    ``build/farm_runs``, equal to the in-process farm; one shard deleted
    and the run resumed reruns that chunk only.  ``mixed_fleet6``
    (printed after ``oracles``): ``mixed_fleet_grid()`` at full width (8
    senders + victim, 6 points, 2 ms) in chunks of 4 and 2, within 5e-4
    of CPU float64 on goodput and incast completion, identical finite
    masks.
20. ``scalar`` (printed after the lines of phases 13-19): the card's
    grids against the port's scalar drivers (host code in Python floats,
    run in chunks in the oracle pool, each point timed): (a) the main
    path's incast48 graph result within 5e-4 of ``Scenario.run``
    (``run_fabric``) on goodput and incast completion (the
    ``fabric_sweep`` ceilings of ``bench_floors.json``; flow completion
    and victim goodput recorded), pause fan-out equal point for point,
    and the main path's CPU float64 run within 1e-9 of it with flow
    completions equal; (b) ``single_pair`` in both receiver modes at 5 ms
    through the graph within 1e-3 of ``run_sim`` (the reference's float32
    tolerance); (c) the 144-point bench sweep within ``0.01 * seq +
    1e-6`` of ``run_sim``, point by point.  Recorded, not gated: the
    scalar walls, the card's warm walls and ``speedup_warm`` of (a) and
    (c).

The card runs of phases 13-19 come first (and the single pair of phase
20), then ``kernel`` rows of both
water-fills at every shape those fabric grids gave them (grants at each
grid's [G, Q, P], admit at its [G, Q, R]; bit for bit); ``seg_variants``
lines run pod64, pod256 and pod1024 through the graph with each
segment-sum kernel in turn (50 ticks traced whole: the segment sums'
device µs a tick and launches by name, 22 a tick; at 256 and 1,024
hosts ms a tick over 300 ticks).  Then the CPU references of phases
13-20 in spawned worker processes (an ``oracles`` line: workers, host
cores, wall of each), so that no reference competes with a timed card
run for the host; the lines of phases 13-20 follow.  The ``pods`` and ``scale``
lines carry the segment sums' device µs a tick, and the ``total`` line
the seconds of each phase.

Right after the water-fills' first rows, before any CUDA graph, the
``kernel`` rows of the segment sum (``warp_fold``) at pod256's and
pod1024's three shapes, pod1024's slot 5 (768 of its 769 entries in one
bin) and [4096, 24576] values into 12,291 bins: bit for bit against its
plain version run on the CPU in float32, over a second launch and
against the first design (``bin_thread``, forced); CUDA-event ms,
device µs and host µs of both kernels in the same call, one
``index_add_`` on the card (atomic) as the yardstick, the launch layout
of the C source held to the Python one, and two bounds: bytes once over
the memory rate, and the bin-order floor (the longest bin's serial adds
at 4 cycles over ``clocks.max.sm``); a ``seg_sum_host`` line itemises
the wrapper's host µs at pod256's largest shape.

The ``kernel`` rows also hold the paged decode kernel (zamba2's shared
attention, a length-0 row that must give o == 0, danube-1.8b,
starcoder2-15b, llama4-scout and gemma-7b (head dim 256) widths; o within
2e-4 in float32 and 1e-2 in bfloat16, lse within 2e-4; no library call
does the same; each row names the variant that ran, which must be the
one the types select, records the split count, blocks and shared memory
of the split kernel and the merge as the C source plans them, each
kernel's device time, the host's microseconds a call, and the same
kernel forced to one split, ``s1_ms``, held to the same tolerances; a
``decode_plan`` line holds the C plan equal to the Python one, and the
``card`` line reports every decode kernel's registers and spills
(``decode_build``), none of which may spill) and the
staged matmul (zamba2's MLP up-projection in float32 and bfloat16,
ragged shapes in float32 and in bfloat16 with K and N multiples of 8
(wgmma in 128 x 128 tiles) and not (mma.sync), small-integer bfloat16
operands in both wgmma tile widths whose product must equal the plain
version's bit for bit, and
``benchmarks/bench_kernels.py``'s FFN tile; within 1e-4 in float32 and
2e-2 in bfloat16, the tolerances of ``tests/test_kernels.py``; each row
names the kernel variant that ran, its stages and shared memory, and
must have run the variant its shape selects; one ``torch.matmul`` as the
yardstick) against their plain versions.  The ``kernels`` line lists the
staged matmul twice: its float32 kernel and its bfloat16 wgmma kernel,
each at zamba2's up-projection with its launches in the ``staged``
phase; the segment sum at pod256's [4, 1158] -> 693 bins with its
launches in pod256's run; and flash attention at zamba2's prefill shape
with its launches summed over the runs that reach it (``serve``,
``serve_danube``, ``serve_scout``, ``api_vision``, ``api_musicgen``),
each first checked against its own count.  Inputs smaller than the L2 cache are timed
over copies that the calls cycle through (not the segment sum's: at the
path's shapes its calls are launch-bound).

A ``wgmma_widths`` line records both tile widths of the wgmma kernel,
timed in turns on the same inputs, at shapes on either side of the rule
that picks between them.

Training.  Right after the flash rows, ``kernel`` rows of the flash
attention backward (``csrc/flash_attention_bwd.cu``) against its plain
version, autograd's gradient of the plain forward: the train path's
danube shape (q [2, 32, 4096, 80], 8 KV heads, window 4,096, float32), a
window that binds (1,024 tokens, window 256), vision's cross-attention
(non-causal, 1,024 over 1,600), MHA at head dim 64 and gemma-7b's 256 in
bfloat16; each on the variant its type picks (``bwd_mma_3xtf32``,
``bwd_mma_bf16``: the tensor cores), its tile plan from the C launcher
equal to ``jet_flash_attention``'s; dq, dk, dv each within 2e-5
(float32) or 2e-2 (bfloat16) of its largest magnitude, the forward's lse
within 1e-4 of the plain log-sum-exp, two launches bit-equal; kernel,
plain and SDPA-backward ms, the first design (``bwd_simt``) forced in
the same call as ``prev_ms``, and the bound (10·D flops a visible pair at
the tensor cores' peak for the type: 989 TFLOP/s bf16, 495 / 3 = 165 for
3xTF32; the CUDA cores' 67 beside it as ``bound_simt_ms``).  After the
SSD forward rows, ``kernel`` rows of the SSD backward
(``csrc/ssd_scan_bwd.cu``): the train path's zamba2 shape (x [2, 4096,
64, 64], N 64, one group, chunk 256, float32), the serve widths at 1,024
tokens, one chunk, two groups, bfloat16 and the simt widths (P = 20,
states recomputed); each on the design its widths pick
(``bwd_mma_3xtf32``, the tensor cores, where the forward keeps its
states; ``bwd_simt_recompute`` at P = 20); dx, ddt, da, db, dc within
1e-4 (float32) or 2e-2 (bfloat16) of their largest magnitudes of
autograd's gradient of the plain forward and of the plain backward
(``ssd_chunked_bwd_ref``), with dh zero and non-zero; two launches
bit-equal; the C plan's shared memory equal to ``bwd_smem_bytes``;
kernel and plain ms, each pass's device µs, the first design
(``bwd_simt``) forced in the same call as ``prev_ms`` and
``prev_device_ms`` (every tensor-core row must beat it), and the bound
(the work the timed call needs, at dh None, at the tensor cores' peak
for the type as for flash's backward: 165 TFLOP/s for float32, 989 for
bfloat16; the CUDA cores' 67 beside it as ``bound_simt_ms``); no library
call computes it; the ``card`` line reports the backward's 55
instantiations, none of which may spill.  After the api phases:
``train_danube`` (h2o-danube-1.8b whole, float32, batch 2 x 4,096
tokens of the ``for_arch`` pipeline, ``remat="full"``, AdamW with
float32 moments, through ``train.steps``:
one warm-up and three timed steps; every loss and gradient norm finite,
the first loss within 1e-5 of the plain versions' on the same state,
flash attention 48 and its backward 24 launches a step; ms a step,
tokens/s, peak memory, and a fifth step traced in its two halves,
gradient and AdamW, by kernel name); ``train_zamba2`` (zamba2-1.2b
whole, 38 layers, the same batch, pipeline and optimizer: one warm-up
and two timed steps, the same checks, the SSD scan 74 launches a step
(the 36 layers of the six checkpointed units twice, the 2 remainder
layers once), its backward 38 (all on ``bwd_mma_3xtf32``), flash
attention 12 and its backward 6); before each of the two, its own step
traced on the meta device in this process
(``launch.dryrun.build_cell(..., mesh=None)``, no process group): the
dry-run's kernel launches equal to one step's, its predicted peak
(``dryrun_peak_gb``: arguments and the traced peak beyond them) within
10 % of the steps' ``max_memory_allocated``, the two ``dryrun_s``
under 60 s together; the SSD backward rows also hold the C launcher's
scratch size to the meta path's (``mamba2_ssd.bwd_scratch_floats``);
``train_vs_plain`` (danube at full width cut to 2 layers, then zamba2 at
full width cut to 6, 5 Mamba2 layers and one with the shared attention
block, each 2 x 1,024 tokens: loss and gradient norm within 1e-5, every
gradient leaf within 1e-4 of its largest magnitude, of the plain
versions', and the kernels' launches as the step's);
``train_loop`` (``train.loop.run`` on tiny danube: 6 steps, a checkpoint
every 2, a fault at step 4 and a resume, final loss within 1e-5 of the
uninterrupted run's, equality recorded; one int8-moment step);
``serve_mesh`` (after ``train_mesh``: ``prefill`` / ``decode_step`` over
the one-rank NCCL mesh against the unsharded path, h2o-danube-1.8b whole
and zamba2-1.2b at 6 layers, 16 greedy steps a prompt: logits within
2e-3, tokens equal, flash and SSD launches a layer a prefill, NCCL's
records of a prefill and a decode step, and the dry-run's danube
prefill and decode peaks within 10 %).  The ``kernels`` line lists
``flash_attention_bwd`` with its launches in ``train_danube`` and
``train_zamba2``, whose flash forward launches add to flash attention's,
and ``ssd_scan_bwd`` with its launches in ``train_zamba2``, whose SSD
forwards add to the scan's, as ``serve_mesh``'s do.

Then the card line as ``nvidia-smi`` prints it, the ``kernels`` summary
line, and last ``{"ok": true, "device": {...}}``.  Any failed check exits
nonzero; without CUDA, or without the package beside it, the script exits
nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12     # H100 SXM TF32 tensor cores, dense
TOL = 5e-4                  # bench_floors.json dev_goodput_vs_numpy
SIM_TIME_S = 0.002          # depth cut: 20 ms -> 2 ms (2000 ticks)
BURSTS_MB = [0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 5.0, 6.0]
BF16_OPS_PER_S = 989e12     # H100 SXM bfloat16 tensor cores, dense
SOURCES = {"flash_attention_bwd":
               "src/repro_torch/csrc/flash_attention_bwd.cu",
           "ssd_scan_bwd": "src/repro_torch/csrc/ssd_scan_bwd.cu",
           "priority_grants": "src/repro_torch/csrc/fused_waterfill.cu",
           "priority_admit": "src/repro_torch/csrc/fused_waterfill.cu",
           "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
           "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu",
           "decode_attention_paged":
               "src/repro_torch/csrc/decode_attention.cu",
           "staged_matmul": "src/repro_torch/csrc/staged_matmul.cu",
           "staged_matmul_wgmma_bf16":
               "src/repro_torch/csrc/staged_matmul.cu",
           "seg_sum": "src/repro_torch/csrc/seg_sum.cu"}
REPLACES = {"flash_attention_bwd":
                "src/repro/kernels/jet_flash_attention.py:77",
            # the reference differentiates its plain scan
            # (src/repro/kernels/ref.py:216): the kernel has no backward
            "ssd_scan_bwd": "src/repro/kernels/mamba2_ssd.py:63",
            "priority_grants": "src/repro/fabric/fused.py:99",
            "priority_admit": "src/repro/fabric/fused.py:142",
            "flash_attention": "src/repro/kernels/jet_flash_attention.py:77",
            "ssd_scan": "src/repro/kernels/mamba2_ssd.py:63",
            "decode_attention_paged":
                "src/repro/kernels/jet_decode_attention.py:73",
            "staged_matmul": "src/repro/kernels/jet_staged_matmul.py:53",
            "staged_matmul_wgmma_bf16":
                "src/repro/kernels/jet_staged_matmul.py:53",
            "seg_sum": "src/repro/fabric/vector.py:1768"}
LARGE = (4096, 3, 4096)
SERVE_PROMPTS = [64, 128, 256, 512, 1024, 256]
SERVE_NEW = 16
STATE_TOL = 2e-3            # prefill with kernels vs plain, relative
MARGIN = 1e-3               # plain top-2 logit margin below which greedy
                            # tokens may rightly differ
ROUTE_MARGIN = 1e-4         # plain top-2 router probability margin below
                            # which a token's expert may rightly differ
MOE_TOL = 2e-4              # the MoE dispatch vs moe_dense_ref, relative
RING_TOL = 1e-4             # tests/multidev_driver.py ring_allgather_matmul
# the collectives moe_ep's body issues on a mesh without FSDP gathers, as
# NCCL's host records name them
EP_COLLECTIVES = {"nccl:all_to_all": 2, "nccl:all_gather": 1,
                  "nccl:all_reduce": 1}
# moe_ep's forward and backward on a one-rank mesh: the two all-to-alls
# and their reverses, the gather of y, the aux all-reduce, and the
# all-reduces that sum the block's and the router's gradient parts
EP_GRAD_COLLECTIVES = {"nccl:all_to_all": 4, "nccl:all_gather": 1,
                       "nccl:all_reduce": 3}
MESH_LAYERS = 6             # train_mesh: danube's depth cut 24 -> 6
ATTN_KINDS = ("attn_dense", "attn_moe", "mamba_attn")   # prefill: flash
SSD_KINDS = ("mamba", "mamba_attn")                     # prefill: SSD
# the engine-served families on the card: phase -> (arch, layers kept
# (None: all), prompt lengths, lane max_len, Jet pool bytes (None: the
# default 12 MiB; danube's 4,224-token prompt books 17.3 MB at 4 KiB a
# token)).  danube's ring is its 4,096-token window: the longest prompt's
# prefill rolls it and its decode wraps it; xlstm's mLSTM prefill needs
# T % 128 == 0 above 128 tokens.
FAMILY_SERVES = {
    "serve_danube": ("h2o-danube-1.8b", None, [64, 256, 1024, 4224], 4352,
                     32 << 20),
    "serve_scout": ("llama4-scout-17b-a16e", 4, [64, 256, 1024], 1040,
                    None),
    "serve_xlstm": ("xlstm-125m", None, [64, 128, 256, 512], 640, None),
}
# the model API on the card, after FAMILY_SERVES: phase -> (arch, layers
# kept (None: all)).  llama-3.2-vision reads 1,600 image patches in every
# 5th layer (8 cross-attention layers of 40); musicgen-large sums 4
# codebooks' embeddings.  Both at full width and depth, float32.
API_PHASES = {"api_vision": ("llama-3.2-vision-11b", None),
              "api_musicgen": ("musicgen-large", None)}
API_PROMPTS = [64, 256, 1024]
API_FORWARD_T = 256         # forward, loss_fn and the batched prefill
PAGED_TOL = 2e-4            # paged decode vs the dense ring decode
                            # (tests/test_serving.py, tests/test_kernels.py)
TIME_LIMIT_S = 1200         # the script's own limit, builds included
L2_BYTES = 50e6             # H100 L2: smaller inputs are cycled through
                            # copies so that a timed call reads cold data
PROFILE_PAD_S = 0.5         # idle seconds on each side of a profiler
                            # session (see :func:`profiled`)
# the fabric tick's own kernels, by a piece of their device name
FABRIC_KERNELS = {"priority_grants": "grants_kernel",
                  "priority_admit": "admit_kernel",
                  "seg_sum": "seg_sum_kernel"}
# the segment sum's two kernels: the one the tick runs, and the first
# design, which only a timing forces
SEG_KERNELS = {"warp_fold": "seg_sum_kernel",
               "bin_thread": "seg_sum_bin_thread_kernel"}
# launches of each a tick: the dense tick, the 3-level sparse tick (a
# grants a slot; segment sums: injection 2, a drain a slot 6, enqueue
# 5 x 2, the uplink tx of slots 1-2, PFC 2) and the 2-tier sparse tick
# (slots 2-3 empty: 2 + 4 + 3 x 2 + 1 + 2)
DENSE_LAUNCHES = {"priority_grants": 4, "priority_admit": 1, "seg_sum": 0}
POD_LAUNCHES = {"priority_grants": 6, "priority_admit": 1, "seg_sum": 22}
SPARSE_2TIER_LAUNCHES = {"priority_grants": 4, "priority_admit": 1,
                         "seg_sum": 15}


# training (the flash backward, the train step): each gradient of the
# backward kernel within this share of its largest magnitude of the plain
# version's, by input type; the forward's lse within LSE_TOL of the plain
# log-sum-exp; a train step's loss and gradient norm within TRAIN_TOL
# (relative) of the plain versions', every gradient leaf within GRAD_TOL
# of its largest magnitude
FLASH_BWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LSE_TOL = 1e-4
TRAIN_TOL = 1e-5
GRAD_TOL = 1e-4
TRAIN_BATCH, TRAIN_SEQ = 2, 4096      # train_4k rows, batch cut
DRYRUN_MEM_TOL = 0.10       # the dry-run's predicted peak vs the card's
SERVE_MESH_NEW = 16         # serve_mesh: greedy decode steps a prompt
SERVE_MESH_TOL = 2e-3       # logits vs the unsharded path, of the largest
SERVE_MESH_MODELS = {       # arch: (layers, None = all; prompts; max_len)
    "h2o-danube-1.8b": (None, ((2, 1024), (1, 4224)), 4352),
    "zamba2-1.2b": (6, ((2, 1024),), 1040)}
SERVE_MESH_DRYRUN = (2, 1024)   # the dry-run's prefill / decode cells
DRYRUN_LIMIT_S = 60.0       # both train phases' dry-runs, build and trace
# the SSD backward's gradients within this share of each one's largest
# magnitude of autograd's gradient of the plain forward and of the plain
# backward, by input type
SSD_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the train step's kernels by a piece of their device name
TRAIN_KERNELS = {"gemm": ("gemm", "Gemm", "GEMM", "cutlass", "xmma"),
                 "flash_fwd": ("flash_mma_kernel", "flash_simt_kernel"),
                 "flash_bwd": ("bwd_delta_kernel", "bwd_dkdv_mma_kernel",
                               "bwd_dq_mma_kernel", "bwd_dkdv_simt_kernel",
                               "bwd_dq_simt_kernel"),
                 "ssd_fwd": ("ssd_state_kernel", "ssd_carry_kernel",
                             "ssd_output_kernel", "ssd_simt_kernel"),
                 "ssd_scan_bwd": ("ssd_bwd_",)}


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log) -> dict:
    """Registers and spill bytes (stores + loads) that ``-Xptxas -v``
    reports for each kernel entry, keyed by its mangled name."""
    import re
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            out[name] = {}
        elif name and "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill", ln)
            out[name]["spill_bytes"] = int(st) + int(ld)
        elif name and "registers" in ln:
            out[name]["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
            name = None
    return out


def flash_build(log):
    """:func:`ptxas_report` of each flash attention instantiation, keyed
    ``<variant>/<head-dim tile>``; None when this run did not build it
    (the library was already built)."""
    import re
    if not log:
        return None
    out = {}
    for name, r in ptxas_report(log).items():
        mt = re.search(r"flash_(mma|simt)_kernelI(f|13__nv_bfloat16)"
                       r"Li(\d+)E", name)
        if not mt:
            continue
        kind, ty, n = mt.group(1), mt.group(2), int(mt.group(3))
        if kind == "mma":
            key = ("mma_3xtf32" if ty == "f" else "mma_bf16") + f"/{n}"
        else:                       # 16 * n output columns a row
            key = f"simt_{'f32' if ty == 'f' else 'bf16'}/{16 * n}"
        out[key] = r
    return out


def flash_bwd_build(log):
    """:func:`ptxas_report` of each flash backward instantiation, keyed
    ``<pass>/<type>/<head-dim width>``: the passes ``dkdv_mma``,
    ``dq_mma`` (width: the head-dim tile, 32, 64, 80, 128, 256),
    ``dkdv_simt``, ``dq_simt`` (the width a thread's DJ columns cover:
    64, 80, 128, 256) and ``delta`` (no width); None when this run did
    not build it."""
    import re
    if not log:
        return None
    out = {}
    for name, r in ptxas_report(log).items():
        mt = re.search(r"bwd_(delta|dkdv_mma|dq_mma|dkdv_simt|dq_simt)"
                       r"_kernelI(f|13__nv_bfloat16)"
                       r"(?:Li(\d+)E(?:Li\d+ELi(\d+)E)?)?", name)
        if not mt:
            continue
        ty = "f32" if mt.group(2) == "f" else "bf16"
        width = ""
        if mt.group(4):
            width = f"/{16 * int(mt.group(4))}"
        elif mt.group(3):
            width = f"/{mt.group(3)}"
        out[f"{mt.group(1)}/{ty}{width}"] = r
    return out


def ssd_build(log):
    """:func:`ptxas_report` of each SSD scan kernel, keyed
    ``<pass>[/<type>][/<N tile>x<P tile>]``; None when this run did not
    build it."""
    import re
    if not log:
        return None
    out = {}
    for name, r in ptxas_report(log).items():
        mt = re.search(r"ssd_(state|carry|output|simt)_kernel"
                       r"(?:I(f|13__nv_bfloat16)(?:Li(\d+)ELi(\d+)E)?)?",
                       name)
        if not mt:
            continue
        key = mt.group(1)
        if mt.group(2):
            key += "/f32" if mt.group(2) == "f" else "/bf16"
        if mt.group(3):
            key += f"/{mt.group(3)}x{mt.group(4)}"
        out[key] = r
    return out


def ssd_bwd_build(log):
    """:func:`ptxas_report` of each SSD backward kernel, keyed
    ``<pass>[/<type>][/<N tile>x<P tile>]``; None when this run did not
    build it."""
    import re
    if not log:
        return None
    out = {}
    for name, r in ptxas_report(log).items():
        mt = re.search(r"ssd_bwd_(\w+?)_kernel"
                       r"(?:I(f|13__nv_bfloat16)(?:Li(\d+)ELi(\d+)E)?)?",
                       name)
        if not mt:
            continue
        key = mt.group(1)
        if mt.group(2):
            key += "/f32" if mt.group(2) == "f" else "/bf16"
        if mt.group(3):
            key += f"/{mt.group(3)}x{mt.group(4)}"
        out[key] = r
    return out


def decode_build(log):
    """:func:`ptxas_report` of each paged decode kernel, keyed
    ``split_mma/<q type>/<head-dim tile>``,
    ``split_simt/<q type>/<heads>x<128-column chunks>`` or
    ``merge/<q type>``; None when this run did not build it."""
    import re
    if not log:
        return None
    out = {}
    for name, r in ptxas_report(log).items():
        mt = re.search(r"decode_(split_mma|split_simt|merge)_kernel"
                       r"I(f|13__nv_bfloat16)(?:Li(\d+)E)?(?:Li(\d+)E)?",
                       name)
        if not mt:
            continue
        key = f"{mt.group(1)}/{'f32' if mt.group(2) == 'f' else 'bf16'}"
        if mt.group(1) == "split_mma":
            key += f"/{mt.group(3)}"
        elif mt.group(1) == "split_simt":
            key += f"/{mt.group(3)}x{mt.group(4)}"
        out[key] = r
    return out


def incast_grid(sim_time_s: float):
    """``benchmarks/bench_fabric.py:_incast_grid`` in the port's terms."""
    from repro_torch.fabric import fabric_grid, incast
    scens, _ = fabric_grid(
        lambda mode, pfc, burst_mb: incast(
            n_senders=8, mode=mode, pfc=pfc, burst_mb=burst_mb,
            sim_time_s=sim_time_s),
        mode=["ddio", "jet"], pfc=[False, True], burst_mb=BURSTS_MB)
    return scens


def rel(a, b) -> float:
    """Max relative deviation; inf when the finite masks differ."""
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not np.array_equal(np.isfinite(a), np.isfinite(b)):
        return math.inf
    m = np.isfinite(b)
    if not m.any():
        return 0.0
    return float(np.max(np.abs(a[m] - b[m])
                        / np.maximum(np.abs(b[m]), 1e-9)))


def cuda_ms(fn, iters: int, warmup: int = 10) -> float:
    """Per-call time from CUDA events around ``iters`` back-to-back calls
    (after ``warmup`` calls): device time when the card is the
    bottleneck, the host's issue time per call when the calls are too
    small to be."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def waterfill_inputs(shape, seed: int):
    """Seeded inputs on the card: demands with zeros, all-False ``can``
    rows, zero budgets (the edge cases of the water-fill)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    g, q, n = shape
    demand = rng.uniform(0.0, 4.0, shape).astype(np.float32)
    demand[rng.random(shape) < 0.2] = 0.0
    can = rng.random(shape) < 0.7
    can[0] = False
    budget = rng.uniform(0.0, 6.0, (g, n)).astype(np.float32)
    budget[:, rng.random(n) < 0.1] = 0.0
    crumb = np.full((g, n), 1e-3, np.float32)
    return [torch.from_numpy(a).cuda() for a in (demand, can, budget,
                                                 crumb)]


def bitwise_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def kernel_phase(name: str, shape, seed: int, iters: int,
                 path=None) -> dict:
    """Hold one kernel against its plain version at ``shape`` (the shape
    the fabric grids named in ``path`` gave it, where given)."""
    from repro_torch.fabric import fused
    demand, can, budget, crumb = waterfill_inputs(shape, seed)
    g, q, n = shape
    if name == "priority_grants":
        def kernel():
            return fused.priority_grants(demand, can, budget, crumb)

        def plain():
            return fused.priority_grants_ref(demand, can, budget, crumb)
        # demand + can + out per cell, budget + crumb per column
        nbytes = g * q * n * (4 + 1 + 4) + g * n * (4 + 4)
        ops = g * q * n * 7
    else:
        def kernel():
            return fused.priority_admit(demand, budget)

        def plain():
            return fused.priority_admit_ref(demand, budget)
        nbytes = g * q * n * (4 + 4) + g * n * 4
        ops = g * q * n * 2
    got, want = kernel(), plain()
    import torch
    torch.cuda.synchronize()
    equal = bitwise_equal(got, want)
    err = float((got - want).abs().max().item()) if got.numel() else 0.0
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    row = {"name": name, "shape": list(shape), "path": path,
           "bitwise_equal": equal,
           "max_abs_err": err, "ms": cuda_ms(kernel, iters),
           "plain_ms": cuda_ms(plain, iters),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes}
    emit("kernel", **row)
    check(equal, f"{name} kernel != plain version at {list(shape)}")
    return row


@contextlib.contextmanager
def profiled():
    """A ``torch.profiler`` session (host and card) with PROFILE_PAD_S of
    idle time before the caller's work and after its last kernel.  The
    profiler keeps only the device records that it places inside its
    session, and it places them on the host's clock loosely: a kernel's
    end can land 14 ms after the host saw the final synchronize return.
    A session opened right before the first launch, or closed right after
    that synchronize, lost the kernels at its edge: up to 104 of 2,000
    replayed ticks of incast48 (PERF.md §6; ``tools/trace_edges.py``
    measures it).  The caller times its own work inside the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)


def trace_kernels(fn) -> dict:
    """One call of ``fn`` traced whole by ``torch.profiler``: the card's
    kernels it ran (every record on the device), their busy µs, and the
    fabric tick's own kernels (the water-fills, the segment sum) counted
    by name.  Reads the profiler's raw records
    (about 1 µs each) rather than its aggregated table, which takes ≈ 100
    µs a record; a trace of 1.05 M records costs a few seconds."""
    import torch
    torch.cuda.synchronize()
    with profiled() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    kernels = busy_ns = 0
    by_name = dict.fromkeys(FABRIC_KERNELS, 0)
    seg = {var: [0, 0] for var in SEG_KERNELS}      # launches, ns
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        kernels += 1
        busy_ns += e.duration_ns()
        name = e.name()
        for k, tag in FABRIC_KERNELS.items():
            if tag in name:
                by_name[k] += 1
        for var, tag in SEG_KERNELS.items():
            if tag in name:
                seg[var][0] += 1
                seg[var][1] += e.duration_ns()
    return {"wall_s": wall,
            "parse_s": time.perf_counter() - t0 - wall - PROFILE_PAD_S,
            "kernels": kernels, "device_busy_us": busy_ns * 1e-3,
            "waterfill_launches": by_name,
            "seg_sum": {var: {"launches": c, "device_us": ns * 1e-3}
                        for var, (c, ns) in seg.items()}}


def fabric_run(scens, graph="auto", adaptive=None, profiled=False,
               sparse=False):
    """One fabric grid on the card through ``FabricRun``: its packing,
    outputs and timing (the capture apart from the replays:
    ``capture_s``, ``run_s``, ms/tick with and without the capture).  The
    launch counters are zeroed after the set-up (capture and warm-up) and
    read after the run (a replay's launches added on the card), with the
    launches captured for an iteration x iterations beside them.  With
    ``profiled`` the run itself is traced whole (:func:`trace_kernels`):
    the water-fill kernels it executed, counted by name
    (``launches_by_name``), its kernels and busy share (its timing then
    includes the tracing).  ``sparse`` packs the grid for the
    sparse-incidence engine."""
    from repro_torch.fabric import fused
    from repro_torch.fabric.vector import FabricRun, FabricSweepParams
    fsp = FabricSweepParams.from_scenarios(scens, sparse=sparse)
    t0 = time.perf_counter()
    run = FabricRun(fsp, graph=graph, adaptive=adaptive)
    fused.reset_launches()
    t1 = time.perf_counter()
    if profiled:
        out = []
        prof = trace_kernels(lambda: out.append(run.run()))
        res = out[0]
    else:
        res = run.run()
    t2 = time.perf_counter()
    n = run.iterations
    head = {"points": fsp.n_points, "flows": fsp.n_flows,
            "ports": fsp.n_ports, "receivers": fsp.n_recv,
            "ticks": fsp.ticks, "graph": graph == "auto",
            "capture_s": run.capture_s, "run_s": t2 - t1,
            "wall_s": t2 - t0, "ms_per_tick": (t2 - t1) / fsp.ticks * 1e3,
            "ms_per_tick_with_capture": (t2 - t0) / fsp.ticks * 1e3,
            "launches": fused.LAUNCHES.read(),
            "launches_captured": run.launches_captured()}
    if profiled:
        head.update(profiled=True,
                    launches_by_name=prof["waterfill_launches"],
                    kernels_per_iteration=prof["kernels"] / n,
                    device_busy_us_per_iteration=prof["device_busy_us"] / n,
                    device_busy_share_profiled=prof["device_busy_us"]
                    * 1e-6 / prof["wall_s"],
                    profiled_run_s=prof["wall_s"],
                    profile_parse_s=prof["parse_s"])
    if adaptive is not None:
        head.update(iterations=n, batches=run.batches)
    return fsp, res, head


def same(a, b) -> bool:
    """Element for element, NaN and inf in the same places."""
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(
        a, b, equal_nan=a.dtype.kind == "f")


def differing(got: dict, want: dict) -> list:
    return sorted(set(got) ^ set(want)) + [
        k for k in want if k in got and not same(got[k], want[k])]


def launches_per_tick(head: dict, n: int, per=None) -> bool:
    """``per`` launches of each fabric kernel for each of ``n`` ticks (or
    iterations); by default the dense tick's 4 grants, 1 admit and no
    segment sum: in the counts the wrappers keep (a replay's added on the
    card), in the launches captured for an iteration x iterations (graph
    runs), and, where the run was profiled, in the kernels the profiler
    saw by name."""
    want = {k: c * n for k, c in (per or DENSE_LAUNCHES).items()}
    return head["launches"] == want \
        and head["launches_captured"] in ({}, want) \
        and head.get("launches_by_name", want) == want


def graph_eager(label: str, scens, per=None, sparse=False) -> dict:
    """The first ``GRAPH_EAGER_TICKS`` ticks of a grid through the
    captured graph and through the eager loop: every output equal, the
    tick's launches (``per``: by default 4 + 1 water-fills) counted both
    ways, ms/tick both ways."""
    fsp, got, g = fabric_run(scens, sparse=sparse)
    _, want, e = fabric_run(scens, graph=False, sparse=sparse)
    diff = differing(got, want)
    keys = ("capture_s", "ms_per_tick", "ms_per_tick_with_capture",
            "launches")
    out = {"grid": label, "points": fsp.n_points, "ticks": fsp.ticks,
           "equal": not diff, "differ": diff,
           "graph": {k: g[k] for k in keys},
           "eager": {k: e[k] for k in ("ms_per_tick", "launches")}}
    emit("graph_eager", **out)
    check(not diff, f"{label}: the graph differs from the eager loop in "
          f"{diff}")
    check(launches_per_tick(g, fsp.ticks, per)
          and launches_per_tick(e, fsp.ticks, per),
          f"{label}: launches graph {g['launches']}, eager {e['launches']}")
    return out


def main_path() -> dict:
    """incast48 at 2000 ticks through the captured graph, and the
    same-call pair: the same ticks through the eager loop, timed, every
    output equal; then the CPU float64 reference.  The main path's
    launches by kernel name come from :func:`main_path_traced`."""
    import numpy as np
    scens = incast_grid(SIM_TIME_S)
    graph_eager("incast48", incast_grid(GRAPH_EAGER_TICKS * 1e-6))
    fsp, res, head = fabric_run(scens)
    ticks = fsp.ticks
    _, eager, e = fabric_run(scens, graph=False)
    t0 = time.perf_counter()
    oracle = run_fabric_sweep_cpu(scens)
    cpu_wall = time.perf_counter() - t0
    G, F = fsp.n_points, fsp.n_flows
    dev = {k: rel(res[k], oracle[k]) for k in
           ("flow_goodput_gbps", "incast_completion_us",
            "victim_goodput_gbps", "flow_delivered_bytes")}
    diff = differing(res, eager)
    out = {**head, "sim_time_s": SIM_TIME_S,
           "eager_ms_per_tick": e["ms_per_tick"],
           "graph_vs_eager": e["ms_per_tick"] / head["ms_per_tick"],
           "graph_with_capture_vs_eager":
               e["ms_per_tick"] / head["ms_per_tick_with_capture"],
           "graph_equals_eager": not diff,
           "launches_eager": e["launches"],
           "cpu_float64_wall_s": cpu_wall,
           "dev_goodput": dev["flow_goodput_gbps"],
           "dev_incast_fct": dev["incast_completion_us"],
           "dev_victim_goodput": dev["victim_goodput_gbps"],
           "dev_delivered_bytes": dev["flow_delivered_bytes"],
           "incast_finite": int(sum(
               math.isfinite(x) for x in res["incast_completion_us"])),
           "pause_fanout_max": int(res["pause_fanout"].max()),
           "cnps_total": float(res["recv_cnp_count"].sum()),
           "nvidia_smi": card_line()}
    emit("main_path", **out)
    check(launches_per_tick(head, ticks) and launches_per_tick(e, ticks),
          f"launches graph {head['launches']} (captured "
          f"{head['launches_captured']}), eager {e['launches']}; want "
          f"{4 * ticks} / {ticks}")
    check(not diff, f"incast48: the graph differs from eager in {diff}")
    check(res["flow_goodput_gbps"].shape == (G, F), "goodput shape")
    check(res["incast_completion_us"].shape == (G,), "completion shape")
    check(bool(np.isfinite(res["flow_goodput_gbps"]).all()),
          "non-finite goodput")
    check(dev["flow_goodput_gbps"] <= TOL,
          f"goodput deviates {dev['flow_goodput_gbps']} > {TOL}")
    check(dev["incast_completion_us"] <= TOL,
          f"incast completion deviates {dev['incast_completion_us']} > "
          f"{TOL} (inf = finite masks differ)")
    out["result"] = res
    out["oracle"] = oracle
    return out


def main_path_traced(want: dict) -> dict:
    """The main path once more, traced whole by ``torch.profiler``
    (:func:`trace_kernels`): its water-fill kernels counted by name, equal
    to the device-counted launches and to captured × ticks, and every
    output equal to the untraced run's (``want``)."""
    fsp, res, head = fabric_run(incast_grid(SIM_TIME_S), profiled=True)
    diff = differing(res, want)
    keep = ("ticks", "capture_s", "launches", "launches_captured",
            "launches_by_name", "kernels_per_iteration",
            "device_busy_us_per_iteration", "device_busy_share_profiled",
            "profiled_run_s", "profile_parse_s")
    out = {**{k: head[k] for k in keep},
           "profiled_ms_per_tick": head["profiled_run_s"] / fsp.ticks * 1e3,
           "equals_untraced": not diff}
    emit("main_path_traced", **out)
    check(launches_per_tick(head, fsp.ticks),
          f"main path traced: launches {head['launches']}, by name "
          f"{head['launches_by_name']}, captured "
          f"{head['launches_captured']}; want {4 * fsp.ticks} / "
          f"{fsp.ticks}")
    check(not diff, f"main path traced: differs from the untraced run in "
          f"{diff}")
    return out


def run_fabric_sweep_cpu(scens):
    import torch
    from repro_torch.fabric.vector import run_fabric_sweep
    return run_fabric_sweep(scens, device="cpu", dtype=torch.float64)


def profile_phase() -> None:
    """Kernel launches per tick and device busy share over a short run,
    under the graph (replays only) and eager; the water-fills' device
    time a launch and the top kernels under the graph."""
    prof = fabric_profile(incast_grid(50e-6), 50, top=8, eager=True)
    emit("profile", **prof)
    check(prof["waterfills_per_tick"] == 5
          and prof["eager"]["waterfills_per_tick"] == 5,
          f"profile: {prof['waterfills_per_tick']} / "
          f"{prof['eager']['waterfills_per_tick']} water-fills a tick")


# --------------------------------------------------------------------------- #
# Adaptive dt: the bench's own grid, fixed dt against adaptive, both captured
# --------------------------------------------------------------------------- #
ADAPTIVE_TIME_S = 0.02      # bench_fabric.py's adaptive depth, kept whole
ADAPTIVE_FLOORS = {"coarsen_ratio": 7.0, "dev_delivered_vs_fixed": 0.01,
                   "max_completion_shift_us": 20.0}   # bench_floors.json
SPEEDUP_FLOOR = 5.0         # bench_floors.json speedup_warm_vs_fixed: the
                            # reference's jax floor, recorded, not gated
ADAPTIVE_TRACED_S = 0.002   # adaptive8's depth in its whole trace


def adaptive_scens(sim_time_s: float):
    """``benchmarks/bench_fabric.py:run_adaptive_bench``'s grid: the
    victimless 8-sender incast, receiver mode x PFC x bursts 0.25 / 0.5
    MB."""
    from repro_torch.fabric import fabric_grid, incast
    scens, _ = fabric_grid(
        lambda mode, pfc, burst_mb: incast(
            n_senders=8, mode=mode, pfc=pfc, burst_mb=burst_mb,
            with_victim=False, sim_time_s=sim_time_s),
        mode=["ddio", "jet"], pfc=[False, True], burst_mb=[0.25, 0.5])
    return scens


def adaptive_phase():
    """``adaptive8`` at its full 20 ms through the captured fixed-dt tick
    and the captured adaptive iteration, and the same grid at 2 ms
    adaptive, traced whole (its water-fills counted by name, its kernels
    and busy µs an iteration; a trace of the full run would hold ≈ 2.0 M
    kernel records).  Runs the card now; returns
    its packing and the function that, given the CPU references, checks
    coarsening, delivered bytes and completion shift against the
    fixed-dt run (the bench's gates), 4 + 1 water-fills an iteration,
    and holds the adaptive run to the CPU float64 adaptive run: delivered
    bytes and goodput within TOL, completion times within a stride and a
    tick (finite masks equal), iterations within ``max_stride`` (a stride
    decision that float32 and float64 take differently moves the count
    by less than one stride)."""
    import numpy as np
    from repro_torch.fabric import fused
    cfg = fused.AdaptiveConfig()
    scens = adaptive_scens(ADAPTIVE_TIME_S)
    fsp, fine, hf = fabric_run(scens)
    _, ad, ha = fabric_run(scens, adaptive=cfg)
    _, _, hs = fabric_run(adaptive_scens(ADAPTIVE_TRACED_S), adaptive=cfg,
                          profiled=True)
    iters = int(ad["adaptive_iterations"][0])
    db_a, db_f = ad["flow_delivered_bytes"], fine["flow_delivered_bytes"]
    ca, cf = ad["flow_completion_us"], fine["flow_completion_us"]
    both = np.isfinite(ca) & np.isfinite(cf)
    traced = ("ticks", "iterations", "launches", "launches_captured",
              "launches_by_name", "kernels_per_iteration",
              "device_busy_us_per_iteration", "device_busy_share_profiled",
              "profiled_run_s", "profile_parse_s")
    out = {"points": fsp.n_points, "ticks": fsp.ticks,
           "sim_time_s": ADAPTIVE_TIME_S, "max_stride": cfg.max_stride,
           "adaptive_iterations": iters, "batches": ha["batches"],
           "coarsen_ratio": fsp.ticks / max(iters, 1),
           "dev_delivered_vs_fixed": float(np.max(
               np.abs(db_a - db_f) / np.maximum(db_f, 1.0))),
           "max_completion_shift_us": float(
               np.abs(ca[both] - cf[both]).max()) if both.any() else 0.0,
           "completion_finite_equal": bool(np.array_equal(
               np.isfinite(ca), np.isfinite(cf))),
           "fixed": {k: hf[k] for k in ("capture_s", "run_s", "wall_s",
                                        "ms_per_tick", "launches",
                                        "launches_captured")},
           "adaptive": {k: ha[k] for k in ("capture_s", "run_s", "wall_s",
                                           "launches",
                                           "launches_captured")},
           "adaptive_traced": {k: hs[k] for k in traced},
           "ms_per_iteration": ha["run_s"] / max(iters, 1) * 1e3,
           "speedup_vs_fixed": hf["run_s"] / ha["run_s"],
           "speedup_vs_fixed_with_capture": hf["wall_s"] / ha["wall_s"],
           "speedup_floor_reference": SPEEDUP_FLOOR,
           "floors": ADAPTIVE_FLOORS,
           "profile": fabric_profile(adaptive_scens(50e-6), 50)}

    def finish(oracles) -> dict:
        want, cpu_wall = oracles["adaptive"]
        iters_cpu = int(want["adaptive_iterations"][0])
        cc = want["flow_completion_us"]
        fin = np.isfinite(cc)
        out.update(
            iterations_cpu_float64=iters_cpu,
            cpu_float64_wall_s=cpu_wall,
            dev_delivered_vs_cpu_float64=rel(db_a,
                                             want["flow_delivered_bytes"]),
            dev_goodput_vs_cpu_float64=rel(ad["flow_goodput_gbps"],
                                           want["flow_goodput_gbps"]),
            completion_finite_equal_cpu=bool(np.array_equal(
                np.isfinite(ca), fin)),
            max_completion_shift_vs_cpu_us=float(
                np.abs(ca[fin] - cc[fin]).max()) if fin.any() else 0.0,
            completion_shift_limit_us=(cfg.max_stride + 1) * fsp.dt_us)
        emit("adaptive", **out)
        check(out["coarsen_ratio"] >= ADAPTIVE_FLOORS["coarsen_ratio"],
              f"adaptive8: coarsen ratio {out['coarsen_ratio']}")
        check(out["dev_delivered_vs_fixed"]
              <= ADAPTIVE_FLOORS["dev_delivered_vs_fixed"],
              f"adaptive8: delivered bytes deviate "
              f"{out['dev_delivered_vs_fixed']} from fixed dt")
        check(out["max_completion_shift_us"]
              <= ADAPTIVE_FLOORS["max_completion_shift_us"],
              "adaptive8: completion shift "
              f"{out['max_completion_shift_us']}")
        check(out["completion_finite_equal"],
              "adaptive8: a completion one run sees and the other does not")
        check(launches_per_tick(hf, fsp.ticks)
              and launches_per_tick(ha, iters)
              and launches_per_tick(hs, hs["iterations"]),
              f"adaptive8: launches fixed {hf['launches']}, adaptive "
              f"{ha['launches']} ({iters} iterations), traced at "
              f"{ADAPTIVE_TRACED_S * 1e3:g} ms {hs['launches']} (by name "
              f"{hs['launches_by_name']}, {hs['iterations']} iterations)")
        check(out["profile"]["waterfills_per_tick"] == 5,
              f"adaptive8 profile: {out['profile']['waterfills_per_tick']} "
              "water-fills a tick")
        check(abs(iters - iters_cpu) <= cfg.max_stride,
              f"adaptive8: {iters} iterations, CPU float64 {iters_cpu}")
        check(out["dev_delivered_vs_cpu_float64"] <= TOL
              and out["dev_goodput_vs_cpu_float64"] <= TOL,
              f"adaptive8: delivered bytes / goodput deviate "
              f"{out['dev_delivered_vs_cpu_float64']} / "
              f"{out['dev_goodput_vs_cpu_float64']} from CPU float64")
        check(out["completion_finite_equal_cpu"]
              and out["max_completion_shift_vs_cpu_us"]
              <= out["completion_shift_limit_us"],
              f"adaptive8: completion times shift "
              f"{out['max_completion_shift_vs_cpu_us']} us from CPU "
              "float64 (or their finite masks differ)")
        return out
    return fsp, finish


def unit_stride_phase(fixed: dict) -> dict:
    """Adaptive dt with ``max_stride=1`` on incast48 (2000 ticks): every
    output equal to the fixed-dt graph run of the main path, one
    iteration a tick."""
    from repro_torch.fabric import fused
    fsp, res, head = fabric_run(incast_grid(SIM_TIME_S),
                                adaptive=fused.AdaptiveConfig(max_stride=1))
    iters = res.pop("adaptive_iterations")
    diff = differing(res, fixed)
    out = {"ticks": fsp.ticks, "iterations": head["iterations"],
           "batches": head["batches"], "equal_fixed_dt": not diff,
           "differ": diff, "ms_per_iteration": head["ms_per_tick"],
           "launches": head["launches"],
           "launches_captured": head["launches_captured"]}
    emit("adaptive_unit_stride", **out)
    check(not diff and (iters == fsp.ticks).all(),
          f"max_stride=1 differs from fixed dt in {diff} "
          f"({head['iterations']} iterations)")
    check(launches_per_tick(head, fsp.ticks),
          f"max_stride=1: launches {head['launches']}")
    return out


# --------------------------------------------------------------------------- #
# The receiver-datapath sweep and the dense tick's dynamic branches
# --------------------------------------------------------------------------- #
SWEEP_TIME_S = 0.01         # bench_fabric.py's sweep depth, kept whole
SWEEP_TOL = 5e-3            # bench_floors.json sweep.max_rel_dev_vs_numpy
ROUTING_TIME_S = 0.008      # depth cut: 20 ms -> 8 ms (8000 ticks)
CLASSES_TIME_S = 0.004      # the reference tests' own 4 ms
MESSAGES_TIME_S = 0.01      # bench_fabric.py's messages depth, kept whole
FAULTS_TIME_S = 0.004       # bench_fabric.py's faults depth, kept whole
COUNT_SLACK = 8             # messages a point: tests/test_messages.py's
                            # float32 tier
P99_SLACK_US = 2.0          # + one histogram bucket: its JAX_SLACK_US
FAULT_TOL = 1e-4            # dropped / retransmitted: tests/test_faults.py
ORACLE_WORKERS = 6          # CPU reference runs, after the card runs
                            # (4 until PR 28), on a host of 8 cores
GRAPH_EAGER_TICKS = 250     # graph == eager, element for element, per grid
ROUTING_MODES = ("static_ecmp", "weighted_ecmp", "adaptive", "spray")
CLASS_JOBS = ("qos_mixed", "wrr", "host_gate")


def sweep_axes(dense: bool) -> dict:
    """``benchmarks/bench_fabric.py``'s sweep axes (6 x 6 x 2), or the
    same ranges densified to 24 x 24 x 8."""
    import numpy as np
    if not dense:
        return dict(msg_bytes=[64 << 10, 128 << 10, 256 << 10, 512 << 10,
                               768 << 10, 1 << 20],
                    cpu_membw_gbps=[1200.0, 1400.0, 1500.0, 1600.0,
                                    1760.0, 1900.0],
                    ddio_bytes=[4 << 20, 6 << 20])
    return dict(
        msg_bytes=[int(x) for x in np.linspace(64 << 10, 1 << 20, 24)],
        cpu_membw_gbps=[float(x) for x in np.linspace(1200.0, 1900.0, 24)],
        ddio_bytes=[int(x) for x in np.linspace(4 << 20, 6 << 20, 8)])


def sweep_configs(dense: bool, sim_time_s: float):
    """The sweep grid in both receiver modes (DDIO points first)."""
    from repro_torch.core.simulator import testbed_100g
    from repro_torch.fabric import grid_configs
    cfgs = []
    for mode in ("ddio", "jet"):
        cfgs += grid_configs(testbed_100g, mode=mode, sim_time_s=sim_time_s,
                             **sweep_axes(dense))[0]
    return cfgs


def routing_scens(sim_time_s: float):
    """Routing mode x {no failure, leaf0 -> spine0 down at 150 us}, 8
    senders, 1 MB bursts: points ordered (fail_at, mode)."""
    from repro_torch.fabric import routing_grid
    return routing_grid(modes=ROUTING_MODES, fail_at_us=(math.inf, 150.0),
                        burst_mb=1.0, sim_time_s=sim_time_s)[0]


def class_scens(job: str, sim_time_s: float):
    """The classes phase's grids: ``qos_mixed_grid`` (legacy vs per-TC
    pause), the strict/WRR pair and the whole-link/per-class host-gate
    pair (``repro_torch.fabric.wrr_pair``, ``host_gate_pair``)."""
    from repro_torch.fabric import host_gate_pair, qos_mixed_grid, wrr_pair
    if job == "qos_mixed":
        return qos_mixed_grid(per_tc=(False, True),
                              sim_time_s=sim_time_s)[0]
    return (wrr_pair if job == "wrr" else host_gate_pair)(sim_time_s)


def message_scens(sim_time_s: float):
    """``benchmarks/bench_fabric.py:run_messages_bench``'s grid: points
    ordered (algo, msg_kb, verb, window)."""
    from repro_torch.fabric import message_sweep_grid
    return message_sweep_grid(msg_kb=(16.0, 64.0, 256.0), window=(4, 16),
                              verb=("write",),
                              algo=("dcqcn", "timely", "hpcc"),
                              sim_time_s=sim_time_s)


def fault_scens(sim_time_s: float):
    """``benchmarks/bench_fabric.py:run_faults_bench``'s grid, points
    ordered (loss_rate, recovery), and its crash case as a ninth point."""
    from repro_torch.fabric import FaultConfig, lossy_incast, \
        lossy_incast_grid
    scens, pts = lossy_incast_grid(loss_rate=(0.0, 0.002, 0.01, 0.05),
                                   recovery=("go_back_n", "selective"),
                                   sim_time_s=sim_time_s)
    crash = lossy_incast(loss_rate=0.005, recovery="selective",
                         sim_time_s=sim_time_s)
    crash.fabric.faults = FaultConfig(0.005, seed=7).crash(
        "h1_0", at_us=400.0, restart_us=600.0)
    return scens + [crash], pts + [{"loss_rate": 0.005,
                                    "recovery": "selective",
                                    "crash": ["h1_0", 400.0, 600.0]}]


SCALAR_TIME_S = 0.005       # single pair vs run_sim: the reference test's
                            # depth (tests/test_fabric_vector.py:82)
PAIR_MODES = ("ddio", "jet")
PAIR_TOL = 1e-3             # the reference's float32 tolerance there
CPU_SCALAR_TOL = 1e-9       # its numpy-vs-scalar one (:100)
SCALAR_JOBS = ("scalar_incast48:0", "scalar_incast48:1", "scalar_incast48:2",
               "scalar_sweep:0", "scalar_sweep:1", "scalar_pair")


def scalar_oracle(job: str) -> dict:
    """One chunk of the scalar drivers' runs, in a worker process, each
    point timed on its own: a third of the main path's incast48 through
    ``Scenario.run`` (``run_fabric``), half of the bench sweep's
    configurations or the single pair through ``run_sim``."""
    import numpy as np
    from repro_torch.core import run_sim, testbed_100g
    name, _, part = job.partition(":")
    parts = sum(j.startswith(name + ":") for j in SCALAR_JOBS)
    walls = []

    def timed(fn, x):
        t0 = time.perf_counter()
        r = fn(x)
        walls.append(time.perf_counter() - t0)
        return r

    def chunk(items):
        k = int(part)
        return items[k * len(items) // parts:(k + 1) * len(items) // parts]
    if name == "scalar_incast48":
        scens = chunk(incast_grid(SIM_TIME_S))
        res = [timed(lambda sc: sc.run(), sc) for sc in scens]
        F = len(scens[0].flows)
        out = {k: np.array([[getattr(r, k)[f] for f in range(F)]
                            for r in res])
               for k in ("flow_goodput_gbps", "flow_completion_us")}
        out.update({k: np.array([getattr(r, k) for r in res])
                    for k in ("incast_completion_us", "victim_goodput_gbps",
                              "pause_fanout")})
    elif name == "scalar_sweep":
        cfgs = chunk(sweep_configs(False, SWEEP_TIME_S))
        out = {"goodput_gbps": np.array(
            [timed(run_sim, c).goodput_gbps for c in cfgs])}
    else:
        out = {"goodput_gbps": np.array(
            [timed(run_sim, testbed_100g(m, sim_time_s=SCALAR_TIME_S))
             .goodput_gbps for m in PAIR_MODES])}
    out["point_wall_s"] = walls
    return out


def pair_phase() -> dict:
    """``single_pair`` in both receiver modes at 5 ms through the captured
    graph on the card: the card half of the scalar phase's pair check."""
    from repro_torch.fabric import single_pair
    fsp, res, head = fabric_run([single_pair(m, sim_time_s=SCALAR_TIME_S)
                                 for m in PAIR_MODES])
    check(launches_per_tick(head, fsp.ticks),
          f"single pair: launches {head['launches']} (captured "
          f"{head['launches_captured']}), want {4 * fsp.ticks} / "
          f"{fsp.ticks}")
    return {"recv_goodput_gbps": res["recv_goodput_gbps"][:, 0],
            "ticks": fsp.ticks, "run_s": head["run_s"],
            "ms_per_tick": head["ms_per_tick"], "launches": head["launches"]}


def scalar_merged(name: str, oracles) -> dict:
    """The chunks of one scalar job, in point order."""
    import numpy as np
    parts = [oracles[j][0] for j in SCALAR_JOBS
             if j.partition(":")[0] == name]
    return {k: (sum((p[k] for p in parts), []) if k == "point_wall_s"
                else np.concatenate([p[k] for p in parts]))
            for k in parts[0]}


def scalar_phase(main: dict, card: dict, cpu64: dict, pair: dict,
                 sweep: dict, oracles) -> dict:
    """The card's grids against the port's scalar drivers (host code,
    Python floats, run in the oracle pool): (a) incast48's float32 graph
    result within the ``fabric_sweep`` ceilings of ``run_fabric`` with
    ``pause_fanout`` equal, and the CPU float64 grid within 1e-9 with
    completions equal; (b) the single pair within 1e-3 of ``run_sim``;
    (c) the 144-point receiver sweep within ``0.01 * seq + 1e-6`` of
    ``run_sim`` point by point.  Scalar walls are summed per point;
    ``speedup_warm`` is scalar over the card's warm run."""
    import numpy as np
    inc = scalar_merged("scalar_incast48", oracles)
    seq = scalar_merged("scalar_sweep", oracles)
    sim = scalar_merged("scalar_pair", oracles)
    dev = {f"dev_{name}_vs_scalar": rel(card[k], inc[k]) for name, k in (
        ("goodput", "flow_goodput_gbps"),
        ("incast_fct", "incast_completion_us"),
        ("completion", "flow_completion_us"),
        ("victim_goodput", "victim_goodput_gbps"))}
    fanout = card["pause_fanout"].tolist() == inc["pause_fanout"].tolist()
    cpu_dev = rel(cpu64["flow_goodput_gbps"], inc["flow_goodput_gbps"])
    cpu_completion = bool(np.array_equal(cpu64["flow_completion_us"],
                                         inc["flow_completion_us"]))
    incast_wall = float(sum(inc["point_wall_s"]))
    pair_dev = rel(pair["recv_goodput_gbps"], sim["goodput_gbps"])
    got, want = sweep["goodput_gbps"].astype(np.float64), seq["goodput_gbps"]
    sweep_ok = bool(np.all(np.abs(got - want) <= 0.01 * want + 1e-6))
    sweep_dev = rel(got, want)
    sweep_wall = float(sum(seq["point_wall_s"]))
    out = {"incast48": {
               "points": len(inc["point_wall_s"]), "sim_time_s": SIM_TIME_S,
               **dev, "pause_fanout_equal": fanout,
               "cpu_float64_dev_goodput_vs_scalar": cpu_dev,
               "cpu_float64_completion_equal": cpu_completion,
               "scalar_wall_s": incast_wall,
               "card_graph_run_s": main["run_s"],
               "card_graph_wall_with_capture_s": main["wall_s"],
               "speedup_warm": incast_wall / main["run_s"],
               "speedup_with_capture": incast_wall / main["wall_s"]},
           "single_pair": {
               "sim_time_s": SCALAR_TIME_S, "modes": list(PAIR_MODES),
               "card_recv_goodput_gbps": pair["recv_goodput_gbps"].tolist(),
               "run_sim_goodput_gbps": sim["goodput_gbps"].tolist(),
               "dev_vs_run_sim": pair_dev, "ticks": pair["ticks"],
               "card_ms_per_tick": pair["ms_per_tick"]},
           "receiver_sweep": {
               "points": len(want), "sim_time_s": SWEEP_TIME_S,
               "within_one_percent": sweep_ok,
               "max_rel_dev_vs_run_sim": sweep_dev,
               "seq_run_sim_wall_s": sweep_wall,
               "card_warm_wall_s": sweep["wall_s"],
               "speedup_warm": sweep_wall / sweep["wall_s"]},
           "nvidia_smi": card_line()}
    emit("scalar", **out)
    check(dev["dev_goodput_vs_scalar"] <= TOL
          and dev["dev_incast_fct_vs_scalar"] <= TOL,
          f"incast48 on the card vs run_fabric: {dev} (inf = finite masks "
          "differ)")
    check(fanout, "incast48: pause fan-out differs from run_fabric: "
          f"{card['pause_fanout'].tolist()} vs "
          f"{inc['pause_fanout'].tolist()}")
    check(cpu_dev <= CPU_SCALAR_TOL and cpu_completion,
          f"incast48 CPU float64 vs run_fabric: goodput {cpu_dev}, "
          f"completions equal {cpu_completion}")
    check(pair_dev <= PAIR_TOL, f"single pair vs run_sim: {pair_dev}")
    check(sweep_ok, "the receiver sweep is more than 1 % off run_sim: max "
          f"relative {sweep_dev}")
    return out


def oracle(job: str, threads: int):
    """A CPU reference run, in a worker process: the sweep in float32,
    the fabric grids in float64, a chunk of the scalar drivers' runs in
    Python floats."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    if job.startswith("scalar"):
        out = scalar_oracle(job)
    elif job.startswith("sweep"):
        from repro_torch.fabric import run_sweep
        out = run_sweep(sweep_configs(job == "sweep_dense", SWEEP_TIME_S),
                        device="cpu")
    else:
        from repro_torch.fabric import run_fabric_sweep
        if job == "routing":
            scens = routing_scens(ROUTING_TIME_S)
        elif job == "messages":
            scens = message_scens(MESSAGES_TIME_S)[0]
        elif job == "faults":
            scens = fault_scens(FAULTS_TIME_S)[0]
        elif job == "adaptive":
            scens = adaptive_scens(ADAPTIVE_TIME_S)
        elif job in POD_TIMES:
            scens = pod_scens(job, POD_TIMES[job])
        elif job == "mixed_fleet6":
            scens = mixed_scens()
        else:
            scens = class_scens(job, CLASSES_TIME_S)
        out = run_fabric_sweep(scens, device="cpu", dtype=torch.float64,
                               adaptive_dt=job == "adaptive")
    return out, time.perf_counter() - t0


def run_oracles() -> dict:
    """Every CPU reference run of the phases below, in a pool of worker
    processes (spawned, so no CUDA state is inherited).  Called once the
    card runs are done, so no worker competes with the thread that
    issues the timed card runs for the host's cores.  Returns ``{job:
    (outputs, wall seconds)}``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    # longest first (their walls in PR 28's run), so the pool ends with
    # the short ones
    jobs = {"messages": 1, "routing": 1, "faults": 1, "pod_storm3": 1,
            "sweep_dense": 2, "pod256": 1, "pod64": 1, "wrr": 1,
            "host_gate": 1, "qos_mixed": 1, "adaptive": 1,
            **{job: 1 for job in SCALAR_JOBS}, "mixed_fleet6": 1,
            "sweep": 1}
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            max_workers=ORACLE_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futs = {j: pool.submit(oracle, j, n) for j, n in jobs.items()}
        out = {j: f.result() for j, f in futs.items()}
    emit("oracles", workers=ORACLE_WORKERS, host_cpus=os.cpu_count(),
         wall_s=time.perf_counter() - t0,
         job_wall_s={j: w for j, (_, w) in out.items()})
    return out


def profile_window(fn, ticks: int, warm: bool = True, top: int = 0) -> dict:
    """Kernels launched per tick and the device's busy share over one
    call of ``fn`` (``ticks`` ticks) under ``torch.profiler`` (after a
    warm-up call of ``fn`` where ``warm``); the water-fill kernels it
    executed, by name; the segment sums' launches and device µs a tick;
    the ``top`` kernels by device time and the water-fills' device time a
    launch where ``top``."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    with profiled() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_time_total", 0) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    parse = time.perf_counter() - t0 - wall - PROFILE_PAD_S
    launches = sum(e.count for e in rows)
    busy_us = sum(e.device_time_total for e in rows)
    own = [e for e in rows if "grants_kernel" in e.key
           or "admit_kernel" in e.key]
    by_name = {f"priority_{name}": sum(e.count for e in own
                                       if f"{name}_kernel" in e.key)
               for name in ("grants", "admit")}
    seg = [e for e in rows if FABRIC_KERNELS["seg_sum"] in e.key]
    out = {"ticks": ticks, "wall_s": wall, "parse_s": parse,
           "kernels_per_tick": launches / ticks,
           "device_busy_us_per_tick": busy_us / ticks,
           "device_busy_share": busy_us * 1e-6 / wall if wall else None,
           "waterfills_per_tick": sum(e.count for e in own) / ticks,
           "waterfill_launches": by_name,
           "seg_sums_per_tick": sum(e.count for e in seg) / ticks,
           "seg_sum_device_us_per_tick":
               sum(e.device_time_total for e in seg) / ticks}
    if top:
        out["own_kernels"] = {name: {
            "count": sum(e.count for e in es),
            "device_us_per_launch": sum(e.device_time_total for e in es)
            / max(1, sum(e.count for e in es))}
            for name in ("grants", "admit")
            for es in [[e for e in own if f"{name}_kernel" in e.key]]}
        rows = sorted(rows, key=lambda e: -e.device_time_total)
        out["top"] = [{"kernel": e.key[:80], "count": e.count,
                       "device_us": e.device_time_total} for e in rows[:top]]
    return out


def fabric_profile(scens, ticks: int, top: int = 0,
                   sparse: bool = False, eager: bool = False) -> dict:
    """:func:`profile_window` of a fabric grid's run under the graph
    (captured before the window opens, so it holds replays only, with the
    capture's seconds beside it) and, with ``eager``, under ``eager``, of
    the eager loop (only the main grid's: its record parse took 14–19 s a
    grid).  The profiler slows the replays more than the eager loop, so
    each also has its busy share over the wall of the same run without
    the profiler (``device_busy_share_unprofiled``)."""
    import torch
    from repro_torch.fabric.vector import FabricRun, FabricSweepParams
    fsp = FabricSweepParams.from_scenarios(scens, sparse=sparse)
    out = {}
    for mode in (False, "auto") if eager else ("auto",):
        run = FabricRun(fsp, graph=mode)
        prof = profile_window(run.run, ticks, warm=False,
                              top=top if mode else 0)
        run = FabricRun(fsp, graph=mode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.run()
        wall = time.perf_counter() - t0
        prof.update(wall_unprofiled_s=wall,
                    device_busy_share_unprofiled=prof[
                        "device_busy_us_per_tick"] * ticks * 1e-6 / wall)
        if mode:
            prof["capture_s"] = run.capture_s
        out[mode] = prof
    return {**out["auto"], **({"eager": out[False]} if eager else {})}


def sweep_phase(label: str, dense: bool):
    """The receiver-datapath sweep on the card, both modes, full depth.
    Runs and times the card now; returns its goodput and warm wall, and
    the function that, given the CPU references, holds every output
    within SWEEP_TOL of the port's CPU float32 run (bitwise expected),
    with identical finite masks."""
    import numpy as np
    import torch
    from repro_torch.fabric import SweepParams, run_sweep
    cfgs = sweep_configs(dense, SWEEP_TIME_S)
    sp = SweepParams.from_configs(cfgs)
    run_sweep(sweep_configs(dense, 20e-6))          # warm-up
    t0 = time.perf_counter()
    res = run_sweep(cfgs)
    wall = time.perf_counter() - t0
    prof = profile_window(
        lambda: run_sweep(sweep_configs(dense, 200e-6)), 200)

    def finish(oracles) -> dict:
        want, cpu_wall = oracles["sweep_dense" if dense else "sweep"]
        dev = {k: rel(res[k], want[k]) for k in want}
        bitwise = {k: bool(np.array_equal(res[k], want[k])) for k in want}
        n = len(cfgs) // 2
        gp = res["goodput_gbps"]
        out = {"case": label, "points": sp.n_points, "ticks": sp.ticks,
               "sim_time_s": SWEEP_TIME_S, "ring_len": sp.ring_len,
               "wall_s": wall, "ms_per_tick": wall / sp.ticks * 1e3,
               "point_ticks_per_s": sp.n_points * sp.ticks / wall,
               "cpu_float32_wall_s": cpu_wall, "profile": prof,
               "max_rel_dev_vs_cpu": max(dev.values()), "dev": dev,
               "bitwise_equal_cpu": all(bitwise.values()),
               "not_bitwise": [k for k, v in bitwise.items() if not v],
               "ddio_goodput_gbps": [float(gp[:n].min()),
                                     float(gp[:n].max())],
               "jet_goodput_gbps": [float(gp[n:].min()),
                                    float(gp[n:].max())],
               "torch_threads": torch.get_num_threads()}
        emit("receiver_sweep", **out)
        check(all(v <= SWEEP_TOL for v in dev.values()),
              f"{label}: the sweep deviates from the CPU run: {dev}")
        check(bool(np.isfinite(gp).all()), f"{label}: non-finite goodput")
        check(gp[:n].min() < gp[:n].max(), f"{label}: DDIO goodput is flat")
        return out
    return {"goodput_gbps": res["goodput_gbps"], "wall_s": wall,
            "points": sp.n_points, "ticks": sp.ticks}, finish


def fabric_vs_cpu(job: str, fsp, res, head: dict, oracles):
    """Hold a card run against its CPU float64 reference: adds the
    deviations to ``head``; returns the reference's outputs and the
    checks every fabric grid meets (called after its line is printed)."""
    import numpy as np
    want, cpu_wall = oracles[job]
    dev = {k: rel(res[k], want[k]) for k in
           ("flow_goodput_gbps", "flow_completion_us",
            "incast_completion_us", "recv_goodput_gbps")}
    head.update(cpu_float64_wall_s=cpu_wall, dev=dev,
                pause_fanout=res["pause_fanout"].tolist(),
                pause_fanout_cpu=want["pause_fanout"].tolist())

    def held():
        check(launches_per_tick(head, fsp.ticks),
              f"{job}: launches {head['launches']} (captured "
              f"{head['launches_captured']}), want {4 * fsp.ticks} / "
              f"{fsp.ticks}")
        check(all(v <= TOL for v in dev.values()),
              f"{job}: deviates from CPU float64: {dev} (inf = finite "
              "masks differ)")
        check(bool(np.isfinite(res["flow_goodput_gbps"]).all()),
              f"{job}: non-finite goodput")
    return want, held


def routing_phase():
    """The routing grid at 8 ms on the card.  Runs and times the card
    now; returns its packing and the function that, given the CPU
    references, holds it within TOL of CPU float64 with reroute counts
    equal and 4 grants + 1 admit a tick, and checks that under the
    failure static ECMP never finishes while adaptive and spray do."""
    graph_eager("routing8", routing_scens(GRAPH_EAGER_TICKS * 1e-6))
    fsp, res, head = fabric_run(routing_scens(ROUTING_TIME_S))
    prof = fabric_profile(routing_scens(50e-6), 50)

    def finish(oracles) -> dict:
        import numpy as np
        want, held = fabric_vs_cpu("routing", fsp, res, head, oracles)
        fct = res["incast_completion_us"]
        rr = res["reroute_count"]
        m = len(ROUTING_MODES)
        out = {**head, "sim_time_s": ROUTING_TIME_S,
               "modes": list(ROUTING_MODES), "fail_at_us": [None, 150.0],
               "incast_fct_us": fct.tolist(), "reroute_count": rr.tolist(),
               "reroute_count_cpu": want["reroute_count"].tolist(),
               "uplink_util_max": res["uplink_util_max"].tolist(),
               "profile": prof}
        emit("routing", **out)
        held()
        check(np.array_equal(rr, want["reroute_count"]),
              f"reroute counts {rr} != CPU {want['reroute_count']}")
        fail = {mode: m + i for i, mode in enumerate(ROUTING_MODES)}
        check(bool(np.isfinite(fct[:m]).all()),
              f"an incast without failure did not finish: {fct[:m]}")
        check(not np.isfinite(fct[fail["static_ecmp"]]),
              "static ECMP finished under the failure")
        check(np.isfinite(fct[fail["adaptive"]])
              and np.isfinite(fct[fail["spray"]]),
              "adaptive or spray did not finish under the failure")
        check(rr[fail["adaptive"]] > 0 and rr[0] == 0
              and rr[fail["static_ecmp"]] == 0,
              f"reroute counts {rr}: adaptive must reroute, static never")
        check(prof["waterfills_per_tick"] == 5,
              f"profile: {prof['waterfills_per_tick']} water-fills a tick")
        return out
    return fsp, finish


def classes_phase():
    """The QoS-mixed grid, the strict/WRR pair and the host-gate pair at
    4 ms on the card.  Runs and times the card now; returns each grid's
    packing and the function that, given the CPU references, holds each
    within TOL of CPU float64 with 4 grants + 1 admit a tick, and checks
    that WRR keeps LOW above 15 Gbps where strict priority starves it
    below 1, and that the per-class host gate keeps HIGH at 0.95 Gbps or
    more where the whole-link gate holds it at 0.85 or less."""
    runs = {}
    for job in CLASS_JOBS:
        graph_eager(job, class_scens(job, GRAPH_EAGER_TICKS * 1e-6))
        fsp, res, head = fabric_run(class_scens(job, CLASSES_TIME_S))
        head["profile"] = fabric_profile(class_scens(job, 50e-6), 50)
        runs[job] = (fsp, res, head)

    def finish(oracles) -> dict:
        out, checks = {}, []
        for job, (fsp, res, head) in runs.items():
            _, held = fabric_vs_cpu(job, fsp, res, head, oracles)
            checks.append(held)
            out[job] = {**head, "sim_time_s": CLASSES_TIME_S,
                        "flow_goodput_gbps":
                            res["flow_goodput_gbps"].tolist(),
                        "recv_pfc_pause_us":
                            res["recv_pfc_pause_us"].tolist()}
        low, hi = (out[j]["flow_goodput_gbps"] for j in ("wrr",
                                                         "host_gate"))
        out["wrr"]["low_gbps"] = [row[3] for row in low]
        out["host_gate"]["high_gbps"] = [row[3] for row in hi]
        emit("classes", **out)
        for held in checks:
            held()
        for job in CLASS_JOBS:
            w = out[job]["profile"]["waterfills_per_tick"]
            check(w == 5, f"{job} profile: {w} water-fills a tick")
        low = out["wrr"]["low_gbps"]
        check(low[0] < 1.0 and low[1] > 15.0,
              f"LOW under strict / WRR: {low}")
        hi = out["host_gate"]["high_gbps"]
        check(hi[1] >= 0.95 and hi[0] <= 0.85,
              f"HIGH under the whole-link / per-class gate: {hi}")
        return out
    return {job: r[0] for job, r in runs.items()}, finish


def counts_within(got, want) -> bool:
    import numpy as np
    return bool(np.abs(np.asarray(got) - np.asarray(want)).max()
                <= COUNT_SLACK)


def messages_phase():
    """The bench's messages grid at its full 10 ms on the card.  Runs and
    times the card now; returns its packing and the function that, given
    the CPU references, holds message counts within COUNT_SLACK a point,
    the percentiles within one histogram bucket + P99_SLACK_US and
    goodput within TOL of CPU float64, with 4 grants + 1 admit a tick."""
    from repro_torch.fabric.messages import hist_ratio
    graph_eager("messages18", message_scens(GRAPH_EAGER_TICKS * 1e-6)[0])
    scens, pts = message_scens(MESSAGES_TIME_S)
    fsp, res, head = fabric_run(scens)
    prof = fabric_profile(message_scens(50e-6)[0], 50)

    def finish(oracles) -> dict:
        import numpy as np
        want, held = fabric_vs_cpu("messages", fsp, res, head, oracles)
        bucket = hist_ratio() - 1.0
        pct = {k: float(np.max(np.abs(res[k] - want[k])
                               - bucket * want[k]))
               for k in ("msg_p50_us", "msg_p99_us", "msg_p999_us")}
        cnt = res["msg_count_total"]
        p99 = {f"{algo}/{int(kb)}k": float(res["msg_p99_us"][i])
               for i, pt in enumerate(pts) for algo, kb in
               [(pt["algo"], pt["msg_kb"])] if pt["window"] == 16}
        out = {**head, "sim_time_s": MESSAGES_TIME_S,
               "msg_count_total": cnt.tolist(),
               "msg_count_total_cpu": want["msg_count_total"].tolist(),
               "count_max_diff": float(np.abs(
                   cnt - want["msg_count_total"]).max()),
               "pct_excess_over_bucket_us": pct,
               "p99_us_window16": p99,
               "msg_rate_mops": res["msg_rate_mops"].tolist(),
               "profile": prof}
        emit("messages", **out)
        held()
        check(counts_within(cnt, want["msg_count_total"]),
              f"messages: counts {cnt} vs CPU {want['msg_count_total']}")
        check(all(v <= P99_SLACK_US for v in pct.values()),
              f"messages: percentiles beyond a bucket + "
              f"{P99_SLACK_US} us: {pct}")
        check(bool(res["has_messages"].all() and (cnt > 0).all()),
              "messages: a point completed no message")
        check(prof["waterfills_per_tick"] == 5,
              f"profile: {prof['waterfills_per_tick']} water-fills a tick")
        return out
    return fsp, finish


def faults_phase():
    """The bench's faults grid and its crash case at the full 4 ms on the
    card.  Runs and times the card now; returns its packing and the
    function that, given the CPU references, holds dropped packets and
    retransmitted bytes within FAULT_TOL, message counts within
    COUNT_SLACK, crash recovery within a tick and deadlock ticks equal
    to CPU float64, and checks the lossless selective point drops
    nothing and selective beats go-back-N at 5 % loss."""
    graph_eager("lossy9", fault_scens(GRAPH_EAGER_TICKS * 1e-6)[0])
    scens, pts = fault_scens(FAULTS_TIME_S)
    fsp, res, head = fabric_run(scens)
    prof = fabric_profile(fault_scens(50e-6)[0], 50)

    def finish(oracles) -> dict:
        import numpy as np
        want, cpu_wall = oracles["faults"]
        dev = {k: rel(res[k], want[k]) for k in
               ("dropped_pkts", "retransmit_bytes", "flow_goodput_gbps",
                "crash_recovery_us")}
        rec, rec_cpu = res["crash_recovery_us"], want["crash_recovery_us"]
        fin = np.isfinite(rec_cpu)
        rec_ok = bool(np.array_equal(np.isfinite(rec), fin)
                      and (np.abs(rec[fin] - rec_cpu[fin])
                           <= fsp.dt_us).all())

        def at(rate, recovery):
            return next(i for i, pt in enumerate(pts)
                        if pt["loss_rate"] == rate
                        and pt["recovery"] == recovery
                        and "crash" not in pt)
        sel0 = at(0.0, "selective")
        g5, s5 = at(0.05, "go_back_n"), at(0.05, "selective")
        retx, cnt = res["retransmit_bytes"], res["msg_count_total"]
        out = {**head, "sim_time_s": FAULTS_TIME_S, "points_axes": pts,
               "cpu_float64_wall_s": cpu_wall, "dev": dev,
               "dropped_pkts": res["dropped_pkts"].tolist(),
               "retransmit_bytes": retx.tolist(),
               "msg_count_total": cnt.tolist(),
               "msg_count_total_cpu": want["msg_count_total"].tolist(),
               "msg_p999_us": res["msg_p999_us"].tolist(),
               "crash_recovery_us": rec[-1].tolist(),
               "crash_recovery_us_cpu": rec_cpu[-1].tolist(),
               "deadlock_ticks": res["deadlock_ticks"].tolist(),
               "deadlock_ticks_cpu": want["deadlock_ticks"].tolist(),
               "profile": prof}
        emit("faults", **out)
        check(launches_per_tick(head, fsp.ticks),
              f"faults: launches {head['launches']} (captured "
              f"{head['launches_captured']}), want {4 * fsp.ticks} / "
              f"{fsp.ticks}")
        check(dev["dropped_pkts"] <= FAULT_TOL
              and dev["retransmit_bytes"] <= FAULT_TOL,
              f"faults: fault accounting deviates from CPU float64: {dev}")
        check(counts_within(cnt, want["msg_count_total"]),
              f"faults: counts {cnt} vs CPU {want['msg_count_total']}")
        check(rec_ok, f"faults: crash recovery {rec.tolist()} vs CPU "
              f"{rec_cpu.tolist()}")
        check(np.array_equal(res["deadlock_ticks"], want["deadlock_ticks"]),
              "faults: deadlock ticks differ from CPU float64")
        check(res["dropped_pkts"][sel0] == 0.0,
              f"faults: the lossless selective point dropped "
              f"{res['dropped_pkts'][sel0]} packets")
        check(retx[s5] < 0.5 * retx[g5] and cnt[s5] > cnt[g5],
              f"faults: at 5 % loss selective retransmits {retx[s5]} vs "
              f"go-back-N {retx[g5]}, completes {cnt[s5]} vs {cnt[g5]}")
        check(bool(np.isfinite(res["flow_goodput_gbps"]).all()),
              "faults: non-finite goodput")
        check(prof["waterfills_per_tick"] == 5,
              f"profile: {prof['waterfills_per_tick']} water-fills a tick")
        return out
    return fsp, finish


# --------------------------------------------------------------------------- #
# The sparse-incidence engine: pod-scale (3-level Clos) cells
# --------------------------------------------------------------------------- #
POD_HOSTS = {"pod64": (2, 2), "pod256": (4, 4), "pod1024": (4, 16)}
                            # (pods, leaves a pod), 16 hosts a leaf:
                            # bench_fabric.py:run_scale_bench's points
                            # (64, 256) and a 1,024-host timing row
POD_PROFILE_TICKS = 20      # the pod cells' profiler window (50 until
                            # PR 28: parsing the eager window took 15-19 s
                            # a cell)
POD_TIMES = {"pod64": 0.004, "pod256": 0.004, "pod1024": 0.004,
             "pod_storm3": 0.005}   # the scale bench's 4 ms, kept whole;
                                    # pod_storm_grid's own 5 ms
SCALE_CEILING = 1.6         # bench_floors.json scale.growth_exponent
# the reference's pod outputs (tests/test_topology_pods.py KEYS) and the
# uplinks' utilization, spine -> super-spine tier included
POD_KEYS = ("flow_goodput_gbps", "flow_completion_us",
            "incast_completion_us", "victim_goodput_gbps", "pause_fanout",
            "ecn_marked_bytes", "switch_dropped_bytes", "uplink_util_max")
SEG_LARGE = (4096, 24576, 3 * 4097)     # rows, values a row, bins


def pod_scens(job: str, sim_time_s: float):
    """A pod cell's grid: ``pod_incast_grid`` (receiver mode x PFC, 0.2
    MB bursts, 16 hosts a leaf) at the cell's size, or ``pod_storm_grid``
    at the reference's defaults (buffers 32/64/128 KB, per-TC PFC,
    lossless, 2 x 2 x 4 hosts)."""
    from repro_torch.fabric import pod_incast_grid, pod_storm_grid
    if job == "pod_storm3":
        return pod_storm_grid(sim_time_s=sim_time_s)[0]
    pods, leaves = POD_HOSTS[job]
    return pod_incast_grid(pods=pods, leaves_per_pod=leaves,
                           hosts_per_leaf=16, burst_mb=0.2,
                           sim_time_s=sim_time_s)[0]


def sm_clock_hz() -> float:
    """The card's highest SM clock (``nvidia-smi clocks.max.sm``), Hz."""
    out = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def seg_device_us(calls: list, n: int = 20) -> list:
    """Device µs a call of each segment-sum variant and of the library
    yardstick at each of several shapes, ``calls`` [{variant: a call of
    it}] a shape, from one ``torch.profiler`` session (:func:`profiled`)
    in which each shape's calls run ``n`` times each, in turn.  The raw
    device records, in the order they ran, fall into one run a (shape,
    variant): a kernel's by its name (``SEG_KERNELS``, one launch a
    call), ``index_add_``'s as every other record (the session runs
    nothing else; its kernels' names and count a call are kept).  Fails
    unless the runs line up with the calls."""
    import torch
    for fns in calls:
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    with profiled() as prof:
        for fns in calls:
            for fn in fns.values():
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    recs = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        var = next((v for v, tag in SEG_KERNELS.items() if tag in e.name()),
                   "index_add_")
        recs.append((e.start_ns(), var, e.duration_ns(), e.name()))
    runs = []                       # [variant, records, ns, names]
    for _, var, ns, name in sorted(recs):
        if runs and runs[-1][0] == var:
            runs[-1][1] += 1
            runs[-1][2] += ns
            runs[-1][3].add(name)
        else:
            runs.append([var, 1, ns, {name}])
    want = [var for fns in calls for var in fns]
    got = [(r[0], r[1]) for r in runs]
    check([r[0] for r in runs] == want
          and all(c == n for var, c in got if var in SEG_KERNELS),
          f"seg_sum device µs: the profiler's records {got} do not line "
          f"up with the calls {want} ({n} each)")
    it = iter(runs)
    out = []
    for fns in calls:
        row = {}
        for var, c, ns, names in (next(it) for _ in fns):
            row[var] = ns * 1e-3 / n
            if var == "index_add_":
                row["index_add_kernels"] = {"per_call": c / n,
                                            "names": sorted(names)}
        out.append(row)
    return out


def seg_sum_phase(label: str, rows: int, idx, size: int, seed: int,
                  iters: int, clock_hz: float) -> tuple:
    """The segment-sum kernel (``warp_fold``) at ``[rows, len(idx)]``
    values into ``size`` bins at the bin index ``idx``: bit for bit
    against its plain version run on the CPU in float32, against itself
    over a second launch and against the first design (``bin_thread``,
    forced); per call, of both kernels, CUDA-event ms and host µs (no
    sync in the loop; :func:`seg_sum_rows` adds the device µs), with the
    plain version on the card and one ``index_add_`` into a zeroed output
    (the same function, atomic: the yardstick); the launch layout the C
    source makes (``fused.seg_launch``).  Two bounds: bytes once
    over the memory rate (``bound_ms``), and the bin-order floor, the
    longest bin's serial chain of adds at 4 cycles each over the highest
    SM clock; ``row_bound_ms`` is the larger and ``row_bound_by`` names
    it.  Values whose sums depend on the order (1e8, 1, -1e8).  Returns
    the row, unprinted, and the calls of both kernels and of the
    yardstick (``index_add_``)."""
    import numpy as np
    import torch
    from repro_torch.fabric import fused
    rng = np.random.default_rng(seed)
    idx = np.asarray(idx, np.int64)
    n = idx.size
    vals_cpu = torch.from_numpy(rng.choice(
        np.array([1e8, 1.0, -1e8, 0.3, -2.5, 0.0], np.float32),
        size=(rows, n)))
    vals = vals_cpu.cuda()
    plan = fused.seg_plan(idx, size, "cuda")
    want = fused.seg_sum_ref(vals_cpu, torch.from_numpy(idx), size)
    calls = {var: (lambda var=var: fused.seg_sum(vals, plan, _variant=var))
             for var in fused.SEG_VARIANTS}
    got = fused.seg_sum(vals, plan)
    again = fused.seg_sum(vals, plan)
    old = calls["bin_thread"]()
    torch.cuda.synchronize()
    equal = bitwise_equal(got.cpu(), want)
    repeat = bitwise_equal(again, got)
    old_equal = bitwise_equal(old, got)
    n_long = int(plan.long_bins.numel())
    layout = fused.seg_launch(rows, n, size, n_long)
    out = torch.zeros((rows, size), device="cuda")

    def library():
        out.index_add_(1, plan.idx, vals)

    nbytes = rows * n * 4 + n * 4 + (size + 1) * 4 + rows * size * 4
    bound_ms, bound_by = bound(nbytes, rows * n, FP32_OPS_PER_S)
    longest = int(np.bincount(idx, minlength=size).max()) if n else 0
    floor_ms = longest * 4 / clock_hz * 1e3
    timed = {var: {"ms": cuda_ms(fn, iters), "device_us": None,
                   "host_us": host_us(fn)} for var, fn in calls.items()}
    row = {"name": "seg_sum", "case": label, "shape": [rows, n],
           "bins": size, "longest": longest,
           "long_bins": n_long, "variant": "warp_fold",
           "layout": layout, "bitwise_equal": equal, "repeat_equal": repeat,
           "bin_thread_equal": old_equal,
           "max_abs_err": float((got.cpu() - want).abs().max().item())
           if got.numel() else 0.0,
           **timed["warp_fold"], "bin_thread": timed["bin_thread"],
           "plain_ms": cuda_ms(lambda: fused.seg_sum_ref(vals, plan.idx,
                                                         size), iters),
           "library_ms": cuda_ms(library, iters),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bin_order_floor_ms": floor_ms,
           "row_bound_ms": max(bound_ms, floor_ms),
           "row_bound_by": "bin order" if floor_ms > bound_ms else bound_by,
           "bytes": nbytes}
    check(equal, f"seg_sum {label}: the card != the CPU plain version")
    check(repeat, f"seg_sum {label}: two launches differ")
    check(old_equal, f"seg_sum {label}: bin_thread != warp_fold")
    return row, {**calls, "index_add_": library}


def seg_host_items(label: str, rows: int, idx, size: int) -> dict:
    """The host's µs a call of the segment-sum wrapper at one shape, and
    of its pieces alone: the output's allocation, the current stream, the
    launch through ctypes (the kernel enqueued, not counted), the launch
    counter, the device check; ``rest`` is the wrapper less those."""
    import numpy as np
    import torch
    from repro_torch.fabric import fused
    vals = torch.zeros((rows, len(idx)), device="cuda")
    plan = fused.seg_plan(np.asarray(idx), size, "cuda")
    out = fused.seg_sum(vals, plan)
    dev = vals.device
    perm, offsets, long_bins, n_long = plan.ptrs
    fn = fused._seg_lib().seg_sum_f32
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    items = {
        "wrapper": host_us(lambda: fused.seg_sum(vals, plan), 200),
        "empty": host_us(lambda: torch.empty(
            (rows, size), dtype=torch.float32, device=dev), 200),
        "stream": host_us(
            lambda: torch._C._cuda_getCurrentRawStream(dev.index), 200),
        "ctypes_launch": host_us(lambda: fn(
            vals.data_ptr(), perm, offsets, long_bins, out.data_ptr(), rows,
            plan.n, size, n_long, stream), 200),
        "launch_counter": host_us(
            lambda: fused.LAUNCHES.add("seg_sum", dev), 200),
        "device_check": host_us(
            lambda: dev.index != torch.cuda.current_device(), 200)}
    items["rest"] = items["wrapper"] - sum(
        v for k, v in items.items() if k != "wrapper")
    out = {"case": label, "shape": [rows, len(idx)], "bins": size,
           "host_us": items}
    emit("seg_sum_host", **out)
    return out


def seg_sum_rows() -> dict:
    """The segment sum at the pod path's shapes (pod256's and pod1024's
    three: a slot row into the (TC, port) bins, every slot entry into
    them, a slot row into the ports; and pod1024's slot 5, 768 of its 769
    entries in one bin) and at a large one; then the wrapper's host µs
    item by item at pod256's largest shape; returns the row of that
    shape, every slot entry into the (TC, port) bins, for the
    ``kernels`` line."""
    import numpy as np
    from repro_torch.fabric.vector import FabricSweepParams, _seg_plans
    clock = sm_clock_hz()
    main, done = None, []
    for i, job in enumerate(("pod256", "pod1024")):
        fsp = FabricSweepParams.from_scenarios(pod_scens(job, 1e-5),
                                               sparse=True)
        plans = _seg_plans(fsp, "cpu")
        picks = [("slot row -> (TC, port)", plans["qp_k"][1]),
                 ("all slots -> (TC, port)", plans["qp_flat"]),
                 ("slot row -> port", plans["po_k"][1])]
        if job == "pod1024":
            picks.append(("slot 5 -> (TC, port)", plans["qp_k"][5]))
        for j, (what, pl) in enumerate(picks):
            done.append(seg_sum_phase(f"{job} {what}", fsp.n_points,
                                      pl.idx.numpy(), pl.size,
                                      50 + 4 * i + j, iters=2000,
                                      clock_hz=clock))
            if job == "pod256" and pl is plans["qp_flat"]:
                main = done[-1][0]
                host = (fsp.n_points, pl.idx.numpy(), pl.size)
    rows, n, size = SEG_LARGE
    idx = np.random.default_rng(60).integers(0, size, n)
    done.append(seg_sum_phase("large", rows, idx, size, 61, iters=20,
                              clock_hz=clock))
    dev = seg_device_us([calls for _, calls in done])
    for (row, _), us in zip(done, dev):
        row["device_us"] = us["warp_fold"]
        row["bin_thread"]["device_us"] = us["bin_thread"]
        row["library_device_us"] = us["index_add_"]
        row["library_kernels"] = us["index_add_kernels"]
    for row, _ in done:
        times = (row["device_us"], row["bin_thread"]["device_us"],
                 row["library_device_us"])
        check(all(math.isfinite(t) and t > 0 for t in times),
              f"seg_sum {row['case']}: device µs {times}")
    for row, _ in done:
        emit("kernel", **row)
    seg_host_items("pod256 all slots -> (TC, port)", *host)
    return main


@contextlib.contextmanager
def forced_seg_variant(variant: str):
    """Every ``fused.seg_sum`` call of the fabric tick runs ``variant``
    (a timing's forcing: the tick reads ``fused.seg_sum`` at each
    call)."""
    from repro_torch.fabric import fused
    real = fused.seg_sum

    def forced(vals, plan, impl="auto", _variant=None):
        return real(vals, plan, impl=impl, _variant=variant)
    fused.seg_sum = forced
    try:
        yield
    finally:
        fused.seg_sum = real


def seg_variants_phase(job: str) -> dict:
    """A pod cell through the captured graph with its segment sums on each
    kernel in turn, ``warp_fold`` then ``bin_thread`` (forced): 50 ticks
    traced whole (:func:`trace_kernels`: the segment sums' launches by
    name, 22 a tick, and their device µs a tick; kernels and busy µs a
    tick), the launches counted on the card (22 a tick); then ms a tick
    over 300 untraced ticks, the two kernels timed in the order
    ``warp_fold``, ``bin_thread``, ``bin_thread``, ``warp_fold`` (a
    drift of the card's clock over the four falls on both alike), each
    kernel's mean in ``ms_per_tick``, its two runs in
    ``ms_per_tick_runs``."""
    import torch
    from repro_torch.fabric import fused
    from repro_torch.fabric.vector import FabricRun, FabricSweepParams

    def forced(var):
        return (forced_seg_variant(var) if var == "bin_thread"
                else contextlib.nullcontext())
    fsp = FabricSweepParams.from_scenarios(pod_scens(job, 50e-6),
                                           sparse=True)
    ticks = fsp.ticks
    timed = FabricSweepParams.from_scenarios(pod_scens(job, 300e-6),
                                             sparse=True)
    out = {}
    for var in SEG_KERNELS:
        with forced(var):
            run = FabricRun(fsp)
            fused.reset_launches()
            tr = trace_kernels(run.run)
            launches = fused.LAUNCHES.read()
        seg = tr["seg_sum"][var]
        out[var] = {"launches": launches,
                    "seg_sums_per_tick": seg["launches"] / ticks,
                    "seg_sum_device_us_per_tick": seg["device_us"] / ticks,
                    "kernels_per_tick": tr["kernels"] / ticks,
                    "device_busy_us_per_tick":
                        tr["device_busy_us"] / ticks,
                    "ms_per_tick_runs": []}
        want = {k: c * ticks for k, c in POD_LAUNCHES.items()}
        check(launches == want and seg["launches"] == 22 * ticks,
              f"{job} {var}: launches {launches}, {seg['launches']} "
              f"segment sums by name in {ticks} ticks")
    for var in ("warp_fold", "bin_thread", "bin_thread", "warp_fold"):
        with forced(var):
            run = FabricRun(timed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run.run()
            out[var]["ms_per_tick_runs"].append(
                (time.perf_counter() - t0) / timed.ticks * 1e3)
    for var in SEG_KERNELS:
        out[var]["ms_per_tick"] = sum(out[var]["ms_per_tick_runs"]) / 2
    emit("seg_variants", job=job, ticks=ticks, timed_ticks=timed.ticks,
         **out, nvidia_smi=card_line())
    return out


def pods_phase(dense: dict):
    """The pod cells on the card, every one at dt 1 µs through the
    captured graph: pod64 and pod_storm3 also graph == eager over
    ``GRAPH_EAGER_TICKS`` ticks; pod64, pod256, pod1024 (the timing row) and pod_storm3 with
    their launches a tick (6 grants, 1 admit, 22 segment sums,
    device-counted, equal to captured x ticks), ms a tick with and
    without the capture and a 20-tick profile (kernels a tick, busy
    share); and incast48_sparse, the main path's grid on the sparse
    engine, against the dense graph run ``dense`` (within TOL, finite
    masks identical: cuBLAS sums the dense one-hot products in its own
    order).  Runs the card now; returns the packings and the function
    that, given the CPU references, holds pod64, pod256 and pod_storm3
    within TOL of CPU float64 on ``POD_KEYS`` and prints the ``scale``
    line (busy µs a tick at 64 -> 256 hosts, exponent <= 1.6)."""
    for job in ("pod64", "pod_storm3"):
        graph_eager(job, pod_scens(job, GRAPH_EAGER_TICKS * 1e-6),
                    per=POD_LAUNCHES, sparse=True)
    runs = {}
    for job, t in POD_TIMES.items():
        fsp, res, head = fabric_run(pod_scens(job, t), sparse=True)
        head["profile"] = fabric_profile(
            pod_scens(job, POD_PROFILE_TICKS * 1e-6), POD_PROFILE_TICKS,
            sparse=True)
        runs[job] = (fsp, res, head)
    fsp2, sp, h2 = fabric_run(incast_grid(SIM_TIME_S), sparse=True)
    dev2 = {k: rel(sp[k], dense[k]) for k in
            ("flow_goodput_gbps", "flow_completion_us",
             "incast_completion_us", "victim_goodput_gbps",
             "flow_delivered_bytes")}
    out2 = {**h2, "sim_time_s": SIM_TIME_S, "dev_vs_dense_graph": dev2}
    emit("incast48_sparse", **out2)
    check(launches_per_tick(h2, fsp2.ticks, SPARSE_2TIER_LAUNCHES),
          f"incast48_sparse: launches {h2['launches']} (captured "
          f"{h2['launches_captured']})")
    check(all(v <= TOL for v in dev2.values()),
          f"incast48_sparse: deviates from the dense graph run: {dev2} "
          "(inf = finite masks differ)")

    def finish(oracles) -> dict:
        import numpy as np
        out = {}
        for job, (fsp, res, head) in runs.items():
            prof = head["profile"]
            row = {**head, "sim_time_s": POD_TIMES[job],
                   "kernels_per_tick": prof["kernels_per_tick"],
                   "device_busy_us_per_tick":
                       prof["device_busy_us_per_tick"],
                   "seg_sum_device_us_per_tick":
                       prof["seg_sum_device_us_per_tick"],
                   "device_busy_share": prof["device_busy_share_unprofiled"],
                   "pause_fanout": res["pause_fanout"].tolist(),
                   "pause_storm": res["pause_storm"].tolist(),
                   "incast_fct_us": res["incast_completion_us"].tolist(),
                   "uplink_util_max": res["uplink_util_max"].tolist()}
            if job in oracles:
                want, cpu_wall = oracles[job]
                row.update(cpu_float64_wall_s=cpu_wall, dev={
                    k: rel(res[k], want[k]) for k in POD_KEYS})
            out[job] = row
        emit("pods", **out)
        busy = {j: out[j]["device_busy_us_per_tick"] for j in POD_HOSTS}
        ms = {j: out[j]["ms_per_tick"] for j in POD_HOSTS}
        scale = {
            "hosts": [64, 256, 1024], "busy_us_per_tick": busy,
            "ms_per_tick": ms,
            "kernels_per_tick": {j: out[j]["kernels_per_tick"]
                                 for j in POD_HOSTS},
            "growth_exponent": math.log(busy["pod256"] / busy["pod64"])
            / math.log(4.0),
            "warm_growth_exponent": math.log(ms["pod256"] / ms["pod64"])
            / math.log(4.0),
            "growth_exponent_256_1024":
                math.log(busy["pod1024"] / busy["pod256"]) / math.log(4.0),
            "seg_sum_device_us_per_tick": {
                j: out[j]["seg_sum_device_us_per_tick"] for j in POD_HOSTS},
            "ceiling": SCALE_CEILING, "nvidia_smi": card_line()}
        emit("scale", **scale)
        for job, (fsp, res, head) in runs.items():
            check(launches_per_tick(head, fsp.ticks, POD_LAUNCHES),
                  f"{job}: launches {head['launches']} (captured "
                  f"{head['launches_captured']}), want {POD_LAUNCHES} a "
                  "tick")
            prof = head["profile"]
            check(prof["waterfills_per_tick"] == 7
                  and prof["seg_sums_per_tick"] == 22,
                  f"{job} profile: {prof['waterfills_per_tick']} "
                  f"water-fills, {prof['seg_sums_per_tick']} segment sums "
                  "a tick")
            check(bool(np.isfinite(res["flow_goodput_gbps"]).all()),
                  f"{job}: non-finite goodput")
            if "dev" in out[job]:
                dev = out[job]["dev"]
                check(all(v <= TOL for v in dev.values()),
                      f"{job}: deviates from CPU float64: {dev} (inf = "
                      "finite masks differ)")
        check(scale["growth_exponent"] <= SCALE_CEILING
              and scale["warm_growth_exponent"] <= SCALE_CEILING,
              f"scale: growth exponents {scale['growth_exponent']} / "
              f"{scale['warm_growth_exponent']} > {SCALE_CEILING}")
        return out
    return {job: r[0] for job, r in runs.items()}, runs["pod256"][2], \
        finish


FARM_CHUNKS = (16, 18)      # incast64: 4 chunks of 16; 3 of 18 + 10 padded to 16
FARM_POD_CHUNK = 2          # pod_storm3: a chunk of 2 and one of 1
MIXED_TIME_S = 0.002        # mixed_fleet6: depth 20 ms -> the registry's 2 ms
MIXED_CHUNK = 4             # mixed_fleet6: a chunk of 4 and one of 2
FARM_RUNS = ROOT / "build" / "farm_runs"    # farm_workers' artifacts


def mixed_scens():
    """``mixed_fleet_grid()`` at full width (8 senders + a victim; Jet
    pool 12 / 4 / 1 MB x bursts 1 / 2 MB), depth cut to 2 ms."""
    from repro_torch.fabric import mixed_fleet_grid
    return mixed_fleet_grid(sim_time_s=MIXED_TIME_S)[0]


def grid_ticks(scens) -> int:
    """A grid's tick count, as its packing computes it."""
    f = scens[0].fabric
    return int(f.sim_time_s * 1e6 / f.dt_us)


def farm_pass(scens, chunk: int, **kw):
    """One in-memory farm run of ``scens`` in chunks of ``chunk`` on the
    card; the launch counts are set to 0 just before it and read just
    after (a capture's warm-up launches included)."""
    from repro_torch.fabric import fused
    from repro_torch.fabric.farm import run_farm
    fused.reset_launches()
    t0 = time.perf_counter()
    res = run_farm(scens, chunk_size=chunk, artifacts=False, **kw)
    wall = time.perf_counter() - t0
    return res, wall, fused.LAUNCHES.read()


def farm_summary(res, wall: float, launches: dict, want: dict, ticks: int,
                 per=None) -> dict:
    """A farm pass against the monolithic run ``want``: outputs that
    differ (NaN and inf in the same places), the largest relative
    deviation over every output, graphs captured, and each chunk's
    launches on the card (counted around its run, a replay's added on
    the card) against ``per`` a tick and the launches captured x ticks."""
    import numpy as np
    recs = res["manifest"]["records"]
    got = res["results"]
    diff = differing(got, want)
    dev = max((rel(np.asarray(got[k], np.float64),
                   np.asarray(want[k], np.float64)) for k in want
               if k in got and np.asarray(want[k]).dtype.kind in "fiub"),
              default=0.0)
    tick_want = {k: c * ticks for k, c in (per or DENSE_LAUNCHES).items()}
    return {"wall_s": wall, "captures": sum(r["captures"] for r in recs),
            "padded": [r["padded"] for r in recs],
            "real": [r["stop"] - r["start"] for r in recs],
            "chunk_wall_s": [r["wall_s"] for r in recs],
            "dev_farm_vs_mono": dev, "differ": diff,
            "launches": launches,
            "launches_chunks": {k: sum(r["launches"][k] for r in recs)
                                for k in launches},
            "launches_ok": all(r["launches"] == tick_want
                               and r["launches_captured"] == tick_want
                               for r in recs)}


def farm_phase():
    """The sweep farm on the card (``repro_torch.fabric.farm.run_farm``),
    in memory: incast64 (``build_grid("incast")``) against its monolithic
    graph run, twice in chunks of 16 and twice in chunks of 18; pod_storm3
    in chunks of 2 against its monolithic run; mixed_fleet6 in chunks of
    4.  Runs the card now; returns the function that holds mixed_fleet6
    to the CPU float64 reference."""
    from repro_torch.fabric import build_grid, pod_storm_grid
    scens, _ = build_grid("incast")
    fsp, mono, head = fabric_run(scens)
    out = {"grid": "incast64", "points": fsp.n_points,
           "flows": fsp.n_flows, "ticks": fsp.ticks,
           "mono": {k: head[k] for k in ("capture_s", "run_s", "wall_s",
                                         "ms_per_tick", "launches")}}
    for chunk in FARM_CHUNKS:
        out[f"chunk{chunk}"] = [
            farm_summary(*farm_pass(scens, chunk), mono, fsp.ticks)
            for _ in range(2)]
    out["nvidia_smi"] = card_line()
    emit("farm", **out)
    check(launches_per_tick(head, fsp.ticks),
          f"incast64 monolithic: launches {head['launches']}")
    built = set()           # chunk shapes with a run in the cache
    for chunk in FARM_CHUNKS:
        first, again = out[f"chunk{chunk}"]
        new = set(first["padded"]) - built
        built |= set(first["padded"])
        for i, ps in enumerate((first, again)):
            check(not ps["differ"] and ps["dev_farm_vs_mono"] == 0.0,
                  f"farm chunk {chunk} pass {i}: differs from the "
                  f"monolithic run in {ps['differ']} (dev "
                  f"{ps['dev_farm_vs_mono']})")
            check(ps["launches_ok"], f"farm chunk {chunk} pass {i}: "
                  f"chunk launches {ps['launches_chunks']}")
        check(first["captures"] == len(new),
              f"farm chunk {chunk}: {first['captures']} captures for "
              f"new shapes {sorted(new)}")
        check(again["captures"] == 0 and again["launches"]
              == again["launches_chunks"],
              f"farm chunk {chunk}, second pass: {again['captures']} "
              f"captures, launches {again['launches']} vs chunks "
              f"{again['launches_chunks']}")

    last = out[f"chunk{FARM_CHUNKS[-1]}"][0]
    check(any(p > r for p, r in zip(last["padded"], last["real"])),
          f"farm chunk {FARM_CHUNKS[-1]}: no chunk pads a lane (real "
          f"{last['real']}, padded {last['padded']})")

    pods = pod_storm_grid()[0]
    pfsp, pmono, phead = fabric_run(pods, sparse=True)
    pod = farm_summary(*farm_pass(pods, FARM_POD_CHUNK), pmono,
                       pfsp.ticks, POD_LAUNCHES)
    emit("farm_pod_storm3", points=pfsp.n_points, ticks=pfsp.ticks,
         mono={k: phead[k] for k in ("capture_s", "run_s", "ms_per_tick",
                                     "launches")}, **pod)
    check(not pod["differ"] and pod["dev_farm_vs_mono"] == 0.0,
          f"farm pod_storm3: differs from the monolithic run in "
          f"{pod['differ']}")
    check(pod["launches_ok"] and pod["captures"] == 2,
          f"farm pod_storm3: chunk launches {pod['launches_chunks']}, "
          f"{pod['captures']} captures")

    mixed = mixed_scens()
    mres, mwall, mlaunch = farm_pass(mixed, MIXED_CHUNK)
    ticks = grid_ticks(mixed)
    mrecs = mres["manifest"]["records"]

    def finish(oracles) -> dict:
        import numpy as np
        got = mres["results"]
        want, cpu_wall = oracles["mixed_fleet6"]
        dev = {k: rel(got[k], want[k]) for k in
               ("flow_goodput_gbps", "incast_completion_us",
                "victim_goodput_gbps", "flow_completion_us")}
        m = {"points": len(mixed), "flows": len(mixed[0].flows),
             "ticks": ticks, "wall_s": mwall,
             "captures": sum(r["captures"] for r in mrecs),
             "padded": [r["padded"] for r in mrecs],
             "launches": mlaunch, "dev": dev,
             "dev_goodput": dev["flow_goodput_gbps"],
             "dev_incast_fct": dev["incast_completion_us"],
             "incast_fct_us": got["incast_completion_us"].tolist(),
             "victim_gbps": got["victim_goodput_gbps"].tolist(),
             "recv_escape_ecn": got["recv_escape_ecn"][:, 0].tolist(),
             "cpu_float64_wall_s": cpu_wall}
        emit("mixed_fleet6", **m)
        tick_want = {k: c * ticks for k, c in DENSE_LAUNCHES.items()}
        check(all(r["launches"] == r["launches_captured"] == tick_want
                  for r in mrecs),
              f"mixed_fleet6: chunk launches "
              f"{[r['launches'] for r in mrecs]}")
        check(dev["flow_goodput_gbps"] <= TOL
              and dev["incast_completion_us"] <= TOL,
              f"mixed_fleet6 deviates from CPU float64: {dev} (inf = "
              "finite masks differ)")
        check(bool(np.isfinite(got["flow_goodput_gbps"]).all()),
              "mixed_fleet6: non-finite goodput")
        return m
    return finish


def farm_workers_phase() -> dict:
    """``run_farm("incast", quick=True)`` (16 points, 4 senders, 1 ms) in
    chunks of 4 through a spawn pool of 2 workers, each on the card and
    writing its own shards under the gitignored ``build/farm_runs``: the
    merged table equal to the in-process farm's, bit for bit; then one
    shard deleted and the run resumed, which reruns that chunk only."""
    import shutil
    from repro_torch.fabric import artifacts, build_grid
    from repro_torch.fabric.farm import run_farm
    shutil.rmtree(FARM_RUNS, ignore_errors=True)
    kw = dict(quick=True, chunk_size=4)
    inproc = run_farm("incast", artifacts=False, **kw)
    t0 = time.perf_counter()
    pooled = run_farm("incast", workers=2, out_dir=str(FARM_RUNS),
                      run_id="workers", **kw)
    pool_wall = time.perf_counter() - t0
    os.remove(artifacts.chunk_path(pooled["run_dir"], 1))
    t0 = time.perf_counter()
    resumed = run_farm("incast", workers=2, out_dir=str(FARM_RUNS),
                       run_id="workers", resume=True, **kw)
    resume_wall = time.perf_counter() - t0
    m = resumed["manifest"]
    reran = [r["chunk"] for r in m["records"]
             if r["chunk"] not in m["resumed_chunks"]]
    recs = pooled["manifest"]["records"]
    diff = differing(pooled["results"], inproc["results"])
    diff2 = differing(resumed["results"], inproc["results"])
    ticks = grid_ticks(build_grid("incast", quick=True)[0])
    tick_want = {k: c * ticks for k, c in DENSE_LAUNCHES.items()}
    out = {"points": m["n_points"], "chunks": m["chunks"],
           "workers": sorted({r["worker"] for r in recs}),
           "captures": sum(r["captures"] for r in recs),
           "pool_wall_s": pool_wall, "resume_wall_s": resume_wall,
           "equal_inprocess": not diff, "differ": diff,
           "resumed_chunks": m["resumed_chunks"], "reran": reran,
           "resume_equal": not diff2,
           "launches_ok": all(r["launches"] == r["launches_captured"]
                              == tick_want for r in m["records"])}
    emit("farm_workers", **out)
    check(not diff and not diff2,
          f"farm_workers: the pool differs from in-process in {diff}, "
          f"the resumed run in {diff2}")
    check(reran == [1] and m["resumed_chunks"] == [0, 2, 3],
          f"farm_workers: resume reran {reran}")
    check(len(out["workers"]) == 2
          and all(w.startswith("pid") for w in out["workers"]),
          f"farm_workers: workers {out['workers']}")
    check(out["launches_ok"], "farm_workers: chunk launches "
          f"{[r['launches'] for r in m['records']]}")
    return out


def waterfill_path_rows(grids: dict, seed: int) -> None:
    """Both water-fill kernels, bit for bit against their plain versions,
    at every shape the driven fabric grids gave them: grants at each
    grid's [G, Q, P], admit at its [G, Q, R]."""
    shapes = {}
    for path, fsp in grids.items():
        for name, n in (("priority_grants", fsp.n_ports),
                        ("priority_admit", fsp.n_recv)):
            shapes.setdefault((name, (fsp.n_points, 3, n)), []).append(path)
    for i, ((name, shape), paths) in enumerate(sorted(shapes.items())):
        kernel_phase(name, shape, seed + i, iters=500, path=paths)


def close_enough(got, want, tol: float):
    """(max abs error, whether |got - want| <= tol + tol * |want| holds
    everywhere and both are finite)."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool(
        (err <= tol + tol * w.abs()).all())
    return float(err.max().item()) if err.numel() else 0.0, ok


def close_to_scale(got, want, tol: float):
    """(max abs error, whether it is <= tol * max |want| and got is
    finite): the check of a matrix product.  tests/test_kernels.py's
    tolerances (1e-4 float32, 2e-2 bfloat16) taken relative to the
    product's largest magnitude, since two float32 sums of K products in
    different orders differ by ~sqrt(K) roundings of the partial sums,
    which an element whose sum cancels cannot absorb relative to
    itself."""
    import torch
    g, w = got.float(), want.float()
    err = float((g - w).abs().max().item())
    scale = float(w.abs().max().item())
    return err, bool(torch.isfinite(g).all()) and err <= tol * scale


def bound(nbytes: float, ops: float, ops_per_s: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def flash_phase(label: str, b: int, hq: int, hkv: int, t: int, s: int,
                d: int, causal: bool, window, dtype: str, seed: int,
                iters: int, plain_iters: int, expect: str) -> dict:
    """Hold the flash attention kernel against its plain version, and
    time one ``F.scaled_dot_product_attention`` call on the same case.
    ``expect`` is the kernel variant the type and head dim must select
    (``jet_flash_attention.VARIANT_LAUNCHES`` shows which one ran)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import jet_flash_attention as jfa
    from repro_torch.kernels import ops
    rng = np.random.default_rng(seed)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda().to(tdt)
    q, k, v = draw((b, hq, t, d)), draw((b, hkv, s, d)), draw((b, hkv, s, d))

    def kernel():
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   impl="cuda")

    def plain():
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   impl="ref")
    jfa.VARIANT_LAUNCHES.reset()
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    ran = [n for n, c in jfa.VARIANT_LAUNCHES.items() if c]
    tol = 2e-4 if dtype == "float32" else 1e-2
    err, ok = close_enough(got, want, tol)
    # bfloat16: the kernels round only P (mma_bf16) and the output, and
    # the H100 reads at most one bfloat16 ulp of the largest |plain|
    # (PERF.md §2); more would be a lost digit, such as a bf16 accumulator
    ulp = None
    if dtype == "bfloat16":
        top = float(want.float().abs().max().item())
        ulp = torch.finfo(torch.bfloat16).eps * 2.0 ** math.floor(
            math.log2(top))
    esize = q.element_size()
    nbytes = (q.numel() * 2 + k.numel() + v.numel()) * esize
    nops = jfa.flops(b, hq, t, s, d, causal, window)
    # each variant's ceiling: the float32 split does three TF32 products
    # for one float32 product; simt runs on the CUDA cores
    bms, by = bound(nbytes, nops, {"mma_bf16": BF16_OPS_PER_S,
                                   "mma_3xtf32": TF32_OPS_PER_S / 3,
                                   "simt": FP32_OPS_PER_S}[expect])
    # the yardstick: one PyTorch call on the same case; a boolean mask
    # (True = attend) where causality is right-aligned or windowed
    lib_kw = {"enable_gqa": True} if hkv != hq else {}
    if causal and t == s and not window:
        lib_kw["is_causal"] = True
    elif causal or window:
        tq = torch.arange(t, device=q.device)[:, None] + (s - t)
        sk = torch.arange(s, device=q.device)[None, :]
        mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
        if causal:
            mask &= tq >= sk
        if window:
            mask &= tq - sk < window
        lib_kw["attn_mask"] = mask

    def library():
        return F.scaled_dot_product_attention(q, k, v, **lib_kw)
    lib_err, _ = close_enough(library(), want, tol)
    lib_ms = cuda_ms(library, iters)
    ms = cuda_ms(kernel, iters)
    row = {"name": "flash_attention", "case": label,
           "q": [b, hq, t, d], "kv": [b, hkv, s, d], "causal": causal,
           "window": window, "dtype": dtype, "variant": ran,
           "smem_bytes": jfa.smem_bytes(expect, d), "tol": tol,
           "bf16_ulp": ulp, "ok": ok, "max_abs_err": err, "ms": ms,
           "plain_ms": cuda_ms(plain, plain_iters), "bound_ms": bms,
           "bound_by": by, "library_ms": lib_ms,
           "library_max_abs_err": lib_err, "tflops": nops / ms * 1e-9,
           "gflop": nops / 1e9, "bytes": nbytes}
    emit("kernel", **row)
    check(ran == [expect], f"flash_attention ({label}) ran {ran}, want "
                           f"{expect}")
    check(ok, f"flash_attention kernel != plain version ({label}): max "
              f"abs err {err}, tol {tol}")
    check(ulp is None or err <= ulp,
          f"flash_attention ({label}): max abs err {err} is more than one "
          f"bfloat16 ulp ({ulp}) of the largest output")
    return row


def ssd_truth64(x, dt, a, b, c):
    """y of the recurrence h_t = exp(dt_t a) h_(t-1) + dt_t b_t x_t^T,
    y_t = c_t h_t, step by step in float64 on the card: the truth both the
    kernel and the plain version (float32) are measured against."""
    import torch
    B, T, H, P = x.shape
    rep = H // b.shape[2]
    xd, dtd, ad = x.double(), dt.double(), a.double()
    bd = b.double().repeat_interleave(rep, dim=2)
    cd = c.double().repeat_interleave(rep, dim=2)
    h = torch.zeros((B, H, b.shape[3], P), dtype=torch.float64,
                    device=x.device)
    y = torch.empty((B, T, H, P), dtype=torch.float64, device=x.device)
    for t in range(T):
        h = (torch.exp(dtd[:, t] * ad)[..., None, None] * h
             + dtd[:, t, :, None, None] * bd[:, t, :, :, None]
             * xd[:, t, :, None, :])
        y[:, t] = torch.einsum("bhn,bhnp->bhp", cd[:, t], h)
    return y


def host_us(fn, calls: int = 50) -> float:
    """Host microseconds per call of ``fn``, back to back with no sync
    inside the timed loop: what a call costs the CPU (checks, allocations,
    launches), apart from the card, which runs behind."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def ssd_plan_phase() -> dict:
    """The SSD kernel's launch plan as the C source sizes it
    (``mamba2_ssd.plan``) against the Python copy (``smem_bytes``) at
    every width tile of ``mma_3xtf32`` and at ``simt`` chunks."""
    from repro_torch.kernels import mamba2_ssd as mssd
    got = {}
    for name, n, p, chunk in (("mma_3xtf32", 64, 64, 256),
                              ("mma_3xtf32", 8, 72, 20),
                              ("mma_3xtf32", 128, 64, 256),
                              ("mma_3xtf32", 128, 128, 64),
                              ("simt", 64, 64, 256), ("simt", 64, 20, 256),
                              ("simt", 12, 24, 32)):
        c_smem = max(v[0] for v in mssd.plan(
            name, 1, chunk, 4, n, p, chunk).values())
        got[f"{name}/{n}x{p}/{chunk}"] = [c_smem,
                                         mssd.smem_bytes(name, n, p, chunk)]
    emit("ssd_plan", smem_bytes_c_vs_python=got)
    check(all(c == py for c, py in got.values()),
          f"the SSD kernel's shared memory (C) differs from "
          f"mamba2_ssd.smem_bytes: {got}")
    return got


def ssd_phase(label: str, B: int, T: int, H: int, P: int, G: int, N: int,
              chunk: int, seed: int, iters: int, plain_iters: int,
              expect: str, prev_iters: int = 0,
              dtype: str = "float32") -> dict:
    """Hold the SSD scan kernel against its plain version, on inputs made
    as the Mamba2 block makes them (dt = softplus around 0.05, a from the
    block's a_log).  ``expect`` is the kernel variant the widths must
    select (``mamba2_ssd.VARIANT_LAUNCHES`` shows which one ran); with
    ``prev_iters``, the first kernel (``simt``, forced through the wrapper,
    never through ``ops``) is held to the plain version too and timed in
    the same call as ``prev_ms``.  Kernel, plain version and ``simt`` are
    each measured against the float64 recurrence as well (``f64``)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import mamba2_ssd as mssd
    from repro_torch.kernels import ops
    rng = np.random.default_rng(seed)
    ty = getattr(torch, dtype)

    def draw(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).cuda()
    x, b, c = draw((B, T, H, P)), draw((B, T, G, N)), draw((B, T, G, N))
    dt = F.softplus(draw((B, T, H), 0.5) + math.log(math.expm1(0.05)))
    x, dt, b, c = (v.to(ty) for v in (x, dt, b, c))
    a = -torch.linspace(1.0, 8.0, H, device="cuda")
    L = min(chunk, T)
    tol_y = 2e-4 if dtype == "float32" else 1e-2

    def kernel():
        return ops.ssd(x, dt, a, b, c, chunk=chunk, impl="cuda")

    def wrapper():
        return mssd.ssd_scan(x, dt, a, b, c, L)

    def plain():
        return ops.ssd(x, dt, a, b, c, chunk=chunk, impl="ref")

    def prev():
        return mssd.ssd_scan(x, dt, a, b, c, L, _variant="simt")
    mssd.VARIANT_LAUNCHES.reset()
    (y, h), (y0, h0) = kernel(), plain()
    torch.cuda.synchronize()
    ran = [n for n, k in mssd.VARIANT_LAUNCHES.items() if k]
    err_y, ok_y = close_enough(y, y0, tol_y)
    err_h, ok_h = close_enough(h, h0, 2e-4)
    truth = ssd_truth64(x, dt, a, b, c)

    def vs_truth(got):
        err = (got.double() - truth).abs()
        return [float(err.max()), float(
            (err / (tol_y + tol_y * truth.abs())).max())]
    f64 = {"kernel": vs_truth(y), "plain": vs_truth(y0)}
    nops = mssd.flops(B, T, H, N, P, L)
    nbytes = x.element_size() * (2 * x.numel() + dt.numel() + b.numel()
                                 + c.numel()) + 4 * (a.numel() + h.numel())
    # each variant's ceiling: the split does three TF32 products for one
    # float32 product; simt runs on the CUDA cores
    bms, by = bound(nbytes, nops, {"mma_3xtf32": TF32_OPS_PER_S / 3,
                                   "simt": FP32_OPS_PER_S}[expect])
    prev_ms = prev_err = prev_ok = prev_dev = prev_host = None
    if prev_iters:
        yp, hp = prev()
        torch.cuda.synchronize()
        ey, oy = close_enough(yp, y0, tol_y)
        eh, oh = close_enough(hp, h0, 2e-4)
        prev_err, prev_ok = max(ey, eh), oy and oh
        f64["simt"] = vs_truth(yp)
        prev_ms = cuda_ms(prev, prev_iters)
        prev_dev = device_us(prev, ["ssd_simt_kernel"])["ssd_simt_kernel"]
        prev_host = host_us(prev)
    ms = cuda_ms(kernel, iters)
    kplan = mssd.plan(expect, B, T, H, N, P, L)
    dev = device_us(kernel, list(kplan))
    row = {"name": "ssd_scan", "case": label, "dtype": dtype,
           "x": [B, T, H, P], "bc": [B, T, G, N], "chunk": L,
           "variant": ran, "blocks": {k: v[1] for k, v in kplan.items()},
           "device_us": dev, "device_ms": sum(dev.values()) / 1e3,
           "smem_bytes": max(v[0] for v in kplan.values()),
           "tol": tol_y, "ok": ok_y and ok_h,
           "max_abs_err": max(err_y, err_h), "max_abs_err_y": err_y,
           "max_abs_err_h": err_h, "f64": f64, "ms": ms,
           "plain_ms": cuda_ms(plain, plain_iters), "bound_ms": bms,
           "bound_by": by, "library_ms": None,
           "host_us": {"ops": host_us(kernel), "wrapper": host_us(wrapper),
                       "simt_wrapper": prev_host},
           "prev_ms": prev_ms, "prev_device_ms":
               None if prev_dev is None else prev_dev / 1e3,
           "prev_max_abs_err": prev_err, "tflops": nops / ms * 1e-9,
           "gflop": nops / 1e9, "bytes": nbytes}
    emit("kernel", **row)
    check(ran == [expect], f"ssd_scan ({label}) ran {ran}, want {expect}")
    check(ok_y and ok_h, f"ssd_scan kernel != plain version ({label}): "
                         f"max abs err y {err_y}, h {err_h}")
    check(prev_ok is not False, f"ssd_scan simt != plain version "
                                f"({label}): max abs err {prev_err}")
    check(row["smem_bytes"] == mssd.smem_bytes(expect, N, P, L),
          f"ssd_scan ({label}): the kernel asks for {row['smem_bytes']} "
          f"bytes of shared memory, smem_bytes says "
          f"{mssd.smem_bytes(expect, N, P, L)}")
    return row


def device_us(fn, names, calls: int = 5, tries: int = 3) -> dict:
    """Device microseconds per call of each kernel in ``names`` (matched in
    the demangled name), from ``torch.profiler`` over ``calls`` calls of
    ``fn``: what a call costs the card, apart from the host's issue time
    that CUDA events over back-to-back calls include.  A window that
    records no time for one of the kernels is profiled again, up to
    ``tries`` windows."""
    import torch
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profiled() as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if getattr(e, "device_time_total", 0) > 0
                and e.device_type == torch.autograd.DeviceType.CUDA]
        out = {n: sum(e.device_time_total for e in rows if n in e.key)
               / calls for n in names}
        if all(v > 0 for v in out.values()):
            break
    return out


def cycled(fn, sets):
    """``fn`` over a ring of input sets, the next set at each call, so that
    inputs smaller than the L2 cache are read cold as a decode step's
    would be."""
    at = [0]

    def call():
        i = at[0]
        at[0] = (i + 1) % len(sets)
        return fn(*sets[i])
    return call


def paged_inputs(b: int, hq: int, hkv: int, d: int, page: int, lengths,
                 dtype, seed: int, hole: bool):
    """Seeded q and pages on the card and a shuffled page table: each
    sequence's pages come from a permutation of the pool, -1 past its
    length, and with ``hole`` one -1 inside the longest sequence (which
    reads page 0, in the kernel as in the plain version)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    need = -(-np.asarray(lengths, np.int64) // page)
    maxp = int(max(need.max(), 1))
    n_pool = int(need.sum()) + 8
    perm = rng.permutation(n_pool)
    table = np.full((b, maxp), -1, np.int32)
    at = 0
    for i in range(b):
        table[i, :need[i]] = perm[at:at + need[i]]
        at += need[i]
    if hole:
        i = int(np.argmax(need))
        table[i, need[i] // 2] = -1
    g = torch.Generator(device="cuda").manual_seed(seed)
    kp = torch.randn((n_pool, page, hkv, d), generator=g, device="cuda",
                     dtype=dtype)
    vp = torch.randn((n_pool, page, hkv, d), generator=g, device="cuda",
                     dtype=dtype)
    q = torch.randn((b, hq, d), generator=g, device="cuda", dtype=dtype)
    return (q, kp, vp, torch.from_numpy(table).cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def decode_phase(label: str, b: int, hq: int, hkv: int, d: int, page: int,
                 lengths, dtype: str, seed: int, iters: int,
                 plain_iters: int, expect: str, hole: bool = False) -> dict:
    """Hold the paged decode kernel against its plain version (o and
    lse).  A length-0 row must give o == 0 from the kernel (the plain
    version gives the mean of v there, as the reference's does).
    ``expect`` is the variant the types must select
    (``jet_decode_attention.VARIANT_LAUNCHES`` shows which one ran).  The
    row records the launch plan as the C source makes it (splits, blocks
    and shared memory of the split kernel and the merge), each kernel's
    device time per call (``torch.profiler``), the host's microseconds per
    ``ops`` call (``host_us``), and the same kernel forced to one split
    (``s1_*``, no merge), held to the same tolerances and timed in the
    same call."""
    import torch
    from repro_torch.kernels import jet_decode_attention as jd
    from repro_torch.kernels import ops
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    q, kp, vp, table, lens = paged_inputs(b, hq, hkv, d, page, lengths, tdt,
                                          seed, hole)

    def kernel(k_pages, v_pages):
        return ops.decode_attention(q, k_pages, v_pages, table, lens,
                                    impl="cuda")

    def one_split(k_pages, v_pages):
        return jd.decode_attention_paged(q, k_pages, v_pages, table, lens,
                                         splits=1)

    def plain(k_pages, v_pages):
        return ops.decode_attention(q, k_pages, v_pages, table, lens,
                                    impl="ref")
    jd.VARIANT_LAUNCHES.reset()
    (o, lse), (o0, lse0) = kernel(kp, vp), plain(kp, vp)
    o1, lse1 = one_split(kp, vp)
    torch.cuda.synchronize()
    ran = [n for n, k in jd.VARIANT_LAUNCHES.items() if k]
    tol = 2e-4 if dtype == "float32" else 1e-2
    live = lens > 0

    def held(got_o, got_lse):
        eo, oo = close_enough(got_o[live], o0[live], tol)
        el, ol = close_enough(got_lse, lse0, 2e-4)
        return eo, el, oo and ol and bool((got_o[~live] == 0).all())
    err_o, err_l, ok = held(o, lse)
    zero_ok = bool((o[~live] == 0).all())
    err_o1, err_l1, ok1 = held(o1, lse1)
    maxp = table.shape[1]
    pl = jd.plan(tdt, tdt, b, hq, hkv, d, page, maxp,
                 jd.sm_count(torch.cuda.current_device()))
    pl1 = jd.plan(tdt, tdt, b, hq, hkv, d, page, maxp,
                  jd.sm_count(torch.cuda.current_device()), splits=1)
    pos = sum(min(n, maxp * page) for n in lengths)
    esize = kp.element_size()
    # q and o, the K and V rows of every position read, their table
    # entries, the lengths, and lse (the partials are the design's cost,
    # not the work's)
    nbytes = (2 * q.numel() * q.element_size() + 2 * pos * hkv * d * esize
              + 4 * sum(-(-n // page) for n in lengths) + 4 * b + 4 * b * hq)
    nops = 4.0 * hq * d * pos
    bms, by = bound(nbytes, nops, FP32_OPS_PER_S)
    copies = max(1, min(8, math.ceil(2 * L2_BYTES
                                     / (2 * kp.numel() * esize))))
    sets = [(kp, vp)] + [(kp.clone(), vp.clone())
                         for _ in range(copies - 1)]
    dev = device_us(cycled(kernel, sets), list(pl["kernels"]))
    dev1 = device_us(cycled(one_split, sets), list(pl1["kernels"]))
    row = {"name": "decode_attention_paged", "case": label,
           "q": [b, hq, d], "pages": list(kp.shape), "page_table": [b, maxp],
           "lengths": list(lengths), "dtype": dtype, "tol": tol,
           "tol_lse": 2e-4, "ok": ok, "variant": ran,
           "splits": pl["splits"], "chunk": pl["chunk"],
           "blocks": {k: v[1] for k, v in pl["kernels"].items()},
           "smem_bytes": {k: v[0] for k, v in pl["kernels"].items()},
           "max_abs_err": max(err_o, err_l), "max_abs_err_o": err_o,
           "max_abs_err_lse": err_l, "zero_rows": int((~live).sum()),
           "zero_rows_o_is_0": zero_ok,
           "ms": cuda_ms(cycled(kernel, sets), iters),
           "device_us": dev, "device_ms": sum(dev.values()) / 1e3,
           "host_us": host_us(lambda: kernel(kp, vp)),
           "s1_ms": cuda_ms(cycled(one_split, sets), iters),
           "s1_device_ms": sum(dev1.values()) / 1e3,
           "s1_blocks": pl1["kernels"][next(iter(pl1["kernels"]))][1],
           "s1_ok": ok1, "s1_max_abs_err": max(err_o1, err_l1),
           "plain_ms": cuda_ms(cycled(plain, sets), plain_iters),
           "timed_copies": copies, "bound_ms": bms, "bound_by": by,
           "library_ms": None,
           "library": "none: no single PyTorch call does the page "
                      "gather, the length mask and the lse",
           "gflop": nops / 1e9, "bytes": nbytes}
    del sets
    torch.cuda.empty_cache()
    emit("kernel", **row)
    check(ran == [expect], f"decode_attention_paged ({label}) ran {ran}, "
                           f"want {expect}")
    check(ok, f"decode_attention_paged kernel != plain version ({label}): "
              f"max abs err o {err_o}, lse {err_l}, length-0 rows o == 0: "
              f"{zero_ok}")
    check(ok1, f"decode_attention_paged forced to one split != plain "
               f"version ({label}): max abs err o {err_o1}, lse {err_l1}")
    return row


def decode_plan_phase() -> dict:
    """The paged decode kernel's launch plan as the C source makes it
    (``jet_decode_attention.plan``) against the Python copy
    (``split_plan``), at every row's sizes, forced splits and the widest
    head dims of each variant."""
    import torch
    from repro_torch.kernels import jet_decode_attention as jd
    f32, bf = torch.float32, torch.bfloat16
    sms = jd.sm_count(torch.cuda.current_device())
    got = {}
    for qt, kt, b, hq, hkv, d, page, maxp, splits in (
            (f32, f32, 6, 32, 32, 64, 16, 64, None),
            (f32, f32, 4, 32, 8, 80, 32, 128, None),
            (bf, bf, 8, 48, 4, 128, 16, 512, None),
            (bf, bf, 32, 40, 8, 128, 16, 2048, None),
            (bf, bf, 32, 40, 8, 128, 16, 2048, 1),
            (bf, bf, 8, 16, 16, 256, 16, 512, None),
            (f32, bf, 3, 64, 2, 256, 16, 63, 40),
            (f32, f32, 3, 64, 2, 256, 1, 4096, None),
            (bf, f32, 2, 12, 1, 20, 8, 9, 7)):
        key = (f"{str(qt)[6:]}/{str(kt)[6:]}/B{b}/Hq{hq}/Hkv{hkv}/D{d}/"
               f"page{page}/maxp{maxp}/S{splits}")
        got[key] = [jd.plan(qt, kt, b, hq, hkv, d, page, maxp, sms, splits),
                    jd.split_plan(qt, kt, b, hq, hkv, d, page, maxp, sms,
                                  splits)]
    emit("decode_plan", sms=sms, c_vs_python=got)
    check(all(c == py for c, py in got.values()),
          f"the paged decode plan (C) differs from split_plan: {got}")
    return got


def matmul_phase(label: str, m: int, k: int, n: int, dtype: str, seed: int,
                 iters: int, plain_iters: int, expect: str,
                 integer: bool = False) -> dict:
    """Hold the staged matmul kernel against its plain version, and time
    one ``torch.matmul`` in the same type (float32 at full precision) as a
    yardstick.  ``expect`` is the kernel variant the shape must select
    (``jet_staged_matmul.VARIANT_LAUNCHES`` shows which one ran).  With
    ``integer`` the operands are small integers (|x| <= 4), whose float32
    sums are exact: the kernel must then equal the plain version bit for
    bit, in both output types."""
    import torch
    from repro_torch._device import resolve_device
    from repro_torch.kernels import jet_staged_matmul as jsm
    from repro_torch.kernels import ops
    resolve_device("cuda")              # float32 products stay float32
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    g = torch.Generator(device="cuda").manual_seed(seed)
    if integer:
        a = torch.randint(-4, 5, (m, k), generator=g, device="cuda").to(tdt)
        b = torch.randint(-4, 5, (k, n), generator=g, device="cuda").to(tdt)
    else:
        a = torch.randn((m, k), generator=g, device="cuda").to(tdt)
        b = torch.randn((k, n), generator=g, device="cuda").to(tdt)

    def kernel():
        return ops.staged_matmul(a, b, impl="cuda")

    def plain():
        return ops.staged_matmul(a, b, impl="ref")

    def library():
        return torch.matmul(a, b)
    jsm.VARIANT_LAUNCHES.reset()
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    ran = [v for v, c in jsm.VARIANT_LAUNCHES.items() if c]
    tol = 1e-4 if dtype == "float32" else 2e-2
    err, ok = close_to_scale(got, want, tol)
    exact = None
    if integer:
        f32 = ops.staged_matmul(a, b, impl="cuda", out_dtype=torch.float32)
        exact = bool(torch.equal(got, want)) and bool(torch.equal(
            f32, ops.staged_matmul(a, b, impl="ref",
                                   out_dtype=torch.float32)))
    lib_err, _ = close_to_scale(library(), want, tol)
    nbytes = (m * k + k * n + m * n) * a.element_size()
    nops = 2.0 * m * n * k
    bms, by = bound(nbytes, nops, FP32_OPS_PER_S if dtype == "float32"
                    else BF16_OPS_PER_S)
    enc0 = jsm.encode_stats()
    ms = cuda_ms(kernel, iters)
    enc1 = jsm.encode_stats()
    row = {"name": "staged_matmul", "case": label, "a": [m, k],
           "b": [k, n], "dtype": dtype, "variant": ran,
           "tile": jsm.TILES[expect], "stages": jsm.STAGES[expect],
           "smem_bytes": jsm.smem_bytes(expect), "tol": tol, "ok": ok,
           "max_abs_err": err, "bitwise_equal": exact, "ms": ms,
           "plain_ms": cuda_ms(plain, plain_iters), "bound_ms": bms,
           "bound_by": by, "library_ms": cuda_ms(library, iters),
           "library": "torch.matmul", "library_max_abs_err": lib_err,
           "tflops": nops / ms * 1e-9, "gflop": nops / 1e9,
           "bytes": nbytes,
           # host microseconds a launch spends encoding TMA tensor maps
           "encode_us_per_call": (enc1[0] - enc0[0]) / (enc1[1] - enc0[1])
           if enc1[1] > enc0[1] else None}
    if expect.startswith("wgmma"):
        # what the kernel asks for, against the wrapper's documented plan
        row["kernel_smem_bytes"] = jsm._lib().staged_matmul_wgmma_smem_bytes(
            jsm.TILES[expect][1])
    emit("kernel", **row)
    check(ran == [expect], f"staged_matmul ({label}) ran {ran}, want "
                           f"{expect}")
    check(row.get("kernel_smem_bytes", row["smem_bytes"]) ==
          row["smem_bytes"], f"staged_matmul ({label}): the kernel asks for "
                             f"{row.get('kernel_smem_bytes')} bytes of shared "
                             f"memory, smem_bytes says {row['smem_bytes']}")
    check(ok, f"staged_matmul kernel != plain version ({label}): max abs "
              f"err {err}, tol {tol}")
    check(exact is not False, f"staged_matmul ({label}): small-integer "
                              f"product not bitwise equal to the plain "
                              f"version")
    return row


def wgmma_widths_phase(iters: int) -> dict:
    """Both tile widths of the wgmma kernel on the same inputs, in turns
    (128, 256, 256, 128), at shapes on either side of the width rule
    (``jet_staged_matmul.variant``): the record behind that rule.  Direct
    calls of the library entry, so these launches count nowhere."""
    import torch
    from repro_torch.kernels import jet_staged_matmul as jsm
    lib = jsm._lib()
    rows = []
    for m, k, n in ((1024, 2048, 8192), (4096, 5120, 8192), (256, 2048, 8192),
                    (1000, 2056, 1000)):
        g = torch.Generator(device="cuda").manual_seed(m + n)
        a = torch.randn((m, k), generator=g, device="cuda").bfloat16()
        b = torch.randn((k, n), generator=g, device="cuda").bfloat16()
        c = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def call(bn):
            err = lib.staged_matmul_wgmma_fwd(a.data_ptr(), b.data_ptr(),
                                              c.data_ptr(), m, n, k, bn, 1,
                                              stream)
            check(err == 0, f"wgmma launch (bn {bn}) failed: {err}")
        t = {bn: [] for bn in (128, 256)}
        for bn in (128, 256, 256, 128):
            t[bn].append(cuda_ms(lambda: call(bn), iters))
        rows.append({"shape": [m, k, n], "ms_128": t[128], "ms_256": t[256],
                     "chosen": jsm.variant(torch.bfloat16, m, n, k)})
    out = {"rows": rows}
    emit("wgmma_widths", **out)
    return out


def layer_kv(params, cfg, tokens, max_len: int):
    """Prefill ``tokens`` (one sequence) through the kernels and return
    the first shared-attention layer's dense ring cache (k, v), each
    [max_len, Hkv, hd]."""
    import numpy as np
    import torch
    from repro_torch.models import api
    dev = params["embed"].device
    tok = torch.from_numpy(tokens.astype(np.int64)).to(dev)[None]
    _, state, _ = api.prefill(params, cfg, tok, max_len=max_len)
    k, v = next(st["kv"] for st in state["pattern"] if "kv" in st)
    return k[0, 0], v[0, 0]             # unit 0, sequence 0


def staged_path(params, cfg, dev) -> dict:
    """zamba2's shared MLP up-projection at a 1024-token prefill (x
    [1024, d_model] @ w_in [d_model, d_ff]) through ``ops.staged_matmul``,
    in float32 and in bfloat16: one launch each, the float32 product within
    1e-4 of ``torch.matmul``'s in full float32, the bfloat16 one within
    2e-2 of the float32 product of the same bfloat16 operands (both of the
    largest magnitude)."""
    import torch
    from repro_torch.kernels import jet_staged_matmul as jsm
    from repro_torch.kernels import ops
    w = params["shared_attn"]["ffn"]["w_in"]
    x = torch.randn((1024, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(12))
    xb, wb = x.bfloat16(), w.bfloat16()
    ops.reset_launches()
    jsm.VARIANT_LAUNCHES.reset()
    y = ops.staged_matmul(x, w)
    yb = ops.staged_matmul(xb, wb)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    variants = dict(jsm.VARIANT_LAUNCHES)
    err, ok = close_to_scale(y, torch.matmul(x, w), 1e-4)
    err_b, ok_b = close_to_scale(yb, torch.matmul(xb.float(), wb.float()),
                                 2e-2)
    out = {"x": list(x.shape), "w_in": list(w.shape), "launches": launches,
           "variants": variants, "max_abs_err_vs_torch_matmul": err,
           "tol": 1e-4, "ok": ok, "bf16_max_abs_err_vs_f32_product": err_b,
           "bf16_tol": 2e-2, "bf16_ok": ok_b}
    emit("staged", **out)
    check(launches == {"flash_attention": 0, "flash_attention_bwd": 0,
                       "ssd_scan": 0, "ssd_scan_bwd": 0,
                       "decode_attention_paged": 0, "staged_matmul": 2},
          f"staged path launches {launches}")
    check(variants == {"simt_f32": 1, "mma_sync_bf16": 0, "wgmma_bf16": 0,
                       "wgmma_bf16_n256": 1},
          f"staged path variants {variants}")
    check(ok, f"staged path deviates from torch.matmul by {err}")
    check(ok_b, f"staged path (bf16) deviates from the float32 product by "
                f"{err_b}")
    return out


def paged_phase(cfg, dev):
    """The paged KV path at zamba2-1.2b's full width: the six serve
    prompts' shared-attention KV, written round-robin into one
    ``PagedKV``, decoded through ``ops.decode_attention`` and held to the
    dense ring decode of the model's decode path; then the lse merge,
    release and reuse, and the escape path.  Returns the ``paged`` and
    ``staged`` phase rows and the first decode's (o, lse)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import api
    from repro_torch.serving import PagedKV, PagedKVConfig
    params = api.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    staged = staged_path(params, cfg, dev)
    max_len, page, maxp, reuse = 1280, 16, 80, 512
    rng = np.random.default_rng(7)     # the serve phase's prompts
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
               for n in SERVE_PROMPTS]
    caches = [layer_kv(params, cfg, p, max_len) for p in prompts]
    new_k, new_v = layer_kv(params, cfg, np.random.default_rng(9).integers(
        2, cfg.vocab_size, size=reuse), max_len)
    del params
    torch.cuda.empty_cache()
    kd = torch.stack([c[0] for c in caches])     # [6, max_len, Hkv, hd]
    vd = torch.stack([c[1] for c in caches])
    del caches
    lengths = torch.tensor(SERVE_PROMPTS, dtype=torch.int32, device=dev)
    hkv, hd = cfg.num_kv_heads, cfg.hd
    q = torch.randn((len(SERVE_PROMPTS), cfg.num_heads, hd), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(10))

    ops.reset_launches()
    calls = 0
    store = PagedKV.create(PagedKVConfig(
        num_pages=160, page_size=page, num_kv_heads=hkv, head_dim=hd,
        max_pages_per_seq=maxp, dtype=torch.float32), len(SERVE_PROMPTS),
        device=dev)

    def decode(table, lens):
        nonlocal calls
        calls += 1
        return ops.decode_attention(q, store.k_pages, store.v_pages, table,
                                    lens)
    # 1-2: every prompt's tokens, round-robin across the sequences
    t0 = time.perf_counter()
    oks = [store.append(b, kd[b, pos], vd[b, pos])
           for pos in range(max(SERVE_PROMPTS))
           for b, n in enumerate(SERVE_PROMPTS) if pos < n]
    appends_ok = bool(torch.stack(oks).all())
    append_s = time.perf_counter() - t0
    table = store.page_table.cpu().numpy()
    contiguous = [bool(np.all(np.diff(r[r >= 0]) == 1)) for r in table]
    # 3: the paged decode against the dense ring decode
    o, lse = decode(store.page_table, store.lengths)
    o_d, lse_d = ref.decode_attention_naive(q, kd, vd, lengths)
    err_o, ok_o = close_enough(o, o_d, PAGED_TOL)
    err_l, ok_l = close_enough(lse, lse_d, PAGED_TOL)
    # 4: each half of every table, merged through lse
    half = maxp // 2
    parts = [decode(store.page_table[:, :half].contiguous(),
                    torch.clamp(store.lengths, max=half * page)),
             decode(store.page_table[:, half:].contiguous(),
                    torch.clamp(store.lengths - half * page, min=0))]
    merged = ref.combine_partial_attention(
        torch.stack([parts[0][0], parts[1][0]]),
        torch.stack([parts[0][1], parts[1][1]]))
    err_split, ok_split = close_enough(merged, o, PAGED_TOL)
    # 5: release the 1024-token sequence, reuse its pages
    avail0 = int(store.pool.available())
    freed = {int(p) for p in table[4] if p >= 0}
    store.release(4)
    avail1 = int(store.pool.available())
    oks = [store.append(4, new_k[pos], new_v[pos]) for pos in range(reuse)]
    reuse_ok = bool(torch.stack(oks).all())
    reused = {int(p) for p in store.page_table[4].cpu().numpy() if p >= 0}
    kd[4].zero_()
    vd[4].zero_()
    kd[4, :reuse], vd[4, :reuse] = new_k[:reuse], new_v[:reuse]
    lengths[4] = reuse
    o2, lse2 = decode(store.page_table, store.lengths)
    o2_d, lse2_d = ref.decode_attention_naive(q, kd, vd, lengths)
    err_o2, ok_o2 = close_enough(o2, o2_d, PAGED_TOL)
    err_l2, ok_l2 = close_enough(lse2, lse2_d, PAGED_TOL)
    # 6: a small pool runs out: the 33rd token needs a third page
    small = PagedKV.create(PagedKVConfig(
        num_pages=2, page_size=page, num_kv_heads=hkv, head_dim=hd,
        max_pages_per_seq=4, dtype=torch.float32), 1, device=dev)
    small_ok = [bool(small.append(0, kd[0, pos], vd[0, pos]))
                for pos in range(2 * page + 1)]
    escape = {"ok": small_ok[-1], "earlier_ok": all(small_ok[:-1]),
              "table": small.page_table[0].tolist(),
              "length": int(small.lengths[0]),
              "available": int(small.pool.available()),
              # the reference writes the token into page 0, offset 0
              "escape_write_in_page0": bool(torch.equal(
                  small.k_pages[0, 0], kd[0, 2 * page]))}
    torch.cuda.synchronize()
    # 7: the kernel ran once per decode call and nothing else launched
    launches = dict(ops.LAUNCHES)
    out = {"arch": cfg.name, "kv_heads": hkv, "head_dim": hd,
           "q_heads": cfg.num_heads, "page": page, "num_pages": 160,
           "max_pages_per_seq": maxp, "lengths": SERVE_PROMPTS,
           "appends": sum(SERVE_PROMPTS),
           "append_s": append_s, "appends_ok": appends_ok,
           "tables_contiguous": contiguous, "tol": PAGED_TOL,
           "max_abs_err_o_vs_dense": err_o, "max_abs_err_lse_vs_dense": err_l,
           "max_abs_err_split_merge": err_split,
           "available_before_release": avail0,
           "available_after_release": avail1, "freed_pages": len(freed),
           "reuse_tokens": reuse, "reused_pages": len(reused),
           "reused_within_freed": reused <= freed, "reuse_ok": reuse_ok,
           "max_abs_err_o_after_reuse": err_o2,
           "max_abs_err_lse_after_reuse": err_l2, "escape": escape,
           "decode_calls": calls, "launches": launches}
    emit("paged", **out)
    check(appends_ok, "an append into the 160-page pool failed")
    check(not any(contiguous), f"page tables are contiguous: {contiguous}")
    check(ok_o and ok_l, f"paged decode deviates from the dense ring "
                         f"decode: o {err_o}, lse {err_l} > {PAGED_TOL}")
    check(ok_split, f"the merged halves deviate from the full decode by "
                    f"{err_split}")
    check(avail1 == avail0 + len(freed),
          f"release restored {avail1 - avail0} pages, want {len(freed)}")
    check(reuse_ok and reused <= freed and len(reused) == -(-reuse // page),
          f"the new sequence's pages {sorted(reused)} are not the freed "
          f"ones")
    check(ok_o2 and ok_l2, f"decode after reuse deviates: o {err_o2}, lse "
                           f"{err_l2}")
    check(escape == {"ok": False, "earlier_ok": True,
                     "table": [0, 1, -1, -1], "length": 2 * page + 1,
                     "available": 0, "escape_write_in_page0": True},
          f"the escape path differs from the reference's: {escape}")
    check(launches == {"flash_attention": 0, "flash_attention_bwd": 0,
                       "ssd_scan": 0, "ssd_scan_bwd": 0,
                       "decode_attention_paged": calls, "staged_matmul": 0},
          f"paged path launches {launches}, want {calls} decode launches")
    return out, staged, (o, lse)


def tree_rel(got, want) -> float:
    """Largest leaf-wise max |got - want| / max |want| over two trees."""
    from repro_torch.models.decoding import tree_map
    worst = []
    tree_map(lambda g, w: worst.append(float(
        (g.float() - w.float()).abs().max()
        / max(float(w.float().abs().max()), 1e-30))), got, want)
    return max(worst)


def route_cuts(kernel_routes, plain_routes, t: int):
    """Compare an MoE model's routing in two prefills of one ``t``-token
    prompt (kernels, plain versions), layer by layer.  A token whose
    expert differs is excused where the plain run's top-2 router
    probability margin is below ``ROUTE_MARGIN``; from that layer on it
    and every later token may rightly move (causal attention, and a
    capacity rank counts the tokens before it), so ``cuts[l]`` is the
    number of leading rows of layer ``l``'s KV no excused flip reaches
    (``cuts[-1]``: the logits' position).  Returns (cuts, report)."""
    import torch
    cut, cuts, flips, excused = t, [], [], True
    pos = torch.arange(t)
    for layer, ((ik, kk, _), (ip, kp, mp)) in enumerate(
            zip(kernel_routes, plain_routes)):
        cuts.append(cut)
        expert = (ik != ip).cpu() & (pos < cut)
        kept = (kk != kp).cpu() & ~expert & (pos < cut)
        if not (expert.any() or kept.any()):
            continue
        first = int(pos[expert].min()) if expert.any() else t
        margins = mp.cpu()[expert]
        excused &= bool(expert.any()) and bool(
            (margins < ROUTE_MARGIN).all()) and bool(
            (pos[kept] > first).all())
        flips.append({"layer": layer, "tokens": pos[expert].tolist(),
                      "plain_margins": margins.tolist(),
                      "kept_moved": pos[kept].tolist()})
        cut = min(cut, first)
    cuts.append(cut)
    return cuts, {"route_flips": flips, "routes_excused": excused}


def kv_rel_rows(got, want, cuts) -> float:
    """``tree_rel`` over the KV caches of a model whose layers are all
    units of one pattern position (``[n_units, B, S, Hkv, hd]``), layer
    ``l`` only over its first ``cuts[l]`` ring slots (= positions: the
    cache is at least the prompt long)."""
    worst = 0.0
    for g, w in zip(got["pattern"][0]["kv"], want["pattern"][0]["kv"]):
        scale = max(float(w.abs().max()), 1e-30)
        for layer in range(g.shape[0]):
            c = cuts[layer]
            if c:
                worst = max(worst, float(
                    (g[layer, :, :c] - w[layer, :, :c]).abs().max()) / scale)
    return worst


def prefill_vs_plain(params, cfg, prompt, max_len: int) -> dict:
    """One prompt's prefill through the kernels and through their plain
    versions: the logits' and the states' largest deviation relative to
    the plain run's largest magnitude.  In an MoE model both runs'
    routing is recorded, and rows a router near-tie reaches are left out
    (``route_cuts``); a flip that is not a near-tie is reported, and
    fails the phase."""
    import numpy as np
    import torch
    from repro_torch.models import api
    from repro_torch.models.transformer import segments
    dev = params["embed"].device
    tok = torch.from_numpy(prompt.astype(np.int64)).to(dev)[None]
    runs = []
    for impl in ("auto", "ref"):
        routes = []
        logits, state, _ = api.prefill(
            params, cfg, tok, max_len=max_len, impl=impl,
            on_route=lambda i, k, m, routes=routes: routes.append((i, k, m)))
        runs.append((logits, state, routes))
    (lk, sk, rk), (lr, sr, rr) = runs
    row = {"prompt": len(prompt)}
    if not rr:
        row.update(logits=tree_rel(lk, lr), state=tree_rel(sk, sr))
        return row
    pattern, _, rem = segments(cfg)
    check(pattern == ["attn_moe"] and not rem,
          f"{cfg.name}: the route check reads MoE layers of period 1")
    cuts, report = route_cuts(rk, rr, len(prompt))
    row.update(report)
    row["logits"] = tree_rel(lk, lr) if cuts[-1] == len(prompt) else None
    row["state"] = kv_rel_rows(sk, sr, cuts)
    row["min_plain_route_margin"] = min(float(m.min()) for _, _, m in rr)
    row["overflow_tokens"] = sum(int((~k).sum()) for _, k, _ in rr)
    return row


def moe_input(params, cfg, prompt):
    """The first layer's MoE parameters and its MoE input for
    ``prompt``."""
    import numpy as np
    import torch
    from repro_torch.models import attention
    from repro_torch.models.decoding import unit
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.transformer import embed_tokens
    dev = params["embed"].device
    tok = torch.from_numpy(prompt.astype(np.int64)).to(dev)[None]
    p0 = unit(params["pattern"][0], 0)
    x = embed_tokens(params, tok, cfg, torch.float32)
    x = x + attention.self_attention(p0["attn"], rms_norm(x, p0["ln1"]), cfg)
    return p0["ffn"], rms_norm(x, p0["ln2"])


def moe_dispatch_phase(ffn, h, cfg) -> dict:
    """The capacity dispatch (``moe.moe_apply``, the serving path) against
    its plain version (``moe.moe_dense_ref``, every expert on every token)
    on the card, at the first layer's MoE input ``h``: the output within
    ``MOE_TOL`` of the plain one's largest magnitude, the same tokens kept
    and the same ``overflow``."""
    import torch
    from repro_torch.models import moe
    cf = cfg.capacity_factor
    routes = []

    def dispatch():
        return moe.moe_apply(ffn, h, cfg, cf)

    def plain():
        return moe.moe_dense_ref(ffn, h, cfg, cf)
    y, aux = moe.moe_apply(ffn, h, cfg, cf,
                           on_route=lambda *r: routes.append(r))
    yr, auxr = moe.moe_dense_ref(ffn, h, cfg, cf,
                                 on_route=lambda *r: routes.append(r))
    err, ok = close_to_scale(y, yr, MOE_TOL)
    (idx, keep, _), (idx_r, keep_r, margin) = routes
    n = h.shape[0] * h.shape[1]
    row = {"arch": cfg.name, "tokens": n, "experts": cfg.num_experts,
           "capacity": moe.capacity(cf, n, cfg.num_experts),
           "max_abs_err": err, "rel_err": err / max(
               float(yr.abs().max()), 1e-30), "tol": MOE_TOL, "ok": ok,
           "kept_equal": bool(torch.equal(idx, idx_r)
                              and torch.equal(keep, keep_r)),
           "overflow": float(aux["overflow"]),
           "overflow_plain": float(auxr["overflow"]),
           "lb_loss": float(aux["lb_loss"]),
           "lb_loss_plain": float(auxr["lb_loss"]),
           "min_route_margin": float(margin.min()),
           "ms": cuda_ms(dispatch, 5), "plain_ms": cuda_ms(plain, 2)}
    emit("moe_dispatch", **row)
    check(ok, f"moe dispatch != moe_dense_ref: {row}")
    check(row["kept_equal"] and row["overflow"] == row["overflow_plain"],
          f"moe dispatch kept other tokens than moe_dense_ref: {row}")
    return row


_NCCL = {}


def nccl_mesh():
    """This process's one-rank NCCL mesh (data 1 x model 1), started once
    and shut down by :func:`close_nccl`: the card holds one rank, since NCCL
    refuses two ranks on one device ("Duplicate GPU detected")."""
    import os
    import torch
    from repro_torch.launch.mesh import init_group, make_mesh
    if "mesh" not in _NCCL:
        store = ROOT / "build" / f"nccl_store_{os.getpid()}"
        store.parent.mkdir(exist_ok=True)
        if store.exists():
            store.unlink()
        init_group("nccl", 0, 1, str(store), device=torch.device("cuda:0"))
        _NCCL["mesh"] = make_mesh((1, 1), ("data", "model"))
    return _NCCL["mesh"]


def close_nccl() -> None:
    """Shut down the mesh of :func:`nccl_mesh`, if one was started."""
    if _NCCL:
        import torch.distributed as dist
        dist.destroy_process_group()
        _NCCL.clear()


def nccl_records(fn) -> dict:
    """One call of ``fn`` under the profiler: NCCL's host records of the
    collectives it issued (``nccl:<op>``, one a collective) and the
    card's records named for NCCL, each counted by name.  On one rank
    NCCL moves data with copies, not kernels of its own."""
    import torch
    torch.cuda.synchronize()
    with profiled() as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    host, device = {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if "nccl" in name.lower():
                device[name] = device.get(name, 0) + 1
        elif name.startswith("nccl:"):
            host[name] = host.get(name, 0) + 1
    return {"host": host, "device": device}


def ep_moe_phase(ffn, h, cfg) -> dict:
    """``moe.moe_ep`` on the one-rank NCCL mesh against ``moe.moe_apply``
    at the same input, plain (no FSDP) and staged (FSDP experts on a
    ``data`` ring of 1, ``jet_collectives``): y bit-equal, ``lb_loss``,
    ``overflow`` and the kept set equal, NCCL's collectives of one call
    ``EP_COLLECTIVES``; ms of both in this call, not gated."""
    import torch
    from repro_torch.launch.mesh import ctx_for_mesh
    from repro_torch.models import moe
    mesh = nccl_mesh()
    cf = cfg.capacity_factor
    want_routes = []
    with torch.no_grad():
        y, aux = moe.moe_apply(ffn, h, cfg, cf,
                               on_route=lambda *r: want_routes.append(r))
        rows = {}
        for variant, kw in (("plain", {"fsdp": False}),
                            ("staged", {"fsdp": True,
                                        "jet_collectives": True})):
            ctx = ctx_for_mesh(mesh, moe_capacity_factor=cf, **kw)
            local, xl = moe.ep_local(ffn, h, ctx)
            routes = []
            ye, auxe = moe.moe_ep(local, xl, cfg, ctx,
                                  on_route=lambda *r: routes.append(r))
            (idx, keep, margin), = routes
            (idx_w, keep_w, margin_w), = want_routes
            nccl = nccl_records(lambda: moe.moe_ep(local, xl, cfg, ctx))
            rows[variant] = {
                "fsdp": ctx.fsdp, "jet_collectives": ctx.jet_collectives,
                "bitwise_equal": bool(torch.equal(ye, y)),
                "max_abs_err": float((ye - y).abs().max()),
                "lb_loss": float(auxe["lb_loss"]),
                "overflow": float(auxe["overflow"]),
                "kept_equal": bool(torch.equal(idx, idx_w)
                                   and torch.equal(keep, keep_w)
                                   and torch.equal(margin, margin_w)),
                "nccl_host": nccl["host"], "nccl_device": nccl["device"],
                "ms": cuda_ms(lambda: moe.moe_ep(local, xl, cfg, ctx), 5,
                              warmup=2)}
        apply_ms = cuda_ms(lambda: moe.moe_apply(ffn, h, cfg, cf), 5,
                           warmup=2)
    n = h.shape[0] * h.shape[1]
    row = {"arch": cfg.name, "mesh": dict(mesh.shape), "backend": "nccl",
           "tokens": n, "experts": cfg.num_experts,
           "capacity": moe.capacity(cf, n, cfg.num_experts),
           "lb_loss_apply": float(aux["lb_loss"]),
           "overflow_apply": float(aux["overflow"]),
           "want_nccl": EP_COLLECTIVES, "apply_ms": apply_ms, **rows}
    emit("ep_moe", **row)
    for variant in ("plain", "staged"):
        r = rows[variant]
        check(r["bitwise_equal"] and r["kept_equal"]
              and r["lb_loss"] == row["lb_loss_apply"]
              and r["overflow"] == row["overflow_apply"],
              f"moe_ep ({variant}) differs from moe_apply on one rank: {r}")
        check(r["nccl_host"] == EP_COLLECTIVES,
              f"moe_ep ({variant}) issued {r['nccl_host']} collectives, "
              f"want {EP_COLLECTIVES}")
    return row


def ep_moe_grad_phase(ffn, h, cfg) -> dict:
    """``moe.moe_ep``'s forward and backward on the one-rank NCCL mesh
    against autograd of ``moe.moe_apply`` at the same input, plain (no
    FSDP) and staged (FSDP experts on a ``data`` ring of 1,
    ``jet_collectives``), of the loss sum(y * w) + ``lb_loss`` (w drawn
    from seed 0): y, dx and the gradients of the router, ``e_gate``,
    ``e_in``, ``e_out`` and the shared expert within MOE_TOL of each
    one's largest magnitude, bit-equality recorded; NCCL's collectives of
    one forward and backward ``EP_GRAD_COLLECTIVES``; ms of each."""
    import torch
    from repro_torch import _tree
    from repro_torch.launch.mesh import ctx_for_mesh
    from repro_torch.models import moe
    mesh = nccl_mesh()
    cf = cfg.capacity_factor
    w = torch.randn(h.shape, generator=torch.Generator(device=h.device)
                    .manual_seed(0), device=h.device)

    def grads(fn, params):
        live = _tree.tree_map(lambda t: t.detach().requires_grad_(True),
                              params)
        x = h.detach().requires_grad_(True)
        y, aux = fn(live, x)
        out = torch.autograd.grad((y * w).sum() + aux["lb_loss"],
                                  [x] + _tree.leaves(live))
        names = ["dx"] + [_tree.key(p) for p, _ in _tree.flatten(live)]
        return y.detach(), dict(zip(names, out))

    def plain(p, x):
        return moe.moe_apply(p, x, cfg, cf)
    y0, g0 = grads(plain, ffn)
    rows = {}
    for variant, kw in (("plain", {"fsdp": False}),
                        ("staged", {"fsdp": True, "jet_collectives": True})):
        ctx = ctx_for_mesh(mesh, moe_capacity_factor=cf, **kw)
        local, _ = moe.ep_local(ffn, h, ctx)

        def ep(p, x):
            return moe.moe_ep(p, x, cfg, ctx)
        y, g = grads(ep, local)
        nccl = nccl_records(lambda: grads(ep, local))
        rel_of = {k: float((g[k] - g0[k]).abs().max()
                           / g0[k].abs().max().clamp(min=1e-30)) for k in g0}
        rows[variant] = {
            "fsdp": ctx.fsdp, "jet_collectives": ctx.jet_collectives,
            "y_rel": float((y - y0).abs().max() / y0.abs().max()),
            "y_bitwise_equal": bool(torch.equal(y, y0)),
            "grad_rel": rel_of, "grad_rel_max": max(rel_of.values()),
            "grads_bitwise_equal": all(torch.equal(g[k], g0[k])
                                       for k in g0),
            "nccl_host": nccl["host"], "nccl_device": nccl["device"],
            "ms": cuda_ms(lambda: grads(ep, local), 3, warmup=1)}
    plain_ms = cuda_ms(lambda: grads(plain, ffn), 3, warmup=1)
    n = h.shape[0] * h.shape[1]
    row = {"arch": cfg.name, "mesh": dict(mesh.shape), "backend": "nccl",
           "tokens": n, "experts": cfg.num_experts,
           "capacity": moe.capacity(cf, n, cfg.num_experts),
           "want_nccl": EP_GRAD_COLLECTIVES, "apply_grad_ms": plain_ms,
           **rows}
    emit("ep_moe_grad", **row)
    for variant in ("plain", "staged"):
        r = rows[variant]
        check(r["y_rel"] <= MOE_TOL and r["grad_rel_max"] <= MOE_TOL,
              f"moe_ep's backward ({variant}) deviates from moe_apply's: "
              f"{r}")
        check(r["nccl_host"] == EP_GRAD_COLLECTIVES,
              f"moe_ep's backward ({variant}) issued {r['nccl_host']} "
              f"collectives, want {EP_GRAD_COLLECTIVES}")
    return row


def collectives_phase(decoded) -> dict:
    """The staged collectives and ``compressed_psum`` on the one-rank NCCL
    mesh at scout widths, and ``srq_combine`` over the paged decode
    kernel's ``decoded`` = (o, lse) of the ``paged`` phase."""
    import torch
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.compression import (compressed_psum,
                                                  dequantize_int8_rowwise,
                                                  quantize_int8_rowwise)
    g = nccl_mesh().group("model")
    gen = torch.Generator(device="cuda").manual_seed(50)
    d, f = 5120, 8192                      # scout's d_model and d_ff
    x = torch.randn((1024, d), generator=gen, device="cuda")
    w = torch.randn((d, f), generator=gen, device="cuda") * d ** -0.5
    y = coll.ring_allgather_matmul(x, w, g, frags=2)
    ring_err, ring_ok = close_to_scale(y, x @ w, RING_TOL)
    gathered = coll.windowed_allgather(x, g, window=4)
    leaf = torch.randn((d, f), generator=gen, device="cuda")
    err = torch.randn((d, f), generator=gen, device="cuda") * 1e-2
    mean, new_err = compressed_psum(leaf, err, g)
    target = leaf + err
    q, scale = quantize_int8_rowwise(target)
    deq = dequantize_int8_rowwise(q, scale)
    o, lse = decoded
    merged = coll.srq_combine(o, lse, g)
    row = {"mesh": {"data": 1, "model": 1}, "backend": "nccl",
           "ring_allgather_matmul": {
               "x": list(x.shape), "w": list(w.shape), "frags": 2,
               "max_abs_err": ring_err, "tol": RING_TOL, "ok": ring_ok,
               "ms": cuda_ms(lambda: coll.ring_allgather_matmul(
                   x, w, g, frags=2), 10, warmup=2),
               "matmul_ms": cuda_ms(lambda: x @ w, 10, warmup=2)},
           "windowed_allgather": {
               "shape": list(x.shape), "window": 4,
               "equal": bool(torch.equal(gathered, x))},
           "compressed_psum": {
               "shape": [d, f], "mean_bitwise": bool(torch.equal(mean, deq)),
               "residual_bitwise": bool(torch.equal(new_err, target - deq)),
               "wire_bytes": q.numel() * q.element_size()
               + scale.numel() * scale.element_size(),
               "f32_bytes": leaf.numel() * leaf.element_size(),
               "ms": cuda_ms(lambda: compressed_psum(leaf, err, g), 5,
                             warmup=2)},
           "srq_combine": {
               "o": list(o.shape), "source": "ops.decode_attention on the "
               "paged zamba2 store (the paged phase's first decode)",
               "equal_o": bool(torch.equal(merged, o))}}
    emit("collectives", **row)
    check(ring_ok, f"ring_allgather_matmul != x @ W: {ring_err}")
    check(row["windowed_allgather"]["equal"],
          "windowed_allgather differs from its input on one rank")
    check(row["compressed_psum"]["mean_bitwise"]
          and row["compressed_psum"]["residual_bitwise"],
          f"compressed_psum differs from the int8 round trip: "
          f"{row['compressed_psum']}")
    check(row["srq_combine"]["equal_o"],
          "srq_combine over one rank's (o, lse) differs from o")
    return row


def serve_phase(cfg, dev, phase: str = "serve", prompt_lens=SERVE_PROMPTS,
                max_len: int = 1280, pool_bytes=None) -> dict:
    """``cfg`` at full width behind the Jet-admitted engine on ``dev``: 4
    lanes, ``prompt_lens`` prompts of ``SERVE_NEW`` new tokens each
    (every 4th HIGH QoS), ``max_len`` a lane, a Jet pool of
    ``pool_bytes`` (the default's 12 MiB if None)."""
    import numpy as np
    import torch
    from repro_torch.core.datapath import QoS
    from repro_torch.core.jet import JetConfig
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models.decoding import tree_map
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.serving.engine import (EngineConfig, Request,
                                            ServingEngine)
    kinds = layer_kinds(cfg)
    n_attn = sum(k in ATTN_KINDS for k in kinds)   # zamba2: 6 of 38
    n_ssd = sum(k in SSD_KINDS for k in kinds)
    t0 = time.perf_counter()
    params = api.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sizes = []
    tree_map(lambda t: sizes.append(t.numel()), params)
    ecfg = EngineConfig(max_lanes=4, max_len=max_len, eos_token=-1)
    jet_cfg = JetConfig(pool_bytes=pool_bytes) if pool_bytes else None
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
               for n in prompt_lens]

    # every prompt's prefill: kernels against the plain versions
    prefill_dev = [prefill_vs_plain(params, cfg, pr, ecfg.max_len)
                   for pr in prompts]
    torch.cuda.empty_cache()

    def requests():
        return [Request(i, pr, SERVE_NEW,
                        QoS.HIGH if i % 4 == 0 else QoS.NORMAL)
                for i, pr in enumerate(prompts)]

    # warm-up: one short request (CUDA context, cuBLAS handles)
    warm = ServingEngine(cfg, ecfg, params, jet_cfg, device=dev)
    warm.submit(Request(99, prompts[0][:64], 2))
    warm.run_until_done(max_ticks=10)
    del warm

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    eng = ServingEngine(cfg, ecfg, params, jet_cfg, device=dev)
    for r in requests():
        eng.submit(r)
    t0 = time.perf_counter()
    eng.run_until_done(max_ticks=200)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    margins = {}

    def record(req_ids, logits):
        top = torch.topk(logits.float(), 2, dim=-1).values
        for rid, m in zip(req_ids, (top[:, 0] - top[:, 1]).tolist()):
            margins.setdefault(rid, []).append(m)
    plain = ServingEngine(cfg, ecfg, params, jet_cfg, device=dev,
                          impl="ref", on_logits=record)
    for r in requests():
        plain.submit(r)
    plain.run_until_done(max_ticks=200)

    served = len(eng.done)
    n_tok = sum(len(r.generated) for r in eng.done.values())
    # a request whose prefill routed a token otherwise at a router
    # near-tie may rightly decode otherwise
    routed = {i for i, row in enumerate(prefill_dev) if row.get(
        "route_flips")}
    diverged, excused = [], True
    for rid, r in eng.done.items():
        want = plain.done[rid].generated
        k = next((i for i, (a, b) in enumerate(zip(r.generated, want))
                  if a != b), None)
        if k is not None:
            diverged.append(rid)
            excused &= rid in routed or min(margins[rid][:k + 1]) < MARGIN
    dec = eng.timings["decode_s"]
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": sum(sizes), "dtype": "float32", "init_s": init_s,
           "requests": len(prompts), "prompts": list(prompt_lens),
           "max_len": max_len, "served": served,
           "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
           "prefill_ms": [x * 1e3 for x in eng.timings["prefill_s"]],
           "decode_steps": len(dec),
           "decode_ms_mean": float(np.mean(dec)) * 1e3,
           "decode_ms_median": float(np.median(dec)) * 1e3,
           "launches": launches,
           "want_launches": {"flash_attention": n_attn * len(prompts),
                             "flash_attention_bwd": 0,
                             "ssd_scan": n_ssd * len(prompts),
                             "ssd_scan_bwd": 0,
                             "decode_attention_paged": 0,
                             "staged_matmul": 0},
           "prefill_vs_plain": prefill_dev,
           "tokens_equal_plain": not diverged, "diverged": diverged,
           "min_plain_margin": min(min(m) for m in margins.values()),
           "peak_mem_gb": peak_gb, "jet": eng.jet.stats()}
    emit(phase, **out)
    check(served == len(prompts), f"{phase}: served {served}/{len(prompts)}")
    check(all(len(r.generated) == SERVE_NEW for r in eng.done.values()),
          f"{phase}: a request did not get its {SERVE_NEW} tokens")
    check(launches == out["want_launches"],
          f"{phase}: launches {launches}, want {out['want_launches']}")
    for row in prefill_dev:
        check(row.get("routes_excused", True) and
              (row["logits"] is None or row["logits"] <= STATE_TOL)
              and row["state"] <= STATE_TOL,
              f"{phase}: prefill with kernels deviates from the plain one: "
              f"{row}")
    check(excused, f"{phase}: tokens of requests {diverged} differ from the "
                   f"plain run after a confident step")
    if cfg.num_experts:
        ffn, h = moe_input(params, cfg, prompts[-1])
        out["moe_dispatch"] = moe_dispatch_phase(ffn, h, cfg)
        out["ep_moe"] = ep_moe_phase(ffn, h, cfg)
        out["ep_moe_grad"] = ep_moe_grad_phase(ffn, h, cfg)
    return out


def family_phase(phase: str, dev) -> dict:
    """One of ``FAMILY_SERVES`` through :func:`serve_phase`, on a card
    whose earlier models are freed."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    arch, layers, prompt_lens, max_len, pool_bytes = FAMILY_SERVES[phase]
    cfg = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    torch.cuda.empty_cache()
    return serve_phase(cfg, dev, phase, prompt_lens, max_len, pool_bytes)


def batch_row(state, b: int):
    """Row ``b`` of a decode state (pattern leaves ``[n_units, B, ...]``,
    remainder leaves ``[B, ...]``), as a one-row state."""
    from repro_torch.models.decoding import tree_map
    return {"pattern": tree_map(lambda t: t[:, b:b + 1], state["pattern"]),
            "remainder": tree_map(lambda t: t[b:b + 1], state["remainder"])}


def api_phase(phase: str, dev) -> dict:
    """One of ``API_PHASES`` through the model API (``api.prefill`` with
    patches or codebook tokens, ``api.decode_step``, ``api.forward``,
    ``api.loss_fn``) at full width, on a card whose earlier models are
    freed.  Each prompt of ``API_PROMPTS`` (vision: with its own seeded
    image) is prefilled with the kernels and with their plain versions
    (logits and every state leaf, ``xkv`` included, within
    ``STATE_TOL``), then decoded ``SERVE_NEW`` greedy steps from each
    prefill (a codebook model feeds its argmax tiled over the codebooks,
    as the reference's smoke test does): tokens equal, except after a
    step whose plain top-2 margin is below ``MARGIN``.  Vision also
    prefills a batch of two rows, one token prompt with two images: each
    row within ``STATE_TOL`` of its one-row prefill.  ``forward`` of the
    ``API_FORWARD_T``-token prompt: its last logits against the prefill's
    and its logits against the plain forward, ``loss_fn`` on seeded
    targets against the plain loss, all within ``STATE_TOL``.  Flash
    attention launches once a self- and once a cross-attention layer a
    pass with the kernels, and nowhere else."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models.transformer import layer_kinds, tree_map
    arch, layers = API_PHASES[phase]
    cfg = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kinds = layer_kinds(cfg)
    per_pass = len(kinds) + kinds.count("attn_cross")
    t0 = time.perf_counter()
    params = api.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sizes = []
    tree_map(lambda t: sizes.append(t.numel()), params)
    rng = np.random.default_rng(11)

    def tokens(t: int):
        return torch.from_numpy(rng.integers(
            0, cfg.vocab_size, api.token_shape(cfg, 1, t))).to(dev)

    def image(seed: int):
        if not cfg.num_patches:
            return None
        return torch.randn((1, cfg.num_patches, cfg.d_model), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               seed))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def greedy(logits):
        tok = torch.argmax(logits, -1).to(torch.int32)
        if cfg.num_codebooks:
            tok = tok[:, None].repeat(1, cfg.num_codebooks)
        return tok

    requests = [(tokens(t), image(100 + i))
                for i, t in enumerate(API_PROMPTS)]
    ops.reset_launches()
    passes = 0
    rows, prefill_ms, decode_ms, diverged, excused = [], [], [], [], True
    last_logits = {}
    for (tok, img), t in zip(requests, API_PROMPTS):
        (lk, sk, lens), ms = timed(lambda: api.prefill(
            params, cfg, tok, img, max_len=t + SERVE_NEW))
        lr, sr, _ = api.prefill(params, cfg, tok, img, max_len=t + SERVE_NEW,
                                impl="ref")
        passes += 1
        prefill_ms.append(ms)
        last_logits[t] = lk
        row = {"prompt": t, "logits": tree_rel(lk, lr),
               "state": tree_rel(sk, sr)}
        seq_k, seq_r, margins = [], [], []
        for step in range(SERVE_NEW + 1):
            if step:
                (lk, sk), ms = timed(lambda: api.decode_step(
                    params, cfg, sk, greedy(lk), lens))
                decode_ms.append(ms)
                lr, sr = api.decode_step(params, cfg, sr, greedy(lr), lens)
                lens = lens + 1
            seq_k.append(int(torch.argmax(lk)))
            seq_r.append(int(torch.argmax(lr)))
            top = torch.topk(lr.float(), 2, dim=-1).values[0]
            margins.append(float(top[0] - top[1]))
        k = next((i for i, (a, b) in enumerate(zip(seq_k, seq_r)) if a != b),
                 None)
        row.update(tokens_equal_plain=k is None, first_diff=k,
                   min_plain_margin=min(margins))
        if k is not None:
            diverged.append(t)
            excused &= min(margins[:k + 1]) < MARGIN
        rows.append(row)
        del sk, sr
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "patches": cfg.num_patches, "codebooks": cfg.num_codebooks,
           "params": sum(sizes), "dtype": "float32", "init_s": init_s,
           "prompts": API_PROMPTS, "prefill_ms": prefill_ms,
           "prefill_vs_plain": rows, "decode_steps": len(decode_ms),
           "decode_ms_mean": float(np.mean(decode_ms)),
           "decode_ms_median": float(np.median(decode_ms)),
           "tokens_equal_plain": not diverged, "diverged": diverged}
    tok, img = requests[API_PROMPTS.index(API_FORWARD_T)]
    max_len = API_FORWARD_T + SERVE_NEW
    if cfg.num_patches:
        # one prompt, two images: a batch mix-up of the patch state shows
        imgs = [img, image(200)]
        one = [api.prefill(params, cfg, tok, im, max_len=max_len)[:2]
               for im in imgs]
        lb, sb, _ = api.prefill(params, cfg, tok.repeat(2, 1),
                                torch.cat(imgs), max_len=max_len)
        passes += 3
        out["batched"] = [{"row": b, "logits": tree_rel(lb[b:b + 1], l1),
                           "state": tree_rel(batch_row(sb, b), s1)}
                          for b, (l1, s1) in enumerate(one)]
        del one, sb
    (fk, aux), fwd_ms = timed(lambda: api.forward(params, cfg, tok, img))
    fr, _ = api.forward(params, cfg, tok, img, impl="ref")
    targets = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, API_FORWARD_T))).to(dev)
    batch = {"tokens": tok, "targets": targets}
    if img is not None:
        batch["patches"] = img
    loss, metrics = api.loss_fn(params, cfg, batch)
    loss_r, _ = api.loss_fn(params, cfg, batch, impl="ref")
    passes += 2
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    want = {"flash_attention": per_pass * passes, "flash_attention_bwd": 0,
            "ssd_scan": 0, "ssd_scan_bwd": 0, "decode_attention_paged": 0,
            "staged_matmul": 0}
    out["forward"] = {
        "tokens": API_FORWARD_T, "ms": fwd_ms,
        "last_vs_prefill": tree_rel(fk[:, -1], last_logits[API_FORWARD_T]),
        "vs_plain": tree_rel(fk, fr), "loss": float(loss),
        "loss_plain": float(loss_r),
        "loss_rel": abs(float(loss) - float(loss_r)) / abs(float(loss_r)),
        "lb_loss": float(metrics["lb_loss"]),
        "overflow": float(metrics["overflow"])}
    out.update(launches=launches, want_launches=want, passes=passes,
               flash_per_pass=per_pass,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit(phase, **out)
    for row in rows:
        check(row["logits"] <= STATE_TOL and row["state"] <= STATE_TOL,
              f"{phase}: prefill with kernels deviates from the plain one: "
              f"{row}")
    check(excused, f"{phase}: tokens of prompts {diverged} differ from the "
                   f"plain run after a confident step")
    for row in out.get("batched", []):
        check(row["logits"] <= STATE_TOL and row["state"] <= STATE_TOL,
              f"{phase}: a row of the batched prefill deviates from its "
              f"one-row prefill: {row}")
    f = out["forward"]
    check(f["last_vs_prefill"] <= STATE_TOL and f["vs_plain"] <= STATE_TOL
          and math.isfinite(f["loss"]) and f["loss_rel"] <= STATE_TOL,
          f"{phase}: forward / loss_fn deviate: {f}")
    check(launches == want, f"{phase}: launches {launches}, want {want}")
    return out


def profile_serve(cfg, dev) -> None:
    """One 1024-token prefill and 8 four-lane decode steps under the
    profiler."""
    import numpy as np
    import torch
    from repro_torch.models import api
    params = api.init_params(
        cfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    tok = torch.from_numpy(np.random.default_rng(8).integers(
        2, cfg.vocab_size, size=(1, 1024))).to(dev)
    state = api.init_decode_state(cfg, 4, 1280, device=dev)
    lanes_tok = torch.full((4,), 5, dtype=torch.int32, device=dev)
    lengths = torch.full((4,), 1024, dtype=torch.int32, device=dev)
    api.prefill(params, cfg, tok, max_len=1280)      # warm
    api.decode_step(params, cfg, state, lanes_tok, lengths)
    torch.cuda.synchronize()
    out = {}
    for name, steps in (("prefill", 1), ("decode", 8)):
        with profiled() as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                if name == "prefill":
                    api.prefill(params, cfg, tok, max_len=1280)
                else:
                    api.decode_step(params, cfg, state, lanes_tok, lengths)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [e for e in prof.key_averages()
                if getattr(e, "device_time_total", 0) > 0
                and e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.device_time_total for e in rows)
        own = {k: [e for e in rows if any(n in e.key for n in names)]
               for k, names in (("flash", ("flash_mma_kernel",
                                           "flash_simt_kernel")),
                                ("ssd_state", ("ssd_state_kernel",)),
                                ("ssd_carry", ("ssd_carry_kernel",)),
                                ("ssd_output", ("ssd_output_kernel",)),
                                ("ssd_simt", ("ssd_simt_kernel",)))}
        top = sorted(rows, key=lambda e: -e.device_time_total)[:6]
        out[name] = {
            "steps": steps, "wall_ms": wall * 1e3,
            "kernels_per_step": sum(e.count for e in rows) / steps,
            "device_busy_us_per_step": busy / steps,
            "device_busy_share": busy * 1e-6 / wall if wall else None,
            "own_kernels": {k: {
                "count": sum(e.count for e in es),
                "device_us_per_launch": sum(e.device_time_total for e in es)
                / max(1, sum(e.count for e in es))}
                for k, es in own.items()},
            "top": [{"kernel": e.key[:80], "count": e.count,
                     "device_us": e.device_time_total} for e in top]}
    emit("profile_serve", **out)
    got = {k: r["count"] for k, r in out["prefill"]["own_kernels"].items()}
    want = {"flash": 6, "ssd_state": 38, "ssd_carry": 38, "ssd_output": 38,
            "ssd_simt": 0}
    check(got == want, f"profile_serve: the prefill's own kernels by name "
                       f"{got}, want {want}")



# --------------------------------------------------------------------------- #
# training: the flash attention backward and the train step
# --------------------------------------------------------------------------- #
def lse_plain(q, k, causal: bool, window, heads: int = 8):
    """Each row's log-sum-exp of the masked, scaled scores, float32
    [B, Hq, T], a few heads at a time (the plain statistic the forward
    kernel writes for the backward)."""
    import torch
    b, hq, t, d = q.shape
    s = k.shape[2]
    kr = k.float().repeat_interleave(hq // k.shape[1], dim=1)
    tq = torch.arange(t, device=q.device)[:, None] + (s - t)
    sk = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= tq >= sk
    if window:
        mask &= tq - sk < window
    out = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    for h0 in range(0, hq, heads):
        sc = torch.einsum("bhtd,bhsd->bhts",
                          q[:, h0:h0 + heads].float() * d ** -0.5,
                          kr[:, h0:h0 + heads])
        out[:, h0:h0 + heads] = torch.logsumexp(
            sc.masked_fill(~mask, -1e30), dim=-1)
    return out


def flash_bwd_phase(label: str, b: int, hq: int, hkv: int, t: int, s: int,
                    d: int, causal: bool, window, dtype: str, seed: int,
                    iters: int, plain_iters: int, prev_iters: int,
                    dev=None) -> dict:
    """Hold the flash attention backward kernel, on the variant its type
    picks (``bwd_mma_3xtf32`` / ``bwd_mma_bf16``), against its plain
    version (autograd's gradient of the plain forward), each of dq, dk,
    dv within FLASH_BWD_TOL of its largest magnitude; the forward's lse
    against the plain log-sum-exp; two launches bit-equal (no atomics);
    the C launcher's tile plan against ``jet_flash_attention``'s; and
    time it beside the plain backward, the first design (``bwd_simt``)
    forced in the same call (``prev_ms``; its gradients held to the same
    tolerance) and one backward of ``F.scaled_dot_product_attention`` on
    the same case (timed, unused by the port)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import jet_flash_attention as jfa
    from repro_torch.kernels import ref
    rng = np.random.default_rng(seed)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    dev = dev or torch.device("cuda")

    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev).to(tdt)
    q, k, v = draw((b, hq, t, d)), draw((b, hkv, s, d)), draw((b, hkv, s, d))
    do = draw((b, hq, t, d))
    o, lse = jfa.flash_attention(q, k, v, causal, window, with_lse=True)
    lse_err = float((lse - lse_plain(q, k, causal, window)).abs().max())

    def kernel():
        return jfa.flash_attention_bwd(q, k, v, o, do, lse, causal, window)

    def prev():
        return jfa.flash_attention_bwd(q, k, v, o, do, lse, causal, window,
                                       variant="bwd_simt")

    def plain():
        return ref.flash_attention_bwd_ref(q, k, v, do, causal, window)
    name = jfa.bwd_variant(tdt, d)
    plan = list(jfa.bwd_plan(name, d))
    plan_c = list(jfa.bwd_plan_c(name, d))
    jfa.VARIANT_LAUNCHES.reset()
    got = kernel()
    torch.cuda.synchronize()
    ran = [n for n, c in jfa.VARIANT_LAUNCHES.items() if c]
    again = kernel()
    deterministic = all(torch.equal(x, y) for x, y in zip(got, again))
    del again
    want = plain()
    tol = FLASH_BWD_TOL[dtype]

    def held(grads):
        errs, ok = {}, True
        for n, g, w in zip(("dq", "dk", "dv"), grads, want):
            err = float((g.float() - w.float()).abs().max())
            top = float(w.float().abs().max())
            errs[n] = {"max_abs_err": err, "max_abs": top,
                       "rel_to_max": err / max(top, 1e-30)}
            ok = ok and bool(torch.isfinite(g).all()) and g.dtype == tdt \
                and err <= tol * top
        return errs, ok
    errs, ok = held(got)
    del got
    prev_errs, prev_ok = held(prev())
    del want
    # the yardstick: SDPA's backward alone, on its own forward's graph; a
    # window no shorter than S masks nothing
    win = window if window and window < s else None
    lib_kw = {"enable_gqa": True} if hkv != hq else {}
    if causal and t == s and not win:
        lib_kw["is_causal"] = True
    elif causal or win:
        tq = torch.arange(t, device=q.device)[:, None] + (s - t)
        sk = torch.arange(s, device=q.device)[None, :]
        mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
        if causal:
            mask &= tq >= sk
        if win:
            mask &= tq - sk < win
        lib_kw["attn_mask"] = mask
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, **lib_kw)

    def library():
        return torch.autograd.grad(lib_out, leaves, do, retain_graph=True)
    lib_ms = cuda_ms(library, iters, warmup=1)
    del lib_out, leaves
    # the new kernel and the first design in turns: prev, new, new, prev
    prev_ms = [cuda_ms(prev, prev_iters, warmup=1)]
    ms = [cuda_ms(kernel, iters, warmup=2) for _ in range(2)]
    prev_ms.append(cuda_ms(prev, prev_iters, warmup=0))
    plain_ms = cuda_ms(plain, plain_iters, warmup=1)
    esize = q.element_size()
    nbytes = (q.numel() * 4 + k.numel() * 2 + v.numel() * 2) * esize \
        + lse.numel() * 4
    nops = jfa.bwd_flops(b, hq, t, s, d, causal, window)
    # the card's peak for the route the type takes: bfloat16 on the tensor
    # cores, float32 through 3xTF32 (the TF32 rate over 3); the CUDA
    # cores' float32 peak, the first design's ceiling, beside it
    bms, by = bound(nbytes, nops, BF16_OPS_PER_S if dtype == "bfloat16"
                    else TF32_OPS_PER_S / 3)
    b_simt, _ = bound(nbytes, nops, FP32_OPS_PER_S)
    row = {"name": "flash_attention_bwd", "case": label,
           "q": [b, hq, t, d], "kv": [b, hkv, s, d], "causal": causal,
           "window": window, "dtype": dtype, "variant": ran,
           "plan": plan, "plan_c": plan_c, "tol": tol, "ok": ok,
           "errors": errs,
           "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
           "lse_max_abs_err": lse_err, "deterministic": deterministic,
           "ms": min(ms), "ms_runs": ms, "plain_ms": plain_ms,
           "prev_ms": min(prev_ms), "prev_ms_runs": prev_ms,
           "prev_ok": prev_ok,
           "prev_max_abs_err": max(e["max_abs_err"]
                                   for e in prev_errs.values()),
           "bound_ms": bms, "bound_by": by, "bound_simt_ms": b_simt,
           "library_ms": lib_ms, "tflops": nops / min(ms) * 1e-9,
           "gflop": nops / 1e9, "bytes": nbytes}
    emit("kernel", **row)
    check(ran == [name], f"flash_attention_bwd ({label}) ran {ran}, "
                         f"want {name}")
    check(plan == plan_c, f"flash_attention_bwd ({label}): the C plan "
                          f"{plan_c} != jet_flash_attention's {plan}")
    check(ok, f"flash_attention_bwd kernel != plain version ({label}): "
              f"{errs}, tol {tol} of each gradient's largest magnitude")
    check(prev_ok, f"flash_attention_bwd bwd_simt forced != plain version "
                   f"({label}): {prev_errs}")
    check(min(ms) < min(prev_ms), f"flash_attention_bwd ({label}): {name} "
                                  f"{ms} ms is not faster than bwd_simt "
                                  f"forced, {prev_ms} ms")
    check(lse_err <= LSE_TOL, f"flash_attention lse ({label}) deviates "
                              f"{lse_err} from the plain log-sum-exp")
    check(deterministic, f"flash_attention_bwd ({label}): two launches "
                         f"differ")
    return row


def flash_bwd_rows() -> dict:
    """The backward kernel at the train path's shape (danube: 32 heads
    of 80 over 8 KV heads, 4,096 tokens, window 4,096, batch 2), with a
    window that binds, at vision's cross-attention (non-causal T < S),
    MHA at D = 64, and gemma-7b's D = 256 in bfloat16 (the 32-row
    tiles)."""
    rows = {"path": flash_bwd_phase(
        "danube-1.8b train", 2, 32, 8, 4096, 4096, 80, True, 4096,
        "float32", 50, iters=5, plain_iters=1, prev_iters=2)}
    flash_bwd_phase("window binds", 1, 32, 8, 1024, 1024, 80, True, 256,
                    "float32", 51, iters=10, plain_iters=2, prev_iters=5)
    flash_bwd_phase("llama-3.2-vision cross-attention", 1, 32, 8, 1024,
                    1600, 128, False, None, "float32", 52, iters=10,
                    plain_iters=2, prev_iters=3)
    flash_bwd_phase("mha D=64", 1, 32, 32, 1024, 1024, 64, True, None,
                    "float32", 53, iters=10, plain_iters=2, prev_iters=5)
    flash_bwd_phase("gemma-7b bf16", 1, 16, 16, 1024, 1024, 256, True, None,
                    "bfloat16", 54, iters=10, plain_iters=2, prev_iters=3)
    return rows


def ssd_bwd_phase(label: str, B: int, T: int, H: int, P: int, G: int,
                  N: int, chunk: int, seed: int, iters: int,
                  plain_iters: int, dtype: str = "float32") -> dict:
    """Hold the SSD scan's backward kernel (``csrc/ssd_scan_bwd.cu``)
    against autograd's gradient of the plain forward and against its
    plain version (``ssd_chunked_bwd_ref``), dx, ddt, da, db, dc each
    within SSD_BWD_TOL of its largest magnitude, with dh zero and
    non-zero, on inputs made as the Mamba2 block makes them; two launches
    bit-equal (no atomics); the C launch plan against
    ``mamba2_ssd.bwd_smem_bytes``; and time it (the path's call: the
    forward's states, dh None) beside the plain backward, each pass's
    device time from the profiler.  On the design ``bwd_variant`` picks:
    ``bwd_mma_3xtf32`` where the forward runs ``mma_3xtf32``, timed in
    turns with the first design (``bwd_simt``) forced in the same call
    (``prev_ms``, ``prev_device_ms``; its gradients held to the same
    tolerance), which it must beat.  Where the widths run the forward's
    ``simt`` (no states kept) the backward recomputes the states
    (``bwd_simt_recompute``), and the row times that."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import mamba2_ssd as mssd
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(seed)
    ty = getattr(torch, dtype)

    def draw(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).cuda()
    x, b, c = draw((B, T, H, P)), draw((B, T, G, N)), draw((B, T, G, N))
    dt = F.softplus(draw((B, T, H), 0.5) + math.log(math.expm1(0.05)))
    dy = draw((B, T, H, P))
    x, dt, b, c, dy = (v.to(ty) for v in (x, dt, b, c, dy))
    a = -torch.linspace(1.0, 8.0, H, device="cuda")
    L = min(chunk, T)
    tol = SSD_BWD_TOL[dtype]
    names = ("dx", "ddt", "da", "db", "dc")

    def held(got, want):
        errs, ok = {}, True
        for n, g, w in zip(names, got, want):
            err = float((g.float() - w.float()).abs().max())
            top = float(w.float().abs().max())
            errs[n] = err / max(top, 1e-30)
            ok = ok and bool(torch.isfinite(g).all()) and \
                g.dtype == w.dtype and err <= tol * top
        return errs, ok
    errs, ok, worst = {}, True, 0.0
    mssd.VARIANT_LAUNCHES.reset()
    ops.reset_launches()
    for which, dh in (("dh0", torch.zeros((B, H, N, P), device="cuda")),
                      ("dh", draw((B, H, N, P)))):
        leaves = [v.clone().requires_grad_(True) for v in (x, dt, a, b, c)]
        y, h = ops.ssd(*leaves, chunk=chunk)
        got = torch.autograd.grad([y, h], leaves, [dy, dh])
        del y, h, leaves
        plain = [v.clone().requires_grad_(True) for v in (x, dt, a, b, c)]
        y0, h0 = ops.ssd(*plain, chunk=chunk, impl="ref")
        want = torch.autograd.grad([y0, h0], plain, [dy, dh])
        del y0, h0, plain
        e1, o1 = held(got, want)
        del want
        e2, o2 = held(got, ref.ssd_chunked_bwd_ref(x, dt, a, b, c, dy, dh,
                                                   chunk=L))
        errs[which] = {"vs_autograd": e1, "vs_plain_bwd": e2}
        ok = ok and o1 and o2
        worst = max(worst, *e1.values(), *e2.values())
        del got
    torch.cuda.synchronize()
    counts = ops.LAUNCHES.read()
    fwd = mssd.variant(ty, N, P)
    want_bwd = mssd.bwd_variant(ty, N, P)
    mma = want_bwd == "bwd_mma_3xtf32"
    ran = {n: k for n, k in mssd.VARIANT_LAUNCHES.items() if k}
    _, _, states = mssd.ssd_scan_states(x, dt, a, b, c, L)

    def kernel():
        return mssd.ssd_scan_bwd(x, dt, a, b, c, dy, None, L, states)

    def prev():
        return mssd.ssd_scan_bwd(x, dt, a, b, c, dy, None, L, states,
                                 _variant="bwd_simt")

    def plain():
        return ref.ssd_chunked_bwd_ref(x, dt, a, b, c, dy, None, chunk=L)
    one, two = kernel(), kernel()
    deterministic = all(torch.equal(p_, q_) for p_, q_ in zip(one, two))
    want = plain()
    max_abs = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(one, want))
    prev_errs, prev_ok = held(prev(), want) if mma else (None, True)
    del one, two, want
    recompute = states is None
    if mma:
        # the new design and the first in turns: prev, new, new, prev
        prev_runs = [cuda_ms(prev, iters, warmup=1)]
        ms_runs = [cuda_ms(kernel, iters, warmup=2) for _ in range(2)]
        prev_runs.append(cuda_ms(prev, iters, warmup=0))
        prev_plan = mssd.bwd_plan("bwd_simt", B, T, H, G, N, P, L,
                                  recompute)
        prev_dev = device_us(prev, list(prev_plan))
    else:
        ms_runs, prev_runs, prev_dev = [cuda_ms(kernel, iters, warmup=2)], \
            None, None
    ms = min(ms_runs)
    plain_ms = cuda_ms(plain, plain_iters, warmup=1)
    kplan = mssd.bwd_plan(want_bwd, B, T, H, G, N, P, L, recompute)
    scratch = (mssd._bwd_lib().ssd_scan_bwd_scratch(B, T, H, P, G, N, L),
               mssd.bwd_scratch_floats(B, T, H, P, G, N, L))
    check(scratch[0] == scratch[1], f"ssd_scan_bwd ({label}): the C "
          f"scratch {scratch[0]} floats, the meta path's {scratch[1]}")
    dev = device_us(kernel, list(kplan))
    nops, nbytes = mssd.bwd_work(B, T, H, G, N, P, L, x.element_size(),
                                 recompute)
    # the card's peak for the type: bfloat16 on the tensor cores, float32
    # through 3xTF32 (the TF32 rate over 3); the CUDA cores' float32 peak,
    # the first design's route, beside it
    bms, by = bound(nbytes, nops, BF16_OPS_PER_S if dtype == "bfloat16"
                    else TF32_OPS_PER_S / 3)
    b_simt, _ = bound(nbytes, nops, FP32_OPS_PER_S)
    row = {"name": "ssd_scan_bwd", "case": label, "dtype": dtype,
           "x": [B, T, H, P], "bc": [B, T, G, N], "chunk": L,
           "variant": ran, "launches": counts, "states": "recomputed"
           if recompute else "the forward's", "tol": tol, "ok": ok,
           "errors": errs, "max_rel_err": worst, "max_abs_err": max_abs,
           "deterministic": deterministic,
           "blocks": {k: v[1] for k, v in kplan.items()},
           "smem_bytes": max(v[0] for v in kplan.values()),
           "device_us": dev, "device_ms": sum(dev.values()) / 1e3,
           "ms": ms, "ms_runs": ms_runs, "plain_ms": plain_ms,
           "prev_ms": min(prev_runs) if prev_runs else None,
           "prev_ms_runs": prev_runs, "prev_device_us": prev_dev,
           "prev_device_ms": sum(prev_dev.values()) / 1e3 if prev_dev
           else None, "prev_ok": prev_ok, "prev_errors": prev_errs,
           "bound_ms": bms, "bound_by": by,
           "bound_simt_ms": b_simt, "library_ms": None,
           "tflops": nops / ms * 1e-9, "gflop": nops / 1e9, "bytes": nbytes}
    emit("kernel", **row)
    check(ran == {fwd: 2, want_bwd: 2}
          and counts["ssd_scan"] == 2 and counts["ssd_scan_bwd"] == 2,
          f"ssd_scan_bwd ({label}) ran {ran}, launches {counts}")
    check(ok, f"ssd_scan_bwd kernel != plain ({label}): {errs}, tol {tol} "
              f"of each gradient's largest magnitude")
    check(deterministic, f"ssd_scan_bwd ({label}): two launches differ")
    check(row["smem_bytes"] == mssd.bwd_smem_bytes(want_bwd, N, P),
          f"ssd_scan_bwd ({label}): the kernel asks for {row['smem_bytes']}"
          f" bytes of shared memory, bwd_smem_bytes says "
          f"{mssd.bwd_smem_bytes(want_bwd, N, P)}")
    check(prev_ok, f"ssd_scan_bwd bwd_simt forced != plain ({label}): "
                   f"{prev_errs}")
    check(not mma or ms < row["prev_ms"],
          f"ssd_scan_bwd ({label}): {want_bwd} {ms_runs} ms is not faster "
          f"than bwd_simt forced, {prev_runs} ms")
    del states
    torch.cuda.empty_cache()
    return row


def ssd_bwd_rows() -> dict:
    """The SSD backward at the train path's shape (zamba2: x [2, 4096, 64,
    64], N 64, one group, chunk 256), the serve widths at 1,024 tokens,
    one chunk (256 tokens), two groups of 32 heads, bfloat16, and the
    simt widths (P = 20: the states recomputed)."""
    rows = {"path": ssd_bwd_phase("zamba2 train", 2, 4096, 64, 64, 1, 64,
                                  256, 60, iters=5, plain_iters=1)}
    ssd_bwd_phase("serve widths", 1, 1024, 64, 64, 1, 64, 256, 61,
                  iters=10, plain_iters=2)
    ssd_bwd_phase("T=256, one chunk", 1, 256, 64, 64, 1, 64, 256, 62,
                  iters=20, plain_iters=3)
    ssd_bwd_phase("G=2", 1, 1024, 64, 64, 2, 64, 256, 63, iters=10,
                  plain_iters=2)
    ssd_bwd_phase("serve widths bf16", 1, 1024, 64, 64, 1, 64, 256, 64,
                  iters=10, plain_iters=2, dtype="bfloat16")
    ssd_bwd_phase("simt P=20", 1, 1024, 64, 20, 1, 64, 256, 65, iters=10,
                  plain_iters=2)
    return rows


def profile_grads_and_update(cfg, state, batch, opt_cfg) -> dict:
    """One train step, its two halves traced apart (the loss and
    gradient, then AdamW): device ms by kernel name (GEMMs, flash
    forward and backward, the rest), the optimizer's device ms, and the
    device-busy share of each half's wall."""
    import torch
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for half in ("grads", "adamw"):
        torch.cuda.synchronize()
        with profiled() as prof:
            t0 = time.perf_counter()
            if half == "grads":
                grads, _, _ = steps.loss_and_grads(
                    cfg, state["params"], batch, remat="full")
            else:
                new = adamw.update(grads, state["opt"], state["params"],
                                   opt_cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by = dict.fromkeys((*TRAIN_KERNELS, "other"), 0.0)
        counts = dict.fromkeys((*TRAIN_KERNELS, "other"), 0)
        busy = 0.0
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            name, ns = e.name(), e.duration_ns()
            busy += ns
            cat = next((c for c, tags in TRAIN_KERNELS.items()
                        if any(tag in name for tag in tags)), "other")
            by[cat] += ns * 1e-6
            counts[cat] += 1
        out[half] = {"wall_ms": wall * 1e3, "device_busy_ms": busy * 1e-6,
                     "busy_share": busy * 1e-9 / wall,
                     "device_ms_by_kind": by, "kernels_by_kind": counts}
    del grads, new
    return out


def train_launches(cfg, n_steps: int) -> dict:
    """Each kernel's launches in ``n_steps`` train steps under
    ``remat="full"``: flash attention and the SSD scan once a layer that
    runs them and once more on each checkpointed unit's replay, their
    backwards once a layer; the remainder layers after the last whole
    pattern unit are not checkpointed (as in the reference), so they run
    once."""
    from repro_torch.models import transformer
    pattern, n_units, rem = transformer.segments(cfg)

    def count(kinds):
        in_units = n_units * sum(k in kinds for k in pattern)
        in_rem = sum(k in kinds for k in rem)
        return (2 * in_units + in_rem) * n_steps, (in_units + in_rem) * n_steps
    fa, fa_bwd = count(ATTN_KINDS)
    ssd, ssd_bwd = count(SSD_KINDS)
    return {"flash_attention": fa, "flash_attention_bwd": fa_bwd,
            "ssd_scan": ssd, "ssd_scan_bwd": ssd_bwd,
            "decode_attention_paged": 0, "staged_matmul": 0}


def dryrun_cell(phase: str, cfg, seq: int) -> dict:
    """The dry-run of the step ``train_model_phase`` runs
    (``launch.dryrun.build_cell(..., mesh=None)``: batch 2 x ``seq``,
    ``remat="full"``, float32, AdamW with float32 moments), traced in this
    process on the meta device with no process group: its record, and
    ``dryrun_s``, the seconds to build and trace it."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    fn, args = dryrun.build_cell(
        cfg, ShapeConfig(phase, "train", seq, TRAIN_BATCH), None,
        {"remat": "full"}, torch.float32)
    rec = dryrun.trace_step(fn, args)
    rec["dryrun_s"] = time.perf_counter() - t0
    return rec


def train_model_phase(phase: str, cfg, dev, seq: int, n_steps: int) -> dict:
    """``cfg`` trained on the card through ``train.steps.make_train_step``:
    batch 2 x ``seq`` tokens of the ``for_arch`` pipeline (seed 0),
    ``remat="full"``, AdamW with float32 moments; ``n_steps`` steps, the
    first a warm-up.  The first step's loss within TRAIN_TOL of the plain
    versions' loss on the same state, every loss and gradient norm
    finite, each kernel launched as :func:`train_launches` says, on the
    variants the float32 path selects; then one more step traced in two
    halves.  Before the card runs, the dry-run of the same step
    (:func:`dryrun_cell`): its kernel launches a step equal to
    :func:`train_launches` of one step, and its predicted peak (the
    arguments and the traced peak of live storages beyond them) within
    DRYRUN_MEM_TOL of the steps' ``max_memory_allocated``."""
    import numpy as np
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import pipeline
    from repro_torch.kernels import jet_flash_attention as jfa
    from repro_torch.kernels import mamba2_ssd as mssd
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    dry = dryrun_cell(phase, cfg, seq)
    b, t = TRAIN_BATCH, seq
    data = pipeline.for_arch(cfg, ShapeConfig(phase, "train", t, b), seed=0)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.next_batch().items()}
               for _ in range(n_steps + 1)]
    opt_cfg = adamw.OptConfig()
    state = steps.init_state(cfg, opt_cfg,
                             torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(p.numel() for p in _leaves(state["params"]))
    with torch.no_grad():
        plain, _ = transformer.loss_fn(state["params"], cfg, batches[0],
                                       impl="ref")
        plain = float(plain)
    step = steps.make_train_step(cfg, opt_cfg, remat="full")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    jfa.VARIANT_LAUNCHES.reset()
    mssd.VARIANT_LAUNCHES.reset()
    rows = []
    for i in range(n_steps):
        t0 = time.perf_counter()
        state, m = step(state, batches[i])
        loss = float(m["loss"])           # waits for the card
        wall = time.perf_counter() - t0
        rows.append({"step": i + 1, "loss": loss,
                     "grad_norm": float(m["grad_norm"]),
                     "lr": float(m["lr"]), "ms": wall * 1e3})
    launches = ops.LAUNCHES.read()
    variants = {"flash": dict(jfa.VARIANT_LAUNCHES),
                "ssd": dict(mssd.VARIANT_LAUNCHES)}
    peak = torch.cuda.max_memory_allocated() / 1e9
    timed = [r["ms"] for r in rows[1:]]
    ms = float(np.mean(timed))
    prof = profile_grads_and_update(cfg, state, batches[n_steps], opt_cfg)
    per_step = {k: v / len(rows) for k, v in launches.items()}
    out = {"arch": cfg.name, "layers": cfg.num_layers, "params": n_params,
           "batch": b, "seq": t, "remat": "full", "dtype": "float32",
           "steps": rows, "ms_per_step": ms, "ms_per_step_timed": timed,
           "tokens_per_s": b * t / (ms * 1e-3),
           "first_loss_plain": plain,
           "first_loss_rel": abs(rows[0]["loss"] - plain) / abs(plain),
           "launches": launches, "launches_per_step": per_step,
           "variants": variants, "peak_mem_gb": peak,
           "dryrun_peak_gb": (dry["argument_size_in_bytes"]
                              + dry["temp_size_in_bytes"]) / 1e9,
           "dryrun_launches": dry["kernel_launches"],
           "dryrun_s": dry["dryrun_s"], "dryrun": dry, "profile": prof}
    out["dryrun_peak_rel"] = abs(out["dryrun_peak_gb"] - peak) / peak
    emit(phase, **out)
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
              for r in rows), f"{phase}: a step is not finite: {rows}")
    check(out["first_loss_rel"] <= TRAIN_TOL,
          f"{phase}: first loss {rows[0]['loss']} vs plain {plain}")
    want = train_launches(cfg, len(rows))
    check(launches == want, f"{phase}: launches {launches}, want {want}")
    check(dry["kernel_launches"] == train_launches(cfg, 1),
          f"{phase}: the dry-run launches {dry['kernel_launches']}, want "
          f"{train_launches(cfg, 1)}")
    check(out["dryrun_peak_rel"] <= DRYRUN_MEM_TOL,
          f"{phase}: the dry-run's peak {out['dryrun_peak_gb']} GB vs the "
          f"card's {peak} GB")
    fv, sv = variants["flash"], variants["ssd"]
    check(fv["mma_3xtf32"] == want["flash_attention"]
          and fv["bwd_mma_3xtf32"] == want["flash_attention_bwd"]
          and fv["bwd_simt"] == 0,
          f"{phase}: flash variants {fv}")
    check(sv["mma_3xtf32"] == want["ssd_scan"]
          and sv["bwd_mma_3xtf32"] == want["ssd_scan_bwd"]
          and sv["simt"] == 0 and sv["bwd_simt"] == 0
          and sv["bwd_simt_recompute"] == 0,
          f"{phase}: SSD variants {sv}")
    del state
    torch.cuda.empty_cache()
    return out


def train_danube_phase(dev=None) -> dict:
    """h2o-danube-1.8b at full depth and width (24 layers, d_model 2560,
    32 / 8 heads of 80, window 4,096, d_ff 6,912, vocab 32,000; 1.83 B
    parameters, float32), batch 2 x 4,096 tokens (``train_4k``, batch cut
    256 -> 2): one warm-up step and three timed ones; flash attention
    launched 48 times a step (24 layers and 24 replays) and its backward
    24, the SSD scan never."""
    import torch
    from repro_torch.configs import get_arch
    return train_model_phase("train_danube", get_arch("h2o-danube-1.8b"),
                             dev or torch.device("cuda"), TRAIN_SEQ, 4)


def train_zamba2_phase(dev=None) -> dict:
    """zamba2-1.2b at full depth and width (38 layers: 32 Mamba2 and 6
    with the shared attention block, d_model 2,048, 64 SSD heads of 64,
    N 64, one group, chunk 256, 32 heads of 64 in the shared block,
    vocab 32,000; 1.17 B parameters, float32), batch 2 x 4,096 tokens
    (``train_4k``, batch cut 256 -> 2): one warm-up step and two timed
    ones; a step launches the SSD scan 74 times (36 layers in the six
    checkpointed units twice, the 2 remainder layers once), its backward
    38, flash attention 12 and its backward 6."""
    import torch
    from repro_torch.configs import get_arch
    return train_model_phase("train_zamba2", get_arch("zamba2-1.2b"),
                             dev or torch.device("cuda"), TRAIN_SEQ, 3)


def _leaves(tree) -> list:
    from repro_torch import _tree
    return _tree.leaves(tree)


def train_vs_plain_phase(cfg=None, dev=None, seq: int = 1024) -> dict:
    """``cfg`` (default: danube at full width, depth cut to 2 layers),
    batch 2 x 1,024 tokens: one train step's loss and gradient with the
    kernels and with
    the plain versions from the same state (loss and gradient norm
    within TRAIN_TOL, every gradient leaf within GRAD_TOL of its largest
    magnitude: gradients, not updated parameters, since AdamW's first
    step is about lr times the gradient's sign), then the full step with
    each (losses and gradient norms within TRAIN_TOL)."""
    import torch
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.data import pipeline
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    dev = dev or torch.device("cuda")
    cfg = cfg or dataclasses.replace(get_arch("h2o-danube-1.8b"),
                                     num_layers=2)
    data = pipeline.for_arch(cfg, ShapeConfig("v", "train", seq, 2), seed=1)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data.next_batch().items()}
    opt_cfg = adamw.OptConfig()
    state = steps.init_state(cfg, opt_cfg,
                             torch.Generator(device=dev).manual_seed(1), dev)
    from repro_torch.kernels import ops
    ops.reset_launches()
    g_k, l_k, _ = steps.loss_and_grads(cfg, state["params"], batch)
    launches = ops.LAUNCHES.read()
    g_p, l_p, _ = steps.loss_and_grads(cfg, state["params"], batch,
                                       impl="ref")
    n_k, n_p = float(adamw.global_norm(g_k)), float(adamw.global_norm(g_p))
    leaf_rel = {}
    from repro_torch import _tree
    for (path, gk), gp in zip(_tree.flatten(g_k), _tree.leaves(g_p)):
        leaf_rel[_tree.key(path)] = float(
            (gk - gp).abs().max() / gp.abs().max().clamp(min=1e-30))
    del g_k, g_p
    _, m_k = steps.make_train_step(cfg, opt_cfg)(state, batch)
    _, m_p = steps.make_train_step(cfg, opt_cfg, impl="ref")(state, batch)
    out = {"arch": cfg.name, "layers": cfg.num_layers, "batch": 2,
           "seq": seq, "loss": float(l_k), "loss_plain": float(l_p),
           "loss_rel": abs(float(l_k) - float(l_p)) / abs(float(l_p)),
           "grad_norm": n_k, "grad_norm_plain": n_p,
           "grad_norm_rel": abs(n_k - n_p) / n_p,
           "grad_leaf_rel_max": max(leaf_rel.values()),
           "grad_leaf_rel": leaf_rel,
           "step_loss_rel": abs(float(m_k["loss"]) - float(m_p["loss"]))
           / abs(float(m_p["loss"])),
           "step_grad_norm_rel": abs(float(m_k["grad_norm"])
                                     - float(m_p["grad_norm"]))
           / float(m_p["grad_norm"]), "launches": launches}
    emit("train_vs_plain", **out)
    check(launches == train_launches(cfg, 1),
          f"train_vs_plain: launches {launches}, want "
          f"{train_launches(cfg, 1)}")
    check(out["loss_rel"] <= TRAIN_TOL and out["grad_norm_rel"] <= TRAIN_TOL
          and out["step_loss_rel"] <= TRAIN_TOL
          and out["step_grad_norm_rel"] <= TRAIN_TOL,
          f"train_vs_plain: loss / grad_norm deviate: {out}")
    check(out["grad_leaf_rel_max"] <= GRAD_TOL,
          f"train_vs_plain: a gradient leaf deviates: {leaf_rel}")
    return out


def mesh_step_collectives(cfg) -> dict:
    """The collectives one sharded train step issues on a one-rank (data
    1 x model 1) mesh under ``remat="full"``, by NCCL's host record
    names, for a model of attention and MLP layers only, each layer its
    own checkpointed unit (danube).  A layer gathers its 4 attention and
    2 or 3 MLP weights over ``data`` in the forward and again in the
    replay, and reduce-scatters their gradients back once; its two
    tensor-parallel sublayers all-reduce their outputs in the forward and
    their inputs' gradients in the backward, and the attention's output
    again in the replay (which stops after the last tensor the backward
    saves, before the MLP's all-reduce).  The embedding and unembedding
    are gathered over both axes and reduce-scattered over ``data``; then
    one all-reduce sums the replicated leaves' gradients over ``data``,
    one averages the figures and two sum the gradient norm's squares
    over ``data`` and ``model``."""
    layers = cfg.num_layers
    weights = 4 + (3 if cfg.mlp in ("swiglu", "geglu") else 2)
    return {"nccl:all_gather": 2 * weights * layers + 4,
            "nccl:_reduce_scatter_base": weights * layers + 2,
            "nccl:all_reduce": 5 * layers + 4}


def train_mesh_phase(dev=None) -> dict:
    """``train.steps.make_train_step(..., ctx=)`` on the one-rank NCCL
    mesh against the unsharded step from the same state: h2o-danube-1.8b
    at full width, depth cut to MESH_LAYERS, batch 2 x 4,096 of the
    ``for_arch`` pipeline, float32, ``remat="full"``.  Gates: the loss and
    gradient norm within TRAIN_TOL, every new parameter and moment leaf
    within GRAD_TOL of its largest magnitude, flash attention and its
    backward launched as ``train_launches(cfg, 1)`` says, NCCL's host
    records of a step :func:`mesh_step_collectives`.  Recorded: whether
    every leaf is bit-equal, ms a step of each in turns (unsharded,
    sharded, sharded, unsharded) and the sharded step's peak memory."""
    import torch
    from repro_torch import _tree
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import ctx_for_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    dev = dev or torch.device("cuda")
    cfg = dataclasses.replace(get_arch("h2o-danube-1.8b"),
                              num_layers=MESH_LAYERS)
    b, t = TRAIN_BATCH, TRAIN_SEQ
    data = pipeline.for_arch(cfg, ShapeConfig("train_mesh", "train", t, b),
                             seed=0)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data.next_batch().items()}
    opt_cfg = adamw.OptConfig()
    state = steps.init_state(cfg, opt_cfg,
                             torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(p.numel() for p in _leaves(state["params"]))
    ctx = ctx_for_mesh(nccl_mesh())
    local = steps.shard_state(state, ctx)
    local_batch = steps.shard_batch(batch, ctx)
    plain_step = steps.make_train_step(cfg, opt_cfg, remat="full")
    mesh_step = steps.make_train_step(cfg, opt_cfg, remat="full", ctx=ctx)
    new_u, m_u = plain_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    new_s, m_s = mesh_step(local, local_batch)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES.read()
    peak = torch.cuda.max_memory_allocated() / 1e9
    leaf_rel, equal = {}, True
    for part in ("params", "opt"):
        for (path, a), w in zip(_tree.flatten(new_s[part]),
                                _tree.leaves(new_u[part])):
            if not a.is_floating_point():
                equal = equal and bool(torch.equal(a, w))
                continue
            leaf_rel[f"{part}/{_tree.key(path)}"] = float(
                (a - w).abs().max() / w.abs().max().clamp(min=1e-30))
            equal = equal and bool(torch.equal(a, w))
    del new_u, new_s
    nccl = nccl_records(lambda: mesh_step(local, local_batch))
    times = {"unsharded": [], "sharded": []}
    for which in ("unsharded", "sharded", "sharded", "unsharded"):
        fn = (lambda: plain_step(state, batch)) if which == "unsharded"             else (lambda: mesh_step(local, local_batch))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        float(out[1]["loss"])
        torch.cuda.synchronize()
        times[which].append((time.perf_counter() - t0) * 1e3)
        del out
    want_nccl = mesh_step_collectives(cfg)
    rel = lambda a, b: abs(float(a) - float(b)) / abs(float(b))  # noqa
    row = {"arch": cfg.name, "layers": cfg.num_layers, "params": n_params,
           "batch": b, "seq": t, "remat": "full", "dtype": "float32",
           "mesh": dict(ctx.mesh.shape), "backend": "nccl",
           "loss": float(m_s["loss"]), "loss_unsharded": float(m_u["loss"]),
           "loss_rel": rel(m_s["loss"], m_u["loss"]),
           "grad_norm": float(m_s["grad_norm"]),
           "grad_norm_unsharded": float(m_u["grad_norm"]),
           "grad_norm_rel": rel(m_s["grad_norm"], m_u["grad_norm"]),
           "leaf_rel_max": max(leaf_rel.values()), "bitwise_equal": equal,
           "launches": launches, "want_launches": train_launches(cfg, 1),
           "nccl_host": nccl["host"], "nccl_device": nccl["device"],
           "want_nccl": want_nccl, "ms": times,
           "ms_sharded": sum(times["sharded"]) / 2,
           "ms_unsharded": sum(times["unsharded"]) / 2,
           "peak_mem_gb": peak}
    emit("train_mesh", **row)
    check(row["loss_rel"] <= TRAIN_TOL and row["grad_norm_rel"] <= TRAIN_TOL,
          f"train_mesh: loss / grad_norm deviate: {row}")
    check(row["leaf_rel_max"] <= GRAD_TOL,
          f"train_mesh: a leaf deviates: "
          f"{sorted(leaf_rel.items(), key=lambda kv: -kv[1])[:5]}")
    check(launches == row["want_launches"],
          f"train_mesh: launches {launches}, want {row['want_launches']}")
    check(nccl["host"] == want_nccl,
          f"train_mesh: NCCL issued {nccl['host']}, want {want_nccl}")
    del state, local
    torch.cuda.empty_cache()
    return row


def mesh_serve_collectives(cfg) -> dict:
    """The collectives one prefill and one decode step issue on a
    one-rank (data 1 x model 1) mesh, by NCCL's host record names, for a
    model of attention, MLP and Mamba2 layers (danube, zamba2).  Both
    gather the vocabulary tables over both axes (4).  A dense attention
    layer gathers its 4 attention and 2 or 3 MLP weights over ``data``
    (the model axis keeps its blocks), zamba2's shared block the same 7
    once a call, and a Mamba2 mixer its 4 sharded weights (``w_xbc``,
    ``w_z``, ``w_dt``, ``w_out``) over both axes (8).  Each attention
    sublayer all-reduces its output and its MLP's; in the prefill its K/V
    go to their slot blocks in one all-to-all, in decode q and the new
    k / v are gathered in one all-gather and the partial (o, lse) in two
    (``srq_combine``)."""
    from repro_torch.models import transformer
    kinds = transformer.layer_kinds(cfg)
    attn = sum(k in ("attn_dense", "mamba_attn") for k in kinds)
    block = 4 + (3 if cfg.mlp in ("swiglu", "geglu") else 2)
    gathers = 4 + block * (kinds.count("attn_dense")
                           + ("mamba_attn" in kinds)) \
        + 8 * sum(k in ("mamba", "mamba_attn") for k in kinds)
    return {"prefill": {"nccl:all_gather": gathers,
                        "nccl:all_reduce": 2 * attn,
                        "nccl:all_to_all": attn},
            "decode": {"nccl:all_gather": gathers + 3 * attn,
                       "nccl:all_reduce": 2 * attn}}


def serve_greedy(params, cfg, tokens, max_len: int, steps: int, ctx=None,
                 specs=None):
    """``models.decoding.prefill`` of ``tokens`` and ``steps`` greedy
    decode steps, with ``ctx`` / ``specs`` on a mesh: (the logits of
    each, the tokens fed, the state, the lengths, the state's specs)."""
    import torch
    from repro_torch.models import decoding
    s_specs = None if ctx is None else decoding.decode_state_specs(
        decoding.init_decode_state(cfg, tokens.shape[0], max_len,
                                   torch.float32, "meta"), ctx)
    with torch.no_grad():
        logits, state, lengths = decoding.prefill(
            params, cfg, tokens, max_len=max_len, ctx=ctx, specs=specs)
        seen, fed = [logits], []
        for _ in range(steps):
            fed.append(logits.argmax(-1).to(torch.int32))
            logits, state = decoding.decode_step(
                params, cfg, state, fed[-1], lengths, ctx=ctx, specs=specs,
                state_specs=s_specs)
            lengths = lengths + 1
            seen.append(logits)
    return seen, fed, state, lengths, s_specs


def serve_dryrun_gate(cfg, params, dev) -> dict:
    """The dry-run's unsharded prefill and decode cells
    (``launch.dryrun.build_cell(..., mesh=None)``, batch and prompt
    SERVE_MESH_DRYRUN, float32) against the same calls on the card: their
    kernel launches equal, their predicted peaks (the arguments and the
    traced peak of live storages beyond them) within DRYRUN_MEM_TOL of
    ``max_memory_allocated`` less what was live before and is not an
    argument."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.models import decoding
    b, t = SERVE_MESH_DRYRUN
    t0 = time.perf_counter()
    dry = {}
    for kind in ("prefill", "decode"):
        fn, args = dryrun.build_cell(cfg, ShapeConfig("serve_mesh", kind, t,
                                                      b),
                                     None, {}, torch.float32)
        dry[kind] = dryrun.trace_step(fn, args)
        del fn, args
    dry_s = time.perf_counter() - t0
    tokens = torch.randint(0, cfg.vocab_size, (b, t), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(3), dtype=torch.int32)
    p_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    out = {}

    def measure(kind, fn, arg_bytes):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        other = torch.cuda.memory_allocated() - arg_bytes
        ops.reset_launches()
        res = fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - other) / 1e9
        rec = dry[kind]
        want = (rec["argument_size_in_bytes"]
                + rec["temp_size_in_bytes"]) / 1e9
        out[kind] = {"peak_gb": peak, "dryrun_peak_gb": want,
                     "other_gb": other / 1e9,
                     "peak_rel": abs(want - peak) / peak,
                     "launches": ops.LAUNCHES.read(),
                     "dryrun_launches": rec["kernel_launches"]}
        return res
    with torch.no_grad():
        _, state, lengths = measure("prefill", lambda: decoding.prefill(
            params, cfg, tokens, max_len=t),
            p_bytes + tokens.numel() * 4)
        tok = torch.zeros(b, dtype=torch.int32, device=dev)
        lengths = torch.full_like(lengths, t - 1)
        s_bytes = sum(x.numel() * x.element_size() for x in _leaves(state))
        measure("decode", lambda: decoding.decode_step(
            params, cfg, state, tok, lengths),
            p_bytes + s_bytes + 2 * b * 4)
    out["dryrun_s"] = dry_s
    del state
    return out


def serve_mesh_model(cfg, prompts, max_len: int, ctx, dev) -> dict:
    """One model of :func:`serve_mesh_phase`: its figures (its tensors die
    with this call, so the next model's peak holds none of them)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import api, decoding, transformer
    from repro_torch.train import steps
    kinds = transformer.layer_kinds(cfg)
    gen = torch.Generator(device=dev)
    params = api.init_params(cfg, gen.manual_seed(0), device=dev)
    specs = steps.param_specs(params, ctx)
    local = ctx.shard_tree(params, specs)
    toks = [torch.randint(0, cfg.vocab_size, shp, device=dev,
                          generator=gen.manual_seed(10 + i),
                          dtype=torch.int32)
            for i, shp in enumerate(prompts)]
    plain = [serve_greedy(params, cfg, tk, max_len, SERVE_MESH_NEW)
             for tk in toks]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    mesh = [serve_greedy(local, cfg, tk, max_len, SERVE_MESH_NEW, ctx, specs)
            for tk in toks]
    torch.cuda.synchronize()
    launches = ops.LAUNCHES.read()
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {k: 0 for k in launches}
    want["flash_attention"] = len(prompts) * sum(k in ATTN_KINDS
                                                 for k in kinds)
    want["ssd_scan"] = len(prompts) * sum(k in SSD_KINDS for k in kinds)
    cases = []
    for shp, (lu, tu, su, _, _), (lm, tm, sm, _, s_specs) in zip(
            prompts, plain, mesh):
        whole = ctx.gather_tree(sm, s_specs)
        cases.append({
            "prompt": list(shp),
            "logit_rel": [tree_rel(a, b) for a, b in zip(lm, lu)],
            "tokens_equal": all(bool(torch.equal(a, b))
                                for a, b in zip(tm, tu)),
            "state_rel": tree_rel(whole, su),
            "bitwise_equal": all(bool(torch.equal(a, b))
                                 for a, b in zip(lm, lu))
            and all(bool(torch.equal(a, b)) for a, b in zip(
                _leaves(whole), _leaves(su)))})
    del plain, mesh, whole, lu, su, lm, sm
    # a prefill and a decode step each way, in turns, and NCCL's records
    # of one of each on the mesh
    tk = toks[0]
    s_specs = decoding.decode_state_specs(decoding.init_decode_state(
        cfg, tk.shape[0], max_len, torch.float32, "meta"), ctx)
    ms = {"prefill": {"unsharded": [], "sharded": []},
          "decode": {"unsharded": [], "sharded": []}}
    with torch.no_grad():
        for which in ("unsharded", "sharded", "sharded", "unsharded"):
            kw = {} if which == "unsharded" else {"ctx": ctx, "specs": specs}
            p = params if which == "unsharded" else local
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, state, lengths = decoding.prefill(p, cfg, tk,
                                                      max_len=max_len, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            decoding.decode_step(p, cfg, state,
                                 logits.argmax(-1).to(torch.int32), lengths,
                                 **kw, **({} if which == "unsharded" else
                                          {"state_specs": s_specs}))
            torch.cuda.synchronize()
            ms["prefill"][which].append((t1 - t0) * 1e3)
            ms["decode"][which].append((time.perf_counter() - t1) * 1e3)
            del logits, state
        holder = {}

        def prefill_once():
            holder["out"] = decoding.prefill(local, cfg, tk, max_len=max_len,
                                             ctx=ctx, specs=specs)
        nccl_p = nccl_records(prefill_once)
        logits, state, lengths = holder.pop("out")
        nccl_d = nccl_records(lambda: decoding.decode_step(
            local, cfg, state, logits.argmax(-1).to(torch.int32), lengths,
            ctx=ctx, specs=specs, state_specs=s_specs))
        del logits, state
    row = {"arch": cfg.name, "layers": cfg.num_layers,
           "mesh": dict(ctx.mesh.shape), "backend": "nccl",
           "dtype": "float32", "max_len": max_len,
           "new_tokens": SERVE_MESH_NEW, "cases": cases,
           "launches": launches, "want_launches": want,
           "nccl_host": {"prefill": nccl_p["host"], "decode": nccl_d["host"]},
           "want_nccl": mesh_serve_collectives(cfg), "ms": ms,
           "ms_prefill_sharded": sum(ms["prefill"]["sharded"]) / 2,
           "ms_prefill_unsharded": sum(ms["prefill"]["unsharded"]) / 2,
           "ms_decode_sharded": sum(ms["decode"]["sharded"]) / 2,
           "ms_decode_unsharded": sum(ms["decode"]["unsharded"]) / 2,
           "peak_mem_gb": peak}
    if cfg.name == "h2o-danube-1.8b":
        row["dryrun"] = serve_dryrun_gate(cfg, params, dev)
    return row


def serve_mesh_phase(dev=None) -> dict:
    """``models.decoding.prefill`` / ``decode_step`` over the one-rank
    NCCL mesh against the unsharded path from the same weights
    (:func:`serve_mesh_model`): SERVE_MESH_MODELS at full width, float32
    (h2o-danube-1.8b whole, prompts 2 x 1,024 and 1 x 4,224, whose 4,224
    tokens roll its 4,096-slot ring; zamba2-1.2b cut to 6 layers, 5
    Mamba2 and one with the shared attention block), SERVE_MESH_NEW
    greedy steps each.  Gates: every step's logits within SERVE_MESH_TOL
    of the unsharded ones' largest magnitude, the greedy tokens equal,
    flash attention and the SSD scan launched once a layer that runs them
    a prefill (decode runs the plain ring decode), NCCL's host records of
    a prefill and a decode step :func:`mesh_serve_collectives`, and
    :func:`serve_dryrun_gate` on danube.  Recorded: whether each run is
    bit-equal to the unsharded one, ms a prefill and a decode step each
    way in turns (unsharded, sharded, sharded, unsharded), the sharded
    runs' peak memory."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import ctx_for_mesh
    dev = dev or torch.device("cuda")
    ctx = ctx_for_mesh(nccl_mesh())
    rows = {}
    for arch, (layers, prompts, max_len) in SERVE_MESH_MODELS.items():
        cfg = get_arch(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        rows[arch] = serve_mesh_model(cfg, prompts, max_len, ctx, dev)
        torch.cuda.empty_cache()
    total = {k: sum(r["launches"][k] for r in rows.values())
             for k in ("flash_attention", "ssd_scan")}
    out = {"models": rows, "launches": total}
    emit("serve_mesh", **out)
    for arch, row in rows.items():
        for c in row["cases"]:
            check(max(c["logit_rel"]) <= SERVE_MESH_TOL and c["tokens_equal"],
                  f"serve_mesh: {arch} {c['prompt']} deviates: {c}")
        check(row["launches"] == row["want_launches"],
              f"serve_mesh: {arch} launches {row['launches']}, want "
              f"{row['want_launches']}")
        check(row["nccl_host"] == row["want_nccl"],
              f"serve_mesh: {arch} NCCL issued {row['nccl_host']}, want "
              f"{row['want_nccl']}")
        for kind, g in row.get("dryrun", {}).items():
            if kind == "dryrun_s":
                continue
            check(g["launches"] == g["dryrun_launches"]
                  and g["peak_rel"] <= DRYRUN_MEM_TOL,
                  f"serve_mesh: {arch} dry-run {kind}: {g}")
    return out


def train_loop_phase(dev=None) -> dict:
    """``train.loop.run`` on the card: tiny danube (2 layers) for 6 steps
    with a checkpoint every 2, once straight through and once with a
    fault injected at step 4 and a resume from the latest checkpoint;
    the final losses must agree within 1e-5
    (``tests/test_fault_tolerance.py``), and whether they are equal bit
    for bit is recorded.  Then one step with int8 moments.  Checkpoints
    go under ``build/`` in the checkout and are removed."""
    import dataclasses
    import shutil
    import torch
    from repro_torch.configs import get_arch, tiny_config
    from repro_torch.data import pipeline
    from repro_torch.optim import adamw
    from repro_torch.train import loop, steps
    dev = dev or torch.device("cuda")
    cfg = dataclasses.replace(tiny_config(get_arch("h2o-danube-1.8b")),
                              num_layers=2)
    root = ROOT / "build" / "train_loop_ckpt"
    shutil.rmtree(root, ignore_errors=True)

    def data():
        return pipeline.SyntheticPipeline(pipeline.PipelineConfig(
            vocab_size=cfg.vocab_size, global_batch=2, seq_len=64))
    opt_cfg = adamw.OptConfig(lr=1e-3, total_steps=6)

    def lcfg(name):
        return loop.LoopConfig(total_steps=6, ckpt_every=2, log_every=1,
                               ckpt_dir=str(root / name))
    gen = torch.Generator(device=dev)
    ref = loop.run(cfg, opt_cfg, lcfg("ref"), data(), gen.manual_seed(0),
                   device=dev)
    crashed = []

    class Fault(RuntimeError):
        pass

    def injector(step):
        if step == 4 and not crashed:
            crashed.append(step)
            raise Fault("simulated node failure")
    try:
        loop.run(cfg, opt_cfg, lcfg("crash"), data(), gen.manual_seed(0),
                 fault_injector=injector, device=dev)
    except Fault:
        pass
    out2 = loop.run(cfg, opt_cfg, lcfg("crash"), data(), None,
                    fault_injector=injector, device=dev)
    want, got = ref["history"][-1]["loss"], out2["history"][-1]["loss"]
    o8 = adamw.OptConfig(lr=1e-3, int8_moments=True)
    st8 = steps.init_state(cfg, o8, gen.manual_seed(0), dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data().next_batch().items()}
    st8, m8 = steps.make_train_step(cfg, o8)(st8, batch)
    q = st8["opt"]["m"]["pattern"][0]["attn"]["wq"]
    out = {"arch": cfg.name, "layers": 2, "steps": 6, "ckpt_every": 2,
           "crash_at": crashed, "resumed_from": out2["history"][0]["step"]
           - 1, "final_loss": want, "final_loss_resumed": got,
           "abs_diff": abs(got - want), "bitwise_equal": got == want,
           "int8_loss": float(m8["loss"]),
           "int8_grad_norm": float(m8["grad_norm"]),
           "int8_moment_dtype": str(q["q"].dtype)}
    emit("train_loop", **out)
    shutil.rmtree(root, ignore_errors=True)
    check(crashed == [4] and out2["final_step"] == 6,
          f"train_loop: the fault or the resume did not happen: {out}")
    check(abs(got - want) < 1e-5,
          f"train_loop: resumed final loss {got} vs {want}")
    check(math.isfinite(out["int8_loss"]) and q["q"].dtype == torch.int8,
          f"train_loop: the int8-moment step failed: {out}")
    return out


PHASE_S: dict = {}           # seconds of each phase of run(), in order
_LAP = [0.0]


def lap(name: str) -> None:
    """Charge the seconds since the previous lap to phase ``name``."""
    now = time.perf_counter()
    PHASE_S[name] = PHASE_S.get(name, 0.0) + now - _LAP[0]
    _LAP[0] = now


def run() -> int:
    import torch
    start = time.perf_counter()
    _LAP[0] = start
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch import _build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing beside this "
              f"script ({e})", file=sys.stderr)
        return 3
    try:
        card = card_line()
        t0 = time.perf_counter()
        builds = _build.build_all()
        log = _build.BUILD_LOG.get("staged_matmul")
        spills = None if not log else [
            r["spill_bytes"] for name, r in ptxas_report(log).items()
            if "wgmma_gemm_kernel" in name]
        flash = flash_build(_build.BUILD_LOG.get("flash_attention"))
        ssd = ssd_build(_build.BUILD_LOG.get("ssd_scan"))
        decode = decode_build(_build.BUILD_LOG.get("decode_attention"))
        flash_bwd = flash_bwd_build(_build.BUILD_LOG.get(
            "flash_attention_bwd"))
        ssd_bwd = ssd_bwd_build(_build.BUILD_LOG.get("ssd_scan_bwd"))
        emit("card", nvidia_smi=card, torch=torch.__version__,
             cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
             build_s=time.perf_counter() - t0, builds=builds,
             ptxas=[ln.strip() for log in _build.BUILD_LOG.values()
                    for ln in log.splitlines() if "registers" in ln],
             wgmma_spill_bytes=spills, flash_build=flash, ssd_build=ssd,
             decode_build=decode, flash_bwd_build=flash_bwd,
             ssd_bwd_build=ssd_bwd)
        lap("build")
        check(spills is None or (len(spills) == 4 and not any(spills)),
              f"the wgmma kernel spills registers: {spills}")
        # 5 head-dim tiles x 2 types on the tensor cores, 2 x 2 on the CUDA
        # cores; none of head dim <= 128 may spill
        check(flash is None or (len(flash) == 14 and not any(
            r["spill_bytes"] for key, r in flash.items()
            if int(key.split("/")[1]) <= 128)),
            f"a flash attention kernel of head dim <= 128 spills: {flash}")
        # 2 passes x 4 width tiles x 2 types, the carry, simt in 2 types;
        # the serve path's float32 64 x 64 passes may not spill
        check(ssd is None or (len(ssd) == 19 and not any(
            ssd[f"{k}/f32/64x64"]["spill_bytes"]
            for k in ("state", "output"))),
            f"an SSD pass of the serve path spills: {ssd}")
        # the split kernel: 3 head-dim tiles x 2 q types on the tensor
        # cores, 4 head tiles x 2 column chunks x 2 q types on the CUDA
        # cores; the merge in 2 q types; none may spill
        check(decode is None or (len(decode) == 24 and not any(
            r["spill_bytes"] for r in decode.values())),
            f"a paged decode kernel spills: {decode}")
        # the backward: 2 types x (delta + 5 head-dim tiles x (dk/dv, dq)
        # on the tensor cores + 4 widths x (dk/dv, dq) of bwd_simt); none
        # of head dim <= 128 may spill
        check(flash_bwd is None or (len(flash_bwd) == 38 and not any(
            r["spill_bytes"] for key, r in flash_bwd.items()
            if key.count("/") == 2 and int(key.split("/")[2]) <= 128)),
            f"a flash backward kernel of head dim <= 128 spills: "
            f"{flash_bwd}")
        # the SSD backward: bwd_simt's 4 tiled passes x 4 width tiles x 2
        # types, bwd_mma_3xtf32's x 2 square tiles x 2 types, the dt pass
        # and the group sums in 2 types, 2 carries and da; none may spill
        check(ssd_bwd is None or (len(ssd_bwd) == 55 and not any(
            r["spill_bytes"] for r in ssd_bwd.values())),
            f"an SSD backward kernel spills: {ssd_bwd}")
        rows = {}
        for name, main_shape, seed in (
                ("priority_grants", (48, 3, 14), 1),
                ("priority_admit", (48, 3, 2), 2)):
            rows[name] = kernel_phase(name, main_shape, seed, iters=2000)
            kernel_phase(name, LARGE, seed + 10, iters=20)
        lap("kernel_waterfill")
        # before any CUDA graph of the script: after one, the profiler kept
        # no record of a kernel launched through ctypes (graph replays'
        # yes), so the rows' device µs would be lost
        rows["seg_sum"] = seg_sum_rows()
        lap("kernel_seg_sum")
        # serve path's shapes first: those rows go into the kernels line
        rows["flash_attention"] = flash_phase(
            "serve path", 1, 32, 32, 1024, 1024, 64, True, None, "float32",
            3, iters=50, plain_iters=5, expect="mma_3xtf32")
        flash_phase("large", 4, 32, 32, 4096, 4096, 64, True, None,
                    "float32", 4, iters=5, plain_iters=2, expect="mma_3xtf32")
        flash_phase("gqa window bf16", 1, 32, 8, 1024, 1024, 80, True, 256,
                    "bfloat16", 5, iters=20, plain_iters=3, expect="mma_bf16")
        flash_phase("non-causal T<S", 2, 8, 8, 200, 1000, 64, False, None,
                    "float32", 6, iters=20, plain_iters=3,
                    expect="mma_3xtf32")
        # the prefill shapes of the dense and MoE serve phases at 1,024
        # tokens: danube's GQA window, scout's 40 heads of 128
        flash_phase("danube-1.8b prefill", 1, 32, 8, 1024, 1024, 80, True,
                    4096, "float32", 39, iters=20, plain_iters=3,
                    expect="mma_3xtf32")
        flash_phase("llama4-scout prefill", 1, 40, 8, 1024, 1024, 128, True,
                    None, "float32", 40, iters=20, plain_iters=3,
                    expect="mma_3xtf32")
        # llama-3.2-vision's cross-attention: 1,024 tokens over 1,600
        # patches, no mask
        flash_phase("llama-3.2-vision cross-attention", 1, 32, 8, 1024, 1600,
                    128, False, None, "float32", 41, iters=20, plain_iters=3,
                    expect="mma_3xtf32")
        flash_phase("gemma-7b bf16", 1, 16, 16, 1024, 1024, 256, True, None,
                    "bfloat16", 33, iters=20, plain_iters=3,
                    expect="mma_bf16")
        flash_phase("gemma-7b f32", 1, 16, 16, 1024, 1024, 256, True, None,
                    "float32", 34, iters=20, plain_iters=3,
                    expect="mma_3xtf32")
        # head dims that are not a multiple of 8 run the CUDA-core kernel:
        # both types at both of its widths (D <= 64, D <= 128)
        for d, dtype, seed in ((20, "float32", 35), (100, "float32", 36),
                               (20, "bfloat16", 37), (100, "bfloat16", 38)):
            flash_phase(f"simt D={d} {dtype}", 1, 16, 4, 1024, 1024, d,
                        True, None, dtype, seed, iters=10, plain_iters=3,
                        expect="simt")
        lap("kernel_flash")
        rows["flash_attention_bwd"] = flash_bwd_rows()["path"]
        torch.cuda.empty_cache()
        lap("kernel_flash_bwd")
        rows["ssd_scan"] = ssd_phase(
            "serve path", 1, 1024, 64, 64, 1, 64, 256, 7, iters=50,
            plain_iters=5, expect="mma_3xtf32", prev_iters=20)
        # single-chunk prompts of the serve path (256 and 64 tokens)
        ssd_phase("T=256, one chunk", 1, 256, 64, 64, 1, 64, 256, 9,
                  iters=50, plain_iters=5, expect="mma_3xtf32",
                  prev_iters=20)
        ssd_phase("T=64, one chunk", 1, 64, 64, 64, 1, 64, 256, 10,
                  iters=50, plain_iters=5, expect="mma_3xtf32",
                  prev_iters=20)
        ssd_phase("large", 4, 4096, 64, 64, 1, 64, 256, 8, iters=5,
                  plain_iters=2, expect="mma_3xtf32", prev_iters=2)
        # bfloat16 inputs, widened as they are staged
        ssd_phase("serve widths bf16", 1, 1024, 64, 64, 1, 64, 256, 12,
                  iters=50, plain_iters=5, expect="mma_3xtf32",
                  dtype="bfloat16")
        # a head dim that is not a multiple of 8 runs the first kernel, simt
        ssd_phase("simt P=20", 1, 1024, 64, 20, 1, 64, 256, 11, iters=10,
                  plain_iters=3, expect="simt")
        ssd_plan_phase()
        lap("kernel_ssd")
        rows["ssd_scan_bwd"] = ssd_bwd_rows()["path"]
        torch.cuda.empty_cache()
        lap("kernel_ssd_bwd")
        rows["decode_attention_paged"] = decode_phase(
            "zamba2 shared attention", 6, 32, 32, 64, 16, SERVE_PROMPTS,
            "float32", 20, iters=200, plain_iters=20, expect="simt_f32")
        decode_phase("length 0", 3, 32, 32, 64, 16, [0, 16, 100], "float32",
                     21, iters=200, plain_iters=20, expect="simt_f32")
        decode_phase("danube-1.8b", 4, 32, 8, 80, 32, [4096, 1, 777, 3000],
                     "float32", 22, iters=100, plain_iters=10,
                     expect="simt_f32")
        decode_phase("starcoder2-15b", 8, 48, 4, 128, 16,
                     [1, 17, 300, 1000, 2048, 4097, 6000, 8192], "bfloat16",
                     23, iters=100, plain_iters=10, expect="mma_bf16",
                     hole=True)
        decode_phase("llama4-scout", 32, 40, 8, 128, 16, [32768] * 32,
                     "bfloat16", 24, iters=10, plain_iters=2,
                     expect="mma_bf16")
        decode_phase("gemma-7b", 8, 16, 16, 256, 16,
                     [1, 300, 1000, 2048, 4096, 4097, 6000, 8192],
                     "bfloat16", 33, iters=50, plain_iters=5,
                     expect="mma_bf16")
        decode_plan_phase()
        lap("kernel_decode")
        rows["staged_matmul"] = matmul_phase(
            "zamba2 MLP up-projection", 1024, 2048, 8192, "float32", 25,
            iters=10, plain_iters=10, expect="simt_f32")
        rows["staged_matmul_wgmma_bf16"] = matmul_phase(
            "zamba2 MLP up-projection bf16", 1024, 2048, 8192, "bfloat16",
            26, iters=50, plain_iters=10, expect="wgmma_bf16_n256")
        matmul_phase("ragged", 1000, 2050, 1000, "float32", 27, iters=10,
                     plain_iters=10, expect="simt_f32")
        matmul_phase("ragged aligned bf16", 1000, 2056, 1000, "bfloat16",
                     29, iters=50, plain_iters=10, expect="wgmma_bf16")
        matmul_phase("ragged unaligned bf16", 1000, 2050, 1000, "bfloat16",
                     30, iters=20, plain_iters=10, expect="mma_sync_bf16")
        matmul_phase("small integers bf16", 1000, 2056, 1000, "bfloat16",
                     31, iters=20, plain_iters=5, expect="wgmma_bf16",
                     integer=True)
        matmul_phase("small integers bf16, wide tiles", 1024, 2048, 8192,
                     "bfloat16", 32, iters=20, plain_iters=5,
                     expect="wgmma_bf16_n256", integer=True)
        matmul_phase("bench_kernels FFN tile", 4096, 5120, 8192, "bfloat16",
                     28, iters=20, plain_iters=5, expect="wgmma_bf16_n256")
        wgmma_widths_phase(iters=20)
        lap("kernel_matmul")
        main = main_path()
        lap("main_path")
        profile_phase()
        lap("profile")
        main_result = main.pop("result")
        main_oracle = main.pop("oracle")
        unit_stride_phase(main_result)
        adaptive_fsp, adaptive_finish = adaptive_phase()
        lap("adaptive")
        from repro_torch.configs import get_arch
        zamba2 = get_arch("zamba2-1.2b")
        serve = serve_phase(zamba2, torch.device("cuda"))
        lap("serve")
        profile_serve(zamba2, torch.device("cuda"))
        lap("profile_serve")
        paged, staged, decoded = paged_phase(zamba2, torch.device("cuda"))
        lap("paged_staged")
        model_runs = {}
        for phase in FAMILY_SERVES:
            model_runs[phase] = family_phase(phase, torch.device("cuda"))
            lap(phase)
            if phase == "serve_scout":
                collectives_phase(decoded)
                del decoded
                lap("collectives")
        for phase in API_PHASES:
            model_runs[phase] = api_phase(phase, torch.device("cuda"))
            lap(phase)
        torch.cuda.empty_cache()
        model_runs["train_danube"] = train = train_danube_phase()
        lap("train_danube")
        model_runs["train_zamba2"] = train_z = train_zamba2_phase()
        lap("train_zamba2")
        check(train["dryrun_s"] + train_z["dryrun_s"] < DRYRUN_LIMIT_S,
              f"the two dry-runs took {train['dryrun_s']} and "
              f"{train_z['dryrun_s']} s")
        train_vs_plain_phase()
        # zamba2 at full width cut to 6 layers: 5 Mamba2 and one with the
        # shared attention block, so both backward kernels run
        train_vs_plain_phase(dataclasses.replace(zamba2, num_layers=6))
        lap("train_vs_plain")
        train_loop_phase()
        lap("train_loop")
        model_runs["train_mesh"] = train_m = train_mesh_phase()
        lap("train_mesh")
        torch.cuda.empty_cache()
        serve_m = serve_mesh_phase()
        lap("serve_mesh")
        # the card runs of the last three phases first, timed with no
        # CPU reference running beside them; then the references
        bench_sweep, bench_finish = sweep_phase("bench 144", False)
        _, dense_finish = sweep_phase("dense 9216", True)
        finish = [bench_finish, dense_finish]
        lap("receiver_sweep")
        routing_fsp, routing_finish = routing_phase()
        lap("routing")
        class_fsps, classes_finish = classes_phase()
        lap("classes")
        msg_fsp, messages_finish = messages_phase()
        lap("messages")
        flt_fsp, faults_finish = faults_phase()
        lap("faults")
        pod_fsps, pod256, pods_finish = pods_phase(main_result)
        lap("pods")
        farm_finish = farm_phase()
        farm_workers_phase()
        lap("farm")
        pair = pair_phase()
        lap("scalar_card")
        waterfill_path_rows({"routing8": routing_fsp, **class_fsps,
                             "messages18": msg_fsp, "lossy9": flt_fsp,
                             "adaptive8": adaptive_fsp, **pod_fsps}, 40)
        lap("kernel_waterfill_paths")
        for job in ("pod64", "pod256", "pod1024", "pod_storm3"):
            seg_variants_phase(job)
        lap("seg_variants")
        oracles = run_oracles()
        lap("oracles")
        for done in finish + [routing_finish, classes_finish,
                              messages_finish, faults_finish,
                              adaptive_finish, pods_finish, farm_finish]:
            done(oracles)
        lap("checks_vs_oracles")
        scalar_phase(main, main_result, main_oracle, pair, bench_sweep,
                     oracles)
        lap("scalar")
        traced = main_path_traced(main_result)
        lap("main_path_traced")
        # each kernel's launches on the path that runs it
        launches = {**traced["launches_by_name"],
                    "flash_attention": sum(
                        r["launches"]["flash_attention"]
                        for r in [serve, serve_m, *model_runs.values()]),
                    "flash_attention_bwd":
                        train["launches"]["flash_attention_bwd"]
                        + train_z["launches"]["flash_attention_bwd"]
                        + train_m["launches"]["flash_attention_bwd"],
                    "ssd_scan": serve["launches"]["ssd_scan"]
                        + train_z["launches"]["ssd_scan"]
                        + serve_m["launches"]["ssd_scan"],
                    "ssd_scan_bwd": train_z["launches"]["ssd_scan_bwd"],
                    "decode_attention_paged":
                        paged["launches"]["decode_attention_paged"],
                    "staged_matmul": staged["variants"]["simt_f32"],
                    "staged_matmul_wgmma_bf16":
                        staged["variants"]["wgmma_bf16"]
                        + staged["variants"]["wgmma_bf16_n256"],
                    "seg_sum": pod256["launches"]["seg_sum"]}
        check(sorted(launches) == sorted(rows) == sorted(SOURCES)
              and all(n > 0 for n in launches.values()),
              f"a kernel was launched on no path: {launches}")
        total = time.perf_counter() - start
        emit("total", wall_s=total, limit_s=TIME_LIMIT_S, phase_s=PHASE_S)
        check(total < TIME_LIMIT_S, f"the script took {total} s")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        close_nccl()
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r.get("library_ms")}
        for name, r in rows.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
