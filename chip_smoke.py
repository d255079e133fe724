"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main paths through the hand-written CUDA kernels and
fails (uncaught exception, non-zero exit) if any phase does.  The
streaming engine (``StreamingEngine.seed -> run_increment -> values``,
every chunk one launch of the cycle kernel: the cluster kernel, the grid
in row bands over a thread-block cluster, wherever a band fits, as it
does on every config here):

  1. device: the card's name and power limit; no CUDA device -> exit 1
  2. build: nvcc for sm_90a, all four kernels at once (the cycle
     kernels as two libraries, their tile instances in the second), with
     the ptxas registers, spills and static shared memory of both cycle
     kernels' twelve instances each (without and with telemetry; plain,
     with faults or query-batched; each also as a tile instance); fails
     if a cluster instance spills
  3. cycle kernel vs plain PyTorch version on the card, every leaf and the
     launch record exactly equal (tolerance 0), each launch counted on the
     kernel it took: (a) the pinned 8x8 config chunk by chunk to
     quiescence (the plain version on a CPU copy of each chunk's input),
     (b) three mid-stream states of the 2000-vertex stream on
     the 32x32 paper config, one K=512 chunk each, on the cluster kernel
     and again forced onto the one-block kernel
  4. fingerprints through the kernel: tests/data/pre_lanes_reference.json
     and src/repro_torch/data/fingerprint_32x32.json, exactly
  5. the paper's 50K-vertex / 1M-edge stream (10 edge-sampled increments)
     on the paper config, BFS values exactly the oracle's: its 102
     launches and 50,030 cycles, every launch on the cluster kernel; ns a
     machine cycle and the wall
  6. one full-size K=512 chunk through the cluster kernel and the
     one-block kernel in turns (cluster, block, block, cluster), each
     equal to the plain version: both times, the plain version's, the
     byte bound and the cluster geometry

The paper's experiments (``launch/paper_experiments.py``; the same cycle
kernel, in its branches for per-cycle traces, ``app="ingest_only"`` and
``allocator="random"``), right after phase 6:

 16. the new branches against the plain version on both cycle kernels
     (cluster, and forced onto the one-block kernel), every leaf, the
     launch record and every trace row equal: (a) the pinned 8x8 config
     chunk by chunk, traced, bfs and ingest_only (the plain version on a
     CPU copy of each chunk's input); (b) three mid-stream
     states of the 2000-vertex stream on the 32x32 paper config, one
     traced K=512 chunk each, for bfs, ingest_only and bfs under the
     random allocator
 17. the experiments at 50K vertices / 1M edges (nothing cut), the counts
     set to 0 before and every launch on the cluster kernel: ingest_only
     and bfs over edge and snowball sampling, bfs under the random
     allocator, ingest_only and bfs traced; every bfs stream's values the
     oracle's, ingest_only's all 1e9, the traced streams' totals those of
     the untraced ones increment by increment with one trace row a cycle,
     the bfs edge stream 102 launches and 50,030 cycles; the wall of each
     stream; then Fig. 8/9, Table 2, Fig. 5 and the Fig. 6/7 summary from
     the runner's cache
 18. replays: ``src/repro_torch/data/paper_ci_fingerprint.json`` (the JAX
     engine's five ci streams: counters, values, vertex_object_stats and
     both traces) and the ``engine_ci`` / ``engine_mid`` counters of
     ``results/bench_engine.json``, exactly
 19. the trace rows' cost: phase 6's K=512 chunk on the cluster kernel
     untraced and traced in turns (untraced, traced, traced, untraced),
     each equal to the plain version, the trace rows too

Virtual lanes, transit parking, rhizome vertex objects and the
max-monotone apps (the same cycle kernel, in its branches for ``lanes >
1``, ``rhizome_cap > 1``, ``app="widest"`` and ``app="reliable"``), and
the skew and lanes experiments, right after phase 19:

 20. the new branches against the plain version on both cycle kernels
     (cluster, and forced onto the one-block kernel), every leaf and the
     launch record equal, chunk by chunk to quiescence: (a) the 8x8 hub
     stream of ``tests/test_lanes.py`` at lanes=4, the hub stream of
     ``tests/test_rhizome.py`` at rhizome_cap=4 (bfs), and widest and
     reliable at rhizome_cap=2, lanes=2 on a weighted stream (the plain
     version on a CPU copy of each chunk's input); (b) the
     32x32 paper-scale skew config (rhizome_cap=4, lanes=2, 16,384
     vertices), whose cells fit no cluster band: a mid-stream state, one
     K=64 chunk on the one-block kernel
 21. ``src/repro_torch/data/skew_fingerprint.json`` (the JAX engine's
     ``bench_skew`` / ``bench_lanes`` configs at ci 8x8 and mid 16x16)
     replayed exactly on the cluster kernel: per-increment counters,
     values and vertex_object_stats of the rows that finish, the increment,
     cycle, chunk and counters of the rows that livelock; each row's wall
     and ms a launch; then ``bench_lanes("ci")`` equal to
     ``results/bench_lanes.json``, ``bench_skew("ci")``'s rows, and
     ``bench_lanes("mid")`` stopping at its lanes-smoke gate
 22. ``bench_skew``'s rows at the paper's 32x32 (16,384 vertices, 262,144
     R-MAT edges, lanes=2, queue_cap 48) on the one-block kernel,
     rhizome_cap 4, 2 and 1, each with a budget of 600,000 cycles an
     increment and the counts set to 0 just before it: ``ok`` with BFS ==
     oracle, ``livelock`` or ``budget``, and where the fingerprint holds
     the JAX engine's run of the row, its counters and outcome exactly;
     cycles, hops, stalls, rhizome stats, launches by kernel, the wall, ms
     a launch beside the byte bound

Telemetry (the same cycle kernel, in its compile-time telemetry instances:
the planes ``tm_cell``, ``tm_lane`` and ``tm_hiw`` accumulated inside the
cycle, a frame a chunk on the device, the flight recorder), right after
phase 22:

 23. both cycle kernels' telemetry instances against the plain version
     (cluster, and forced onto the one-block kernel), every leaf (the
     three planes included) and the launch record equal: the pinned 8x8
     stream chunk by chunk, the 8x8 hub stream at lanes=4, rhizome_cap=4
     (its first 16 chunks), the plain version of both on a CPU copy of
     each chunk's input, and phase 6's full-size state (the 32x32
     paper config, lanes=1), one K=512 chunk
 24. ``src/repro_torch/data/telemetry_fingerprint.json`` (the JAX engine
     with telemetry on: the pinned stream, the six ci skew and lanes
     configs, ``bench_engine``'s ci stream and the 8x8 hub livelock)
     replayed exactly on the cluster kernel: each increment's counters,
     frame count, ``dropped``, totals and final-frame plane digests, the
     ci heatmap, each livelock's cycle, chunk, frames and full text
 25. the paths with telemetry at full width, the counts set to 0 just
     before each and read just after: the paper stream (50K / 1M) in turns
     without and with telemetry (off, on, on, off), each 102 launches on
     the cluster kernel and 50,030 cycles, the runs with telemetry equal
     to phase 5's counters with every increment's final frame reconciling
     and BFS == oracle, ms a launch by CUDA events; ``bench_skew``'s
     rhizome_cap=4 row at paper scale (16,384 vertices) on the one-block
     kernel, whose ``LivelockError`` at cycle 8,192 carries the frame log
     and the JAX engine's text, wedge report included; and
     ``bench_engine("ci", profile=True)``, its heatmap equal to
     ``results/profile/heatmap_jnp.json`` but ``cycles`` (208); the paper
     stream without and with telemetry once more under ``torch.profiler``
     for the device's idle share (not measured where the profiler fails)
 26. telemetry's cost: phase 6's K=512 chunk on the cluster kernel in turns
     (off, on, on, off), each equal to its plain version

Faults, seals and repair (the same cycle kernel, in its compile-time
fault instances: a ``FaultPlan``'s drop, dup, corrupt and blackout
hazards in the hop stage, the seals, ``OP_REPAIR``, the ``flt``
counters; the engine's loss detector and repair pass), right after phase
26:

 27. both cycle kernels' fault instances, telemetry on and off, against
     one run of the plain version with telemetry on (the runs without it
     on every leaf but the planes), every leaf (``flt`` and the seal
     words included) and the launch record equal: (a) the pinned 8x8
     stream (lanes=1) under drop, dup and corrupt, chunk by chunk; (b)
     the hub stream of ``tests/test_resilience.py`` (lanes=2) under its
     plan, 16 chunks; (c) phase 6's full-size state under the paper plan
     with its blackout window over that chunk's cycles, one K=512 chunk;
     (d) the 8x8 hub stream at rhizome_cap=4 under drop, run on the
     kernel without its repair, then the repair's sentinel rows (to
     secondary roots too) loaded and run under the plan's safe twin
     (the plain version of (a), (b) and (d) on a CPU copy of each
     chunk's input)
 28. ``src/repro_torch/data/fault_fingerprint.json`` (the JAX engine
     under fault plans, telemetry on: the ci and mid fault smokes, the
     hub stream under a zero-rate plan and its four plans, the pinned
     stream under drop and corrupt; the paper config at 20K vertices /
     400K edges under the paper plan, telemetry off, which livelocks in
     its repair pass) replayed exactly on the cluster kernel: each
     increment's cycles, counters, ``flt``, frames and the digest of
     every leaf of its final state, the livelock's increment, cycle,
     chunk and ``flt``; then
     ``paper_experiments.fault_smoke`` at ci (943 cycles) and mid (3,451)
 29. the paper stream (50K / 1M) under the paper plan (drop, dup and
     corrupt at 4, 2 and 2 per cent, a W link dead for cycles 0-511) on
     the cluster kernel, telemetry off and on, the counts set to 0 just
     before each: per increment the cycles (repair included), ``flt``,
     whether the repair ran and, with telemetry, departures less
     deliveries == ``FLT_DROP``; launches by kernel; BFS == oracle.  A
     livelock is recorded, not hidden: its increment, cycle and pass,
     the kernels held against the plain version on the chunk in which
     the machine wedged, and the path again without dups
 30. what faults cost, in turns (CUDA events): the paper stream without
     faults and under a zero-rate plan (off, zero, zero, off), ms a
     launch; phase 6's K=512 chunk without faults, under the zero-rate
     plan and under the paper plan (off and faulty each equal to the
     plain version, zero-rate equal to off but for the seals); the
     faulty mid stream (10K / 100K on the paper config) against the
     clean one, both through the same function, cycles and wall (clean,
     faulty, faulty, clean).  The off
     path against the parent commit: ``tools/cca_cycle_ab.py``

Durable state, livelock recovery and the ingest guard (host-side: the
checkpointer in the JAX package's format, ``StreamingEngine.checkpoint``
/ ``restore``, ``run_increment(ckpt=, recover=)``, ``RecoveryPolicy``
and ``migrate_state``, ``ingest_guard``; the same cycle kernel, in the
escalated configs' lanes and in its telemetry and fault instances),
right after phase 30, each with the counts set to 0 just before:

 31. kill and resume at full size: the paper stream with an async
     checkpoint before each of increments 0-4 and a blocking one after
     them, the engine dropped, a new one restored from it replaying
     increments 5-9: every leaf, the totals and total_cycles == phase
     5's, 102 launches and 50,030 cycles on the cluster kernel, BFS ==
     oracle; each checkpoint's bytes, host snapshot and writer-thread
     write seconds and the restore's; then ``kill_resume_smoke("ci")``
     (totals 41,157 / 7,868 / 14 / 109)
 32. recovery: (a) ``recovery_smoke``, the 8x8 hub wedge recovered at
     lanes 2, wedge cycle 704; (b) the paper stream under the paper plan
     with ``RecoveryPolicy(max_attempts=2)``, telemetry off: each failed
     attempt's lanes, queue_cap, cycle, chunk and launches by kernel, how
     it ends (BFS == oracle if it recovers, the attempt log in the
     re-raised message if not), the chunk in which each attempt wedged
     held against the plain version on both kernels
 33. the ingest guard at full width: the paper stream with
     ``ingest_guard=True`` on the cluster kernel's telemetry instance:
     per increment the budget before and after, spill passes, cycles and
     launches; every final frame reconciles with the counters; BFS ==
     oracle
 34. ``src/repro_torch/data/resilience_fingerprint.json`` (the JAX
     engine: kill-and-resume at ci, the recovery smoke, the guarded hub
     stream through both drivers, the 20K / 400K paper-plan stream under
     ``RecoveryPolicy(max_attempts=2)``) replayed exactly
 35. what checkpoints cost: ``profile_resilience("paper")``, the paper
     stream with no checkpoint and one before every increment, in turns
     (never, 1, 1, never), walls after ``ckpt.wait()``

Multi-tenant serving (``repro_torch.mq``: ``batch_app``, ``MQSession``,
``FrontDesk``, ``launch/serve_bench.py``; the cycle kernels'
query-batched instances, qbatch = Q > 1), right after phase 35, each with
the counts set to 0 just before and its time printed:

 36. the query-batched instances against the plain version, every leaf
     (qchg / qlast included) and the launch record exactly equal: (a)
     ``tests/test_mq.py``'s 8x8 config on the MIX8 weighted stream (Q =
     8), chunk by chunk to quiescence, on the cluster kernel (8 CTAs of 1
     row) and forced onto the one-block kernel, telemetry on and off, the
     plain version on a CPU copy of each input; (b) the serving preset at
     paper scale (32x32, Q = 8): three mid-stream states, one K=256 chunk
     each, on the one-block kernel (no band fits), where
     ``path="cluster"`` raises
 37. ``src/repro_torch/data/mq_fingerprint.json`` (the JAX engine: the
     Q=1 session on the pinned stream, MIX8, mid-stream admit / retire /
     recycle, the Q=3 parity config, ``bench_serve("ci")`` with its eight
     serial runs and the record of ``results/bench_serve.json``, the
     paper config at 2,000 vertices / 20K edges with an all-BFS Q=8
     batch) replayed exactly: every increment's counters, qchg / qlast,
     lifecycle and leaf digests, each slot's values, the receipts
 38. serving at full size: ``bench_serve("paper")`` (32x32, 4,096
     vertices, 20,000 symmetric weighted R-MAT edges in 10 increments,
     QUERY_MIX at Q = 8, telemetry and the ingest guard on): every tenant
     == its serial run, the bfs / sssp / cc / widest tenants == the
     oracles; batch against serial cycles, the speedup, latency p50 / p99
     in cycles, deferrals, the walls, launches by kernel and instance
 39. the paper's 50K / 1M stream on the paper config under an all-BFS
     Q = 8 batch from ``batch_sources(50000)`` (source 0 one of them):
     each slot == the BFS oracle from its source; cycles against phase
     5's 50,030, ns a machine cycle against phase 6's one-block chunk,
     launches, the wall.  A livelock prints the engine's message and
     holds the wedged chunk against the plain version

Distribution (``repro_torch.dist``: the cell grid tiled over the ranks
of a ``(data, model)`` mesh, a halo two cells deep, one cycle a tile step
of the cycle kernels' tile instance ``kTl``, the halo's hop leaves
exchanged and the quiescence flag reduced after every cycle; on one card
the ranks are ``LocalTiles``, the same launches and exchange code as the
process-group path, which NCCL cannot run on one card), right after
phase 39, each with its time:

 40. the JAX parity config (8x8, 64 vertices, 160 edges, chunk 32) and the
     pinned 8x8 stream tiled over (2, 1), (4, 1), (8, 1), (2, 2) and
     (4, 2): chunk by chunk, every leaf of the gathered tiles == the
     unsharded kernel's run and the launch records equal, and == the
     plain tile step on the CPU (every mesh on the parity config, (2, 2)
     on the pinned stream, cut for time: the plain tiles run on the CPU);
     BFS == oracle; every tile step one launch of the tile instance
 41. the 32x32 fingerprint stream (2,000 / 20K, 2,372 cycles) tiled over
     (4, 1) and (2, 2), each increment to quiescence through
     ``dist.cca.run_to_quiescence`` (one host read a chunk): counters and
     values == ``src/repro_torch/data/fingerprint_32x32.json``
 42. the distribution path's main run: phase 6's full-size state (50K /
     1M) over (4, 1), four K=128 chunks with the counts set to 0 just
     before, each == the unsharded kernel on every leaf; launches by
     kernel, ms a cycle, the halo exchange's and the flag reduction's ms
     a cycle alone
 43. ``launch.dist_bench`` at ci and mid over 1, 2, 4 and 8 tiles
 44. gcn-cora on full_graph_sm with a 4-tile mesh registered (owner-
     partitioned edges, ``graph.partition.spmm_partitioned``) against the
     unsharded forward, 2e-2

The streaming engine on a sharded grid with every knob (``StreamingEngine``
over a ``dist.cca.ShardedState``; each tile cycle one launch of a tile
instance of the cycle kernel with the knob's mix: telemetry, faults,
query batches, traces), right after phase 44, each run with the counts
set to 0 just before it and read just after:

 52. the ten new tile instances (telemetry, faults, both, query batches,
     query batches with telemetry, on each kernel) against the plain tile
     step on a CPU copy, over a (2, 2) mesh of ``LocalTiles``: the pinned
     8x8 config and the 32x32 fingerprint config, traced, every leaf of
     the gathered tiles, the record and the trace rows equal, every tile
     step one launch of the knob's instance; every tile instance's ptxas
     registers and spills
 53. the paper stream (50K / 1M) with telemetry through the engine over
     (4, 1): 50,030 cycles, BFS == oracle, every increment's counters and
     every frame equal to the unsharded engine's, all launches on the
     cluster kernel's telemetry tile instance; then the cost of each knob
     on a 4-tile cycle at paper size (telemetry, a zero-rate plan, both,
     a trace), in turns with the plain tile cycle
 54. ``PAPER_PLAN`` through the engine over (4, 1): the 50K / 1M stream
     wedges where the unsharded engine does (increment 1, cycle 9,358,
     chunk 18); the mid stream (10K / 100K) finishes increment for
     increment with the unsharded engine
 55. an all-BFS Q=8 batch at 2,000 / 20K on the paper config, admitted by
     ``MQSession``, through the engine over (4, 1) and unsharded: the same
     cycles and counters, every slot == the oracle from its source
 56. phase 17's traced bfs stream through the engine over (4, 1): every
     trace row and counter equal to the unsharded engine's

The GNN and DLRM serving forwards (every aggregation a launch of the
scatter-SpMM kernel, every DLRM lookup one launch of the EmbeddingBag
kernel):

  7. the ptxas reports of the scatter-SpMM and EmbeddingBag kernels
  8. scatter-SpMM kernel vs plain on the card (max |d| <= 1e-4 max(1,
     max |ref|)) at every aggregation shape of phase 9: GCN-Cora (D = 16,
     7, gather and coeff fused), Cora edge messages (D = 70 gatedgcn, 128
     meshgraphnet), ogb_products (D = 16, 7), and GraphCast's multimesh
     at refinement 6, grid-to-mesh and mesh-to-grid sets (D = 512), and
     equal bit for bit to ``spmm_ordered``, the order of the warp shape
     ``ops.geometry`` picks; the kernel over the graph's row pointers
     timed in turns with the old wide shape (old, new, new, old, twice), beside
     the wrapper, the plain version, ``torch.sparse.mm`` on the CSR matrix
     (yardstick only), the bound and the gather floor (the 32-byte
     sectors of x the edges touch)
  9. GNN serving at published widths: gcn-cora on full_graph_sm and on
     ogb_products, gatedgcn, meshgraphnet and graphcast on full_graph_sm;
     finite outputs, equal to the CPU forward elementwise within 1e-4
     (full_graph_sm; graphcast, whose f32 function cannot meet that at
     random init, no farther from its f64 forward than twice its plain
     f32 forward, both on the card with ``index_add_`` sums), spmm
     launches per forward, wall per forward, peak memory
 10. EmbeddingBag kernel vs plain at RM2 widths on the 26 full-size tables
     (36.8 GB, drawn on the card, checked once by
     ``dlrm.prepare_dlrm_params`` as serving does) for serve_p99 and
     serve_bulk (1e-5), and
     equal bit for bit to ``embedding_bags_ordered`` (the kernel's order
     of sums); the warp shape ``ops.geometry`` picked; timed beside the
     plain version and ``F.embedding_bag`` per table, the byte bound, its
     share of the kernel's time, and the gather floor (every lookup into a
     table larger than the L2 read from memory); serve_p99 both by the
     call rate and as device time from a CUDA graph of its one launch
 11. DLRM-RM2 serving at full width: serve_p99 and serve_bulk forwards,
     retrieval over 1,000,000 candidates; finite logits, top-100 shapes,
     the serve_p99 logits and the retrieval's scores equal to the CPU
     forward over the touched rows (elementwise, 1e-4), launches (every
     one in the warp shape ``ops.geometry`` picks at RM2), wall, peak
     memory

The LM serving path (llama3.2-1b; every prefill attention one launch of
the flash-attention kernel a layer, the bf16 prefill on its tensor-core
path, decode attention plain PyTorch):

 12. the ptxas report of each flash-attention instantiation (registers,
     spills, shared memory); the tensor-core kernels, bf16 and 3xTF32, at
     dh 64 and 128 must not spill
 13. flash kernel vs plain on the card, entry by entry (``flash_excess``:
     2e-2 x (|ref| + median |ref|) in bf16, 2e-5 x (|ref| + 1) in f32) at
     T = 4096 at the heads of llama3.2-1b (32/8, dh 64), qwen3-1.7b (16/8,
     128) and starcoder2-3b (24/2, 128), bf16 and f32, at arctic's heads
     (56/8: G = 7, an odd group count) at T = 4096 in bf16, and at the
     heads of llama (dh 64) and phi3.5-moe (32/8, dh 128) at T = 32768 in
     bf16 (the plain version head by head: its full score matrix would be
     137 GB); at each shape two planted faults (the
     next KV head; each row blind to the keys more than T/2 back) must
     fail the same limit; each timed beside the plain version,
     ``F.scaled_dot_product_attention`` (yardstick only, on K/V repeated
     to the query heads beforehand; the backend its dispatcher picks, its
     time held to EFFICIENT_ATTENTION, and its own excess over the same
     limit) and the bound (f32: three TF32 products at 165 TFLOP/s, the
     CUDA cores' 67 beside it), with the kernel's TFLOP/s, its time over
     SDPA's and the bound's share of its time, and the path it took
     (bf16: tensor cores; f32: tensor cores as 3xTF32)
 14. prefill at full width: llama3.2-1b on prefill_32k at B = 1 and
     T = 32768 (the main path whose flash launches the kernels line
     reports: 80, all on the tensor-core path), qwen3-1.7b at B = 1,
     T = 4096: finite logits, flash
     launches per forward = n_layers, wall, tokens/s, the attention share
     by CUDA events, peak memory; llama3.2-1b once more at B = 16 (its
     own 32 runs out of memory): finite logits, wall, peak memory; at
     T = 2048 the kernel path's bf16 logits no farther from an f32
     forward than max(1e-3, 2x) the plain attention's bf16 forward; at
     T = 128 the last-token logits of ``prefill`` equal those of 128
     ``lm_decode_step`` calls within 5e-2
 15. serving at full width: ``serve()`` on llama3.2-1b at decode_32k with
     32 slots (cut from 128) and max_len 32768, 64 requests of 16 prompt
     and 24 generated tokens: every request answered, decode-step p50 /
     p99, tokens/s, peak memory

MoE serving (``models.transformer``: ``_route``, ``_ffn_moe`` by index
dispatch, ``_ffn_moe_ep`` over ``LocalTiles``, ``dense_residual``, the
aux loss; the expert products are batched ``torch.matmul``, as JAX's are
plain XLA products; every prefill attention one flash launch a layer),
right after phase 15:

 45. the MoE FFN against its plain version at full width, phi3.5-moe's
     layer 0 (f32 weights) and arctic's one layer (bf16 weights):
     ``_ffn_moe`` against ``_ffn_moe_ref`` (JAX's literal ``[S, E, cap]``
     dispatch and combine einsums) at S = 512 in bf16, the routing shared,
     the slots of the sort equal to the one-hot cumsum's, the output equal
     bit for bit or within one bf16 step of the largest |out|, each timed;
     phi3.5-moe's ``_ffn_moe_ep`` on ``LocalTiles`` at (1, 4) and (2, 2)
     against ``_ffn_moe`` at capacity factor E / K (nothing dropped),
     within two bf16 steps of the largest |out|
 46. MoE prefill at full width, the flash counts set to 0 just before
     each and read just after (two more main paths of the kernels line):
     phi3.5-moe at 8 of its 32 layers (cut by memory: 42.7 GB of f32
     weights; the whole model is 168 GB) on prefill_32k at B = 1,
     T = 32768, and arctic at 1 of its 35 layers in bf16 weights (28 GB;
     the whole is 1.9 TB in f32) at B = 1, T = 4096: finite logits, flash
     launches = layers on the tensor-core path, the (token, k) pairs the
     capacity dropped, wall, tokens/s, the MoE block's share by CUDA
     events split into routing, dispatch, expert products and combine,
     the expert products' bound (their kept rows' flops at 989 TFLOP/s or
     their weights read once, whichever is longer), peak memory
 47. MoE serving: ``serve()`` on phi3.5-moe at 8 layers, decode_32k with
     8 slots (cut from 128: the bf16 cache is 8.6 GB at 8 layers and 8
     slots, 137 GB at 128 and 32 layers) and max_len 32768, 16 requests
     of 16 prompt and 24 generated tokens: every request answered,
     decode-step p50 / p99, tokens/s, pairs dropped, peak memory; at
     T = 128 and capacity factor E / K (no drops on either path) the
     prefill's logits against 128 ``lm_decode_step`` calls on the
     prefill's experts within 5e-2 x max(1, max |ref|) at every
     position, each (token, layer) whose own router would take other
     experts a near-tie of the prefill's router logits (within 8 bf16
     steps), and two
     planted faults (a token's experts moved, the cache blind to token
     0) rejected by the same limit

Training (the autograd Functions of the three model kernels: the flash
backward kernel, the SpMM kernel over the transposed edges, the bag
backward kernel; ``optim``, ``launch.steps``, ``launch.train``), right
after phase 47, each printing the card's name and power limit:

 48. the flash backward kernel against its plain backward
     (``ref.flash_attention_bwd_ref``, f32 over query tiles) on the same
     q, k, v, o, lse and dout, at smoke shapes and at llama3.2-1b's
     (32/8, dh 64) and phi3.5-moe's (32/8, dh 128) heads, T = 4096,
     B = 1, bf16: dq, dk and dv within the forward's elementwise limit
     (2e-2 x (|ref| + median |ref|)), the same bits on a second launch, a
     planted fault (K and V of the next KV head) rejected; ms, the bound
     (10 dh flops a head and causal pair over 989 TFLOP/s), the plain
     backward's ms, SDPA's backward ms (K/V repeated, as phase 13's
     column); the forward's lse store against the plain lse; the
     forward's ms with the lse store and without it (the serving
     instance; ``tools/flash_parent_ab.py`` holds that one against the
     parent commit's kernel)
 49. the SpMM backward (the kernel over the transposed edges) at
     ogb_products' size (2,449,029 nodes, 61,859,140 edges, drawn on the
     card), D = 16 and 7, against the plain backward (1e-4 x max(1,
     max |ref|)), with ``torch.sparse.mm``'s time; the bag backward at
     train_batch (B = 65,536, 26 x 4 lookups) on tables cut to 2^20 rows
     and at skew4 (the same shape, each row floor(V u^4)): bit for bit
     ``ref.embedding_bags_bwd_ordered``, the same bits twice, within 1e-5
     of ``index_add_``, untouched rows +0.0 over an allocator poisoned
     with NaN; the call, the key pass, both sorts (CUB's over the key
     bits, ``torch.sort``), the segments and rows kernels alone, beside
     the byte bound, the gather floor, ``index_add_`` and
     ``F.embedding_bag``'s backward; launch counts
 50. one family at a time: one grad step against the same step with every
     kernel replaced by its plain version (the flash forward and
     backward, the SpMM, the bag forward and backward), the loss and
     every gradient leaf: llama3.2-1b at 2 of 16 layers, full width,
     T = 4096, B = 1, and phi3.5-moe at 1 layer, its plain run on the
     kernel run's experts (bf16: each leaf's ||d|| / ||ref|| within 2e-2);
     gcn-cora on ogb_products and DLRM-RM2 train_batch on the cut tables
     (f32: 1e-4 x the leaf's max |ref|), graphcast on full_graph_sm (both
     f32 steps against its f64 step, whose every sum is ``index_add_``:
     the kernel step's worst leaf within max(1e-3, 2x the plain step's
     worst), its 16 processor layers: ``GRAD_TOL_GRAPHCAST``); each
     kernel launched on the kernel path and none on the plain one; the
     DLRM step's device time by part under ``torch.profiler`` (the bag
     backward's kernels and its sort, the bag forward, the matmuls)
 51. the training main path at full width: ``steps.build_plan`` for
     llama3.2-1b train_4k, all 16 layers, remat on, T = 4096, B = 4 (cut
     from 256 by memory and time), 4 AdamW steps under deterministic
     algorithms: step time, tokens/s, peak memory, flash launches a step
     (forward, recompute and backward), the ops that warned of no
     deterministic kernel; 2 + 2 steps across a save, a kill and a
     restore through the port's ``Checkpointer``: params and moments
     equal to the straight run's bit for bit; ``train()`` on lm100m, with
     and without ``--compress``, 3 steps each

It ends with the kernels line (JSON; the flash kernel's ``launches``
summed over its three main paths: llama3.2-1b's prefill_32k run and the
two MoE prefills; the two backward kernels' from their training paths)
and the ok line (JSON, last).
"""
import collections
import contextlib
import dataclasses
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time
import warnings
from unittest import mock

# the deterministic cuBLAS workspace that phase 51's bit-identical resume
# needs, read by cuBLAS when the process makes its first product
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
import torch.utils.checkpoint  # noqa: E402
from torch.nn.attention import SDPBackend, sdpa_kernel  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.configs import gnn_archs, lm_archs  # noqa: E402
from repro_torch.configs.base import (gnn_shapes, lm_shapes,  # noqa: E402
                                      recsys_shapes)
from repro_torch.configs.recsys_archs import DLRM_RM2  # noqa: E402
from repro_torch.core import (LIVELOCK_CHUNKS, EngineConfig,  # noqa: E402
                              LivelockError, StreamingEngine)
from repro_torch.core.apps import BFS  # noqa: E402
from repro_torch.core.msg import DIR_W  # noqa: E402
from repro_torch.core.ingest import load_stream  # noqa: E402
from repro_torch.core.reference import (bfs_levels, cc_labels,  # noqa: E402
                                        sssp_dists)
from repro_torch.data.graphs import build_graph  # noqa: E402
from repro_torch.data.pipeline import (RecSysBatchSpec,  # noqa: E402
                                       recsys_batch)
from repro_torch.graph.segment_ops import sym_norm_coeff  # noqa: E402
from repro_torch.core.state import TM_HOP, init_state  # noqa: E402
from repro_torch.graph.streams import StreamSpec, make_stream  # noqa: E402
from repro_torch.kernels.cca_cycle import ops  # noqa: E402
from repro_torch.kernels.cca_cycle.ref import cca_cycle_chunk_ref  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as bag_ops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import (  # noqa: E402
    embedding_bags_ordered, embedding_bags_ref)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)
from repro_torch.kernels.spmm import ops as spmm_ops  # noqa: E402
from repro_torch.kernels.spmm.ref import (scatter_spmm_ref,  # noqa: E402
                                          spmm_ordered, spmm_sorted_coo_ref)
from repro_torch.launch import paper_experiments as pe  # noqa: E402
from repro_torch.launch import serve as lm_serve  # noqa: E402
from repro_torch.launch import serve_bench as sb  # noqa: E402
from repro_torch.models import dlrm, gnn, transformer  # noqa: E402
from repro_torch.mq import FrontDesk, MQSession, batch_app  # noqa: E402
from repro_torch.dist import cca  # noqa: E402
from repro_torch.dist.ctx import set_dist_mesh  # noqa: E402
from repro_torch.graph.partition import partition_edges  # noqa: E402
from repro_torch.launch import dist_bench  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.resilience import (FLT_CORRUPT, FLT_DROP,  # noqa: E402
                                    FaultPlan)
from repro_torch.configs.base import shape as spec_shape  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.data.pipeline import LMBatchSpec, lm_batch  # noqa: E402
from repro_torch.dist.sharding import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import (  # noqa: E402
    embedding_bags_bwd_ordered, embedding_bags_bwd_ref)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_fwd_ref)
from repro_torch.kernels.spmm.ref import (scatter_spmm_bwd_ref,  # noqa: E402
                                          source_rows)
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig,  # noqa: E402
                                     adamw_update, init_adamw)
from repro_torch.train.checkpoint import Checkpointer  # noqa: E402

H100_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (data sheet, 700 W)
H100_L2_BYTES = 50e6         # H100 L2 (data sheet)
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores (data sheet)
H100_BF16_FLOPS = 989e12     # bf16 tensor cores, dense (data sheet)
H100_TF32_FLOPS = 495e12     # tf32 tensor cores, dense (data sheet)
# f32 accuracy on the tensor cores: three TF32 products (3xTF32) each
H100_F32_TC_FLOPS = H100_TF32_FLOPS / 3
PAPER_FULL = dict(n_vertices=50_000, n_edges=1_000_000)


def paper_cfg(n_vertices, n_edges):
    """``benchmarks/paper_experiments.py::_engine``'s config formula."""
    ghosts = max(64, 2 * n_edges // (8 * 1024), 3 * n_vertices // 1024)
    return EngineConfig(height=32, width=32, n_vertices=n_vertices,
                        edge_cap=8, ghost_slots=ghosts, queue_cap=64,
                        chan_cap=16, futq_cap=16, io_stream_cap=2 ** 21,
                        chunk=512)


def clone(st):
    return st._replace(**{k: v.clone() for k, v in st._asdict().items()})


def leaf_diff(a, b) -> float:
    """Max abs difference over all leaves; float leaves must also match
    bit for bit (a NaN or a -0.0 counts as a difference)."""
    worst = 0.0
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x.dtype == torch.float32:
            if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
                worst = max(worst, float((x - y).abs().max()), 1e-30)
        elif not torch.equal(x, y):
            worst = max(worst, float((x.long() - y.long()).abs().max()))
        if worst:
            raise AssertionError(f"leaf {name!r} differs (max |d| {worst})")
    return worst


TM_LEAVES = ("tm_cell", "tm_lane", "tm_hiw")


def without_telemetry(cfg, st):
    """``cfg`` with telemetry off and ``st`` with its planes the 1x1
    dummies that config lays out."""
    cfg_off = dataclasses.replace(cfg, telemetry=False)
    like = init_state(cfg_off, device="meta")
    return cfg_off, st._replace(**{
        k: torch.zeros(getattr(like, k).shape, dtype=torch.int32,
                       device=st.aq.device) for k in TM_LEAVES})


def to_device(st, dev):
    return st._replace(**{k: v.to(dev) for k, v in st._asdict().items()})


def kernel_vs_plain(cfg, app, st, n_cycles=None, paths=("auto",),
                    traced=False, plain_on_cpu=False,
                    also_without_telemetry=False):
    """One chunk through the kernel (once for each of ``paths``) and the
    plain version from the same input; returns the max abs difference (0)
    or raises.  ``traced``: each call fills a trace tensor, and the
    kernel's rows of the cycles run must equal the plain version's.
    ``plain_on_cpu`` runs the plain version on a CPU copy of the input
    (the same integer and IEEE f32 arithmetic; on an 8x8 grid ~2.5x the
    speed of its thousands of tiny launches a cycle on the card) and
    brings its result back.  ``also_without_telemetry`` (``cfg`` has
    telemetry on): each path also runs with telemetry off, and those runs
    equal the plain version's on every leaf but the planes (telemetry
    touches no other leaf), which stay their zero dummies."""
    n = cfg.chunk if n_cycles is None else n_cycles
    dev = st.aq.device

    def rows(d):
        return torch.full((n, 2), -1, dtype=torch.int32,
                          device=d) if traced else None

    cases = [(cfg, st, None)]
    if also_without_telemetry:
        cfg_off, st_off = without_telemetry(cfg, st)
        cases.append((cfg_off, st_off, st_off))
    runs = []
    for p in paths:
        for c, s, off in cases:
            tr = rows(dev)
            runs.append((off,) + ops.cca_cycle_chunk(c, app, clone(s),
                                                     n_cycles, path=p,
                                                     trace=tr) + (tr,))
    src = to_device(st, "cpu") if plain_on_cpu else st
    want = rows(src.aq.device)
    sr, cr = cca_cycle_chunk_ref(cfg, app, src, n_cycles, want)
    sr, cr = to_device(sr, dev), cr.to(dev)
    want = want.to(dev) if traced else None
    torch.cuda.synchronize()
    worst, ran = 0.0, int(cr[1])
    for off, sk, ck, tk in runs:
        tm = f" (telemetry {'off' if off else 'on'})" \
            if also_without_telemetry else ""
        if not torch.equal(ck, cr):
            raise AssertionError(f"launch record {ck.tolist()} != "
                                 f"{cr.tolist()}{tm}")
        worst = max(worst, leaf_diff(sk, sr if off is None else sr._replace(
            **{k: getattr(off, k) for k in TM_LEAVES})))
        if traced and not torch.equal(tk[:ran], want[:ran]):
            bad = int((tk[:ran] != want[:ran]).any(1).nonzero()[0])
            raise AssertionError(f"trace row {bad}: {tk[bad].tolist()} != "
                                 f"{want[bad].tolist()}{tm}")
    return worst, sr, bool(cr[0])


def chunks_vs_plain(tag, cfg, app, st, incs, max_chunks=None, **kw):
    """``kernel_vs_plain`` on both kernels (cluster, then forced onto the
    one-block kernel), the plain version on the CPU (``plain_on_cpu``: the
    8x8 grids this runs), chunk by chunk over ``incs`` from ``st``: each
    increment loaded (``None`` loads nothing), the counters, planes and
    ``flt`` reset, then run to quiescence, or until ``max_chunks`` chunks
    in all; raises unless every cycle-kernel launch since the start was
    one of these.  ``kw`` goes to ``kernel_vs_plain``.  Returns ``(max abs
    difference (0), state, chunks, cycles)``."""
    worst, chunks, cycles = 0.0, 0, 0
    before = dict(ops.path_launches)
    for e in incs:
        if e is not None:
            st, spill = load_stream(cfg, st, e)
            assert len(spill) == 0
        st, q = fresh_stats(st), False
        c0 = int(st.cycle)
        while not q and chunks != max_chunks:
            d, st, q = kernel_vs_plain(cfg, app, st,
                                       paths=("cluster", "block"),
                                       plain_on_cpu=True, **kw)
            worst, chunks = max(worst, d), chunks + 1
        cycles += int(st.cycle) - c0
    per = 2 if kw.get("also_without_telemetry") else 1
    got = {p: ops.path_launches[p] - before[p] for p in ops.PATHS}
    if got != {"block": per * chunks, "cluster": per * chunks}:
        raise AssertionError(f"{tag}: launches {got}, {chunks} chunks")
    return worst, st, chunks, cycles


def on_path(before, path, n):
    """Raise unless the cycle-kernel launches since ``before`` (a copy of
    ``ops.path_launches``) were all on ``path``: ``n`` of them, or at
    least one where ``n`` is None."""
    got = {p: ops.path_launches[p] - before[p] for p in ops.PATHS}
    ok = got[path] > 0 if n is None else got[path] == n
    if not ok or sum(got.values()) != got[path]:
        raise AssertionError(f"cycle-kernel launches {got}, not all on the "
                             f"{path} kernel")


CYCLE_INSTANCES = tuple(f"{k}{t}{f}{tl}" for k in ("cluster", "block")
                        for t in ("", "_telemetry")
                        for f in ("", "_faults", "_query")
                        for tl in ("", "_tile"))


def cycle_ptxas(report: str) -> dict:
    """Phase 2: the registers, spills and static shared memory of both
    cycle kernels, each in its twelve instances, without and with
    telemetry, plain, with faults or query-batched (``cluster``,
    ``cluster_telemetry``, ``cluster_faults``, ``cluster_telemetry_faults``,
    ``cluster_query``, ``cluster_telemetry_query``), each also as a tile
    instance (``cluster_tile``, ``cluster_telemetry_tile``, ...;
    ``block...`` the same), printed; raises if a cluster instance spills
    or an instance is missing."""
    out = {}
    for name, info in _build.ptxas_functions(report).items():
        m = re.search(r"(cca_cycle_cluster_kernel|cca_cycle_kernel)"
                      r"ILb([01])ELb([01])ELb([01])ELb([01])E", name)
        if not m:
            continue
        kind = ("cluster" if "cluster" in m[1] else "block") + (
            "_telemetry" if m[2] == "1" else "") + (
            "_faults" if m[3] == "1" else "") + (
            "_query" if m[4] == "1" else "") + (
            "_tile" if m[5] == "1" else "")
        out[kind] = info
        print(f"[2] {kind} kernel: {info.get('registers')} registers, "
              f"{info.get('spill_stores')} bytes spill stores, "
              f"{info.get('spill_loads')} bytes spill loads, "
              f"{info.get('stack')} bytes stack, static smem "
              f"{info.get('smem', 0)} bytes", flush=True)
    for kind in CYCLE_INSTANCES:
        if not kind.startswith("cluster"):
            continue
        c = out.get(kind, {})
        if not c or c.get("spill_stores", 1) or c.get("spill_loads", 1):
            raise AssertionError(f"{kind} cycle kernel: spills or no report "
                                 f"({c})")
    if set(out) != set(CYCLE_INSTANCES):
        raise AssertionError(f"cycle kernel instances {sorted(out)}")
    return out


STAT_LEAVES = ("stat_hops", "stat_exec", "stat_stall", "stat_allocs",
               "tm_cell", "tm_lane", "tm_hiw", "flt")


def fresh_stats(st):
    """Counters, telemetry planes and fault counters zeroed, as
    ``run_increment`` does."""
    return st._replace(**{k: torch.zeros_like(getattr(st, k))
                          for k in STAT_LEAVES})


@contextlib.contextmanager
def timed_launches(events: list):
    """While the block runs, every cycle-kernel launch through
    ``ops.cca_cycle_chunk`` appends a pair of CUDA events around it to
    ``events``."""
    launch = ops.cca_cycle_chunk

    def timed_chunk(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = launch(*a, **kw)
        ev[1].record()
        events.append(ev)
        return out

    ops.cca_cycle_chunk = timed_chunk
    try:
        yield
    finally:
        ops.cca_cycle_chunk = launch


def replay(ref):
    cfg_fields = EngineConfig.__dataclass_fields__
    cfg = EngineConfig(**{k: v for k, v in ref["cfg"].items()
                          if k in cfg_fields})
    incs = make_stream(StreamSpec(**ref["spec"]))
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    rows = []
    for e in incs:
        r = eng.run_increment(e, max_cycles=ref.get("max_cycles", 500_000))
        rows.append(dict(cycles=r.cycles, hops=r.hops, execs=r.execs,
                         stalls=r.stalls, allocs=r.allocs))
    return rows, eng.values()


def branch_phases(pinned) -> float:
    """Phase 16: the cycle kernel's branches of the paper experiments
    against the plain version, every launch on both kernels (cluster, then
    forced onto the one-block kernel), every leaf, the record and every
    trace row equal; returns the max abs difference (0)."""
    worst = 0.0
    # (a) the pinned 8x8 config chunk by chunk, traced, bfs and ingest_only
    for app in ("bfs", "ingest_only"):
        t0 = time.time()
        eng = StreamingEngine(EngineConfig(**pinned["cfg"]), app)
        if app == "bfs":
            eng.seed(0, 0.0)
        d, _, chunks, _ = chunks_vs_plain(
            f"16a {app}", eng.cfg, eng.app, eng.state,
            make_stream(StreamSpec(**pinned["spec"])), traced=True)
        worst = max(worst, d)
        print(f"[16a] 8x8 pinned, {app}, traced: both kernels == plain on "
              f"every leaf, the record and every trace row over {chunks} "
              f"chunks (max |d| {worst}; {time.time() - t0:.1f}s)",
              flush=True)
    # (b) the 32x32 ci stream: three mid-stream states, one K=512 chunk each
    ci = pe.SCALES["ci"]
    incs = pe.stream_increments("edge", "ci")
    for app, alloc in (("bfs", "vicinity"), ("ingest_only", "vicinity"),
                       ("bfs", "random")):
        eng = pe._engine(ci["n_vertices"], app, alloc, n_edges=ci["n_edges"])
        for i, e in enumerate(incs):
            if i in (2, 5, 8):
                st, _ = load_stream(eng.cfg, clone(eng.state), e)
                t0 = time.time()
                before = dict(ops.path_launches)
                d, sr, q = kernel_vs_plain(eng.cfg, eng.app, fresh_stats(st),
                                           512, ("cluster", "block"),
                                           traced=True)
                if {p: ops.path_launches[p] - before[p] for p in ops.PATHS} \
                        != {"cluster": 1, "block": 1}:
                    raise AssertionError("16b: not one launch on each kernel")
                worst = max(worst, d)
                print(f"[16b] 32x32 ci {app} {alloc} increment {i}: one "
                      f"traced K=512 chunk, both kernels == plain on every "
                      f"leaf, the record and every trace row (cycle "
                      f"{int(sr.cycle)}, quiescent {q}, "
                      f"{time.time() - t0:.1f}s)", flush=True)
            eng.run_increment(e, max_cycles=2_000_000)
    return worst


PAPER_STREAMS = (  # (app, sampling, allocator, traced), in the order run
    ("ingest_only", "edge", "vicinity", False),
    ("bfs", "edge", "vicinity", False),
    ("ingest_only", "snowball", "vicinity", False),
    ("bfs", "snowball", "vicinity", False),
    ("bfs", "edge", "random", False),
    ("ingest_only", "edge", "vicinity", True),
    ("bfs", "edge", "vicinity", True))
TOTALS = ("edges", "cycles", "hops", "execs", "stalls", "allocs")


HUB_KW = dict(height=8, width=8, n_vertices=128, edge_cap=4, ghost_slots=48,
              queue_cap=20, chan_cap=16, futq_cap=4, io_stream_cap=2048,
              chunk=64)          # tests/test_lanes.py::_hub_cfg
RHIZOME_KW = dict(height=8, width=8, n_vertices=64, edge_cap=4,
                  ghost_slots=32, queue_cap=96, chan_cap=16, futq_cap=8,
                  io_stream_cap=2048, chunk=128)   # test_rhizome.py::cfg_for
MAX_APP_KW = dict(height=8, width=8, n_vertices=64, edge_cap=4,
                  ghost_slots=32, queue_cap=48, chan_cap=16, futq_cap=4,
                  io_stream_cap=2048, chunk=64, rhizome_cap=2, lanes=2)
MAX_APP_SEEDS = {"widest": 1e9, "reliable": 1.0}

def weighted_increments(seed=1, n=64, m=320):
    """``tests/test_torch_max_apps.py``'s stream: two increments of random
    edges, each weight drawn from (0, 1]."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    w = (1.0 - rng.random(m)).astype(np.float32)
    e = np.stack([src, dst, w.view(np.int32)], 1).astype(np.int32)
    return [e[: m // 2], e[m // 2:]]


def lane_rhizome_phases() -> float:
    """Phase 20a: the lane, park, rhizome and max-app branches of both
    cycle kernels against the plain version, every leaf and the launch
    record equal, chunk by chunk to quiescence.  Returns the max abs
    difference (0)."""
    worst = 0.0
    cases = (
        ("8x8 hub lanes=4", EngineConfig(lanes=4, **HUB_KW), "bfs",
         [pe.hub_stream(128, 200)], 0.0),
        ("8x8 hub rhizome_cap=4 bfs", EngineConfig(rhizome_cap=4,
                                                   **RHIZOME_KW),
         "bfs", [pe.hub_stream(64, 40)], 0.0),
        ("8x8 widest rhizome_cap=2 lanes=2", EngineConfig(**MAX_APP_KW),
         "widest", weighted_increments(), MAX_APP_SEEDS["widest"]),
        ("8x8 reliable rhizome_cap=2 lanes=2", EngineConfig(**MAX_APP_KW),
         "reliable", weighted_increments(), MAX_APP_SEEDS["reliable"]))
    for name, cfg, app, incs, seed in cases:
        t0 = time.time()
        eng = StreamingEngine(cfg, app)
        eng.seed(0, seed)
        d, st, chunks, cycles = chunks_vs_plain(f"20a {name}", cfg, eng.app,
                                                eng.state, incs)
        worst = max(worst, d)
        print(f"[20a] {name}, {app}: both kernels (cluster "
              f"{ops.cluster_geometry(cfg)}) == plain on every leaf and the "
              f"record over {chunks} chunks, {cycles} cycles, "
              f"{int(st.stat_stall)} stalls in the last increment (max |d| "
              f"{worst}; {time.time() - t0:.1f}s)", flush=True)
    return worst


def skew_state_phase() -> float:
    """Phase 20b: the paper-scale skew config (rhizome_cap=4, lanes=2),
    whose cells fit no cluster band, mid-stream: eight K=512 chunks of
    increment 0 on the kernel, then one K=64 chunk on the one-block kernel
    against the plain version.  Returns the max abs difference (0)."""
    t0 = time.time()
    cfg = pe.skew_config("paper", rhizome_cap=4)
    if ops.cluster_geometry(cfg) is not None:
        raise AssertionError("20b: the paper skew config fits a band")
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    st, _ = load_stream(cfg, eng.state, pe.skew_increments("paper")[0])
    st = fresh_stats(st)
    for _ in range(8):
        st, _ = ops.cca_cycle_chunk(cfg, eng.app, st, 512)
    before = dict(ops.path_launches)
    d, sr, q = kernel_vs_plain(cfg, eng.app, st, 64, ("block",))
    on_path(before, "block", 1)
    print(f"[20b] 32x32 skew paper config (rhizome_cap=4, lanes=2; a cell "
          f"{ops.cluster_cell_bytes(cfg)} bytes, no band fits): at cycle "
          f"{int(st.cycle)} of increment 0 ({int(st.pk_n.sum())} messages "
          f"parked, {int(st.ch_n.sum())} in channels), one K=64 chunk, the "
          f"one-block kernel == plain on every leaf (quiescent {q}; "
          f"{time.time() - t0:.1f}s)", flush=True)
    return d


def skew_records() -> list:
    return json.loads((ROOT / "src" / "repro_torch" / "data"
                       / "skew_fingerprint.json").read_text())["configs"]


def check_skew_row(name, row, eng, c) -> str:
    """Raise unless ``row`` (``pe.skew_row``'s) and ``eng`` hold the JAX
    engine's record ``c``: the status, each increment's counters, then the
    livelock's increment, cycle, chunk and counters, or the values and
    ``vertex_object_stats``.  Returns what was held, in words."""
    if row["status"] != c["status"] or row["increments"] != c["increments"]:
        raise AssertionError(f"{name}: {row['status']} {row['increments']} "
                             f"!= {c['status']} {c['increments']}")
    if c["status"] == "livelock":
        if row["livelock"] != c["livelock"]:
            raise AssertionError(f"{name}: {row['livelock']} != "
                                 f"{c['livelock']}")
        return "livelock at increment %(increment)d cycle %(cycle)d" \
            % c["livelock"]
    if not (eng.values() == np.float32(c["values"])).all():
        raise AssertionError(f"{name}: values differ")
    if eng.vertex_object_stats() != c["vertex_object_stats"]:
        raise AssertionError(f"{name}: vertex_object_stats")
    return "values (== oracle) and vertex_object_stats"


def skew_replay_phases() -> dict:
    """Phase 21: ``src/repro_torch/data/skew_fingerprint.json``, the JAX
    engine's skew and lanes configs at ci and mid scale, replayed exactly
    on the cluster kernel: per-increment counters, values and
    ``vertex_object_stats`` of the rows that finish, the increment, cycle,
    chunk and counters of the livelocks."""
    t_all = time.time()
    out = {}
    for c in skew_records():
        if c["scale"] == "paper":
            continue                  # phase 22, on the one-block kernel
        key = (c["scale"], c["queue_cap"], c["lanes"], c["rhizome_cap"])
        name = "%s q=%d lanes=%d R=%d" % key
        cfg = pe.skew_config(*key)
        want_cfg = {k: v for k, v in c["cfg"].items()
                    if k in EngineConfig.__dataclass_fields__}
        if dataclasses.asdict(cfg) != want_cfg:
            raise AssertionError(f"21 {name}: config differs from the record")
        if ops.cluster_geometry(cfg) is None:
            raise AssertionError(f"21 {name}: no band fits")
        row, eng = pe.skew_row(*key)
        what = check_skew_row(f"21 {name}", row, eng, c)
        la = row["launches"]
        if la["block"] or not la["cluster"]:
            raise AssertionError(f"21 {name}: launches {la}")
        cycles = sum(r["cycles"] for r in row["increments"]) + (
            row["livelock"]["cycle"] if "livelock" in row else 0)
        out[name] = dict(status=row["status"], cycles=cycles,
                         launches=la["cluster"], wall_s=row["wall_s"])
        print(f"[21] {name}: {row['status']}, {cycles} cycles, counters and "
              f"{what} == the JAX engine's; {la['cluster']} launches on the "
              f"cluster kernel {ops.cluster_geometry(cfg)}, wall "
              f"{row['wall_s']:.4f}s ({1e3 * row['wall_s'] / la['cluster']:.4f}"
              f" ms a launch, host clock)", flush=True)
    # the ported benchmarks themselves: bench_lanes at ci against
    # results/bench_lanes.json (the JAX package's run), bench_skew's ci
    # rows, and bench_lanes at mid, which stops at its lanes-smoke gate
    rows, base = pe.bench_lanes("ci")
    want = json.loads((ROOT / "results" / "bench_lanes.json").read_text())[
        "lanes_ci"]
    if rows != want["rows"] or base != want["oversize_baseline"]:
        raise AssertionError(f"21 bench_lanes ci: {rows} {base} != {want}")
    skew = pe.bench_skew("ci")
    print(f"[21] bench_lanes ci == results/bench_lanes.json: "
          f"{json.dumps(rows)}, baseline {json.dumps(base)}; bench_skew ci: "
          f"{json.dumps(skew)}", flush=True)
    try:
        pe.bench_lanes("mid")
        raise AssertionError("21 bench_lanes mid passed its gate")
    except SystemExit as ex:
        print(f"[21] bench_lanes mid stops at its gate, as the JAX "
              f"package's does: {ex}", flush=True)
    out["bench_skew_ci"] = skew
    print(f"[21] done in {time.time() - t_all:.1f}s", flush=True)
    return out


SKEW_PAPER_ROWS = (4, 2, 1)            # rhizome_cap, lanes=2, queue_cap 48
SKEW_PAPER_MAX_CYCLES = 600_000        # a row's budget, each increment


def skew_paper_phases() -> dict:
    """Phase 22: ``bench_skew``'s rows at the paper's 32x32 (16,384
    vertices, 262,144 R-MAT edges) on the one-block kernel, since no band
    fits; each row ``ok`` with BFS == oracle, ``livelock`` or ``budget``.
    The counts are set to 0 just before each row and read just after."""
    rows = {}
    records = {c["rhizome_cap"]: c for c in skew_records()
               if c["scale"] == "paper"}
    for R in SKEW_PAPER_ROWS:
        cfg = pe.skew_config("paper", rhizome_cap=R)
        st0 = init_state(cfg, device="meta")
        mutable = sum(t.numel() * t.element_size()
                      for k, t in st0._asdict().items() if k != "io_edges")
        bound_ms = 1e3 * 2 * mutable / H100_BYTES_PER_S
        events = []
        ops.launches = 0
        ops.path_launches = dict.fromkeys(ops.PATHS, 0)
        with timed_launches(events):
            row, eng = pe.skew_row("paper", rhizome_cap=R,
                                   max_cycles=SKEW_PAPER_MAX_CYCLES)
        la = dict(ops.path_launches)
        if la["cluster"] or not la["block"] or la != row["launches"]:
            raise AssertionError(f"22 R={R}: launches {la}")
        held = "no JAX record"
        if R in records:
            held = check_skew_row(f"22 R={R}", row, eng, records[R]) \
                + " == the JAX engine's"
        kern_ms = sum(a.elapsed_time(b) for a, b in events)
        stats = eng.vertex_object_stats()
        cycles = row["cycles"] + (row["livelock"]["cycle"]
                                  if "livelock" in row else 0)
        row.update(vertex_object_stats=stats, kernel_ms=kern_ms,
                   ms_per_launch=kern_ms / la["block"], bound_ms=bound_ms,
                   mutable_mib=mutable / 2 ** 20, all_cycles=cycles)
        rows[R] = row
        print(f"[22] paper skew rhizome_cap={R}: {row['status']}"
              + (" at increment %(increment)d cycle %(cycle)d" %
                 row["livelock"] if "livelock" in row else "")
              + f", {cycles} cycles ({[r['cycles'] for r in row['increments']]}"
              f" by increment), {row['hops']} hops, {row['stalls']} stalls "
              f"in the increments that finished; rhizomes "
              f"{stats['rhizomes']} on {stats['multi_root_vertices']} "
              f"vertices, max fan-out {stats['max_fanout']}, ghosts "
              f"{stats['ghosts']}; launches {la} (one-block kernel); wall "
              f"{row['wall_s']:.3f}s (host clock), kernel "
              f"{kern_ms / 1e3:.3f}s by CUDA events, "
              f"{kern_ms / la['block']:.4f} ms a launch "
              f"({1e6 * kern_ms / max(cycles, 1):.1f} ns a cycle) beside "
              f"the bound {bound_ms:.4f} ms a launch (2 x "
              f"{mutable / 2 ** 20:.1f} MiB over 3.35 TB/s)"
              + ("; BFS == oracle" if row["status"] == "ok" else "")
              + f"; counters and {held}", flush=True)
        del eng
        torch.cuda.empty_cache()
    return rows


TELEMETRY_FP = json.loads((ROOT / "src" / "repro_torch" / "data"
                           / "telemetry_fingerprint.json").read_text())
PINNED_SPEC = json.loads((ROOT / "tests" / "data"
                          / "pre_lanes_reference.json").read_text())["spec"]


def telemetry_phase_kernels(pinned, cfg_p, st) -> tuple[float, tuple]:
    """Phase 23: both cycle kernels' telemetry instances against the plain
    version, every leaf (the three planes included) and the record equal:
    (a) the pinned 8x8 stream chunk by chunk; (b) the 8x8 hub stream at
    lanes=4, rhizome_cap=4, its first 16 chunks; (c) phase 6's full-size
    state (the 32x32 paper config, lanes=1, the last increment), one K=512
    chunk.  Returns the max abs difference (0) and (c)'s config, input and
    plain result."""
    worst = 0.0
    cases = (("8x8 pinned", EngineConfig(**pinned["cfg"], telemetry=True),
              make_stream(StreamSpec(**pinned["spec"])), None),
             ("8x8 hub lanes=4 rhizome_cap=4",
              EngineConfig(**dict(HUB_KW, lanes=4, rhizome_cap=4),
                           telemetry=True), [pe.hub_stream(128, 200)], 16))
    for name, cfg, incs, max_chunks in cases:
        t0 = time.time()
        eng = StreamingEngine(cfg, "bfs")
        eng.seed(0, 0.0)
        d, st8, chunks, _ = chunks_vs_plain(f"23 {name}", cfg, BFS,
                                            eng.state, incs, max_chunks)
        worst = max(worst, d)
        print(f"[23] {name}, telemetry: both kernels == plain on every leaf "
              f"(planes included) and the record over {chunks} chunks; "
              f"sum of tm_cell {int(st8.tm_cell.sum())}, of tm_lane "
              f"{int(st8.tm_lane.sum())} (max |d| {worst}; "
              f"{time.time() - t0:.1f}s)", flush=True)
    t0 = time.time()
    cfg_t = dataclasses.replace(cfg_p, telemetry=True)
    like = init_state(cfg_t, device="meta")
    st_t = st._replace(**{k: torch.zeros(getattr(like, k).shape,
                                         dtype=torch.int32,
                                         device=st.aq.device)
                          for k in ("tm_cell", "tm_lane", "tm_hiw")})
    before = dict(ops.path_launches)
    d, s_plain_t, q = kernel_vs_plain(cfg_t, BFS, st_t, 512,
                                      ("cluster", "block"))
    if {p: ops.path_launches[p] - before[p] for p in ops.PATHS} != \
            {"cluster": 1, "block": 1}:
        raise AssertionError("23c: not one launch on each kernel")
    print(f"[23] 32x32 paper config, the last increment's state, telemetry: "
          f"one K=512 chunk, both kernels == plain on every leaf (planes "
          f"included; cycle {int(s_plain_t.cycle)}, quiescent {q}; "
          f"{time.time() - t0:.1f}s)", flush=True)
    return max(worst, d), (cfg_t, st_t, s_plain_t)


def telemetry_run(rec: dict):
    """One stream of the telemetry fingerprint through the engine on the
    card (``pe.telemetry_replay``).  Returns ``(record, engine)``."""
    return pe.telemetry_replay(rec, TELEMETRY_FP["max_cycles"], PINNED_SPEC)


def check_telemetry_record(name, got, rec) -> None:
    for k in ("increments", "livelock", "heatmap"):
        if got.get(k) != rec.get(k):
            raise AssertionError(f"{name}: {k} differs from the JAX "
                                 f"engine's: {got.get(k)} != {rec.get(k)}")


def telemetry_phase_replay() -> None:
    """Phase 24: ``src/repro_torch/data/telemetry_fingerprint.json`` (the
    JAX engine with telemetry on) replayed exactly on the cluster kernel:
    each increment's counters, frame count, ``dropped``, totals and the
    final frame's plane digests, ``bench_engine``'s ci heatmap, and each
    livelock's increment, cycle, chunk, frame log digests and full text
    (the wedge report included)."""
    t_all = time.time()
    for rec in TELEMETRY_FP["streams"]:
        if rec["args"][:1] == ["paper"]:
            continue                       # phase 25, one-block kernel
        t0 = time.time()
        before = dict(ops.path_launches)
        got, _ = telemetry_run(rec)
        check_telemetry_record(f"24 {rec['name']}", got, rec)
        la = {p: ops.path_launches[p] - before[p] for p in ops.PATHS}
        if la["block"] or not la["cluster"]:
            raise AssertionError(f"24 {rec['name']}: launches {la}")
        ll = got.get("livelock")
        print(f"[24] {rec['name']}: "
              f"{[r['cycles'] for r in got['increments']]} cycles, frames "
              f"{[r['frames'] for r in got['increments']]}"
              + (f", livelock at increment {ll['increment']} cycle "
                 f"{ll['cycle']} with {ll['frames']} frames and its wedge "
                 f"report" if ll else "")
              + (", the heatmap" if "heatmap" in got else "")
              + f" == the JAX engine's ({la['cluster']} launches on the "
              f"cluster kernel, {time.time() - t0:.1f}s)", flush=True)
    print(f"[24] done in {time.time() - t_all:.1f}s", flush=True)


def paper_stream_run(cfg, incs, events=None, launches=102, cycles=50_030):
    """The paper stream through the engine: per-increment results and the
    engine; ``events`` (a list) gets a pair of CUDA events around each
    launch; every run ``launches`` launches on the cluster kernel and
    ``cycles`` cycles (the 50K / 1M stream's by default)."""
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    before = dict(ops.path_launches)
    with timed_launches(events) if events is not None \
            else contextlib.nullcontext():
        res = [eng.run_increment(e, max_cycles=2_000_000) for e in incs]
    torch.cuda.synchronize()
    la = {p: ops.path_launches[p] - before[p] for p in ops.PATHS}
    got = sum(r.cycles for r in res)
    if la != {"block": 0, "cluster": launches} or got != cycles:
        raise AssertionError(f"paper stream telemetry={cfg.telemetry}, "
                             f"faults={cfg.faults}: launches {la}, {got} "
                             f"cycles")
    return res, eng


def profiler_error(step) -> str | None:
    """Run one step of ``torch.profiler``; the reason it failed, if it
    did."""
    try:
        step()
    except Exception as ex:      # the profiler, not the run: not measured
        return f"{type(ex).__name__}: {ex}"
    return None


def device_idle_share(fn) -> dict:
    """Run ``fn`` under ``torch.profiler`` (CPU and CUDA activity) and
    return its wall, the device time of its kernels and copies (the sum of
    their self device times; one stream, so they do not overlap) and the
    idle share 1 - device / wall; the profiler's own host cost inflates
    the wall, so the share is an upper bound.  An exception of ``fn``
    propagates; where the profiler itself fails or its trace holds no
    device time, the share is not measured and the reason is returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    err = profiler_error(prof.start)
    if err:
        return dict(idle_share=None, reason=err)
    t0 = time.time()
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        wall = time.time() - t0
        err = profiler_error(prof.stop)
    if err:
        return dict(idle_share=None, reason=err)
    dev_us = []
    err = profiler_error(lambda: dev_us.append(sum(
        getattr(e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0))
        for e in prof.key_averages() if e.device_type == DeviceType.CUDA)))
    if err or not dev_us[0]:
        return dict(idle_share=None,
                    reason=err or "no device time in the trace")
    return dict(wall_s=wall, device_s=dev_us[0] / 1e6,
                idle_share=1 - dev_us[0] / 1e6 / wall)


def telemetry_phase_paths(incs, cfg_p, plain_rows, want) -> dict:
    """Phase 25: the three paths with telemetry at full width, each with
    the counts set to 0 just before it and read just after: (a) the paper
    stream (50K / 1M) in turns without and with telemetry (off, on, on,
    off; CUDA events around every launch): every run 102 launches on the
    cluster kernel and 50,030 cycles, the runs with telemetry equal to
    phase 5's counters increment by increment, every increment's final
    frame reconciling exactly, BFS == oracle; (b) ``bench_skew``'s
    rhizome_cap=4 row at paper scale on the one-block kernel: its
    ``LivelockError`` carries the frame log and the text, wedge report
    included, of the JAX engine's (the telemetry fingerprint); (c)
    ``bench_engine("ci", profile=True)``: its heatmap equal to
    ``results/profile/heatmap_jnp.json`` in every field but ``cycles``,
    208 as the live JAX engine gives."""
    out = {}
    cfg_t = dataclasses.replace(cfg_p, telemetry=True)
    turns = {False: [], True: []}
    for tm in (False, True, True, False):
        ops.launches = 0
        ops.path_launches = dict.fromkeys(ops.PATHS, 0)
        events = []
        t0 = time.time()
        res, eng = paper_stream_run(cfg_t if tm else cfg_p, incs, events)
        wall = time.time() - t0
        la = dict(ops.path_launches)
        cycles = sum(r.cycles for r in res)
        ms = sum(a.elapsed_time(b) for a, b in events) / len(events)
        turns[tm].append(ms)
        if tm:
            rows = [dict(cycles=r.cycles, hops=r.hops, execs=r.execs,
                         stalls=r.stalls, allocs=r.allocs) for r in res]
            if rows != plain_rows:
                raise AssertionError(f"25a: {rows} != {plain_rows}")
            for r, e in zip(res, incs):
                pe.check_frames(r, len(e))
            assert (eng.values() == want).all(), "25a: BFS != oracle"
            frames = [len(r.frames) for r in res]
        print(f"[25] paper stream telemetry={tm}: {cycles} cycles, launches "
              f"{la}, {ms:.4f} ms a launch by CUDA events, wall {wall:.3f}s "
              f"(host clock, the engine's set-up included)"
              + (f"; counters == phase 5's, every final frame reconciles "
                 f"(frames by increment {frames}), BFS == oracle"
                 if tm else ""), flush=True)
        del eng, res
    out["paper_stream_ms"] = dict(off=turns[False], on=turns[True])
    out["paper_stream_launches"] = 102
    out["idle"] = {}
    for tm in (False, True):
        idle = device_idle_share(
            lambda: paper_stream_run(cfg_t if tm else cfg_p, incs))
        out["idle"]["on" if tm else "off"] = idle
        print(f"[25] paper stream telemetry={tm} under torch.profiler: "
              + (f"wall {idle['wall_s']:.3f}s, device {idle['device_s']:.3f}"
                 f"s, idle share {idle['idle_share']:.4f} (the engine's "
                 f"set-up included; an upper bound)"
                 if idle["idle_share"] is not None
                 else f"idle share not measured: {idle['reason']}"),
              flush=True)
    print(f"[25] paper stream in turns off, on, on, off: "
          f"{turns[False][0]:.4f} / {turns[True][0]:.4f} / "
          f"{turns[True][1]:.4f} / {turns[False][1]:.4f} ms a launch: "
          f"telemetry {np.mean(turns[True]) / np.mean(turns[False]):.4f}x",
          flush=True)
    torch.cuda.empty_cache()
    # (b) the paper-scale skew row, R = 4, with telemetry
    rec = next(r for r in TELEMETRY_FP["streams"]
               if r["args"][:1] == ["paper"])
    ops.launches = 0
    ops.path_launches = dict.fromkeys(ops.PATHS, 0)
    t0 = time.time()
    got, eng = telemetry_run(rec)
    wall = time.time() - t0
    la = dict(ops.path_launches)
    if la["cluster"] or not la["block"]:
        raise AssertionError(f"25b: launches {la}")
    check_telemetry_record("25b paper skew R=4", got, rec)
    ll = got["livelock"]
    print(f"[25] paper skew rhizome_cap=4, telemetry: livelock at increment "
          f"{ll['increment']} cycle {ll['cycle']} chunk {ll['chunk']}, "
          f"{ll['frames']} frames, the frame digests and the error's text "
          f"== the JAX engine's; launches {la} (one-block kernel), wall "
          f"{wall:.3f}s (host clock). Its report:\n"
          + "\n".join(ll["message"].splitlines()[1:4]), flush=True)
    out["skew_paper"] = dict(launches=la["block"], cycle=ll["cycle"],
                             frames=ll["frames"], wall_s=wall)
    del eng
    torch.cuda.empty_cache()
    # (c) the ci profile of bench_engine
    ops.launches = 0
    ops.path_launches = dict.fromkeys(ops.PATHS, 0)
    prof_dir = ROOT / "build" / "profile"
    got = pe.bench_engine("ci", profile=True, profile_dir=prof_dir)
    prof = got["profile"]
    heat = json.loads(pathlib.Path(prof["heatmap"]).read_text())
    want_heat = json.loads((ROOT / "results" / "profile"
                            / "heatmap_jnp.json").read_text())
    if heat["cycles"] != 208 or {k: v for k, v in heat.items()
                                 if k != "cycles"} != \
            {k: v for k, v in want_heat.items() if k != "cycles"}:
        raise AssertionError("25c: the heatmap differs from "
                             "results/profile/heatmap_jnp.json")
    la = dict(ops.path_launches)
    if la["block"] or not la["cluster"]:
        raise AssertionError(f"25c: launches {la}")
    print(f"[25] bench_engine ci profile: heatmap == results/profile/"
          f"heatmap_jnp.json but cycles (208, the file's 464); "
          f"{prof['frames']} frames, rates {json.dumps(prof['rates'])}; "
          f"wall {prof['wall_s']:.4f}s with telemetry, "
          f"{prof['wall_vs_plain']:.3f}x the plain run's {got['wall_s']:.4f}s"
          f" (host clock); launches {la}; dumps in {prof_dir}", flush=True)
    out["engine_ci_profile"] = dict(frames=prof["frames"],
                                    rates=prof["rates"],
                                    wall_s=prof["wall_s"],
                                    wall_vs_plain=prof["wall_vs_plain"])
    return out


def telemetry_phase_cost(cfg_t, st_t, s_plain_t, cfg_p, st, s_plain) -> dict:
    """Phase 26: telemetry's cost on phase 6's K=512 chunk on the cluster
    kernel, in turns (off, on, on, off; CUDA events), each equal to its
    plain version."""
    turns = {False: [], True: []}
    for tm in (False, True, True, False):
        cfg, s0, want = (cfg_t, st_t, s_plain_t) if tm else \
            (cfg_p, st, s_plain)
        s = clone(s0)
        before = dict(ops.path_launches)
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        a.record()
        s2, _ = ops.cca_cycle_chunk(cfg, BFS, s, 512, path="cluster")
        b.record()
        torch.cuda.synchronize()
        on_path(before, "cluster", 1)
        leaf_diff(s2, want)
        turns[tm].append(a.elapsed_time(b))
    ratio = np.mean(turns[True]) / np.mean(turns[False])
    print(f"[26] full-size K=512 chunk on the cluster kernel in turns off, "
          f"on, on, off: {turns[False][0]:.4f} / {turns[True][0]:.4f} / "
          f"{turns[True][1]:.4f} / {turns[False][1]:.4f} ms: telemetry "
          f"{ratio:.4f}x; each == plain on every leaf", flush=True)
    return dict(chunk_ms=dict(off=turns[False], on=turns[True]),
                chunk_ratio=ratio)


# ---- faults, seals and repair (phases 27-30) ----

FAULT_FP = json.loads((ROOT / "src" / "repro_torch" / "data"
                       / "fault_fingerprint.json").read_text())
# the JAX package's tests/test_resilience.py: its hub config and plan
FAULT_HUB_KW = dict(height=8, width=8, n_vertices=256, edge_cap=8,
                    ghost_slots=24, queue_cap=32, chan_cap=16, chunk=64,
                    lanes=2, max_cycles=200_000)
HUB_PLAN = FaultPlan(seed=7, drop_rate=0.05, dup_rate=0.03,
                     corrupt_rate=0.02)
# the paper stream's plan: drop, dup and corrupt at 4, 2 and 2 per cent,
# the W link out of cell (0, 1) dead for the first 512 cycles; and the
# plan fixed in advance for a livelock under it, the same without dups
PAPER_PLAN = FaultPlan(seed=7, drop_rate=0.04, dup_rate=0.02,
                       corrupt_rate=0.02, blackouts=((0, 1, DIR_W, 0, 512),))
PAPER_PLAN_NO_DUP = dataclasses.replace(PAPER_PLAN, dup_rate=0.0)
# the mid stream (10K / 100K, ten increments) on the paper config: its
# launches and cycles clean and under PAPER_PLAN (repairs included)
MID_STREAM = {"clean": (20, 7049), "faulty": (38, 14869)}
def fault_phase_kernels(pinned, cfg_p, st) -> tuple[float, tuple]:
    """Phase 27: the fault instances of both cycle kernels, telemetry on
    and off, against one run of the plain version with telemetry on
    (``kernel_vs_plain(also_without_telemetry=True)``): (a) the pinned
    8x8 stream (lanes=1) under drop, dup and corrupt, chunk by chunk; (b)
    the hub stream of ``tests/test_resilience.py`` (lanes=2) under its
    plan, 16 chunks; (c) phase 6's full-size state (the 32x32 paper
    config, the last increment loaded) under the paper plan with the
    blackout window moved onto its cycles, one K=512 chunk; (d) the 8x8
    hub stream at rhizome_cap=4 under drop, run to quiescence on the
    kernel without its repair, then the repair's sentinel rows loaded and
    run chunk by chunk under the plan's safe twin.  Returns the max abs
    difference (0) and (c)'s config, input and plain result."""

    def chunks(name, cfg, st, incs, max_chunks=None):
        t0 = time.time()
        d, st, n, _ = chunks_vs_plain(f"27 {name}", cfg, BFS, st, incs,
                                      max_chunks, also_without_telemetry=True)
        print(f"[27] {name}: the fault instances of both kernels, telemetry "
              f"on and off, == plain on every leaf and the record over {n} "
              f"chunks (cycle {int(st.cycle)}); flt {st.flt.tolist()} in the "
              f"last increment (max |d| {d}; {time.time() - t0:.1f}s)",
              flush=True)
        return d

    cfg = EngineConfig(**pinned["cfg"], telemetry=True,
                       faults=dataclasses.replace(HUB_PLAN, seed=5))
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    worst = chunks("(a) 8x8 pinned lanes=1", cfg, eng.state,
                   make_stream(StreamSpec(**pinned["spec"])))
    cfg = EngineConfig(**FAULT_HUB_KW, telemetry=True, faults=HUB_PLAN)
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    worst = max(worst, chunks("(b) 8x8 hub lanes=2", cfg, eng.state,
                              [pe.hub_stream()], 16))
    t0 = time.time()
    c0 = int(st.cycle)
    cfg_f = dataclasses.replace(cfg_p, telemetry=True, faults=dataclasses
                                .replace(PAPER_PLAN, blackouts=(
                                    (0, 1, DIR_W, c0, 512),)))
    like = init_state(cfg_f, device="meta")
    st_f = st._replace(**{k: torch.zeros(getattr(like, k).shape,
                                         dtype=torch.int32,
                                         device=st.aq.device)
                          for k in TM_LEAVES + ("flt",)})
    before = dict(ops.path_launches)
    d, s_plain_f, q = kernel_vs_plain(cfg_f, BFS, st_f, 512,
                                      ("cluster", "block"),
                                      also_without_telemetry=True)
    if {p: ops.path_launches[p] - before[p] for p in ops.PATHS} != \
            {"cluster": 2, "block": 2}:
        raise AssertionError("27c: not two launches on each kernel")
    flt = s_plain_f.flt.tolist()
    if min(flt) == 0:
        raise AssertionError(f"27c: a hazard never fired: flt {flt}")
    worst = max(worst, d)
    print(f"[27] (c) 32x32 paper config, the last increment's state, the "
          f"paper plan with its blackout over cycles {c0}..{c0 + 511}: one "
          f"K=512 chunk, the fault instances of both kernels, telemetry on "
          f"and off, == plain on every leaf (flt {flt}; cycle "
          f"{int(s_plain_f.cycle)}, quiescent {q}; {time.time() - t0:.1f}s)",
          flush=True)
    cfg = EngineConfig(rhizome_cap=4, **RHIZOME_KW, telemetry=True,
                       faults=FaultPlan(seed=3, drop_rate=0.05))
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    eng.state, spill = load_stream(cfg, eng.state, pe.hub_stream(64, 40))
    eng.state = fresh_stats(eng.state)
    eng._passes(cfg, spill, 200_000, [])
    entries = eng._repair_entries()
    secondary = int((entries[:, 1] < -1).sum())
    if not eng._loss_count() or not secondary:
        raise AssertionError(f"27d: lost {eng._loss_count()}, {secondary} "
                             f"sentinel rows for secondary roots")
    safe = dataclasses.replace(cfg, faults=cfg.faults.safe())
    st_r, spill = load_stream(safe, eng.state, entries)
    assert len(spill) == 0
    worst = max(worst, chunks(
        f"(d) 8x8 hub rhizome_cap=4, {len(entries)} repair rows "
        f"({secondary} to secondary roots) under the safe plan", safe,
        st_r, [None]))
    return worst, (cfg_f, st_f, s_plain_f)


def check_fault_record(name, got, rec) -> None:
    if got.get("livelock") != rec.get("livelock"):
        raise AssertionError(f"{name}: livelock {got.get('livelock')} != "
                             f"the JAX engine's {rec.get('livelock')}")
    if got["increments"] != rec["increments"]:
        for i, (a, b) in enumerate(zip(got["increments"],
                                       rec["increments"])):
            diff = sorted(k for k in b if a.get(k) != b[k])
            diff += sorted(f"state.{k}" for k in b["state"]
                           if a["state"].get(k) != b["state"][k])
            if diff:
                raise AssertionError(f"{name}: increment {i} differs from "
                                     f"the JAX engine's in {diff}")
        raise AssertionError(f"{name}: {len(got['increments'])} increments, "
                             f"the JAX engine's {len(rec['increments'])}")


def fault_phase_replay() -> dict:
    """Phase 28: ``src/repro_torch/data/fault_fingerprint.json`` (the JAX
    engine under fault plans) replayed exactly on the cluster kernel:
    each increment's cycles, counters, ``flt``, frame count and the digest
    of every leaf of its final state, and the livelock of the 32x32 row at
    20K vertices / 400K edges under the paper plan (its increment, cycle,
    chunk and ``flt``: the repair pass's flood, phase 29's at a size the
    JAX engine replays on a CPU); then
    ``fault_smoke`` at ci and mid, its record's cycles and counts those of
    the fingerprint's smoke rows."""
    t_all, smokes = time.time(), {}
    for rec in FAULT_FP["streams"]:
        t0 = time.time()
        before = dict(ops.path_launches)
        got, _ = pe.fault_replay(rec, PINNED_SPEC)
        check_fault_record(f"28 {rec['name']}", got, rec)
        la = {p: ops.path_launches[p] - before[p] for p in ops.PATHS}
        if la["block"] or not la["cluster"]:
            raise AssertionError(f"28 {rec['name']}: launches {la}")
        rows, ll = got["increments"], got.get("livelock")
        print(f"[28] {rec['name']}: {[r['cycles'] for r in rows]} cycles, "
              f"flt {[r['flt'] for r in rows]}, frames "
              f"{[r['frames'] for r in rows]}, every final leaf"
              + (f", the livelock at increment {ll['increment']} cycle "
                 f"{ll['cycle']} (chunk {ll['chunk']}, flt {ll['flt']})"
                 if ll else "")
              + f" == the JAX engine's ({la['cluster']} launches on the "
              f"cluster kernel, {time.time() - t0:.1f}s)", flush=True)
    for scale in pe.ENGINE_SCALES:
        rec = next(r for r in FAULT_FP["streams"]
                   if r["kind"] == "smoke" and r["scale"] == scale)
        got = pe.fault_smoke(scale)
        want = [{k: r[k] for k in ("cycles", "flt", "frames")}
                for r in rec["increments"]]
        if [{k: r[k] for k in ("cycles", "flt", "frames")}
                for r in got["increments"]] != want:
            raise AssertionError(f"28 fault_smoke {scale}: "
                                 f"{got['increments']} != {want}")
        smokes[scale] = {k: got[k] for k in (
            "status", "cycles", "wall_s", "dropped", "duplicated",
            "corrupted", "blackout_hits")}
        print(f"[28] fault_smoke({scale!r}): {json.dumps(smokes[scale])}; "
              f"== the fingerprint", flush=True)
    print(f"[28] done in {time.time() - t_all:.1f}s", flush=True)
    return smokes


@contextlib.contextmanager
def keep_inputs(ring: collections.deque):
    """While the block runs, every cycle-kernel launch through
    ``ops.cca_cycle_chunk`` first appends its config and a copy of its
    input state to ``ring`` (a bounded deque): after a livelock, its
    oldest entry is the chunk in which the machine wedged."""
    launch = ops.cca_cycle_chunk

    def kept(cfg, app, st, *a, **kw):
        ring.append((cfg, clone(st)))
        return launch(cfg, app, st, *a, **kw)

    ops.cca_cycle_chunk = kept
    try:
        yield
    finally:
        ops.cca_cycle_chunk = launch


def faulty_stream(cfg, incs, want) -> dict:
    """A stream under ``cfg``'s plan on the engine, the counts set to 0
    just before and read just after: per increment the cycles (the
    repair's included), ``flt``, whether the repair ran and (telemetry)
    departures less deliveries, which must equal ``FLT_DROP``; launches by
    kernel, all on the cluster kernel; BFS == oracle.  On a
    ``LivelockError`` the record has ``livelock`` (increment, cycle,
    chunk, whether in the repair pass, with telemetry the head of the
    flight recorder's report) and, under ``wedged``, the config
    and input of the chunk in which the machine wedged (the last with
    progress, ``LIVELOCK_CHUNKS`` launches before the error)."""
    ops.launches = 0
    ops.path_launches = dict.fromkeys(ops.PATHS, 0)
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    rows, out = [], {}
    ring = collections.deque(maxlen=LIVELOCK_CHUNKS + 1)
    torch.cuda.synchronize()
    t0 = time.time()
    with keep_inputs(ring):
        for i, e in enumerate(incs):
            try:
                r = eng.run_increment(e, max_cycles=2_000_000)
            except LivelockError as ex:
                out.update(livelock=dict(
                    increment=i, cycle=ex.cycle, chunk=ex.chunk,
                    in_repair=ring[-1][0].faults == cfg.faults.safe(),
                    flt=eng.state.flt.tolist(),
                    report=str(ex).splitlines()[1:4]), wedged=ring[0])
                break
            row = dict(cycles=r.cycles, hops=r.hops,
                       flt=eng.state.flt.tolist(),
                       repaired=pe.lost(eng) > 0)
            if cfg.telemetry:
                row["gap"] = int(eng.state.stat_hops
                                 - eng.state.tm_cell[..., TM_HOP].sum())
                if row["gap"] != row["flt"][FLT_DROP]:
                    raise AssertionError(
                        f"29 increment {i}: departures less deliveries "
                        f"{row['gap']} != FLT_DROP of {row['flt']}")
            rows.append(row)
        torch.cuda.synchronize()
    out.update(wall_s=time.time() - t0, increments=rows,
               cycles=sum(r["cycles"] for r in rows),
               launches=dict(ops.path_launches))
    if out["launches"]["block"] or not out["launches"]["cluster"]:
        raise AssertionError(f"29: launches {out['launches']}")
    if "livelock" not in out and not (eng.values() == want).all():
        raise AssertionError("29: BFS != oracle")
    return out


def fault_phase_paths(cfg_p, incs, want) -> dict:
    """Phase 29: the paper stream (50K / 1M) under ``PAPER_PLAN`` on the
    cluster kernel, telemetry off and on (``faulty_stream``): it loses
    messages and repairs them, ending with BFS == oracle.  Should it
    livelock, that is recorded, not hidden: the increment, the cycle,
    whether in the repair pass, and under ``PAPER_PLAN`` the fault
    instances of both kernels held against the plain version on the chunk
    in which it wedged (the telemetry run's); and the path runs again
    under ``PAPER_PLAN_NO_DUP``, fixed in advance."""
    out = {}
    for name, plan in (("paper", PAPER_PLAN),
                       ("paper without dups", PAPER_PLAN_NO_DUP)):
        for tm in (False, True):
            key = f"{name}, telemetry={'on' if tm else 'off'}"
            r = faulty_stream(dataclasses.replace(cfg_p, faults=plan,
                                                  telemetry=tm), incs, want)
            rows = r["increments"]
            ll = r.get("livelock")
            lost = sum(x["flt"][FLT_DROP] + x["flt"][FLT_CORRUPT]
                       for x in rows) + (ll["flt"][FLT_DROP]
                                         + ll["flt"][FLT_CORRUPT]
                                         if ll else 0)
            if not lost:
                raise AssertionError(f"29 {key}: no message lost")
            print(f"[29] {key}: "
                  + (f"LIVELOCK at increment {ll['increment']}, cycle "
                     f"{ll['cycle']} (chunk {ll['chunk']}), "
                     f"{'in' if ll['in_repair'] else 'before'} its repair "
                     f"pass, flt {ll['flt']}; before it " if ll else "")
                  + f"{r['cycles']} cycles (repairs included) in "
                  f"{r['launches']} launches, wall {r['wall_s']:.3f}s (host "
                  f"clock, set-up included); by increment: cycles "
                  f"{[x['cycles'] for x in rows]}, flt "
                  f"{[x['flt'] for x in rows]}, repaired "
                  f"{[x['repaired'] for x in rows]}"
                  + ("; departures - deliveries == FLT_DROP in each"
                     if tm else "")
                  + ("" if ll else "; BFS == oracle"), flush=True)
            if ll and tm:
                print("\n".join(f"[29]   {x}" for x in ll["report"]),
                      flush=True)
            if ll and tm and plan is PAPER_PLAN:
                t0 = time.time()
                cfg_w, st_w = r["wedged"]
                d, s_w, _ = kernel_vs_plain(cfg_w, BFS, st_w,
                                            paths=("cluster", "block"),
                                            also_without_telemetry=True)
                print(f"[29] {key}: the chunk in which it wedged (cycle "
                      f"{int(st_w.cycle)}..{int(s_w.cycle) - 1}): the fault "
                      f"instances of both kernels, telemetry on and off, == "
                      f"plain on every leaf (max |d| {d}; "
                      f"{time.time() - t0:.1f}s)", flush=True)
            r.pop("wedged", None)
            out[key] = r
        if not any("livelock" in v for v in out.values()):
            break
    return out


SEALED = ("aq", "ch", "pk", "cmsg")    # leaves that hold sealed messages


def same_but_seals(a, b) -> None:
    """Raise unless states ``a`` and ``b`` are equal but for the seal word
    (word 4) of the messages they hold and ``flt``: what a zero-rate plan
    may change."""
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if name == "flt":
            continue
        if name in SEALED:
            x, y = x[..., :4], y[..., :4]
        if not torch.equal(x, y):
            raise AssertionError(f"leaf {name!r} differs beyond the seals")


def fault_phase_cost(incs, cfg_p, st, s_plain, cfg_f, st_f, s_plain_f
                     ) -> dict:
    """Phase 30: what faults cost on the card, in turns (CUDA events).
    (a) The paper stream without faults and under a zero-rate plan (off,
    zero, zero, off): ms a launch, the same 102 launches, 50,030 cycles
    and values in every run.  (b) Phase 6's K=512 chunk on the cluster
    kernel without faults, under the zero-rate plan and under phase 27c's
    paper plan (off, zero, faulty, faulty, zero, off): without faults and
    faulty each equal to its plain version, the zero-rate run to the run
    without faults but for the seals.  (c) The faulty stream against the
    clean one, wall and cycles, in turns (clean, faulty, faulty, clean),
    both through ``paper_stream_run`` (the same code and no reads between
    increments; each run's counts set to 0 before it), on the paper config
    at the paper experiments' mid scale (10K vertices, 100K edges, ten
    increments), the largest scale whose faulty stream does not livelock
    (phase 29)."""
    out = {}
    zero = dataclasses.replace(cfg_p, faults=FaultPlan(seed=7))
    turns = {"off": [], "zero": []}
    want = None
    for which in ("off", "zero", "zero", "off"):
        ops.launches = 0
        ops.path_launches = dict.fromkeys(ops.PATHS, 0)
        events = []
        res, eng = paper_stream_run(zero if which == "zero" else cfg_p,
                                    incs, events)
        turns[which].append(sum(a.elapsed_time(b) for a, b in events)
                            / len(events))
        vals = eng.values()
        if want is None:
            want = vals
        elif not (vals == want).all():
            raise AssertionError("30a: values differ between the runs")
        if which == "zero" and sum(eng.state.flt.tolist()):
            raise AssertionError("30a: a zero-rate plan injected faults")
        del eng, res
    ratio = np.mean(turns["zero"]) / np.mean(turns["off"])
    print(f"[30] paper stream in turns off, zero-rate, zero-rate, off: "
          f"{turns['off'][0]:.4f} / {turns['zero'][0]:.4f} / "
          f"{turns['zero'][1]:.4f} / {turns['off'][1]:.4f} ms a launch "
          f"(102 launches, 50,030 cycles each): the zero-rate plan "
          f"{ratio:.4f}x", flush=True)
    out["paper_stream_ms"] = turns
    out["zero_rate_ratio"] = ratio
    cfg_fo, st_fo = without_telemetry(cfg_f, st_f)
    want_f = s_plain_f._replace(**{k: getattr(st_fo, k) for k in TM_LEAVES})
    cases = {"off": (cfg_p, st), "zero": (zero, st_f._replace(
        **{k: getattr(st, k) for k in TM_LEAVES})), "faulty": (cfg_fo, st_fo)}
    chunk = {k: [] for k in cases}
    kept = {}
    for which in ("off", "zero", "faulty", "faulty", "zero", "off"):
        cfg, s0 = cases[which]
        s = clone(s0)
        before = dict(ops.path_launches)
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        a.record()
        s2, _ = ops.cca_cycle_chunk(cfg, BFS, s, 512, path="cluster")
        b.record()
        torch.cuda.synchronize()
        on_path(before, "cluster", 1)
        chunk[which].append(a.elapsed_time(b))
        kept[which] = s2
        if which == "off":
            leaf_diff(s2, s_plain)
        elif which == "faulty":
            leaf_diff(s2, want_f)
    same_but_seals(kept["zero"], kept["off"])
    off_ms = np.mean(chunk["off"])
    print(f"[30] full-size K=512 chunk on the cluster kernel in turns off, "
          f"zero-rate, faulty, faulty, zero-rate, off: off "
          f"{chunk['off'][0]:.4f} / {chunk['off'][1]:.4f} ms, zero-rate "
          f"{chunk['zero'][0]:.4f} / {chunk['zero'][1]:.4f} ms "
          f"({np.mean(chunk['zero']) / off_ms:.4f}x), faulty "
          f"{chunk['faulty'][0]:.4f} / {chunk['faulty'][1]:.4f} ms "
          f"({np.mean(chunk['faulty']) / off_ms:.4f}x); off and faulty == "
          f"plain on every leaf, zero-rate == off but for the seals",
          flush=True)
    out["chunk_ms"] = chunk
    mid = pe.SCALES["mid"]
    incs_mid = make_stream(StreamSpec(increments=10, sampling="edge", seed=1,
                                      **mid))
    want_mid = bfs_levels(mid["n_vertices"], np.concatenate(incs_mid), 0)
    cfg_mid = paper_cfg(**mid)
    runs = {"clean": [], "faulty": []}
    for which in ("clean", "faulty", "faulty", "clean"):
        faulty = which == "faulty"
        ops.launches = 0
        ops.path_launches = dict.fromkeys(ops.PATHS, 0)
        torch.cuda.synchronize()
        t0 = time.time()
        _, eng = paper_stream_run(
            dataclasses.replace(cfg_mid, faults=PAPER_PLAN) if faulty
            else cfg_mid, incs_mid, None, *MID_STREAM[which])
        wall = time.time() - t0
        if not (eng.values() == want_mid).all():
            raise AssertionError(f"30c: the {which} mid stream's BFS != "
                                 f"oracle")
        if faulty:
            flt = eng.state.flt.tolist()
            if not flt[FLT_DROP]:
                raise AssertionError(f"30c: no drop in the last increment "
                                     f"({flt})")
        runs[which].append(wall)
        del eng
    (c_la, c_cy), (f_la, f_cy) = MID_STREAM["clean"], MID_STREAM["faulty"]
    out["faulty_vs_clean_mid"] = dict(
        clean_cycles=c_cy, faulty_cycles=f_cy, clean_launches=c_la,
        faulty_launches=f_la, clean_wall_s=runs["clean"],
        faulty_wall_s=runs["faulty"])
    print(f"[30] mid stream (10K / 100K on the 32x32 paper config) in turns "
          f"clean, faulty, faulty, clean, each through paper_stream_run: "
          f"{c_cy} / {f_cy} cycles ({f_cy / c_cy:.4f}x), {c_la} / {f_la} "
          f"launches, wall {runs['clean'][0]:.4f} / {runs['faulty'][0]:.4f} "
          f"/ {runs['faulty'][1]:.4f} / {runs['clean'][1]:.4f}s "
          f"({np.mean(runs['faulty']) / np.mean(runs['clean']):.4f}x; host "
          f"clock, the engine's set-up included, ends in synchronize); BFS "
          f"== oracle in every run, the faulty one's after its repairs (flt "
          f"of its last increment {flt})", flush=True)
    return out


# ---- durable state, recovery and the ingest guard (phases 31-35) ----

RESILIENCE_FP = json.loads((ROOT / "src" / "repro_torch" / "data"
                            / "resilience_fingerprint.json").read_text())
CKPT_DIR = ROOT / "build" / "ckpt"    # checkpoints, removed after each run


def reset_counts() -> None:
    ops.launches = 0
    ops.path_launches = dict.fromkeys(ops.PATHS, 0)


def since(before: dict) -> dict:
    return {p: ops.path_launches[p] - before[p] for p in ops.PATHS}


def save_stats(ck) -> dict:
    """The newest save of ``ck`` once written: bytes, host snapshot and
    writer-thread seconds."""
    ck.wait()
    return dict(ck.last)


def resilience_phase_resume(cfg_p, incs, eng5, want) -> dict:
    """Phase 31: kill and resume at full size.  The paper stream on the
    paper config with an async checkpoint before each of increments 0-4
    and a blocking one after them (step 5); the engine dropped; a new one
    restored from step 5 replays increments 5-9: every leaf, the totals
    and ``total_cycles`` equal to phase 5's uninterrupted run, the 102
    launches and 50,030 cycles of the whole stream, all on the cluster
    kernel, BFS the oracle's.  Each checkpoint's bytes, host snapshot and
    writer-thread write seconds, and the restore's.  Then
    ``kill_resume_smoke("ci")``: totals 41,157 / 7,868 / 14 / 109."""
    import tempfile
    from repro_torch.train import Checkpointer
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=CKPT_DIR) as d:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        eng = StreamingEngine(cfg_p, "bfs")
        eng.seed(0, 0.0)
        ck, saves = Checkpointer(d), []
        for i, e in enumerate(incs[:5]):
            if i:
                saves.append(save_stats(ck))
            eng.run_increment(e, ckpt=ck, max_cycles=2_000_000)
        saves.append(save_stats(ck))
        eng.checkpoint(ck)                     # the boundary after 0-4
        saves.append(save_stats(ck))
        del eng                                # the "kill"
        torch.cuda.synchronize()
        t1 = time.time()
        res = StreamingEngine.restore(cfg_p, "bfs", Checkpointer(d))
        torch.cuda.synchronize()
        restore_s = time.time() - t1
        if res.stream_pos != 5:
            raise AssertionError(f"31: restored at {res.stream_pos}, not 5")
        for e in incs[5:]:
            res.run_increment(e, max_cycles=2_000_000)
        torch.cuda.synchronize()
        wall = time.time() - t0
    la = dict(ops.path_launches)
    if la != {"block": 0, "cluster": 102} or res.total_cycles != 50_030:
        raise AssertionError(f"31: launches {la}, {res.total_cycles} "
                             f"cycles, not 102 and 50,030")
    leaf_diff(res.state, eng5.state)
    if (res.totals, res.total_cycles) != (eng5.totals, eng5.total_cycles):
        raise AssertionError(f"31: totals {res.totals} != {eng5.totals}")
    if not (res.values() == want).all():
        raise AssertionError("31: BFS != oracle after the resume")
    mib = [x["bytes"] / 2**20 for x in saves]
    print(f"[31] paper stream, async checkpoints before increments 0-4, a "
          f"blocking one at step 5, killed, restored in {restore_s:.3f}s, "
          f"increments 5-9 replayed: every leaf, totals {res.totals} and "
          f"total_cycles {res.total_cycles} == phase 5's uninterrupted run; "
          f"{la} launches; BFS == oracle; wall {wall:.3f}s (host clock, "
          f"set-up, six saves and the restore included)", flush=True)
    print(f"[31] checkpoints: {mib[0]:.1f} MiB each ({saves[0]['bytes']} "
          f"bytes); host snapshot "
          f"{[round(x['snapshot_s'], 4) for x in saves]} s, write on the "
          f"writer thread {[round(x['write_s'], 4) for x in saves]} s",
          flush=True)
    out["paper"] = dict(saves=saves, restore_s=restore_s, wall_s=wall,
                        launches=la, total_cycles=res.total_cycles)
    del res
    t0 = time.time()
    ci = pe.kill_resume_smoke("ci", out_dir=CKPT_DIR)
    if ci["totals"] != dict(hops=41157, execs=7868, stalls=14, allocs=109):
        raise AssertionError(f"31: kill_resume_smoke('ci') totals "
                             f"{ci['totals']}")
    print(f"[31] kill_resume_smoke('ci'): {ci['status']}, resumed at "
          f"{ci['resumed_at']}, totals {ci['totals']} "
          f"({time.time() - t0:.1f}s)", flush=True)
    out["ci"] = {k: ci[k] for k in ("status", "resumed_at", "totals")}
    return out


@contextlib.contextmanager
def livelock_records(ring: collections.deque, attempts: list, mark: dict):
    """While the block runs, every ``LivelockError`` the engine raises
    first appends to ``attempts`` its config's lanes and queue_cap, cycle,
    chunk, the launches by kernel since ``mark`` (a copy of
    ``ops.path_launches``, moved on to now), and the config and input of
    the chunk in which the machine wedged (``ring[0]``, see
    ``keep_inputs``)."""
    from repro_torch.core import engine as engine_mod
    raise_livelock = engine_mod._raise_livelock

    def recorded(cfg, *, cycle, chunk, frames=None):
        attempts.append(dict(lanes=cfg.lanes, queue_cap=cfg.queue_cap,
                             cycle=cycle, chunk=chunk, launches=since(mark),
                             wedged=ring[0]))
        mark.update(ops.path_launches)
        raise_livelock(cfg, cycle=cycle, chunk=chunk, frames=frames)

    with mock.patch.object(engine_mod, "_raise_livelock", recorded):
        yield


def resilience_phase_recovery(cfg_p, incs, want) -> dict:
    """Phase 32: (a) ``recovery_smoke``, the 8x8 hub wedge: lanes 1 -> 2,
    one attempt, wedge cycle 704, BFS == oracle, the report naming wedged
    cells; (b) the paper stream under ``PAPER_PLAN`` (telemetry off) with
    ``RecoveryPolicy(max_attempts=2)``, the counts set to 0 just before:
    each failed attempt's lanes, queue_cap, cycle, chunk and launches by
    kernel, and how it ends (BFS == oracle if it recovers, the attempt
    log in the message if the budget runs out); the chunk in which each
    attempt wedged held against the plain version on the kernels its
    config fits (the cluster kernel where a band fits, and the one-block
    kernel)."""
    from repro_torch.resilience import RecoveryPolicy
    out = {}
    reset_counts()
    t0 = time.time()
    rec = pe.recovery_smoke()
    la = dict(ops.path_launches)
    if (rec["escalated_lanes"], rec["attempts"], rec["wedge_cycle"]) != \
            (2, 1, 704) or la["block"] or not la["cluster"]:
        raise AssertionError(f"32a: {rec}, launches {la}")
    print(f"[32] (a) recovery_smoke: {rec['status']}, lanes 1 -> "
          f"{rec['escalated_lanes']}, {rec['attempts']} attempt, wedge "
          f"cycle {rec['wedge_cycle']} (chunk {rec['log'][0]['chunk']}), "
          f"{rec['cycles']} cycles under lanes=2, {la} launches; BFS == "
          f"oracle; report: {rec['log'][0]['wedge'].splitlines()[1]} "
          f"({time.time() - t0:.1f}s)", flush=True)
    out["recovery_smoke"] = dict(
        {k: rec[k] for k in ("status", "escalated_lanes", "attempts",
                             "wedge_cycle", "cycles")}, launches=la)
    cfg = dataclasses.replace(cfg_p, faults=PAPER_PLAN)
    reset_counts()
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    ring = collections.deque(maxlen=LIVELOCK_CHUNKS + 1)
    attempts, rows, ending, mark = [], [], None, {}
    policy = RecoveryPolicy(max_attempts=2)
    torch.cuda.synchronize()
    t0 = time.time()
    with keep_inputs(ring), livelock_records(ring, attempts, mark):
        for i, e in enumerate(incs):
            n0 = len(attempts)
            mark.update(ops.path_launches)
            try:
                r = eng.run_increment(e, max_cycles=2_000_000,
                                      recover=policy)
            except LivelockError as ex:
                msg = str(ex)
                lines = [f"attempt {k}: lanes=" for k in range(3)]
                if "recovery budget exhausted (2 escalations)" not in msg \
                        or not all(x in msg for x in lines):
                    raise AssertionError(f"32b: the re-raised message "
                                         f"lacks the attempt log: {msg}")
                ending = dict(outcome="exhausted", increment=i,
                              cycle=ex.cycle, chunk=ex.chunk,
                              log=msg.splitlines()[-3:])
                break
            rows.append(dict(cycles=r.cycles, lanes=eng.cfg.lanes,
                             failed=len(attempts) - n0,
                             launches=since(mark)))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(ops.path_launches)   # before the checks launch more
    if ending is None:
        if not (eng.values() == want).all():
            raise AssertionError("32b: recovered, but BFS != oracle")
        ending = dict(outcome="recovered", lanes=eng.cfg.lanes)
    ring.clear()
    for a in attempts:
        cfg_w, st_w = a.pop("wedged")
        paths = (("cluster", "block") if ops.cluster_geometry(cfg_w)
                 else ("block",))
        t1 = time.time()
        d, s_w, _ = kernel_vs_plain(cfg_w, BFS, st_w, paths=paths)
        a["held_on"] = list(paths)
        print(f"[32] (b) attempt at lanes={a['lanes']} queue_cap="
              f"{a['queue_cap']}: wedged at cycle {a['cycle']} (chunk "
              f"{a['chunk']}) after {a['launches']} launches; the chunk in "
              f"which it wedged (cycle {int(st_w.cycle)}..{int(s_w.cycle) - 1}"
              f"), {'in' if cfg_w.faults == PAPER_PLAN.safe() else 'before'} "
              f"the repair pass: the fault instances of the kernels "
              f"{paths} == plain on every leaf (max |d| {d}; "
              f"{time.time() - t1:.1f}s)", flush=True)
        del st_w, s_w
    print(f"[32] (b) paper stream under the paper plan with "
          f"RecoveryPolicy(max_attempts=2): {ending}; increments before: "
          f"{rows}; {len(attempts)} failed attempts; launches "
          f"{launches}; wall {wall:.3f}s (host clock, the per-launch input "
          f"copies included)", flush=True)
    if launches["block"] or not launches["cluster"]:
        raise AssertionError(f"32b: launches {launches}")
    out["paper_plan"] = dict(ending, increments=rows, attempts=attempts,
                             launches=launches, wall_s=wall)
    del eng
    torch.cuda.empty_cache()
    return out


def resilience_phase_guard(cfg_p, incs, want, plain_rows) -> dict:
    """Phase 33: the paper stream with ``ingest_guard=True`` (and the
    telemetry it reads: the cluster kernel's ``kTm`` instance), the counts
    set to 0 just before: per increment the budget before and after,
    every budget set (one a spill pass and one at the end), the cycles and
    launches; every final frame reconciling with the counters
    (``check_frames``); BFS == oracle; where the guard never limited a
    load (no spill pass), the counters equal phase 5's."""
    cfg = dataclasses.replace(cfg_p, ingest_guard=True, telemetry=True)
    reset_counts()
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    traj, rows = pe.guard_budgets(eng), []
    torch.cuda.synchronize()
    t0 = time.time()
    for e in incs:
        before, l0 = eng._ingest_budget, ops.launches
        r = eng.run_increment(e, max_cycles=2_000_000)
        pe.check_frames(r, len(e))
        rows.append(dict(budget_before=before,
                         budget_after=eng._ingest_budget,
                         spill_passes=len(traj) - 1, cycles=r.cycles,
                         launches=ops.launches - l0, hops=r.hops,
                         execs=r.execs, stalls=r.stalls, allocs=r.allocs))
        traj.clear()
    torch.cuda.synchronize()
    wall = time.time() - t0
    la = dict(ops.path_launches)
    if la["block"] or not la["cluster"]:
        raise AssertionError(f"33: launches {la}")
    if not (eng.values() == want).all():
        raise AssertionError("33: BFS != oracle under the guard")
    keys = ("cycles", "hops", "execs", "stalls", "allocs")
    same = [i for i, (r, p) in enumerate(zip(rows, plain_rows))
            if r["spill_passes"] == 0]
    for i in same:
        if {k: rows[i][k] for k in keys} != plain_rows[i]:
            raise AssertionError(f"33: increment {i} loaded whole, but its "
                                 f"counters differ from phase 5's")
    print(f"[33] paper stream, ingest_guard=True (telemetry on): budgets "
          f"{[(r['budget_before'], r['budget_after']) for r in rows]}, "
          f"spill passes {[r['spill_passes'] for r in rows]}, cycles "
          f"{[r['cycles'] for r in rows]}, launches "
          f"{[r['launches'] for r in rows]} ({la}); every final frame "
          f"reconciles; BFS == oracle; counters == phase 5's in the "
          f"{len(same)} increments loaded whole; wall {wall:.3f}s",
          flush=True)
    del eng
    return dict(increments=rows, launches=la, wall_s=wall)


def resilience_phase_replay() -> dict:
    """Phase 34: ``src/repro_torch/data/resilience_fingerprint.json`` (the
    JAX engine: kill-and-resume at ci, the recovery smoke, the guarded hub
    stream through both drivers at ``io_stream_cap`` 32 and 8, and the
    paper config at 20K / 400K under the paper plan with
    ``RecoveryPolicy(max_attempts=2)``) replayed exactly through
    ``paper_experiments.resilience_replay``: every recorded field, the
    digest of every final leaf, the recovery logs and messages included;
    launches by kernel."""
    out = {}
    for rec in RESILIENCE_FP["streams"]:
        t0 = time.time()
        before = dict(ops.path_launches)
        got = pe.resilience_replay(rec)
        bad = sorted(k for k in got if got[k] != rec[k])
        if bad:
            raise AssertionError(f"34 {rec['name']}: {bad} differ from the "
                                 f"JAX engine's")
        la = since(before)
        if not la["cluster"]:
            raise AssertionError(f"34 {rec['name']}: launches {la}")
        note = ""
        if rec["kind"] == "paper_recover":
            ex = got.get("exhausted")
            note = (f"; {got['outcome']}"
                    + (f" in increment {ex['increment']} after attempts at "
                       f"cycles {[a['cycle'] for a in ex['log']]}" if ex
                       else ""))
        print(f"[34] {rec['name']}: {', '.join(sorted(got))} == the JAX "
              f"engine's{note} ({la} launches, {time.time() - t0:.1f}s)",
              flush=True)
        out[rec["name"]] = dict(launches=la, seconds=time.time() - t0)
    return out


def resilience_phase_cost() -> dict:
    """Phase 35: what checkpoints cost on the paper stream, in turns
    (``profile_resilience("paper")``: none, every increment, every
    increment, none; the first increment untimed, the wall of the other
    nine taken after ``ckpt.wait()``)."""
    t0 = time.time()
    # never and every increment, in turns: the every-second cadence is cut
    # to keep the whole smoke near 12 minutes
    rec = pe.profile_resilience("paper", cadences=(0, 1, 1, 0),
                                ckpt_dir=CKPT_DIR)
    walls = collections.defaultdict(list)
    for r in rec["runs"]:
        walls[r["every"]].append(r["wall_s"])
    base = float(np.mean(walls[0]))
    saves = [x for r in rec["runs"] for x in r["saves"]]
    print(f"[35] checkpoint cadence on the paper stream, in turns: "
          + "; ".join(f"every {k or 'never'}: "
                      f"{' / '.join(f'{w:.3f}' for w in v)} s "
                      f"({np.mean(v) / base:.2f}x)"
                      for k, v in sorted(walls.items()))
          + f" (9 timed increments, host clock after ckpt.wait()); "
          f"{len(saves)} saves of {saves[0]['bytes'] / 2**20:.1f} MiB: host "
          f"snapshot {np.mean([x['snapshot_s'] for x in saves]):.4f} s, "
          f"write {np.mean([x['write_s'] for x in saves]):.4f} s mean "
          f"({time.time() - t0:.1f}s)", flush=True)
    return dict(walls={str(k): v for k, v in walls.items()},
                snapshot_s=[x["snapshot_s"] for x in saves],
                write_s=[x["write_s"] for x in saves],
                bytes=saves[0]["bytes"])

# ---- multi-tenant serving (phases 36-39) ----

MQ_FP = json.loads((ROOT / "src" / "repro_torch" / "data"
                    / "mq_fingerprint.json").read_text())
# tests/test_mq.py's mixed Q=8 batch: (app, source) a slot
MIX8 = (("bfs", 0), ("bfs", 7), ("sssp", 3), ("sssp", 11), ("cc", 0),
        ("widest", 5), ("reliable", 9), ("bfs", 23))


def mq_cfg(**kw):
    """``tests/test_mq.py::_mq_cfg``."""
    base = dict(height=8, width=8, n_vertices=128, edge_cap=8,
                ghost_slots=64, queue_cap=64, chan_cap=32, futq_cap=8,
                io_stream_cap=2048, lanes=4, chunk=128)
    base.update(kw)
    return EngineConfig(**base)


def query_since(before: dict) -> dict:
    return {p: ops.query_launches[p] - before[p] for p in ops.PATHS}


def widest_oracle(n, edges, source):
    """Maximin bottleneck capacity by Bellman-Ford (``tests/test_mq.py``)."""
    cap = np.zeros(n, np.float64)
    cap[source] = 1e9
    w = edges[:, 2].astype(np.int32).view(np.float32).astype(np.float64)
    s, d = edges[:, 0], edges[:, 1]
    while True:
        new = cap.copy()
        np.maximum.at(new, d, np.minimum(cap[s], w))
        if np.array_equal(new, cap):
            return cap.astype(np.float32)
        cap = new


def mq_session(cfg, mix, admit_all=True):
    """An ``MQSession`` on the card over ``mix`` ((app, source) a slot),
    every tenant admitted into its slot when ``admit_all``."""
    ses = MQSession(cfg, qbatch=len(mix), apps=[a for a, _ in mix])
    if admit_all:
        for q, (app, src) in enumerate(mix):
            ses.admit(app, src, slot=q)
    return ses


def timed_chunk(fn, cfg, app, st, n_cycles, **kw):
    """One chunk of ``fn`` (the kernel's wrapper or the plain version) on a
    copy of ``st``, timed by CUDA events: ``(ms, state, record)``."""
    s = clone(st)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    a.record()
    s2, qr = fn(cfg, app, s, n_cycles, **kw)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), s2, qr


def mq_phase_kernels() -> tuple[float, dict]:
    """Phase 36: the query-batched instances of both kernels against the
    plain version, (a) 8x8 MIX8 chunk by chunk, both kernels, telemetry on
    and off; (b) three mid-stream states of the paper-scale serving
    preset, one K=256 chunk each on the one-block kernel, which the route
    takes because no band fits (``path="cluster"`` raises): the kernel's
    and the plain version's times and the byte bound (the mutable state
    read and written once).  Returns ``(max abs difference (0), (b)'s
    times)``."""
    t_all = time.time()
    reset_counts()
    ses = mq_session(mq_cfg(telemetry=True), MIX8)
    cfg = ses.eng.cfg
    geometry = ops.cluster_geometry(cfg)
    qb = dict(ops.query_launches)
    worst, _, chunks, cycles = chunks_vs_plain(
        "36a", cfg, ses.eng.app, ses.eng.state, sb.weighted_stream(),
        also_without_telemetry=True)
    if query_since(qb) != {"block": 2 * chunks, "cluster": 2 * chunks}:
        raise AssertionError(f"36a: query-batched launches "
                             f"{query_since(qb)}, {chunks} chunks")
    print(f"[36a] 8x8 MIX8 (Q=8, {cfg.msg_words}-word records), cluster "
          f"kernel {geometry} (n_ctas, rows, bytes a CTA) and one-block "
          f"kernel, telemetry on and off: == plain on every leaf over "
          f"{chunks} chunks, {cycles} cycles (max |d| {worst}; "
          f"{time.time() - t_all:.1f}s)", flush=True)

    t0 = time.time()
    p = sb.SCALES["paper"]
    incs = sb._stream(p)
    ses = mq_session(sb._serve_cfg(p), sb.QUERY_MIX, admit_all=False)
    cfg = ses.eng.cfg
    if ops.cluster_geometry(cfg) is not None:
        raise AssertionError("36b: a band fits the paper serving preset")
    try:
        ops.route(cfg, "cluster")
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("36b: path='cluster' did not raise")
    fd = FrontDesk(ses)
    for app, src in sb.QUERY_MIX:
        if app == "cc":
            ses.admit(app, src)
        else:
            fd.submit(app, src)
    times = dict(ms=[], plain_ms=[], bound_ms=[], cycles=[])
    for i, e in enumerate(incs[:9]):
        if i in (2, 5, 8):
            st, _ = load_stream(cfg, clone(ses.eng.state), e)
            st = fresh_stats(st)._replace(qchg=torch.zeros_like(st.qchg))
            mutable = sum(t.numel() * t.element_size()
                          for k, t in st._asdict().items()
                          if k != "io_edges")
            t_plain, sr, qr = timed_chunk(cca_cycle_chunk_ref, cfg,
                                          ses.eng.app, st, 256)
            before, qb = dict(ops.path_launches), dict(ops.query_launches)
            t_kern, sk, qk = timed_chunk(ops.cca_cycle_chunk, cfg,
                                         ses.eng.app, st, 256)
            on_path(before, "block", 1)
            if query_since(qb) != {"block": 1, "cluster": 0}:
                raise AssertionError("36b: not a query-batched launch")
            if not torch.equal(qk, qr):
                raise AssertionError(f"36b: launch record {qk.tolist()} != "
                                     f"{qr.tolist()}")
            worst = max(worst, leaf_diff(sk, sr))
            ran = int(qr[1])
            bound = 1e3 * 2 * mutable / H100_BYTES_PER_S
            for k, v in zip(times, (t_kern, t_plain, bound, ran)):
                times[k].append(v)
            print(f"[36b] paper serving preset (32x32, Q=8) before "
                  f"increment {i}: one K=256 chunk on the one-block kernel "
                  f"== plain on every leaf ({ran} cycles, cycle "
                  f"{int(sr.cycle)}): kernel {t_kern:.4f} ms "
                  f"({1e6 * t_kern / ran:.1f} ns a cycle), plain "
                  f"{t_plain:.1f} ms, bound {bound:.4f} ms (2 x "
                  f"{mutable / 2**20:.1f} MiB mutable state over 3.35 TB/s;"
                  f" {t_kern / bound:.0f}x)", flush=True)
        fd.step(e)
    print(f"[36b] path='cluster' refused: {refused} "
          f"({time.time() - t0:.1f}s)", flush=True)
    print(f"[36] done in {time.time() - t_all:.1f}s", flush=True)
    return worst, times


def mq_phase_replay() -> dict:
    """Phase 37: every run of ``mq_fingerprint.json`` through
    ``serve_bench.mq_replay`` on the card, exactly; launches by kernel and
    instance."""
    t_all = time.time()
    pinned = json.loads((ROOT / "tests" / "data"
                         / "pre_lanes_reference.json").read_text())
    out = {}
    for rec in MQ_FP["runs"]:
        t0 = time.time()
        reset_counts()
        qb = dict(ops.query_launches)
        got = sb.mq_replay(rec, pinned=pinned)
        bad = sorted(k for k in rec if got.get(k) != rec[k])
        if bad:
            raise AssertionError(f"37 {rec['name']}: {bad} differ from the "
                                 f"JAX engine's")
        la, lq = dict(ops.path_launches), query_since(qb)
        if not ops.launches:
            raise AssertionError(f"37 {rec['name']}: no launch")
        note = ""
        if rec["kind"] == "serve":
            r = got["record"]
            note = (f"; batch {r['batch_cycles']} / serial "
                    f"{r['serial_cycles_total']} cycles, speedup "
                    f"{r['speedup']}, all exact {r['all_exact']}, "
                    f"deferrals {r['deferrals']} (== "
                    f"results/bench_serve.json)")
        elif rec["kind"] == "paper_q8":
            note = (f"; {got['outcome']}, "
                    f"{sum(i['cycles'] for i in got['increments'])} cycles")
        print(f"[37] {rec['name']}: == the JAX engine's{note} (launches "
              f"{la}, query-batched {lq}; {time.time() - t0:.1f}s)",
              flush=True)
        out[rec["name"]] = dict(launches=la, query_launches=lq,
                                seconds=time.time() - t0)
    print(f"[37] done in {time.time() - t_all:.1f}s", flush=True)
    return out


def mq_phase_serve() -> dict:
    """Phase 38: ``bench_serve("paper")`` at full size, every tenant ==
    its serial run and the bfs / sssp / cc / widest tenants == the
    oracles."""
    t0 = time.time()
    reset_counts()
    qb = dict(ops.query_launches)
    values = {}
    rec = sb.bench_serve("paper", out_values=values)
    la, lq = dict(ops.path_launches), query_since(qb)
    if not rec["all_exact"]:
        raise AssertionError(f"38: tenants != their serial runs: "
                             f"{rec['queries']}")
    p = sb.SCALES["paper"]
    edges = np.concatenate(sb._stream(p))
    n = p["n_vertices"]
    w = edges[:, 2].astype(np.int32).view(np.float32)
    for (app, src), v in values.items():
        if app == "bfs":
            want = bfs_levels(n, edges, src)
        elif app == "sssp":
            want = sssp_dists(n, edges, w, src)
        elif app == "cc":
            want = cc_labels(n, edges)
        else:
            want = widest_oracle(n, edges, src)
        assert v.shape == want.shape and np.isfinite(v).all()
        if app == "sssp":
            np.testing.assert_allclose(v, want, rtol=1e-5,
                                       err_msg=f"38: {app}@{src}")
        elif not np.array_equal(v, want):
            raise AssertionError(f"38: {app}@{src} != the oracle")
    if lq["block"] == 0 or lq["cluster"]:
        raise AssertionError(f"38: query-batched launches {lq}")
    walls = rec["wall_s"]
    print(f"[38] bench_serve('paper') (32x32, 4,096 vertices, 20,000 "
          f"edges, Q=8): batch {rec['batch_cycles']} cycles against serial "
          f"{rec['serial_cycles_total']} (speedup {rec['speedup']}), "
          f"latency p50 {rec['p50_cycles']} / p99 {rec['p99_cycles']} "
          f"cycles, deferrals {rec['deferrals']}; all 8 tenants == their "
          f"serial runs, bfs / sssp (rtol 1e-5) / cc / widest == the "
          f"oracles; wall batch {walls['batch']:.3f}s, serial "
          f"{sum(walls['serial']):.3f}s ({' / '.join(f'{x:.3f}' for x in walls['serial'])}); "
          f"launches {la}, query-batched {lq} ({time.time() - t0:.1f}s)",
          flush=True)
    return dict(record={k: rec[k] for k in (
        "batch_cycles", "serial_cycles_total", "speedup", "p50_cycles",
        "p99_cycles", "deferrals", "all_exact", "wall_s")},
        launches=la, query_launches=lq)


def mq_phase_paper(t_block_ns: float) -> dict:
    """Phase 39: the 50K / 1M paper stream under an all-BFS Q=8 batch.
    Each slot == the BFS oracle from its source, or a livelock whose
    wedged chunk equals the plain version."""
    t_all = time.time()
    incs = make_stream(StreamSpec(increments=10, sampling="edge", seed=1,
                                  **PAPER_FULL))
    sources = sb.batch_sources(PAPER_FULL["n_vertices"])
    ses = mq_session(paper_cfg(**PAPER_FULL), [("bfs", v) for v in sources])
    cfg = ses.eng.cfg
    ring = collections.deque(maxlen=LIVELOCK_CHUNKS + 1)
    reset_counts()
    qb = dict(ops.query_launches)
    events, cycles, livelock = [], 0, None
    torch.cuda.synchronize()
    t0 = time.time()
    with keep_inputs(ring), timed_launches(events):
        try:
            for i, e in enumerate(incs):
                cycles += ses.run_increment(e, max_cycles=2_000_000).cycles
        except LivelockError as ex:
            livelock = dict(increment=i, cycle=ex.cycle, chunk=ex.chunk)
            print(f"[39] livelock in increment {i}: {ex}", flush=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    la, lq = dict(ops.path_launches), query_since(qb)
    if la["cluster"] or lq["block"] != la["block"] or not la["block"]:
        raise AssertionError(f"39: launches {la}, query-batched {lq}")
    kern_ms = sum(a.elapsed_time(b) for a, b in events)
    out = dict(sources=sources, cycles=cycles, launches=la, wall_s=wall,
               kernel_ms=kern_ms, livelock=livelock)
    total = cycles + (livelock["cycle"] if livelock else 0)
    out["cycles"] = total
    if livelock is None:
        edges = np.concatenate(incs)
        for q, src in enumerate(sources):
            want = bfs_levels(PAPER_FULL["n_vertices"], edges, src)
            got = ses.values(q)
            assert got.shape == want.shape and np.isfinite(got).all()
            if not np.array_equal(got, want):
                raise AssertionError(f"39: slot {q} (bfs@{src}) != oracle")
        status = "every slot == the BFS oracle from its source"
    else:
        cfg_w, st_w = ring[0]
        d, _, _ = kernel_vs_plain(cfg_w, ses.eng.app, st_w, None, ("auto",))
        status = (f"livelocked at cycle {livelock['cycle']} (chunk "
                  f"{livelock['chunk']}); the wedged chunk == plain "
                  f"(max |d| {d})")
    ns = 1e6 * kern_ms / max(1, total)
    out["ns_per_cycle"] = ns
    ratio = ns / t_block_ns
    print(f"[39] 50K/1M paper stream, all-BFS Q=8 from {sources}: "
          f"{total} cycles (Q=1 phase 5: 50,030), {status}; launches "
          f"{la}, {ns:.1f} ns a machine cycle by CUDA events ({ratio:.2f}x "
          f"phase 6's one-block Q=1 chunk, {t_block_ns:.1f}); wall "
          f"{wall:.3f}s ({time.time() - t_all:.1f}s)", flush=True)
    return out


# ---- distribution: the grid tiled over ranks (phases 40-44) ----

DIST_MESHES = ((2, 1), (4, 1), (8, 1), (2, 2), (4, 2))


def reset_launch_counts() -> None:
    ops.launches = 0
    ops.path_launches = dict.fromkeys(ops.PATHS, 0)
    ops.tile_launches = {}


def sharded_stream(cfg, incs, mesh_shape, plain: bool) -> dict:
    """One stream chunk by chunk, three ways from one seeded state: the
    unsharded kernel, the grid tiled over a ``mesh_shape`` mesh of
    ``LocalTiles`` on the card (the tile instance) and, where ``plain``,
    the same tiles on the CPU (the plain tile step).  Every chunk every
    leaf of the gathered tiles equals the unsharded run's (and the plain
    tiles'), the launch records too; BFS == oracle at the end.  Returns
    the chunks, cycles and the tile launches by kernel."""
    eng = StreamingEngine(cfg, "bfs")
    eng.seed(0, 0.0)
    cfg, one = eng.cfg, eng.state
    k_sst = cca.shard_state(cfg, one, make_host_mesh(*mesh_shape))
    p_sst = (cca.shard_state(cfg, to_device(one, "cpu"),
                             make_host_mesh(*mesh_shape, device="cpu"))
             if plain else None)
    before = ops.tile_launches_by_path()
    chunks = cycles = 0
    for e in incs:
        one, spill = load_stream(cfg, one, e)
        assert len(spill) == 0
        one = fresh_stats(one)
        for sst in (k_sst, p_sst):
            if sst is not None:
                assert len(cca.load_stream(cfg, sst, e)) == 0
                cca.reset_counters(sst)
        c0, q = int(one.cycle), False
        while not q:
            k_sst, kr = cca.run_chunk(cfg, BFS, k_sst)
            one, r1 = ops.cca_cycle_chunk(cfg, BFS, one)
            got = cca.gather_state(k_sst)
            leaf_diff(got, one)
            if not torch.equal(kr, r1):
                raise AssertionError(f"{mesh_shape}: record {kr.tolist()} "
                                     f"!= unsharded {r1.tolist()}")
            if p_sst is not None:
                p_sst, pr = cca.run_chunk(cfg, BFS, p_sst)
                leaf_diff(got, to_device(cca.gather_state(p_sst), "cuda"))
                assert pr.tolist() == kr.tolist()
            q, chunks = bool(kr[0]), chunks + 1
        cycles += int(one.cycle) - c0
    eng.state = one
    want = bfs_levels(cfg.n_vertices, np.concatenate(incs), 0)
    if not (eng.values() == want).all():
        raise AssertionError(f"{mesh_shape}: BFS != oracle")
    now = ops.tile_launches_by_path()
    got = {p: now[p] - before[p] for p in ops.PATHS}
    n_tiles = mesh_shape[0] * mesh_shape[1]
    if sum(got.values()) != n_tiles * chunks * cfg.chunk:
        raise AssertionError(f"{mesh_shape}: tile launches {got}, "
                             f"{chunks} chunks of {n_tiles} tiles")
    return dict(chunks=chunks, cycles=cycles, tile_launches=got)


def dist_phase_parity() -> dict:
    """Phase 40: the JAX parity config and the pinned 8x8 stream, tiled
    over every mesh of ``DIST_MESHES``, held chunk by chunk against the
    unsharded kernel, and against the plain tile step on the CPU (every
    mesh on the parity config, (2, 2) on the pinned stream; phase 52 holds
    every knob's tile instance to it on the pinned stream)."""
    out = {}
    pinned = json.loads((ROOT / "tests" / "data"
                         / "pre_lanes_reference.json").read_text())
    streams = (("parity", *dist_bench.scale_config("ci"), DIST_MESHES),
               ("pinned", EngineConfig(**pinned["cfg"]),
                make_stream(StreamSpec(**pinned["spec"])), ((2, 2),)))
    for name, cfg, incs, plain in streams:
        incs = [incs] if isinstance(incs, np.ndarray) else incs
        for m in DIST_MESHES:
            t0 = time.time()
            r = sharded_stream(cfg, incs, m, m in plain)
            r["wall_s"] = round(time.time() - t0, 3)
            out[f"{name} {m[0]}x{m[1]}"] = r
            print(f"[40] {name} on a {m[0]}x{m[1]} mesh of LocalTiles: "
                  f"{r['chunks']} chunks, {r['cycles']} cycles, gathered "
                  f"tiles == unsharded kernel"
                  + (" == plain tiles" if m in plain else "")
                  + f" on every leaf, chunk by chunk; BFS == oracle; tile "
                  f"launches {r['tile_launches']} ({r['wall_s']}s)",
                  flush=True)
    return out


def dist_phase_fingerprint() -> dict:
    """Phase 41: the 32x32 fingerprint stream tiled over (4, 1) and (2, 2),
    each increment to quiescence through ``dist.cca.run_to_quiescence``,
    its counters and the final values the fingerprint's."""
    fp = json.loads((ROOT / "src" / "repro_torch" / "data"
                     / "fingerprint_32x32.json").read_text())
    cfg_fields = EngineConfig.__dataclass_fields__
    cfg = EngineConfig(**{k: v for k, v in fp["cfg"].items()
                          if k in cfg_fields})
    incs = make_stream(StreamSpec(**fp["spec"]))
    want = [{k: r[k] for k in ("cycles", "hops", "execs", "stalls",
                               "allocs")} for r in fp["increments"]]
    out = {}
    for m in ((4, 1), (2, 2)):
        eng = StreamingEngine(cfg, "bfs")
        eng.seed(0, 0.0)
        sst = cca.shard_state(eng.cfg, eng.state, make_host_mesh(*m))
        before = ops.tile_launches_by_path()
        t0 = time.time()
        rows = []
        for e in incs:
            assert len(cca.load_stream(eng.cfg, sst, e)) == 0
            cca.reset_counters(sst)
            cyc, q, _, (h, x, st_, al) = cca.run_to_quiescence(
                eng.cfg, BFS, sst, limit=fp["max_cycles"])
            assert q, f"{m}: not quiescent"
            rows.append(dict(cycles=cyc, hops=h, execs=x, stalls=st_,
                             allocs=al))
        torch.cuda.synchronize()
        wall = time.time() - t0
        if rows != want:
            raise AssertionError(f"41 {m}: {rows} != the fingerprint")
        eng.state = cca.gather_state(sst)
        assert (eng.values() == np.float32(fp["values"])).all()
        now = ops.tile_launches_by_path()
        got = {p: now[p] - before[p] for p in ops.PATHS}
        cycles = sum(r["cycles"] for r in rows)
        out[f"{m[0]}x{m[1]}"] = dict(cycles=cycles, wall_s=round(wall, 3),
                                     tile_launches=got)
        print(f"[41] 32x32 fingerprint on a {m[0]}x{m[1]} mesh of "
              f"LocalTiles reproduced exactly: {cycles} cycles, {wall:.3f}s "
              f"wall, tile launches {got}", flush=True)
    return out


def cuda_events_ms(fn) -> float:
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def dist_phase_paper(cfg_p, st) -> dict:
    """Phase 42, the distribution path's main run: phase 6's full-size
    state (50K / 1M, the last increment loaded) tiled over a (4, 1) mesh,
    four K=128 chunks, the counts set to 0 just before; each chunk's
    gathered state == the unsharded kernel's on every leaf.  The ms a
    chunk and a cycle by CUDA events; then 128 halo exchanges and 128
    flag reductions alone, the ms of each a cycle."""
    mesh = make_host_mesh(4, 1)
    sst = cca.shard_state(cfg_p, clone(st), mesh)
    one = clone(st)
    torch.cuda.synchronize()
    reset_launch_counts()
    times, cycles, d = [], 0, 0.0
    for k in range(4):
        box = {}

        def chunk():
            box["r"] = cca.run_chunk(cfg_p, BFS, sst, n_cycles=128)[1]
        times.append(cuda_events_ms(chunk))
        kr = box["r"]
        one, r1 = ops.cca_cycle_chunk(cfg_p, BFS, one, 128)
        d = max(d, leaf_diff(cca.gather_state(sst), one))
        if not torch.equal(kr, r1):
            raise AssertionError(f"42: record {kr.tolist()} != "
                                 f"{r1.tolist()}")
        cycles += int(kr[1])
    launches, by_path = ops.launches, dict(ops.path_launches)
    tiles = ops.tile_launches_by_path()
    if launches != 4 * 128 * 4 + 4 or sum(tiles.values()) != 4 * 128 * 4:
        raise AssertionError(f"42: launches {launches} {by_path}, tile "
                             f"launches {tiles}")
    ex_ms = cuda_events_ms(lambda: [sst.exchange() for _ in range(128)])
    red_ms = cuda_events_ms(lambda: [sst.reduce_quiet()
                                     for _ in range(128)])
    ms_cycle = sum(times) / cycles
    geo = ops.tile_route(cfg_p, sst.grid.shape)
    words = int(sst.plan.send.numel())
    print(f"[42] 50K/1M state on a 4x1 mesh of LocalTiles ({sst.grid.shape} "
          f"cells a tile, cluster geometry {geo}): 4 K=128 chunks == the "
          f"unsharded kernel on every leaf, {cycles} cycles; chunks "
          f"{', '.join(f'{t:.3f}' for t in times)} ms = {ms_cycle:.4f} ms a "
          f"cycle; the halo exchange alone {ex_ms / 128:.4f} ms a cycle "
          f"({words} words), the flag reduction {red_ms / 128:.4f} ms; "
          f"launches {launches} by kernel {by_path}, of them tile steps "
          f"{tiles} (4 tiles x 128 cycles x 4 chunks)", flush=True)
    return dict(launches=launches, launches_by_path=by_path,
                tile_launches=tiles, chunk_ms=times, ms_per_cycle=ms_cycle,
                exchange_ms_per_cycle=ex_ms / 128,
                reduce_ms_per_cycle=red_ms / 128, halo_words=words,
                tile_shape=list(sst.grid.shape), geometry=geo,
                max_abs_err=d, cycles=cycles)


def dist_phase_bench() -> dict:
    """Phase 43: ``dist_bench`` at ci and mid over 1/2/4/8 tiles."""
    out = {}
    for scale in ("ci", "mid"):
        out[scale] = rows = dist_bench.run_local(scale)
        for r in rows:
            print(f"[43] dist_bench {scale}: {json.dumps(r)}", flush=True)
    return out


def dist_phase_gcn() -> dict:
    """Phase 44: the gcn forward (gcn-cora at published width) on
    full_graph_sm with a 4-tile mesh registered (owner-partitioned edges,
    ``spmm_partitioned``) against the unsharded forward, 2e-2 as JAX's
    test holds it."""
    shapes = {s.name: s for s in gnn_shapes()}
    spec = shapes["full_graph_sm"]
    cfg = dataclasses.replace(gnn_archs.GCN_CORA, d_in=spec.dim("d_feat"))
    dev = torch.device("cuda")
    g = build_graph(cfg, spec, device=dev)
    params = gnn.init_gnn_params(
        cfg, torch.Generator(device=dev).manual_seed(44))
    want = gnn.gnn_forward(cfg, params, g)
    n = g.x.shape[0]
    part = torch.from_numpy(partition_edges(g.edge_index.cpu().numpy(), n,
                                            4)).to(dev)
    set_dist_mesh(make_host_mesh(4, 1))
    try:
        t0 = time.time()
        got = gnn.gnn_forward(cfg, params, gnn.Graph(x=g.x, edge_index=part))
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        set_dist_mesh(None)
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    print(f"[44] gcn-cora on full_graph_sm ({n} nodes, "
          f"{part.shape[1]} partitioned edge slots over 4 tiles): the mesh "
          f"forward == the unsharded forward within 2e-2 (max |d| {err:.3g}; "
          f"{wall:.3f}s)", flush=True)
    return dict(max_abs_err=err, wall_s=wall, edge_slots=int(part.shape[1]))


def dist_phases(cfg_p, st) -> dict:
    """Phases 40-44, each with its time."""
    out = {}
    for name, fn in (("parity", dist_phase_parity),
                     ("fingerprint", dist_phase_fingerprint),
                     ("paper", lambda: dist_phase_paper(cfg_p, st)),
                     ("bench", dist_phase_bench), ("gcn", dist_phase_gcn)):
        t0 = time.time()
        out[name] = fn()
        print(f"[40-44] {name}: {time.time() - t0:.1f}s", flush=True)
    return out


# ---- the sharded engine's knobs (phases 52-56) ----

# drops, dups and corruptions often enough to cross the tile boundaries of
# a (2, 2) mesh, and the S link of cell (3, 3) (a boundary of the 8x8
# grid's tiles) dead for 40 cycles
TILE_PLAN = FaultPlan(seed=3, drop_rate=0.05, dup_rate=0.05,
                      corrupt_rate=0.05, blackouts=((3, 3, 1, 0, 40),))
# each knob mix of the unsharded kernels in its tile instance: (config
# fields, app or the slot apps of a query batch)
TILE_KNOBS = {"tl+tm": (dict(telemetry=True), "bfs"),
              "tl+flt": (dict(faults=TILE_PLAN), "bfs"),
              "tl+tm+flt": (dict(telemetry=True, faults=TILE_PLAN), "bfs"),
              "tl+q": ({}, ("bfs", "sssp", "cc")),
              "tl+q+tm": (dict(telemetry=True), ("bfs", "sssp", "cc"))}


def knob_state(cfg, knob, edges, dev):
    """``(cfg, app, state)``: ``cfg`` under knob mix ``knob``, seeded (a
    query batch: vertices 0, 5 and 9 in its three slots) and ``edges``
    loaded, on ``dev``."""
    kw, app = TILE_KNOBS[knob]
    eng = StreamingEngine(dataclasses.replace(cfg, **kw),
                          app if isinstance(app, str) else batch_app(app),
                          device=dev)
    for vid, q in ((0, 0), (5, 1), (9, 2))[:eng.cfg.qbatch]:
        eng.seed(vid, 0.0, val_idx=q)
    st, spill = load_stream(eng.cfg, eng.state, edges)
    assert len(spill) == 0
    return eng.cfg, eng.app, st


def tile_phase_instances(cca_ptxas: dict) -> dict:
    """Phase 52: each new tile instance of both kernels against the plain
    tile step, over a (2, 2) mesh of ``LocalTiles``: the pinned 8x8 config
    (its first increment, two 32-cycle chunks) and the 32x32 fingerprint
    config (its first increment, one 16-cycle chunk), each knob mix of
    ``TILE_KNOBS``; the plain tile step on a CPU copy once, the cluster and
    the one-block kernel from the same input, traced: every leaf of the
    gathered tiles (planes, ``flt``, ``qchg`` / ``qlast`` included), the
    launch record and the trace rows equal, every tile step one launch of
    the knob's instance.  Then every tile instance's ptxas registers and
    spills (phase 2's report)."""
    t_all = time.time()
    pinned = json.loads((ROOT / "tests" / "data"
                         / "pre_lanes_reference.json").read_text())
    fp = json.loads((ROOT / "src" / "repro_torch" / "data"
                     / "fingerprint_32x32.json").read_text())
    fields = EngineConfig.__dataclass_fields__
    configs = (
        ("pinned 8x8", EngineConfig(**pinned["cfg"]),
         make_stream(StreamSpec(**pinned["spec"]))[0], 2, 32),
        ("32x32", EngineConfig(**{k: v for k, v in fp["cfg"].items()
                                  if k in fields}),
         make_stream(StreamSpec(**fp["spec"]))[0], 1, 16))
    dev = torch.device("cuda")
    out, worst = {}, 0.0
    for name, base, edges, chunks, n in configs:
        for knob in TILE_KNOBS:
            t0 = time.time()
            cfg, app, st = knob_state(base, knob, edges, dev)
            cpu_mesh = make_host_mesh(2, 2, device="cpu")
            p_sst = cca.shard_state(cfg, to_device(st, "cpu"), cpu_mesh)
            k_ssts = {p: cca.shard_state(cfg, clone(st), make_host_mesh(2, 2))
                      for p in ops.PATHS}
            p_tr = torch.zeros((n, 2), dtype=torch.int32)
            k_tr = torch.zeros((n, 2), dtype=torch.int32, device=dev)
            before = dict(ops.tile_launches)
            for _ in range(chunks):
                p_sst, pr = cca.run_chunk(cfg, app, p_sst, n, trace=p_tr)
                want = to_device(cca.gather_state(p_sst), dev)
                ran = int(pr[1])
                for p in ops.PATHS:
                    k_ssts[p], kr = cca.run_chunk(cfg, app, k_ssts[p], n,
                                                  path=p, trace=k_tr)
                    worst = max(worst, leaf_diff(
                        cca.gather_state(k_ssts[p]), want))
                    if kr.tolist() != pr.tolist() or not torch.equal(
                            k_tr[:ran].cpu(), p_tr[:ran]):
                        raise AssertionError(
                            f"52 {name} {knob} {p}: record {kr.tolist()} / "
                            f"{pr.tolist()} or the trace rows differ")
            steps = {p: ops.tile_launches.get(f"{p} {knob}", 0)
                     - before.get(f"{p} {knob}", 0) for p in ops.PATHS}
            if steps != dict.fromkeys(ops.PATHS, 4 * chunks * n):
                raise AssertionError(f"52 {name} {knob}: launches {steps}")
            flt = cca.gather_state(p_sst).flt.tolist()
            out[f"{name} {knob}"] = dict(launches=steps, flt=flt,
                                         wall_s=time.time() - t0)
            print(f"[52] {name} {knob} over 2x2 tiles: {chunks} chunk(s) of "
                  f"{n} cycles, both kernels' tile instance == the plain "
                  f"tile step on every leaf, the record and the trace rows"
                  + (f"; flt {flt}" if "flt" in knob else "")
                  + f"; tile launches {steps} ({time.time() - t0:.1f}s)",
                  flush=True)
    for kind in CYCLE_INSTANCES:
        if kind.endswith("_tile"):
            c = cca_ptxas[kind]
            print(f"[52] ptxas {kind}: {c.get('registers')} registers, "
                  f"{c.get('spill_stores')} / {c.get('spill_loads')} bytes "
                  f"spilled (stores / loads)", flush=True)
    print(f"[52] done in {time.time() - t_all:.1f}s", flush=True)
    return dict(cases=out, max_abs_err=worst,
                ptxas={k: v for k, v in cca_ptxas.items()
                       if k.endswith("_tile")})


def sharded_engine(cfg, app="bfs", mesh=(4, 1)):
    """A seeded engine on the card, its state sharded over a ``mesh`` of
    ``LocalTiles`` (``dist.cca.shard_state``: the port's ``device_put``)."""
    eng = StreamingEngine(cfg, app)
    eng.seed(0, 0.0)
    eng.state = cca.shard_state(eng.cfg, eng.state, make_host_mesh(*mesh))
    return eng


def tile_stream(eng, incs, **kw) -> tuple[list, float, float]:
    """``incs`` through ``eng``, the counts set to 0 just before: the
    results, the wall (host clock, ending in a synchronize) and the device
    ms (CUDA events around the stream)."""
    reset_launch_counts()
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    torch.cuda.synchronize()
    t0 = time.time()
    a.record()
    res = [eng.run_increment(e, max_cycles=2_000_000, **kw) for e in incs]
    b.record()
    torch.cuda.synchronize()
    return res, time.time() - t0, a.elapsed_time(b)


def tile_launch_line(knob: str) -> dict:
    """The tile launches by instance since the counts were set to 0;
    raises unless every launch was ``knob``'s (on either kernel)."""
    got = dict(ops.tile_launches)
    if not got or any(k.split()[1] != knob for k in got) or \
            sum(got.values()) != ops.launches:
        raise AssertionError(f"tile launches {got}, {ops.launches} in all: "
                             f"not all on {knob}")
    return got


def tile_phase_telemetry(cfg_p, incs, want) -> dict:
    """Phase 53: the paper stream (50K / 1M) with telemetry through the
    engine sharded over a (4, 1) mesh of ``LocalTiles``: 50,030 cycles, BFS
    == oracle, every increment's counters and every frame equal to the
    unsharded engine's, every launch the cluster kernel's ``tl+tm``
    instance; ms a 4-tile cycle by CUDA events."""
    cfg_t = dataclasses.replace(cfg_p, telemetry=True)
    res1, _ = paper_stream_run(cfg_t, incs)
    eng = sharded_engine(cfg_t)
    res, wall, dev_ms = tile_stream(eng, incs)
    la = tile_launch_line("tl+tm")
    cycles = sum(r.cycles for r in res)
    for i, (r, r1) in enumerate(zip(res, res1)):
        for k in ("cycles", "hops", "execs", "stalls", "allocs"):
            if getattr(r, k) != getattr(r1, k):
                raise AssertionError(f"53 increment {i}: {k}")
        for k in ("cell", "lane", "hiw", "aq_n", "pk_n", "ch_n", "scal"):
            if not np.array_equal(getattr(r.frames, k),
                                  getattr(r1.frames, k)):
                raise AssertionError(f"53 increment {i}: frames {k}")
    if cycles != 50_030 or list(la) != ["cluster tl+tm"]:
        raise AssertionError(f"53: {cycles} cycles, launches {la}")
    assert (eng.values() == want).all(), "53: BFS != oracle"
    stepped = sum(la.values()) // 4
    print(f"[53] 50K/1M paper stream, telemetry on, 4x1 tiles: {cycles} "
          f"cycles, counters and all {sum(len(r.frames) for r in res)} "
          f"frames == the unsharded engine's, BFS == oracle; tile launches "
          f"{la} ({stepped} tile cycles, the frozen ones of each chunk's "
          f"tail included); {dev_ms / stepped:.4f} ms a 4-tile cycle by "
          f"CUDA events, wall {wall:.3f}s", flush=True)
    return dict(cycles=cycles, launches=la, wall_s=wall, device_ms=dev_ms,
                ms_per_tile_cycle=dev_ms / stepped,
                frames=sum(len(r.frames) for r in res))


def tile_phase_faults(cfg_p, incs) -> dict:
    """Phase 54: ``PAPER_PLAN`` through the engine sharded over (4, 1),
    telemetry off: the 50K / 1M stream wedges where the unsharded engine
    does (increment 1, cycle 9,358, chunk 18), every launch the cluster
    kernel's ``tl+flt`` instance; the mid stream (10K / 100K) finishes
    increment for increment with the unsharded engine (cycles, counters,
    ``flt``, values), its cycles against the clean stream's."""
    cfg_f = dataclasses.replace(cfg_p, faults=PAPER_PLAN)
    eng = sharded_engine(cfg_f)
    try:
        tile_stream(eng, incs)
        raise AssertionError("54: the paper plan did not wedge the stream")
    except LivelockError as ex:
        ll = dict(increment=eng.stream_pos, cycle=ex.cycle, chunk=ex.chunk)
    torch.cuda.synchronize()
    la = tile_launch_line("tl+flt")
    if ll != dict(increment=1, cycle=9_358, chunk=18):
        raise AssertionError(f"54: wedged at {ll}, not increment 1, cycle "
                             f"9,358, chunk 18")
    print(f"[54] 50K/1M paper stream under PAPER_PLAN, 4x1 tiles: livelock "
          f"at increment {ll['increment']}, cycle {ll['cycle']}, chunk "
          f"{ll['chunk']}, as the unsharded engine's (phase 29); tile "
          f"launches {la}", flush=True)
    del eng
    mid = make_stream(StreamSpec(increments=10, sampling="edge", seed=1,
                                 n_vertices=10_000, n_edges=100_000))
    cfg_m = dataclasses.replace(paper_cfg(10_000, 100_000), faults=PAPER_PLAN)
    one = StreamingEngine(cfg_m, "bfs")
    one.seed(0, 0.0)
    rows1 = [one.run_increment(e, max_cycles=2_000_000) for e in mid]
    eng = sharded_engine(cfg_m)
    rows, wall, dev_ms = tile_stream(eng, mid)
    la_mid = tile_launch_line("tl+flt")
    for i, (r, r1) in enumerate(zip(rows, rows1)):
        if [getattr(r, k) for k in ("cycles", "hops", "execs", "stalls",
                                    "allocs")] != \
                [getattr(r1, k) for k in ("cycles", "hops", "execs",
                                          "stalls", "allocs")]:
            raise AssertionError(f"54 mid increment {i} differs")
    if not np.array_equal(eng.values(), one.values()):
        raise AssertionError("54: mid-stream values differ")
    flt = cca.gather_state(eng.state).flt.tolist()
    if flt != one.state.flt.tolist():
        raise AssertionError(f"54: flt {flt} != {one.state.flt.tolist()}")
    want = bfs_levels(10_000, np.concatenate(mid), 0)
    assert (eng.values() == want).all(), "54: mid BFS != oracle"
    cycles = sum(r.cycles for r in rows)
    clean = MID_STREAM["clean"][1]
    stepped = sum(la_mid.values()) // 4
    print(f"[54] mid stream (10K / 100K) under PAPER_PLAN, 4x1 tiles: "
          f"{cycles} cycles ({cycles / clean:.4f}x the clean {clean}), every "
          f"increment's counters, the last flt {flt} and the values == the "
          f"unsharded engine's, BFS == oracle; tile launches {la_mid}, "
          f"{dev_ms / stepped:.4f} ms a 4-tile cycle, wall {wall:.3f}s",
          flush=True)
    return dict(livelock=ll, launches=la, mid=dict(
        cycles=cycles, clean_cycles=clean, launches=la_mid, wall_s=wall,
        ms_per_tile_cycle=dev_ms / stepped, flt=flt))


def tile_phase_batch() -> dict:
    """Phase 55: an all-BFS Q=8 batch (``sb.batch_sources``, admitted by
    ``MQSession`` as phase 39's) at 2,000 vertices / 20K edges on the
    paper config through the engine sharded over (4, 1) and unsharded:
    the same cycles and counters increment for increment, 5,619 cycles in
    all, every slot == the BFS oracle from its source, every launch of the
    sharded run the ``tl+q`` tile instance's."""
    incs = make_stream(StreamSpec(increments=10, sampling="edge", seed=1,
                                  n_vertices=2_000, n_edges=20_000))
    sources = sb.batch_sources(2_000)
    runs = {}
    for shard in (False, True):
        ses = mq_session(paper_cfg(2_000, 20_000),
                         [("bfs", v) for v in sources])
        eng = ses.eng
        if shard:
            eng.state = cca.shard_state(eng.cfg, eng.state,
                                        make_host_mesh(4, 1))
        res, wall, dev_ms = tile_stream(eng, incs)
        runs[shard] = (eng, res, wall, dev_ms, tile_launch_line("tl+q")
                       if shard else dict(ops.path_launches))
    (one, res1, wall1, ms1, la1), (eng, res, wall, dev_ms, la) = \
        runs[False], runs[True]
    for i, (r, r1) in enumerate(zip(res, res1)):
        if (r.cycles, r.hops, r.execs) != (r1.cycles, r1.hops, r1.execs):
            raise AssertionError(f"55 increment {i} differs")
    edges = np.concatenate(incs)
    for q, src in enumerate(sources):
        got = eng.values(val_idx=q, combine=np.minimum)
        if not np.array_equal(got, bfs_levels(2_000, edges, src)):
            raise AssertionError(f"55: slot {q} (bfs@{src}) != oracle")
    cycles = sum(r.cycles for r in res)
    if cycles != 5_619:
        raise AssertionError(f"55: {cycles} cycles, not 5,619")
    stepped = sum(la.values()) // 4
    print(f"[55] all-BFS Q=8 batch from {sources} at 2K / 20K on the paper "
          f"config: {cycles} cycles sharded over 4x1 tiles == unsharded "
          f"({sum(r.cycles for r in res1)}, launches {la1}), every slot == "
          f"the BFS oracle; tile launches {la}, {dev_ms / stepped:.4f} ms a "
          f"4-tile cycle, wall {wall:.3f}s (unsharded {ms1:.1f} ms of "
          f"device, wall {wall1:.3f}s)", flush=True)
    return dict(cycles=cycles, launches=la, wall_s=wall,
                ms_per_tile_cycle=dev_ms / stepped, unsharded_launches=la1,
                unsharded_device_ms=ms1, device_ms=dev_ms)


def tile_phase_traced(cfg_p, incs) -> dict:
    """Phase 56: phase 17's traced bfs stream (50K / 1M,
    ``collect_traces=True``) through the engine sharded over (4, 1): every
    increment's trace rows and counters equal to the unsharded engine's,
    every launch the cluster kernel's traced ``tl`` instance."""
    one = StreamingEngine(cfg_p, "bfs")
    one.seed(0, 0.0)
    res1 = [one.run_increment(e, max_cycles=2_000_000, collect_traces=True)
            for e in incs]
    eng = sharded_engine(cfg_p)
    res, wall, dev_ms = tile_stream(eng, incs, collect_traces=True)
    la = tile_launch_line("tl")
    for i, (r, r1) in enumerate(zip(res, res1)):
        if not (np.array_equal(r.active_per_cycle, r1.active_per_cycle)
                and np.array_equal(r.in_flight_per_cycle,
                                   r1.in_flight_per_cycle)
                and r.cycles == r1.cycles == len(r.active_per_cycle)):
            raise AssertionError(f"56 increment {i}: trace rows differ")
    cycles = sum(r.cycles for r in res)
    stepped = sum(la.values()) // 4
    print(f"[56] 50K/1M traced bfs stream, 4x1 tiles: {cycles} cycles, "
          f"every trace row and counter == the unsharded engine's; tile "
          f"launches {la}, {dev_ms / stepped:.4f} ms a traced 4-tile cycle, "
          f"wall {wall:.3f}s", flush=True)
    return dict(cycles=cycles, launches=la, wall_s=wall,
                ms_per_tile_cycle=dev_ms / stepped)


def tile_knob_cost(cfg_p, st) -> dict:
    """The cost of each knob on the tiles: phase 6's full-size state over
    (4, 1), a K=256 chunk (``dist.cca.run_chunk``) on the cluster kernel
    without the knob and with it in turns (off, on, on, off; CUDA events):
    telemetry, a zero-rate fault plan, both, and a traced chunk."""
    out = {}
    mesh = make_host_mesh(4, 1)
    cfg_z = dataclasses.replace(cfg_p, faults=FaultPlan(seed=7))
    cases = {"telemetry": dataclasses.replace(cfg_p, telemetry=True),
             "zero-rate faults": cfg_z,
             "telemetry + zero-rate faults": dataclasses.replace(
                 cfg_z, telemetry=True), "trace": cfg_p}
    like = {}
    for name, cfg in cases.items():
        if cfg not in like:
            lay = init_state(cfg, device="meta")
            like[cfg] = st._replace(**{k: torch.zeros(
                getattr(lay, k).shape, dtype=torch.int32,
                device=st.aq.device) for k in ("tm_cell", "tm_lane",
                                               "tm_hiw", "flt")})
    like[cfg_p] = st
    trace = torch.empty((256, 2), dtype=torch.int32, device=st.aq.device)
    for name, cfg in cases.items():
        turns = {False: [], True: []}
        for on in (False, True, True, False):
            c = cfg if on else cfg_p
            sst = cca.shard_state(c, clone(like[c]), mesh)
            tr = trace if on and name == "trace" else None
            turns[on].append(cuda_events_ms(lambda: cca.run_chunk(
                c, BFS, sst, n_cycles=256, trace=tr)) / 256)
        ratio = np.mean(turns[True]) / np.mean(turns[False])
        out[name] = dict(off=turns[False], on=turns[True], ratio=ratio)
        print(f"[53] a 4-tile cycle at paper size, {name} off / on / on / "
              f"off: {turns[False][0]:.4f} / {turns[True][0]:.4f} / "
              f"{turns[True][1]:.4f} / {turns[False][1]:.4f} ms ({ratio:.4f}x)",
              flush=True)
    return out


def tile_phases(cfg_p, st, incs, want, cca_ptxas) -> dict:
    """Phases 52-56, each with its time."""
    out = {}
    for name, fn in (
            ("instances", lambda: tile_phase_instances(cca_ptxas)),
            ("telemetry", lambda: tile_phase_telemetry(cfg_p, incs, want)),
            ("knob_cost", lambda: tile_knob_cost(cfg_p, st)),
            ("faults", lambda: tile_phase_faults(cfg_p, incs)),
            ("batch", tile_phase_batch),
            ("traced", lambda: tile_phase_traced(cfg_p, incs))):
        t0 = time.time()
        out[name] = fn()
        out[name + "_s"] = time.time() - t0
        print(f"[52-56] {name}: {time.time() - t0:.1f}s", flush=True)
        torch.cuda.empty_cache()
    return out


def experiment_phases(smi: str) -> dict:
    """Phase 17: the paper's experiments at 50K vertices / 1M edges through
    ``launch/paper_experiments.py``, every launch on the cluster kernel
    (the counts set to 0 before and read after), checked by the repo's own
    means; then the tables, read from its cache."""
    t_all = time.time()
    ops.launches = 0
    ops.path_launches = dict.fromkeys(ops.PATHS, 0)
    n = pe.SCALES["paper"]["n_vertices"]
    oracle, streams = {}, []
    for app, sampling, alloc, traced in PAPER_STREAMS:
        t0 = time.time()
        incs = pe.stream_increments(sampling, "paper")
        gen_s = time.time() - t0
        before = dict(ops.path_launches)
        torch.cuda.synchronize()
        t0 = time.time()
        rows, eng = pe.run_stream(app, sampling, "paper", allocator=alloc,
                                  collect_traces=traced)
        torch.cuda.synchronize()
        wall = time.time() - t0
        got = {p: ops.path_launches[p] - before[p] for p in ops.PATHS}
        if got["block"] or not got["cluster"]:
            raise AssertionError(f"17 {app} {sampling}: launches {got}")
        key = (app, sampling, "paper", alloc, traced, "cuda")
        cycles = sum(r["cycles"] for r in rows)
        vals = eng.values()
        if app == "bfs":
            if sampling not in oracle:
                oracle[sampling] = bfs_levels(n, np.concatenate(incs), 0)
            assert (vals == oracle[sampling]).all(), \
                f"17 {sampling} {alloc}: BFS != oracle"
        elif not (vals == np.float32(1e9)).all():
            raise AssertionError(f"17 ingest_only {sampling}: values moved")
        if traced:
            plain = pe._CACHE[key[:4] + (False, "cuda")][0]
            for a, b in zip(plain, rows):
                if {k: a[k] for k in TOTALS} != {k: b[k] for k in TOTALS} \
                        or len(a["active"]) or len(b["active"]) != b["cycles"]:
                    raise AssertionError(f"17 traced {app}: increment "
                                         f"{b['increment']} {b} != {a}")
        if (app, sampling, alloc, traced) == ("bfs", "edge", "vicinity",
                                              False) \
                and (got["cluster"], cycles) != (102, 50_030):
            raise AssertionError(f"17 bfs edge: {got['cluster']} launches, "
                                 f"{cycles} cycles, not 102 and 50,030")
        streams.append(dict(app=app, sampling=sampling, allocator=alloc,
                            traced=traced, cycles=cycles,
                            launches=got["cluster"], wall_s=wall,
                            per_increment=[r["cycles"] for r in rows]))
        print(f"[17] {app} {sampling} {alloc}{' traced' if traced else ''}: "
              f"{cycles} cycles in {got['cluster']} launches (cluster "
              f"kernel), wall {wall:.4f}s (host clock, the engine's set-up "
              f"included, ends in synchronize; "
              f"{1e3 * wall / got['cluster']:.4f} ms a launch); "
              + ("BFS == oracle" if app == "bfs" else "values all 1e9")
              + ("; every increment's totals == the untraced run's, one "
                 "trace row a cycle" if traced else "")
              + f" (stream generated in {gen_s:.1f}s)", flush=True)
    launches = dict(ops.path_launches)
    tables = dict(
        fig8_9={s: pe.bench_cycles_per_increment("paper", s)[0]
                for s in ("edge", "snowball")},
        table2=pe.bench_energy("paper"),
        fig5=pe.bench_allocator("paper"),
        fig6_7=pe.bench_activation("paper", "edge"))
    if dict(ops.path_launches) != launches:
        raise AssertionError("17: the tables ran streams of their own")
    for name, rows in tables.items():
        print(f"[17] {name}: {json.dumps(rows)}", flush=True)
    print(f"[17] done in {time.time() - t_all:.1f}s: {launches['cluster']} "
          f"launches, all on the cluster kernel", flush=True)
    return dict(streams=streams, tables=tables, launches=launches)


def ci_stream(run: dict) -> tuple[list, object, np.ndarray, np.ndarray]:
    """One stream of the ci fingerprint through the engine on the card:
    (per-increment totals, engine, active, in-flight traces)."""
    ci = pe.SCALES["ci"]
    eng = pe._engine(ci["n_vertices"], run["app"], run["allocator"],
                     n_edges=ci["n_edges"])
    rows, act, flt = [], [], []
    for e in pe.stream_increments(run["sampling"], "ci"):
        r = eng.run_increment(e, max_cycles=2_000_000,
                              collect_traces=run["traced"])
        rows.append(dict(edges=len(e), cycles=r.cycles, hops=r.hops,
                         execs=r.execs, stalls=r.stalls, allocs=r.allocs))
        act.append(r.active_per_cycle)
        flt.append(r.in_flight_per_cycle)
    return rows, eng, np.concatenate(act), np.concatenate(flt)


def replay_phases() -> dict:
    """Phase 18: the ci fingerprint recorded from the JAX engine, and the
    ``engine_ci`` / ``engine_mid`` counters of results/bench_engine.json,
    exactly."""
    t0 = time.time()
    fp = json.loads((ROOT / "src" / "repro_torch" / "data"
                     / "paper_ci_fingerprint.json").read_text())
    before = dict(ops.path_launches)
    for run in fp["streams"]:
        rows, eng, act, flt = ci_stream(run)
        cfg = dataclasses.asdict(eng.cfg)
        want_cfg = {k: v for k, v in run["cfg"].items() if k in cfg}
        name = f"{run['app']} {run['sampling']} {run['allocator']}"
        if cfg != want_cfg or rows != run["increments"]:
            raise AssertionError(f"18 {name}: {rows} != {run['increments']}")
        if not (eng.values() == np.float32(run["values"])).all():
            raise AssertionError(f"18 {name}: values differ")
        if eng.vertex_object_stats() != run["vertex_object_stats"]:
            raise AssertionError(f"18 {name}: vertex_object_stats differ")
        if run["traced"] and not (
                act.tolist() == run["active_per_cycle"]
                and flt.tolist() == run["in_flight_per_cycle"]):
            raise AssertionError(f"18 {name}: traces differ")
        print(f"[18] ci fingerprint {name}"
              f"{' traced' if run['traced'] else ''}: "
              f"{sum(r['cycles'] for r in rows)} cycles, counters, values, "
              f"vertex_object_stats{', every trace row' if run['traced'] else ''}"
              f" == the JAX engine's", flush=True)
    bench = json.loads((ROOT / "results" / "bench_engine.json").read_text())
    engine = {}
    for scale in ("ci", "mid"):
        got = pe.bench_engine(scale)
        want = bench[f"engine_{scale}"]["backends"]["jnp"]
        keys = ("cycles", "execs", "hops", "total_cycles")
        if {k: got[k] for k in keys} != {k: want[k] for k in keys}:
            raise AssertionError(f"18 engine_{scale}: {got} != {want}")
        engine[scale] = got
        print(f"[18] engine_{scale} ({got['grid']}): cycles {got['cycles']}, "
              f"execs {got['execs']}, hops {got['hops']}, total cycles "
              f"{got['total_cycles']} == results/bench_engine.json; wall "
              f"{got['wall_s']:.4f}s for the second increment "
              f"({got['cell_cycles_per_s']:.4g} cell-cycles/s)", flush=True)
    got = {p: ops.path_launches[p] - before[p] for p in ops.PATHS}
    if got["block"] or not got["cluster"]:
        raise AssertionError(f"18: launches {got}")
    print(f"[18] done in {time.time() - t0:.1f}s", flush=True)
    return engine


def print_ptxas(report: str) -> None:
    for line in report.splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "stack")):
            print("  ptxas:", line.strip())


def bag_ptxas(lib: str, report: str) -> None:
    """Phase 7: the EmbeddingBag kernel's instantiations, its shape at RM2
    (``bag_tile_kernel<16, 4, 4>``) line by line and the worst spill of
    the rest."""
    funcs = _build.ptxas_functions(report)
    rm2 = [i for n, i in funcs.items() if "bag_tile_kernelILi16ELi4ELi4E" in n]
    worst = max(funcs.values(), key=lambda i: i.get("spill_stores", 0))
    print(f"[7] {lib}: {len(funcs)} kernels; at RM2 (16 lanes x float4, "
          f"L = 4): {rm2}; the most spill of any: {worst}", flush=True)


FLASH_KERNELS = {"fa_fwd_tc": ("tensor_core", "bf16"),
                 "fa_fwd_tf32": ("tensor_core_tf32x3", "f32")}


def flash_ptxas(report: str) -> list[dict]:
    """Phase 12: one row a flash-attention instantiation (its path, head
    width, dtype and lse store read from the mangled name), printed;
    raises if an instance of a tensor-core kernel (bf16, or f32 as
    3xTF32) spills at dh 64 or 128."""
    rows = []
    for name, info in _build.ptxas_functions(report).items():
        m = re.search(r"(fa_fwd_tc|fa_fwd_tf32)ILi(\d+)E(?:Lb(\d)E)?", name)
        if not m:
            continue
        path, dtype = FLASH_KERNELS[m[1]]
        row = dict(path=path, dtype=dtype, dh=int(m[2]),
                   lse=m[3] == "1", **info)
        rows.append(row)
        print(f"[12] {row['path']} {row['dtype']} dh={row['dh']}"
              f"{' (lse store)' if row['lse'] else ''}: "
              f"{info.get('registers')} registers at entry, "
              f"{info.get('spill_stores')} bytes spill stores, "
              f"{info.get('spill_loads')} bytes spill loads, "
              f"{info.get('stack')} bytes stack, static smem "
              f"{info.get('smem', 0)} bytes", flush=True)
    for path in ("tensor_core", "tensor_core_tf32x3"):
        for dh in (64, 128):
            tc = [r for r in rows if r["path"] == path and r["dh"] == dh]
            if not tc or any(r.get("spill_stores", 1) or r.get(
                    "spill_loads", 1) for r in tc):
                raise AssertionError(f"{path} flash kernel at dh {dh}: "
                                     f"spills or no report ({tc})")
    return rows


def cuda_ms(fn, min_reps=3, budget_ms=300.0) -> float:
    """Mean device time of ``fn()`` in ms by CUDA events: one warm call,
    then as many calls as fit in ``budget_ms`` (at least ``min_reps``)."""
    fn()
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    reps = max(min_reps, min(200, int(budget_ms / max(a.elapsed_time(b),
                                                      1e-3))))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps=100) -> float:
    """Device time of ``fn``'s launches in ms: a CUDA graph of one call,
    captured after a warm call, replayed ``reps`` times between two
    events (so the host's call rate does not count)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def same_bits(got, want) -> bool:
    """Equal as f32 bits, NaN in the same places."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        got.view(torch.int32)[~nan], want.view(torch.int32)[~nan])


def check(name, got, want, tol) -> float:
    """Max |got - want|; raises unless it is at most tol x max(1, max
    |want|) and NaN sits in the same places."""
    got, want = got.float(), want.float()
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError(f"{name}: NaN in different places")
    err = float((got - want).abs().nan_to_num(0.0).max())
    scale = max(1.0, float(want.nan_to_num(0.0).abs().max()))
    if err > tol * scale:
        raise AssertionError(f"{name}: max |d| {err} > {tol} x {scale}")
    return err


def scaled_err(got, want) -> tuple[float, float]:
    """(max |got - want|, the largest |got - want| / (|want| + median
    |want|) over the entries): elementwise, an entry near 0 held to the
    output's typical size rather than to its largest."""
    got, want = got.double(), want.double()
    if got.shape != want.shape:
        raise AssertionError(f"shape {got.shape} != {want.shape}")
    d = (got - want).abs()
    tol = want.abs() + float(want.abs().median())
    return float(d.max()), float(torch.where(d == 0, 0.0, d / tol).max())


def check_close(name, got, want, rtol) -> tuple[float, float]:
    """``scaled_err``, raising unless the scaled error is at most rtol."""
    err, rel = scaled_err(got, want)
    if not rel <= rtol:
        raise AssertionError(f"{name}: an entry is off by {rel:.3g} of "
                             f"|ref| + median |ref| (limit {rtol}; max |d| "
                             f"{err})")
    return err, rel


def index_add_sum(msgs, edge_index, n_nodes, rowptr=None):
    """``gnn.scatter_sum`` by ``index_add_`` in the messages' dtype (no
    spmm kernel; a built graph's destinations are all in range)."""
    out = msgs.new_zeros((n_nodes, *msgs.shape[1:]))
    return out.index_add_(0, edge_index[1].long(), msgs)


def plain_forward(cfg, params, g, dtype):
    """GraphCast's ``gnn_forward`` in ``dtype`` on the card in plain torch
    ops: its segment sums by ``index_add_`` in ``dtype`` too.  Its MLPs run
    in the activations' dtype and it has no layer norm, so in float64
    nothing rounds to f32."""
    assert cfg.kind == "graphcast"
    with mock.patch.object(gnn, "scatter_sum", index_add_sum):
        return gnn.gnn_forward(
            dataclasses.replace(cfg, compute_dtype=dtype), params, g)


def vs_cpu(arch, cfg, params, g, out) -> tuple[dict, str]:
    """Hold the card's forward ``out`` to the CPU's, elementwise: within
    1e-4 of |ref| + median |ref|.  GraphCast's 16 unnormalised residual
    blocks reach 1e10 at random init, and its f32 function is then no
    more accurate than that allows, on any device: it is held to its f64
    forward instead, no farther from it than 1e-4 or twice the plain f32
    forward, whichever is more.  Both run on the card in plain torch ops
    (``plain_forward``): on the CPU they took ~133 s of the smoke."""
    if arch == "graphcast":
        want64 = plain_forward(cfg, params, g, torch.float64)
        _, card64 = scaled_err(out, want64)
        _, plain64 = scaled_err(plain_forward(cfg, params, g,
                                              torch.float32), want64)
        limit = max(1e-4, 2 * plain64)
        if not card64 <= limit:
            raise AssertionError(f"graphcast: the card is off its f64 "
                                 f"forward by {card64:.3g}, the plain f32 "
                                 f"forward by {plain64:.3g} (limit "
                                 f"{limit:.3g})")
        return (dict(vs_f64_scaled_err=card64,
                     plain_vs_f64_scaled_err=plain64),
                f"off the f64 forward by {card64:.3g} (scaled), the plain "
                f"f32 forward by {plain64:.3g} (limit max(1e-4, 2x that); "
                f"both on the card, sums by index_add_; max |ref| "
                f"{float(want64.abs().max()):.4g})")
    cpu_p, cpu_g = to_cpu(params), gnn.Graph(*to_cpu(tuple(g)))
    want = gnn.gnn_forward(cfg, cpu_p, cpu_g)
    err, rel = check_close(f"{arch} vs CPU", out.cpu(), want, 1e-4)
    return (dict(vs_cpu_max_abs_err=err, vs_cpu_scaled_err=rel),
            f"== CPU forward elementwise (scaled error {rel:.3g} <= "
            f"1e-4; max |d| {err:.3g})")


def forward_wall(fn, reps) -> tuple[float, int, int, object]:
    """(mean host seconds per call, each ending in synchronize; peak bytes
    allocated during the calls, resident inputs included; that peak less
    what was resident before the calls; the last output), after one warm
    call."""
    out = fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.time()
    for _ in range(reps):
        out = fn()
        torch.cuda.synchronize()
    wall = (time.time() - t0) / reps
    peak = torch.cuda.max_memory_allocated()
    return wall, peak, peak - resident, out


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return None if tree is None else tree.cpu()


def spmm_phases(smi: str, dev: torch.device) -> dict:
    """Phases 8 and 9: the scatter-SpMM kernel against its plain version
    and the library call, then the GNN serving forwards through it."""
    shapes = {s.name: s for s in gnn_shapes()}
    gen = torch.Generator(device=dev)

    # ---- 8. kernel vs plain at the main path's shapes ----
    t0 = time.time()
    d_feat = shapes["full_graph_sm"].dim("d_feat")   # d_in, as launch/steps
    cora_cfg = dataclasses.replace(gnn_archs.GCN_CORA, d_in=d_feat)
    ogb_cfg = dataclasses.replace(cora_cfg, d_in=shapes["ogb_products"].dim(
        "d_feat"))
    g_cora = build_graph(cora_cfg, shapes["full_graph_sm"], device=dev)
    g_ogb = build_graph(ogb_cfg, shapes["ogb_products"], device=dev)
    gc_cfg = dataclasses.replace(gnn_archs.GRAPHCAST, d_in=d_feat)
    g_gc = build_graph(gc_cfg, shapes["full_graph_sm"], device=dev)
    torch.cuda.synchronize()
    print(f"[8] graphs built in {time.time() - t0:.1f}s: full_graph_sm "
          f"{g_cora.edge_index.shape[1]} edges, ogb_products "
          f"{g_ogb.edge_index.shape[1]} edges, multimesh "
          f"{g_gc.mesh_edge_index.shape[1]} edges", flush=True)
    rows, worst = [], 0.0
    # (shape, edge set, D, gather): every aggregation shape of phase 9's
    # forwards: gcn's two layers (gather and coeff fused), gatedgcn's and
    # meshgraphnet's edge messages, graphcast's three edge sets
    cases = [("full_graph_sm", g_cora, "edge_index", 16, True),
             ("full_graph_sm", g_cora, "edge_index", 7, True),
             ("full_graph_sm", g_cora, "edge_index", 70, False),
             ("full_graph_sm", g_cora, "edge_index", 128, False),
             ("ogb_products", g_ogb, "edge_index", 16, True),
             ("ogb_products", g_ogb, "edge_index", 7, True),
             ("multimesh_r6", g_gc, "mesh_edge_index", 512, False),
             ("grid2mesh", g_gc, "g2m_edge_index", 512, False),
             ("mesh2grid", g_gc, "m2g_edge_index", 512, False)]
    for name, g, key, D, gather in cases:
        gen.manual_seed(D)
        ei, rowptr = getattr(g, key), g.rowptr[key]   # built once per graph
        n, E = rowptr.shape[0] - 1, ei.shape[1]
        src, dst = ei[0].contiguous(), ei[1].contiguous()
        if gather:                     # spmm_sorted_coo, GCN layer shape
            x = torch.randn((n, D), generator=gen, device=dev)
            coeff = sym_norm_coeff(ei, n)
            wrapper = lambda: spmm_ops.spmm_sorted_coo(  # noqa: E731
                x, src, dst, n, coeff, rowptr)
            plain = lambda: spmm_sorted_coo_ref(  # noqa: E731
                x, src, dst, n, coeff)
            # the library's CSR: columns sorted within each row
            o = torch.argsort(dst.long() * n + src.long())
            col, vals, dense, n_in = src[o], coeff[o], x, n
            # src, coeff, rowptr, x, out; a multiply and an add an entry
            nbytes, nops = E * 8 + (n + 1) * 4 + n * D * 8, 2 * E * D
            # the gather floor: the 32-byte sectors of x each edge's row
            # touches, none found in L2, beside src, coeff, rowptr and out
            first = src.long() * D * 4
            sectors = int(((first + D * 4 - 1) // 32 - first // 32 + 1).sum())
            floor_bytes = 32 * sectors + nbytes - n * D * 4
            del first
        else:                          # scatter_spmm of edge messages
            msgs = torch.randn((E, D), generator=gen, device=dev)
            src = coeff = None
            wrapper = lambda: spmm_ops.scatter_spmm(  # noqa: E731
                msgs, dst, n, rowptr)
            plain = lambda: scatter_spmm_ref(msgs, dst, n)  # noqa: E731
            col = torch.arange(E, dtype=torch.int32, device=dev)
            vals = torch.ones(E, device=dev)
            dense, n_in = msgs, E
            # msgs, rowptr, out; an add an entry
            nbytes, nops = E * D * 4 + (n + 1) * 4 + n * D * 4, E * D
            floor_bytes = nbytes     # the messages stream in order
        # the kernel alone, over the graph's row pointers, in the warp
        # shape the wrapper picks, and in the wide shape (lanes over the
        # columns, the kernel's only shape before the narrow ones) for the
        # old kernel's time
        shape = spmm_ops.geometry(D, dense.data_ptr() % 16 == 0)
        kern = lambda: spmm_ops.launch(  # noqa: E731
            dense, src, coeff, rowptr, n)
        old = lambda: spmm_ops.launch(  # noqa: E731
            dense, src, coeff, rowptr, n, shape=spmm_ops.WIDE)
        with warnings.catch_warnings():   # "sparse CSR is in beta", ...
            warnings.simplefilter("ignore", UserWarning)
            csr = torch.sparse_csr_tensor(rowptr, col, vals, size=(n, n_in))
        got, want = wrapper(), plain()
        torch.cuda.synchronize()
        err = check(f"spmm {name} D={D}", got, want, 1e-4)
        if not torch.equal(kern(), got):
            raise AssertionError("a second launch gave other bits")
        # the kernel's own order of sums, in plain PyTorch: the same bits
        if not torch.equal(got, spmm_ordered(dense, src, dst, n, coeff,
                                             32 // shape[0])):
            raise AssertionError(f"spmm {name} D={D}: not the bits of its "
                                 f"order ({shape})")
        old_err = check(f"spmm wide shape {name} D={D}", old(), want, 1e-4)
        # twice old, new, new, old: the small shapes are host-bound, and
        # their times spread by some 10% from one turn to the next
        turns = {"old": [], "new": []}
        for which in ("old", "new", "new", "old") * 2:
            turns[which].append(cuda_ms(kern if which == "new" else old))
        lib_err = check(f"torch.sparse.mm {name} D={D}",
                        torch.sparse.mm(csr, dense), want, 1e-4)
        worst = max(worst, err)
        bytes_ms = 1e3 * nbytes / H100_BYTES_PER_S
        ops_ms = 1e3 * nops / H100_F32_FLOPS
        floor_ms = 1e3 * floor_bytes / H100_BYTES_PER_S
        row = dict(shape=name, D=D, nodes=n, edges=E, gather=gather,
                   geometry=list(shape), max_abs_err=err,
                   ms=float(np.mean(turns["new"])), ms_turns=turns["new"],
                   old_ms=float(np.mean(turns["old"])),
                   old_ms_turns=turns["old"], old_max_abs_err=old_err,
                   equal_to_ordered=True,
                   wrapper_ms=cuda_ms(wrapper),
                   row_pointers_ms=cuda_ms(
                       lambda: spmm_ops.row_pointers(dst, n)),
                   plain_ms=cuda_ms(plain),
                   library_ms=cuda_ms(lambda: torch.sparse.mm(csr, dense)),
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   bytes=nbytes, ops=nops, library_max_abs_err=lib_err)
        rows.append(row)
        print(f"[8] spmm {name} D={D} ({n} nodes, {E} edges, "
              f"{'gather x coeff' if gather else 'messages'}): kernel "
              f"(lanes, vec) = {shape} "
              f"{' / '.join(f'{t:.4f}' for t in turns['new'])} ms, the old "
              f"wide shape in turns "
              f"{' / '.join(f'{t:.4f}' for t in turns['old'])} ms "
              f"({row['old_ms'] / row['ms']:.2f}x); bits == its ordered "
              f"sum; gather floor {floor_ms:.4f} ms ({floor_bytes / 1e9:.4f} "
              f"GB of sectors and streams over 3.35 TB/s) (wrapper over the "
              f"row pointers "
              f"{row['wrapper_ms']:.4f} ms; building them, once per graph, "
              f"{row['row_pointers_ms']:.4f} ms), plain "
              f"{row['plain_ms']:.4f} ms, torch.sparse.mm "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"by {row['bound_by']} ({nbytes / 1e9:.4f} GB over 3.35 TB/s,"
              f" {nops / 1e9:.4f} Gflop over 67 TFLOP/s); max |d| "
              f"{err:.3g}", flush=True)
        del got, want, csr, col, vals
    print(f"[8] done in {time.time() - t0:.1f}s", flush=True)

    # ---- 9. GNN serving on the card at published widths ----
    t0 = time.time()
    runs = [("gcn-cora", cora_cfg, g_cora, 2),
            ("gcn-cora", ogb_cfg, g_ogb, 2),
            ("gatedgcn", dataclasses.replace(gnn_archs.GATEDGCN,
                                             d_in=d_feat), g_cora, 32),
            ("meshgraphnet", dataclasses.replace(gnn_archs.MESHGRAPHNET,
                                                 d_in=d_feat), g_cora, 15),
            ("graphcast", gc_cfg, g_gc, 18)]
    spmm_ops.launches = 0
    serving = []
    for i, (arch, cfg, g, per_fwd) in enumerate(runs):
        shape_name = "ogb_products" if g is g_ogb else "full_graph_sm"
        params = gnn.init_gnn_params(cfg, gen.manual_seed(100 + i))
        before = spmm_ops.launches
        with torch.no_grad():
            out = gnn.gnn_forward(cfg, params, g)
            torch.cuda.synchronize()
            if spmm_ops.launches - before != per_fwd:
                raise AssertionError(f"{arch}: {spmm_ops.launches - before} "
                                     f"spmm launches, expected {per_fwd}")
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{arch} {shape_name}: non-finite")
            cpu, note = {}, ""
            if g is not g_ogb:
                tc = time.time()
                cpu, note = vs_cpu(arch, cfg, params, g, out)
                note = f"; {note}; reference {time.time() - tc:.1f}s"
            reps = 3 if g is g_ogb or arch == "graphcast" else 10
            wall, peak, peak_fwd, _ = forward_wall(
                lambda: gnn.gnn_forward(cfg, params, g), reps)
        serving.append(dict(arch=arch, shape=shape_name, wall_s=wall,
                            peak_bytes=peak, peak_forward_bytes=peak_fwd,
                            spmm_launches=per_fwd, out=list(out.shape),
                            **cpu))
        print(f"[9] {arch} on {shape_name}: out {list(out.shape)} finite; "
              f"{per_fwd} spmm launches per forward; wall "
              f"{1e3 * wall:.3f} ms per forward (host clock, ends in "
              f"synchronize, mean of {reps}); peak {peak / 2**20:.1f} MiB "
              f"({peak_fwd / 2**20:.1f} MiB above the resident graphs)"
              f"{note}", flush=True)
        del params, out
    launches = spmm_ops.launches
    if launches == 0:
        raise AssertionError("the GNN path launched no spmm kernel")
    print(f"[9] done in {time.time() - t0:.1f}s: {launches} spmm launches",
          flush=True)
    head = next(r for r in rows if r["shape"] == "ogb_products"
                and r["D"] == 16)      # GCN layer 1
    return {"name": "scatter_spmm", "route": "cuda",
            "source": "src/repro_torch/kernels/spmm/csrc/spmm.cu",
            "replaces": "src/repro/kernels/spmm/kernel.py:51",
            "replaces_wrapper": "repro/kernels/spmm/ops.py::spmm_sorted_coo",
            "launches": launches, "equal_to_plain": True,
            "geometry": head["geometry"], "old_ms": head["old_ms"],
            "max_abs_err": worst, "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "library": "torch.sparse.mm (CSR)",
            "headline_shape": "ogb_products D=16", "shapes": rows,
            "serving": serving, "card": smi}


def dlrm_phases(smi: str, dev: torch.device) -> dict:
    """Phases 10 and 11: the EmbeddingBag kernel against its plain version
    and the library call on the full RM2 tables, then DLRM serving."""
    cfg = DLRM_RM2
    shapes = {s.name: s for s in recsys_shapes()}
    gen = torch.Generator(device=dev).manual_seed(7)

    # ---- 10. kernel vs plain at RM2 widths, on the full tables ----
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    params = dlrm.prepare_dlrm_params(dlrm.init_dlrm_params(cfg, gen))
    tables = params["tables"]          # checked once: a BagTables
    torch.cuda.synchronize()
    table_bytes = sum(t.numel() * 4 for t in tables)
    print(f"[10] {len(tables)} tables, {sum(t.shape[0] for t in tables)} "
          f"rows x {cfg.embed_dim} f32 = {table_bytes / 1e9:.2f} GB drawn "
          f"on the card in {time.time() - t0:.3f}s", flush=True)

    def batch(name):
        b = recsys_batch(RecSysBatchSpec(
            shapes[name].dim("batch"), cfg.n_dense, cfg.n_sparse,
            cfg.lookups_per_field, cfg.resolved_vocabs()), 0)
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    batches = {name: batch(name) for name in ("serve_p99", "serve_bulk")}
    rows, worst = [], 0.0
    for name, b in batches.items():
        idx = b["sparse"]
        B, Fn, L = idx.shape
        kern = lambda: bag_ops.embedding_bags(tables, idx)  # noqa: E731
        plain = lambda: embedding_bags_ref(tables, idx)  # noqa: E731
        fields = [idx[:, f].long() for f in range(Fn)]

        def library():
            return [F.embedding_bag(fields[f], t, mode="sum")
                    for f, t in enumerate(tables)]

        before = dict(bag_ops.shape_launches)
        got, want = kern(), plain()
        shape = [g for g, n in bag_ops.shape_launches.items()
                 if n != before.get(g, 0)]
        if len(shape) != 1:
            raise AssertionError(f"bag {name}: launches on {shape}")
        shape = shape[0]
        err = check(f"embedding bag {name}", got, want, 1e-5)
        # the kernel's own order of sums, in plain PyTorch: the same bits
        if not same_bits(got, embedding_bags_ordered(tables, idx)):
            raise AssertionError(f"embedding bag {name}: not the bits of "
                                 f"its ordered sum ({shape})")
        check(f"F.embedding_bag {name}", torch.stack(library(), 1), want,
              1e-5)
        worst = max(worst, err)
        # the bound counts each distinct row once; the gather floor every
        # lookup into a table larger than the L2 (no reuse found there)
        distinct = floor_rows = 0
        for f, t in zip(fields, tables):
            n = int(torch.unique(f).numel())
            distinct += n
            floor_rows += f.numel() if t.numel() * 4 > H100_L2_BYTES else n
        row_bytes = cfg.embed_dim * 4
        nbytes = idx.numel() * 4 + distinct * row_bytes + got.numel() * 4
        floor_bytes = nbytes + (floor_rows - distinct) * row_bytes
        nops = idx.numel() * cfg.embed_dim       # an add a gathered entry
        bytes_ms = 1e3 * nbytes / H100_BYTES_PER_S
        ops_ms = 1e3 * nops / H100_F32_FLOPS
        row = dict(shape=name, B=B, F=Fn, L=L, D=cfg.embed_dim,
                   geometry=list(shape), distinct_rows=distinct,
                   max_abs_err=err, equal_to_ordered=True,
                   ms=cuda_ms(kern), graph_ms=graph_ms(kern),
                   plain_ms=cuda_ms(plain), library_ms=cuda_ms(library),
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        floor_ms = 1e3 * floor_bytes / H100_BYTES_PER_S
        share = row["bound_ms"] / row["ms"]
        rows.append(row)
        print(f"[10] embedding bag {name} (B={B}, F={Fn}, L={L}, D="
              f"{cfg.embed_dim}; {distinct} distinct rows): kernel "
              f"(lanes, vec, lt, rounds) = {tuple(shape)}, "
              f"{shape.bags} bags a warp; {row['ms']:.4f} ms by the call "
              f"rate, {row['graph_ms']:.4f} ms of device time (a CUDA "
              f"graph of the launch replayed); bits == its ordered sum; "
              f"plain {row['plain_ms']:.4f} ms, F.embedding_bag x{Fn} "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"by {row['bound_by']} ({nbytes / 1e9:.4f} GB over 3.35 TB/s, "
              f"{nops / 1e9:.4f} Gflop over 67 TFLOP/s; "
              f"{100 * share:.1f}% of the kernel's time), "
              f"gather floor {floor_ms:.4f} ms "
              f"({floor_bytes / 1e9:.4f} GB: every lookup into a table "
              f"above the 50 MB L2 from memory); max |d| {err:.3g}",
              flush=True)
        del got, want
    print(f"[10] done in {time.time() - t0:.1f}s", flush=True)

    # ---- 11. DLRM-RM2 serving at full width ----
    t0 = time.time()
    gen.manual_seed(8)
    cand = torch.randn((shapes["retrieval_cand"].dim("n_candidates"),
                        cfg.embed_dim), generator=gen, device=dev)
    q = batch("serve_p99")
    query = dict(dense=q["dense"][:1], sparse=q["sparse"][:1].contiguous(),
                 candidates=cand)
    bag_ops.launches = 0
    bag_ops.shape_launches.clear()
    serving = []
    with torch.no_grad():
        for name, fn, reps in (
                ("serve_p99",
                 lambda: dlrm.dlrm_forward(cfg, params, batches["serve_p99"]),
                 20),
                ("serve_bulk",
                 lambda: dlrm.dlrm_forward(cfg, params,
                                           batches["serve_bulk"]), 5),
                ("retrieval_cand",
                 lambda: dlrm.retrieval_score(cfg, params, query), 10)):
            before = bag_ops.launches
            wall, peak, peak_fwd, out = forward_wall(fn, reps)
            per_fwd = (bag_ops.launches - before) / (reps + 1)
            if per_fwd < 1:
                raise AssertionError(f"{name}: no EmbeddingBag launch")
            if name == "retrieval_cand":
                scores, ids = out
                assert scores.shape == ids.shape == (1, 100)
                ok = bool(torch.isfinite(scores).all())
            else:
                assert out.shape == (batches[name]["dense"].shape[0],)
                ok = bool(torch.isfinite(out).all())
            if not ok:
                raise AssertionError(f"{name}: non-finite output")
            serving.append(dict(shape=name, wall_s=wall, peak_bytes=peak,
                                peak_forward_bytes=peak_fwd,
                                launches_per_forward=per_fwd))
            shp = [list(o.shape) for o in out] \
                if name == "retrieval_cand" else list(out.shape)
            print(f"[11] {name}: out {shp} finite; {per_fwd:g} "
                  f"EmbeddingBag launches per forward; "
                  f"wall {1e3 * wall:.3f} ms per forward (host clock, ends "
                  f"in synchronize, mean of {reps}); peak "
                  f"{peak / 2**30:.2f} GiB allocated "
                  f"({peak_fwd / 2**20:.1f} MiB above the resident tables "
                  f"and batches)", flush=True)
        launches = bag_ops.launches
        by_shape = dict(bag_ops.shape_launches)
        main_shape = bag_ops.geometry(cfg.embed_dim, cfg.lookups_per_field)
        if by_shape != {main_shape: launches}:
            raise AssertionError(f"main-path bag launches by shape "
                                 f"{by_shape}, not all on {main_shape}")
        # the same forwards on the CPU over the rows the batch touches
        sub = cpu_subtables(tables, q["sparse"])
        cpu_params = dict(tables=sub[0], bot=to_cpu(params["bot"]),
                          top=to_cpu(params["top"]))
        want = dlrm.dlrm_forward(cfg, cpu_params, dict(
            dense=q["dense"].cpu(), sparse=sub[1]))
        got = dlrm.dlrm_forward(cfg, params, q)
        err, used = check_close("serve_p99 logits vs CPU", got.cpu(), want,
                                1e-4)
        w_scores, w_ids = dlrm.retrieval_score(cfg, cpu_params, dict(
            dense=q["dense"][:1].cpu(), sparse=sub[1][:1].contiguous(),
            candidates=cand.cpu()))
        g_scores, g_ids = dlrm.retrieval_score(cfg, params, query)
        s_err, s_used = check_close("retrieval scores vs CPU",
                                    g_scores.cpu(), w_scores, 1e-4)
        same_ids = float((g_ids.cpu() == w_ids).float().mean())
        if same_ids < 0.95:
            raise AssertionError(f"retrieval ids agree on {same_ids:.2%}")
    print(f"[11] serve_p99 logits == CPU forward over the touched rows, "
          f"elementwise (scaled error {used:.3g} <= 1e-4; max |d| "
          f"{err:.3g}); retrieval top-100 scores == CPU (scaled error "
          f"{s_used:.3g}; max |d| {s_err:.3g}), ids equal on "
          f"{same_ids:.0%}; {launches} bag launches, all in the shape "
          f"{tuple(main_shape)}; done in {time.time() - t0:.1f}s",
          flush=True)
    del params, tables, cand, batches
    torch.cuda.empty_cache()
    head, p99 = rows[1], rows[0]      # serve_bulk, serve_p99
    return {"name": "embedding_bag_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/embedding_bag/csrc/"
                      "embedding_bag.cu",
            "replaces": "src/repro/kernels/embedding_bag/kernel.py:38",
            "launches": launches, "launches_by_shape": {
                str(tuple(k)): v for k, v in by_shape.items()},
            "equal_to_plain": True, "equal_to_ordered": True,
            "geometry": head["geometry"],
            "graph_ms": head["graph_ms"], "p99_ms": p99["ms"],
            "p99_graph_ms": p99["graph_ms"],
            "max_abs_err": worst, "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "library": "torch.nn.functional.embedding_bag, one call per "
                       "table (26)",
            "headline_shape": "serve_bulk", "shapes": rows,
            "serving": serving, "table_bytes": table_bytes, "card": smi}


def cpu_subtables(tables, sparse):
    """The rows of each table that ``sparse`` [B, F, L] touches, on the
    CPU, and the indices renumbered into them."""
    subs, idx = [], []
    for f, t in enumerate(tables):
        rows, inv = torch.unique(sparse[:, f], return_inverse=True)
        subs.append(t[rows.long()].cpu())
        idx.append(inv.to(torch.int32).cpu())
    return subs, torch.stack(idx, 1).contiguous()


FLASH_SHAPES = [   # (config, B, T, H, Kh, dh): the dense LMs' attention
    ("llama3.2-1b", 1, 4096, 32, 8, 64),
    ("qwen3-1.7b", 1, 4096, 16, 8, 128),
    ("starcoder2-3b", 1, 4096, 24, 2, 128)]
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


def flash_excess(got, want, dtype) -> tuple[float, float]:
    """(max |got - want|, the largest |got - want| over its limit), entry
    by entry; above 1 fails.  The limit is tol x (|want| + a): in f32 a = 1,
    as ``tests/test_kernels.py`` holds the Pallas kernel (the 3xTF32
    kernel's split operands and order of sums put it a few 1e-6 off,
    whatever the entry's size; one TF32 product would be ~40-90x the
    limit, ``tests/test_torch_flash_tf32.py``); in bf16
    a = median |want|, as the two differ by the output's one rounding (at
    most 2^-7 |want|) and a row t averages some t / e keys, so at
    T = 32768 a typical |out| is ~0.01 while the first rows reach 3 to 4:
    a limit scaled by the largest |want| would pass a wrong kernel."""
    d = (got.double() - want.double()).abs()
    w = want.double().abs()
    a = float(w.median()) if dtype == torch.bfloat16 else 1.0
    return float(d.max()), float((d / (FLASH_TOL[dtype] * (w + a))).max())


def flash_bound(B, T, H, Kh, dh, dtype) -> tuple[float, str, int, int]:
    """(bound ms, what bounds it, bytes, flops) of a causal forward: q, k
    and v read once, o written once; 4 dh flops a head and (row, col <=
    row) pair, over the best rate at which the card reaches the inputs'
    accuracy: the bf16 tensor cores, or for f32 three TF32 tensor-core
    products (165 TFLOP/s; the CUDA cores' 67 are printed beside it)."""
    nbytes = 2 * B * T * (H + Kh) * dh * (torch.finfo(dtype).bits // 8)
    flops = 4 * B * H * dh * (T * (T + 1) // 2)
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_TC_FLOPS
    bytes_ms, ops_ms = 1e3 * nbytes / H100_BYTES_PER_S, 1e3 * flops / peak
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes, flops)


def banded_ref(q, k, v, window):
    """The plain version with each row's keys more than ``window`` back
    masked too: a planted fault, a kernel that drops the far keys of the
    late rows (rows within ``window`` of the start are unchanged)."""
    B, T, H, dh = q.shape
    G = H // k.shape[2]
    qf = (q.float() * (1.0 / dh ** 0.5)).reshape(B, T, -1, G, dh)
    s = torch.einsum("btkgd,bskd->bkgts", qf, k.float())
    rows = torch.arange(T, device=q.device)[:, None]
    cols = torch.arange(T, device=q.device)[None, :]
    s = s.masked_fill((cols > rows) | (cols <= rows - window), -1e30)
    out = torch.einsum("bkgts,bskd->btkgd", torch.softmax(s, dim=-1),
                       v.float())
    return out.reshape(B, T, H, dh).to(q.dtype)


def flash_case(name, B, T, H, Kh, dh, dtype, gen, dev) -> dict:
    """Phase 13 at one shape: the kernel against its plain version (head
    by head above T = 8192, where the plain score matrix would not fit),
    timed beside them, SDPA and the bound."""
    q = torch.randn((B, T, H, dh), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((B, T, Kh, dh), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    G = H // Kh
    kern = lambda: fa_ops.flash_attention(q, k, v)  # noqa: E731
    by_head = T > 8192

    def plain_of(q, k, v, fn=flash_attention_ref, *a):
        if not by_head:
            return fn(q, k, v, *a)
        return torch.cat([fn(q[:, :, h:h + 1], k[:, :, h // G:h // G + 1],
                             v[:, :, h // G:h // G + 1], *a)
                          for h in range(H)], dim=2)

    plain = lambda: plain_of(q, k, v)  # noqa: E731
    # the yardstick, on K/V repeated to the query heads beforehand
    qs, ks, vs = (t.transpose(1, 2) for t in (
        q, k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)))
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qs, ks, vs, is_causal=True).transpose(1, 2)

    def efficient():      # SDPA held to its memory-efficient backend
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return library()
    before = dict(fa_ops.path_launches)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    path = [p for p, n in fa_ops.path_launches.items() if n != before[p]]
    tag = f"flash {name} T={T} {dtype}"
    want_path = ("tensor_core" if dtype == torch.bfloat16
                 else "tensor_core_tf32x3")
    if path != [want_path]:
        raise AssertionError(f"{tag}: launched on {path}, not {want_path}")
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError(f"{tag}: NaN in different places")
    err, excess = flash_excess(got, want, dtype)
    if not excess <= 1:
        raise AssertionError(f"{tag}: an entry is off by {excess:.3g} x its "
                             f"limit (max |d| {err})")
    if not torch.equal(kern(), got):
        raise AssertionError("a second launch gave other bits")
    # planted faults the limit must reject: each query head reading the next
    # KV head, and each row past T/2 blind to the keys more than T/2 back
    faults = {"next_kv_head": plain_of(q, k.roll(1, dims=2),
                                       v.roll(1, dims=2)),
              "far_keys_dropped": plain_of(q, k, v, banded_ref, T // 2)}
    fault_excess = {f: flash_excess(out, want, dtype)[1]
                    for f, out in faults.items()}
    # the same faults against a limit scaled by max(1, max |want|)
    top = FLASH_TOL[dtype] * max(1.0, float(want.float().abs().max()))
    fault_max_scaled = {f: float((out.float() - want.float()).abs().max())
                        / top for f, out in faults.items()}
    del faults
    if not min(fault_excess.values()) > 1:
        raise AssertionError(f"{tag}: the limit passes a planted fault "
                             f"({fault_excess})")
    lib_out = library()
    lib_err = check(f"sdpa {name} T={T} {dtype}", lib_out, want, 2e-2)
    # the yardstick's own precision, under the kernel's limit, and the
    # backend the dispatcher picks
    lib_excess = flash_excess(lib_out, want, dtype)[1]
    eff_excess = flash_excess(efficient(), want, dtype)[1]
    backend = sdpa_backend(qs, ks, vs)
    del got, want, lib_out
    bound, by, nbytes, flops = flash_bound(B, T, H, Kh, dh, dtype)
    row = dict(shape=name, B=B, T=T, H=H, Kh=Kh, dh=dh,
               dtype=str(dtype).split(".")[-1], max_abs_err=err,
               excess=excess, fault_excess=fault_excess,
               fault_max_scaled=fault_max_scaled,
               plain_by_head=by_head, ms=cuda_ms(kern),
               plain_ms=cuda_ms(plain, min_reps=1),
               library_ms=cuda_ms(library), bound_ms=bound, bound_by=by,
               bytes=nbytes, flops=flops, library_max_abs_err=lib_err,
               library_excess=lib_excess, sdpa_backend=backend,
               efficient_ms=cuda_ms(efficient), efficient_excess=eff_excess,
               path=want_path)
    if dtype == torch.float32:     # the CUDA cores' bound, named as such
        row["cuda_core_bound_ms"] = 1e3 * flops / H100_F32_FLOPS
    row.update(tflops=flops / row["ms"] / 1e9,
               vs_library=row["ms"] / row["library_ms"],
               bound_share=bound / row["ms"])
    print(f"[13] flash {name} (B={B}, T={T}, H={H}, Kh={Kh}, dh={dh}, "
          f"{row['dtype']}, {want_path}): kernel {row['ms']:.4f} ms "
          f"({row['tflops']:.2f} TFLOP/s, {row['vs_library']:.3f}x SDPA, "
          f"{100 * row['bound_share']:.1f}% of the bound), plain "
          f"{row['plain_ms']:.4f} ms{' (head by head)' if by_head else ''}, "
          f"SDPA {row['library_ms']:.4f} ms ({backend}; under "
          f"EFFICIENT_ATTENTION {row['efficient_ms']:.4f} ms), bound "
          f"{bound:.4f} ms by {by} ({nbytes / 1e9:.4f} GB over 3.35 TB/s, "
          f"{flops / 1e9:.1f} Gflop over "
          f"{'989' if dtype == torch.bfloat16 else '165 (3xTF32)'} TFLOP/s"
          + (f"; CUDA-core bound at 67 TFLOP/s {row['cuda_core_bound_ms']:.4f}"
             f" ms" if dtype == torch.float32 else "") + "); "
          f"max |d| {err:.3g}, {excess:.3g} x the elementwise limit; planted "
          f"faults at {fault_excess['next_kv_head']:.3g} x (next KV head) and "
          f"{fault_excess['far_keys_dropped']:.3g} x (far keys dropped) "
          f"(against max(1, max |ref|) x tol: "
          f"{fault_max_scaled['next_kv_head']:.3g} x and "
          f"{fault_max_scaled['far_keys_dropped']:.3g} x); "
          f"SDPA max |d| {lib_err:.3g}, {lib_excess:.3g} x the elementwise "
          f"limit (EFFICIENT_ATTENTION {eff_excess:.3g} x)", flush=True)
    return row


def sdpa_backend(q, k, v) -> str:
    """The name of the backend SDPA's dispatcher picks for these inputs
    (causal), by ``torch._fused_sdp_choice``."""
    names = {b.value: n for n, b in SDPBackend.__members__.items()}
    return names[int(torch._fused_sdp_choice(q, k, v, is_causal=True))]


def prefill_run(tag, cfg, params, tokens, reps) -> dict:
    """Phase 14 at one config: ``prefill`` through the kernel, its
    launches, finite logits, the attention share by CUDA events, wall and
    peak memory."""
    B, T = tokens.shape
    before = fa_ops.launches
    logits = lm_serve.prefill(cfg, params, tokens)
    torch.cuda.synchronize()
    per_fwd = fa_ops.launches - before
    if per_fwd != cfg.n_layers:
        raise AssertionError(f"{tag}: {per_fwd} flash launches a forward, "
                             f"not {cfg.n_layers}")
    if logits.shape != (B, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{tag}: logits {list(logits.shape)} "
                             f"not finite or not [B, vocab]")
    events = []

    def timed(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = fa_ops.flash_attention(*a, **kw)
        ev[1].record()
        events.append(ev)
        return out

    whole = (torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True))
    with mock.patch.object(transformer, "flash_attention", timed):
        whole[0].record()
        lm_serve.prefill(cfg, params, tokens)
        whole[1].record()
    torch.cuda.synchronize()
    attn_ms = sum(a.elapsed_time(b) for a, b in events)
    device_ms = whole[0].elapsed_time(whole[1])
    wall, peak, peak_fwd, _ = forward_wall(
        lambda: lm_serve.prefill(cfg, params, tokens), reps)
    row = dict(config=cfg.name, B=B, T=T, wall_s=wall,
               tok_per_s=B * T / wall, flash_launches_per_forward=per_fwd,
               attention_ms=attn_ms, prefill_device_ms=device_ms,
               attention_share=attn_ms / device_ms, peak_bytes=peak,
               peak_forward_bytes=peak_fwd)
    print(f"[14] {tag}: logits {list(logits.shape)} finite; {per_fwd} flash "
          f"launches a forward; wall {wall:.4f} s a prefill (host clock, "
          f"ends in synchronize, mean of {reps}) = {B * T / wall:.1f} "
          f"tokens/s; attention {attn_ms:.1f} of {device_ms:.1f} ms by CUDA "
          f"events ({100 * attn_ms / device_ms:.1f}%); peak "
          f"{peak / 2**30:.2f} GiB ({peak_fwd / 2**30:.2f} GiB above the "
          f"resident weights)", flush=True)
    return row


def lm_phases(smi: str, dev: torch.device, ptxas: list) -> dict:
    """Phases 13 to 15: the flash kernel against its plain version and
    SDPA, prefill at full width through it, and serving at full width."""
    gen = torch.Generator(device=dev)

    # ---- 13. flash kernel vs plain at the LMs' attention shapes ----
    t0 = time.time()
    rows = [flash_case(*shp, dtype, gen.manual_seed(13), dev)
            for shp in FLASH_SHAPES
            for dtype in (torch.bfloat16, torch.float32)]
    # arctic's heads (56/8: G = 7, an odd group count; phase 46's shape)
    rows.append(flash_case("arctic-480b", 1, 4096, 56, 8, 128,
                           torch.bfloat16, gen.manual_seed(13), dev))
    # phi3.5-moe's prefill_32k heads (32/8 at dh 128; phase 46's shape)
    rows.append(flash_case("phi3.5-moe-42b-a6.6b", 1, 32768, 32, 8, 128,
                           torch.bfloat16, gen.manual_seed(13), dev))
    # last: the kernels line's row
    rows.append(flash_case("llama3.2-1b", 1, 32768, 32, 8, 64,
                           torch.bfloat16, gen.manual_seed(13), dev))
    torch.cuda.empty_cache()
    print(f"[13] done in {time.time() - t0:.1f}s", flush=True)

    # ---- 14. prefill at full width ----
    t0 = time.time()
    shapes = {s.name: s for s in lm_shapes()}
    cfg = lm_archs.LLAMA32_1B
    T = shapes["prefill_32k"].dim("seq_len")        # B = 1; B = 16 once
    params = transformer.init_lm_params(cfg, gen.manual_seed(14))
    tokens = torch.randint(0, cfg.vocab, (1, T), generator=gen, device=dev,
                           dtype=torch.int32)
    fa_ops.launches = 0     # the main path: this run's forwards
    fa_ops.path_launches = dict.fromkeys(fa_ops.PATHS, 0)
    prefills = [prefill_run(f"{cfg.name} prefill_32k B=1 T={T}", cfg,
                            params, tokens, 2)]
    launches, by_path = fa_ops.launches, dict(fa_ops.path_launches)
    # prefill_run's forwards: a check, a timed one, a warm one and 2 reps
    if launches != 5 * cfg.n_layers or by_path["tensor_core"] != launches:
        raise AssertionError(f"the main path made {launches} flash launches "
                             f"({by_path}), not {5 * cfg.n_layers} on the "
                             f"tensor-core path")
    # the kernel path against an f32 forward and the plain attention, T=2048
    tok = tokens[:, :2048].contiguous()
    with mock.patch.object(transformer, "flash_attention",
                           flash_attention_ref):
        ref = transformer.lm_forward(dataclasses.replace(
            cfg, compute_dtype=torch.float32), params, tok)[0]
        base = transformer.lm_forward(cfg, params, tok)[0]
    got = transformer.lm_forward(cfg, params, tok)[0]
    scale = max(1.0, float(ref.abs().max()))
    d_got = float((got.float() - ref).abs().max()) / scale
    d_base = float((base.float() - ref).abs().max()) / scale
    limit = max(1e-3, 2 * d_base)
    if not d_got <= limit:
        raise AssertionError(f"kernel path off the f32 forward by {d_got:.3g}"
                             f", plain attention by {d_base:.3g}")
    del ref, base, got
    print(f"[14] T=2048: bf16 logits through the kernel off the f32 forward "
          f"by {d_got:.3g} x max |ref| ({scale:.3g}), through the plain "
          f"attention by {d_base:.3g} (limit max(1e-3, 2x) = {limit:.3g})",
          flush=True)
    # prefill's last-token logits against 128 decode steps, T = 128
    tok = tokens[:, :128].contiguous()
    want = lm_serve.prefill(cfg, params, tok).float()
    cache = transformer.init_kv_cache(cfg, 1, 128, device=dev)
    lengths = torch.zeros(1, dtype=torch.int32, device=dev)
    for t in range(128):
        logits, cache = transformer.lm_decode_step(cfg, params,
                                                   tok[:, t:t + 1], cache,
                                                   lengths)
        lengths += 1
    # both bf16 paths, rounding at other places (the decode rounds q * scale
    # and p to bf16, the kernel keeps f32): at reduced widths on the CPU
    # they differ by 1.0-1.5e-2 x max |logit|, as much as either differs
    # from its f32 forward
    dec_err = check("decode vs prefill", logits[:, -1], want, 5e-2)
    print(f"[14] T=128: prefill's last-token logits == 128 decode steps "
          f"within 5e-2 x max(1, max |ref|) (max |d| {dec_err:.3g} on max "
          f"|ref| {float(want.abs().max()):.3g})", flush=True)
    del cache, logits, want
    # prefill_32k at the largest power-of-two batch that fits, once: its
    # own B = 32 runs out of the card's memory (the gated FFN's four
    # [B, T, 8192] bf16 temporaries alone are 64 GiB); the timings above
    # run at B = 1, as at ~2.6 s a sequence five forwards at B = 16 would
    # take some three and a half minutes
    Bp = shapes["prefill_32k"].dim("global_batch") // 2
    toks = torch.randint(0, cfg.vocab, (Bp, T), generator=gen, device=dev,
                         dtype=torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before, t1 = fa_ops.launches, time.time()
    logits = lm_serve.prefill(cfg, params, toks)
    torch.cuda.synchronize()
    wall = time.time() - t1
    per_fwd = fa_ops.launches - before
    if per_fwd != cfg.n_layers or logits.shape != (Bp, cfg.vocab) or not (
            bool(torch.isfinite(logits).all())):
        raise AssertionError(f"prefill_32k B={Bp}: {per_fwd} flash launches, "
                             f"logits {list(logits.shape)} not all finite")
    full_batch = dict(config=cfg.name, B=Bp, T=T, wall_s=wall,
                      tok_per_s=Bp * T / wall, flash_launches=per_fwd,
                      peak_bytes=torch.cuda.max_memory_allocated())
    print(f"[14] {cfg.name} prefill_32k B={Bp} T={T}, one forward: logits "
          f"{list(logits.shape)} finite; {per_fwd} flash launches; wall "
          f"{wall:.3f} s (host clock, ends in synchronize) = "
          f"{Bp * T / wall:.1f} tokens/s; peak "
          f"{full_batch['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    del params, tokens, toks, logits
    torch.cuda.empty_cache()
    qcfg = lm_archs.QWEN3_1P7B
    params = transformer.init_lm_params(qcfg, gen.manual_seed(15))
    tokens = torch.randint(0, qcfg.vocab, (1, 4096), generator=gen,
                           device=dev, dtype=torch.int32)
    prefills.append(prefill_run(f"{qcfg.name} B=1 T=4096", qcfg, params,
                                tokens, 3))
    del params, tokens
    torch.cuda.empty_cache()
    print(f"[14] done in {time.time() - t0:.1f}s: {launches} flash launches "
          f"in the main path's prefill_32k B=1 run "
          f"({launches // cfg.n_layers} forwards), by path {by_path}",
          flush=True)

    # ---- 15. serving at full width ----
    t0 = time.time()
    dec = shapes["decode_32k"]                      # 128 slots cut to 32
    torch.cuda.reset_peak_memory_stats()
    out, tput, metrics = lm_serve.serve(cfg, 64, 32, prompt_len=16,
                                        gen_len=24,
                                        max_len=dec.dim("seq_len"), seed=16,
                                        device=dev)
    peak = torch.cuda.max_memory_allocated()
    if sorted(out) != list(range(64)) or any(
            len(v) != 24 or not all(0 <= x < cfg.vocab for x in v)
            for v in out.values()):
        raise AssertionError("serve did not answer every request with 24 "
                             "tokens of the vocabulary")
    serving = dict(metrics, requests=64, slots=32, max_len=dec.dim("seq_len"),
                   peak_bytes=peak, wall_s=time.time() - t0)
    print(f"[15] {cfg.name} serve: 64 requests answered (24 tokens each) "
          f"through 32 slots, max_len {dec.dim('seq_len')}: "
          f"{metrics['steps']} steps, decode step p50 {metrics['p50']:.2f} "
          f"ms, p99 {metrics['p99']:.2f} ms (first "
          f"{metrics['first_step_ms']:.1f} ms), {tput:.1f} tokens/s; peak "
          f"{peak / 2**30:.2f} GiB; "
          f"{serving['wall_s']:.1f}s", flush=True)
    torch.cuda.empty_cache()
    head = rows[-1]         # llama3.2-1b at prefill_32k's T, bf16
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention_tc.cuh",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:71",
            "path": "tensor_core", "launches": launches,
            "launches_by_path": by_path,
            "f32_source": "src/repro_torch/kernels/flash_attention/csrc/"
                          "flash_attention_tf32.cuh",
            "f32_path": "tensor_core_tf32x3",
            "launches_per_forward": prefills[0]["flash_launches_per_forward"],
            "equal_to_plain": True,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "excess": max(r["excess"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "tflops": head["tflops"],
            "vs_library": head["vs_library"],
            "bound_share": head["bound_share"], "ptxas": ptxas,
            "library": "torch.nn.functional.scaled_dot_product_attention "
                       "(causal, K/V repeated to the query heads)",
            "headline_shape": "llama3.2-1b T=32768 bf16", "shapes": rows,
            "prefill": prefills, "prefill_full_batch": full_batch,
            "serving": serving, "card": smi}


# ---- MoE serving (phases 45-47) ----

MOE_S = 512              # phase 45's tokens: _ffn_moe against its einsums
MOE_PARTS = ("_route", "_dispatch", "_experts", "_combine")


def bf16_step(x) -> float:
    """The spacing of bf16 numbers at the largest |x|."""
    return 2.0 ** (math.floor(math.log2(float(x.float().abs().max()))) - 7)


def moe_vs_plain(tag, cfg, lp, gen, dev) -> dict:
    """Phase 45 at one config: ``_ffn_moe`` (index dispatch) against
    ``_ffn_moe_ref`` (the ``[S, E, cap]`` einsums) on the card at S = 512
    in bf16; the slots of the sort against the one-hot cumsum's; each
    timed."""
    x = torch.randn((1, MOE_S, cfg.d_model), generator=gen,
                    device=dev).to(cfg.compute_dtype)
    _, _, topi, _ = transformer._route(cfg, lp, x[0])
    pos = transformer._moe_slots(topi, cfg.n_experts)
    if not torch.equal(pos, transformer._moe_slots_onehot(topi,
                                                          cfg.n_experts)):
        raise AssertionError(f"{tag}: the slots differ from the one-hot "
                             f"cumsum's")
    cap = transformer._capacity(cfg, MOE_S, 4)
    dropped = int((pos >= cap).sum())
    transformer.reset_moe_dropped()
    got, aux = transformer._ffn_moe(cfg, lp, x)
    counted = transformer.moe_dropped()
    ref, aux_ref = transformer._ffn_moe_ref(cfg, lp, x)
    if counted != dropped or not torch.equal(aux, aux_ref):
        raise AssertionError(f"{tag}: dropped {counted} != {dropped} "
                             f"or aux {float(aux)} != {float(aux_ref)}")
    d = (got.float() - ref.float()).abs()
    step = bf16_step(ref)
    if not float(d.max()) <= step:
        raise AssertionError(f"{tag}: _ffn_moe off its plain version by "
                             f"{float(d.max())} > one bf16 step {step}")
    row = dict(config=cfg.name, S=MOE_S, cap=cap, dropped=dropped,
               equal_bits=bool(torch.equal(got, ref)),
               entries_off=int((d > 0).sum()), max_abs_err=float(d.max()),
               bf16_step=step,
               ms=cuda_ms(lambda: transformer._ffn_moe(cfg, lp, x)),
               plain_ms=cuda_ms(lambda: transformer._ffn_moe_ref(cfg, lp,
                                                                 x)))
    print(f"[45] {tag}: _ffn_moe vs _ffn_moe_ref at S={MOE_S} bf16 (cap "
          f"{cap}, {dropped} (token, k) pairs dropped): routing equal, the "
          f"slots of the sort == the one-hot cumsum's, keep equal; output "
          + ("equal bit for bit" if row["equal_bits"] else
             f"{row['entries_off']} entries one bf16 step off (cuBLAS rounds "
             f"an einsum's f32 sums to bf16 in parts), max |d| "
             f"{row['max_abs_err']:.3g} <= {step:.3g}")
          + f"; {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms",
          flush=True)
    return dict(row, x=x)


def moe_ep_vs_dense(cfg, lp, x) -> list:
    """Phase 45: phi3.5-moe's ``_ffn_moe_ep`` on ``LocalTiles`` at (1, 4)
    and (2, 2) against ``_ffn_moe`` on the card, at capacity factor E / K
    (no rank and no expert can drop), within two bf16 steps of the
    largest |out| (EP adds the f32 gates in f32, rounds a rank's sum to
    bf16 and sums bf16 over ``model``; the dense path rounds the gates to
    bf16 and the sum of both experts once)."""
    wide = dataclasses.replace(cfg, moe_impl="ep",
                               capacity_factor=cfg.n_experts / cfg.top_k)
    dense, _ = transformer._ffn_moe(wide, lp, x)
    rows = []
    for shape in ((1, 4), (2, 2)):
        set_dist_mesh(make_host_mesh(*shape, device=x.device))
        try:
            transformer.reset_moe_dropped()
            ep, _ = transformer._ffn_moe_ep(wide, lp, x)
            drops = transformer.moe_dropped()
            ms = cuda_ms(lambda: transformer._ffn_moe_ep(wide, lp, x))
        finally:
            set_dist_mesh(None)
        err, tol = float((ep.float() - dense.float()).abs().max()), \
            2 * bf16_step(dense)
        if drops or not err <= tol:
            raise AssertionError(f"EP {shape}: {drops} dropped, off the "
                                 f"dense dispatch by {err} > {tol}")
        rows.append(dict(mesh=list(shape), max_abs_err=err, tol=tol, ms=ms))
        print(f"[45] {cfg.name} layer 0 _ffn_moe_ep on LocalTiles {shape} "
              f"(cf {wide.capacity_factor}, none dropped) == _ffn_moe within "
              f"two bf16 steps of max |out| (max |d| {err:.3g} <= "
              f"{tol:.3g});"
              f" {ms:.4f} ms", flush=True)
    return rows


def moe_prefill_run(tag, cfg, params, tokens) -> dict:
    """Phase 46 at one config: ``prefill`` with the flash counts set to 0
    just before and read just after (a main path of the kernels line),
    finite logits, the (token, k) pairs dropped, then a forward with each
    part of the MoE block timed by CUDA events, the wall and peak
    memory."""
    B, T = tokens.shape
    transformer.reset_moe_dropped()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.launches = 0
    fa_ops.path_launches = dict.fromkeys(fa_ops.PATHS, 0)
    t0 = time.time()
    logits = lm_serve.prefill(cfg, params, tokens)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches, by_path = fa_ops.launches, dict(fa_ops.path_launches)
    peak = torch.cuda.max_memory_allocated()
    if launches != cfg.n_layers or by_path["tensor_core"] != launches:
        raise AssertionError(f"{tag}: {launches} flash launches ({by_path}),"
                             f" not {cfg.n_layers} on the tensor-core path")
    if logits.shape != (B, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{tag}: logits {list(logits.shape)} not "
                             f"finite or not [B, vocab]")
    dropped = transformer.moe_dropped()
    events = collections.defaultdict(list)

    def timed(name, fn):
        def run(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            events[name].append(ev)
            return out
        return run
    whole = (torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True))
    with contextlib.ExitStack() as stack:
        for name in (*MOE_PARTS, "_ffn_moe", "flash_attention"):
            stack.enter_context(mock.patch.object(
                transformer, name, timed(name, getattr(transformer, name))))
        whole[0].record()
        lm_serve.prefill(cfg, params, tokens)
        whole[1].record()
    torch.cuda.synchronize()
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in events.items()}
    device_ms = whole[0].elapsed_time(whole[1])
    wall, _, _, _ = forward_wall(
        lambda: lm_serve.prefill(cfg, params, tokens), 1)
    S, K, E = B * T, cfg.top_k, cfg.n_experts
    cap = transformer._capacity(cfg, S, 4)
    # the expert products' bound: the kept rows' flops at the bf16 peak, or
    # every layer's expert weights (as stored) read once with the rows in
    # and out, whichever is longer
    mats = 3 if cfg.gated_ffn else 2
    flops = 2 * (S * K * cfg.n_layers - dropped) * cfg.d_model * cfg.d_ff \
        * mats
    nbytes = cfg.n_layers * (
        E * mats * cfg.d_model * cfg.d_ff
        * (torch.finfo(cfg.param_dtype).bits // 8)
        + 2 * E * cap * cfg.d_model * 2)
    flops_ms, bytes_ms = (1e3 * flops / H100_BF16_FLOPS,
                          1e3 * nbytes / H100_BYTES_PER_S)
    bound_ms = max(flops_ms, bytes_ms)
    row = dict(config=cfg.name, layers=cfg.n_layers, B=B, T=T,
               param_dtype=str(cfg.param_dtype).split(".")[-1],
               flash_launches=launches, flash_by_path=by_path,
               dropped=dropped, pairs=S * K * cfg.n_layers, cap=cap,
               first_s=first_s, wall_s=wall, tok_per_s=B * T / wall,
               device_ms=device_ms, moe_ms=ms["_ffn_moe"],
               routing_ms=ms["_route"], dispatch_ms=ms["_dispatch"],
               experts_ms=ms["_experts"], combine_ms=ms["_combine"],
               attention_ms=ms["flash_attention"], experts_flops=flops,
               experts_bytes=nbytes, experts_flops_ms=flops_ms,
               experts_bytes_ms=bytes_ms, experts_bound_ms=bound_ms,
               experts_bound_by="operations" if flops_ms >= bytes_ms
               else "bytes",
               padded_rows=E * cap * cfg.n_layers, peak_bytes=peak)
    print(f"[46] {tag}: logits {list(logits.shape)} finite; {launches} flash "
          f"launches ({by_path}); {dropped} of {row['pairs']} (token, k) "
          f"pairs dropped (cap {cap} a layer); wall {wall:.4f} s (host "
          f"clock, ends in synchronize; first call {first_s:.3f} s) = "
          f"{B * T / wall:.1f} tokens/s; by CUDA events of {device_ms:.1f} "
          f"ms: the MoE block {ms['_ffn_moe']:.1f} ms "
          f"({100 * ms['_ffn_moe'] / device_ms:.1f}%: routing "
          f"{ms['_route']:.2f}, dispatch {ms['_dispatch']:.2f}, expert "
          f"products {ms['_experts']:.2f}, combine {ms['_combine']:.2f}), "
          f"attention {ms['flash_attention']:.1f}; the expert products' "
          f"bound {bound_ms:.2f} ms by {row['experts_bound_by']} (FLOP "
          f"bound {flops_ms:.2f} ms: {flops / 1e12:.2f} TFLOP of kept rows "
          f"at 989 TFLOP/s; byte bound {bytes_ms:.2f} ms: {nbytes / 1e9:.2f}"
          f" GB of expert weights as stored, rows in and out, at 3.35 TB/s; "
          f"{row['padded_rows']} rows computed, capacity padding included);"
          f" peak {peak / 2**30:.2f} GiB", flush=True)
    return row


# phase 47: how far apart a near-tie's router logits may lie, in bf16 steps
# at their magnitude (on an H100 the 15 partings of phi3.5-moe's 1,024
# (token, layer) pairs at T = 128 lay 0 to 6.5 steps apart)
NEAR_TIE_STEPS = 8
FAULT_STEPS = 16         # phase 47: decode steps a planted fault runs


def moe_decode_vs_prefill(cfg, params, tok) -> dict:
    """Phase 47: the prefill's logits at T = 128 against 128
    ``lm_decode_step`` calls, position by position.  At the config's
    capacity factor the prefill drops pairs that a decode step at B = 1
    (cap 4) never drops, so both run at cf = E / K, where neither drops.
    Both paths round in other places (the flash kernel keeps f32 where
    the plain decode attention rounds to bf16), so a token whose router
    gates sit at a near-tie may take other experts on one path, and from
    there on the paths would rightly part.  So the decode steps take the
    prefill's experts for each (token, layer) (``_route`` returns the
    prefill's top-k and the step's own gates at those experts,
    renormalised), and every position is held within 5e-2 x max(1, max
    |ref|).  Where a step's own router would take other experts, the
    prefill's router logits of the experts kept and of those taken
    instead must lie within ``NEAR_TIE_STEPS`` bf16 steps at their
    magnitude (the logits are bf16 products, so two paths whose inputs
    differ by bf16 rounding move them by a step or so), and never at
    token 0.  Two planted faults,
    each over the first ``FAULT_STEPS`` steps, the limit must reject:
    token 1's experts in layer 0 moved to the next ones, and every
    layer's cache blind to token 0 from step 2 on."""
    T, L, E = tok.shape[1], cfg.n_layers, cfg.n_experts
    transformer.reset_moe_dropped()
    lm_serve.prefill(cfg, params, tok)
    own_drops = transformer.moe_dropped()
    wide = dataclasses.replace(cfg, capacity_factor=E / cfg.top_k)
    route = transformer._route
    p_routes = []

    def recording(c, lp, xs):
        out = route(c, lp, xs)
        p_routes.append((xs @ lp["router"].to(c.compute_dtype)).float())
        p_routes.append(out)
        return out
    with mock.patch.object(transformer, "_route", recording):
        want = transformer.lm_forward(wide, params, tok)[0][0].float()
    p_logits = torch.stack(p_routes[0::2])                   # [L, T, E]
    p_top = torch.stack([r[2] for r in p_routes[1::2]])      # [L, T, K]
    p_gates = torch.stack([r[0] for r in p_routes[1::2]])

    def decode(n, fault=None):
        """n decode steps on the prefill's experts -> (logits [n, vocab]
        f32, the steps' own top-k [L, n, K])."""
        own, calls = [], iter(range(n * L))

        def forced(*a):
            gates, _, topi, aux = route(*a)
            t, layer = divmod(next(calls), L)
            own.append(topi[0])
            topi = p_top[layer, t:t + 1]
            if fault == "route" and (t, layer) == (1, 0):
                topi = (topi + 1) % E
            topv = gates.gather(-1, topi)
            return (gates, topv / topv.sum(-1, keepdim=True).clamp_min(1e-9),
                    topi, aux)
        cache = transformer.init_kv_cache(wide, 1, T, device=tok.device)
        lengths = torch.zeros(1, dtype=torch.int32, device=tok.device)
        got = []
        with mock.patch.object(transformer, "_route", forced):
            for t in range(n):
                logits, cache = transformer.lm_decode_step(
                    wide, params, tok[:, t:t + 1], cache, lengths)
                got.append(logits[0, 0])
                lengths += 1
                if fault == "cache" and t == 1:
                    for c in cache:
                        c[:, :, 0].zero_()
        return torch.stack(got), torch.stack(own).view(n, L, -1) \
            .transpose(0, 1)

    transformer.reset_moe_dropped()
    got, d_top = decode(T)
    if transformer.moe_dropped():
        raise AssertionError(f"{transformer.moe_dropped()} pairs dropped at "
                             f"cf {wide.capacity_factor}")
    err = check("MoE decode vs prefill", got, want, 5e-2)
    differ = (p_top.sort(-1).values != d_top.sort(-1).values).any(-1)
    gaps, steps = [], []          # each parting's gates and logits apart
    for layer, t in differ.nonzero().tolist():
        kept, other = (list(set(p_top[layer, t].tolist())
                            - set(d_top[layer, t].tolist())),
                       list(set(d_top[layer, t].tolist())
                            - set(p_top[layer, t].tolist())))
        g, lg = p_gates[layer, t], p_logits[layer, t]
        gaps.append(float((g[kept].min() - g[other].max()).abs()))
        d = float((lg[kept].min() - lg[other].max()).abs())
        steps.append(d / bf16_step(lg[kept + other]))
        if t == 0 or not steps[-1] <= NEAR_TIE_STEPS:
            raise AssertionError(
                f"decode vs prefill: token {t}'s own router takes experts "
                f"{other} for {kept} in layer {layer}, their logits "
                f"{steps[-1]:.3g} bf16 steps apart (limit {NEAR_TIE_STEPS}; "
                f"gates {gaps[-1]:.3g} apart)")
    scale = max(1.0, float(want[:FAULT_STEPS].abs().max()))
    faults = {f: float((decode(FAULT_STEPS, f)[0] - want[:FAULT_STEPS])
                       .abs().max()) / scale for f in ("route", "cache")}
    if not min(faults.values()) > 5e-2:
        raise AssertionError(f"a planted fault passes the 5e-2 limit: "
                             f"{faults}")
    row = dict(T=T, capacity_factor=wide.capacity_factor, positions=T,
               max_abs_err=err, last_max_abs_err=float(
                   (got[-1] - want[-1]).abs().max()),
               own_route_differs=int(differ.sum()),
               own_route_differs_tokens=int(differ.any(0).sum()),
               near_tie_gates_apart=gaps, near_tie_logit_steps=steps,
               planted_faults_scaled=faults, dropped_at_own_cf=own_drops)
    print(f"[47] T={T} at cf {wide.capacity_factor} (none dropped), the "
          f"decode steps on the prefill's experts: prefill's logits == "
          f"{T} decode steps within 5e-2 x max(1, max |ref|) at every "
          f"position (max |d| {err:.3g}, the last position's "
          f"{row['last_max_abs_err']:.3g}); the steps' own routers take "
          f"other experts at {row['own_route_differs']} (token, layer) "
          f"pairs of {row['own_route_differs_tokens']} tokens, each a "
          f"near-tie of the prefill's router logits (at most "
          + (f"{max(steps):.3g} bf16 steps apart, gates {max(gaps):.3g}"
             if gaps else "none") + f"; limit {NEAR_TIE_STEPS} steps); "
          f"planted faults off by {faults['route']:.3g} (token 1's experts "
          f"moved) and {faults['cache']:.3g} (cache blind to token 0) x "
          f"max(1, max |ref|) against 5e-2; at the config's cf "
          f"{cfg.capacity_factor} the prefill drops {own_drops} pairs",
          flush=True)
    return row


def moe_phases(smi: str, dev: torch.device) -> dict:
    """Phases 45 to 47: the MoE FFN against its plain version and EP at
    full width, the MoE prefills at full width, MoE serving."""
    gen = torch.Generator(device=dev)
    shapes = {s.name: s for s in lm_shapes()}

    # ---- phi3.5-moe at 8 of its 32 layers (42.7 GB of f32 weights) ----
    t0 = time.time()
    cfg = dataclasses.replace(lm_archs.PHI35_MOE, n_layers=8)
    params = transformer.init_lm_params(cfg, gen.manual_seed(45))
    torch.cuda.synchronize()
    print(f"[45] {cfg.name} at {cfg.n_layers} layers drawn on the card in "
          f"{time.time() - t0:.1f}s ({torch.cuda.memory_allocated() / 1e9:.1f}"
          f" GB)", flush=True)
    lp = transformer._layer_params(params, 0)
    phi = moe_vs_plain(f"{cfg.name} layer 0", cfg, lp, gen.manual_seed(451),
                       dev)
    ep = moe_ep_vs_dense(cfg, lp, phi.pop("x"))
    print(f"[45] phi3.5-moe done in {time.time() - t0:.1f}s", flush=True)

    t0 = time.time()
    T = shapes["prefill_32k"].dim("seq_len")            # B = 1
    tokens = torch.randint(0, cfg.vocab, (1, T), generator=gen.manual_seed(46),
                           device=dev, dtype=torch.int32)
    prefills = [moe_prefill_run(f"{cfg.name} {cfg.n_layers} layers "
                                f"prefill_32k B=1 T={T}", cfg, params,
                                tokens)]
    print(f"[46] phi3.5-moe done in {time.time() - t0:.1f}s", flush=True)

    # ---- 47. serving ----
    t0 = time.time()
    dec = shapes["decode_32k"]                      # 128 slots cut to 8
    torch.cuda.reset_peak_memory_stats()
    out, tput, metrics = lm_serve.serve(cfg, 16, 8, prompt_len=16,
                                        gen_len=24,
                                        max_len=dec.dim("seq_len"), seed=47,
                                        params=params, device=dev)
    peak = torch.cuda.max_memory_allocated()
    if sorted(out) != list(range(16)) or any(
            len(v) != 24 or not all(0 <= x < cfg.vocab for x in v)
            for v in out.values()):
        raise AssertionError("MoE serve did not answer every request with 24 "
                             "tokens of the vocabulary")
    serving = dict(metrics, requests=16, slots=8, max_len=dec.dim("seq_len"),
                   peak_bytes=peak, wall_s=time.time() - t0)
    print(f"[47] {cfg.name} ({cfg.n_layers} layers) serve: 16 requests "
          f"answered (24 tokens each) through 8 slots, max_len "
          f"{dec.dim('seq_len')}: {metrics['steps']} steps, decode step p50 "
          f"{metrics['p50']:.2f} ms, p99 {metrics['p99']:.2f} ms (first "
          f"{metrics['first_step_ms']:.1f} ms), {tput:.1f} tokens/s, "
          f"{metrics['moe_dropped']} (token, k) pairs dropped; peak "
          f"{peak / 2**30:.2f} GiB; {serving['wall_s']:.1f}s", flush=True)
    decode_check = moe_decode_vs_prefill(cfg, params, tokens[:, :128])
    print(f"[47] done in {time.time() - t0:.1f}s", flush=True)
    del params, lp, tokens
    torch.cuda.empty_cache()

    # ---- arctic at 1 of its 35 layers, bf16 parameters ----
    t0 = time.time()
    acfg = dataclasses.replace(lm_archs.ARCTIC, n_layers=1,
                               param_dtype=torch.bfloat16)
    params = transformer.init_lm_params(acfg, gen.manual_seed(48))
    torch.cuda.synchronize()
    print(f"[45] {acfg.name} at {acfg.n_layers} layer, bf16 parameters, "
          f"drawn on the card in {time.time() - t0:.1f}s "
          f"({torch.cuda.memory_allocated() / 1e9:.1f} GB)", flush=True)
    arctic = moe_vs_plain(f"{acfg.name} layer 0", acfg,
                          transformer._layer_params(params, 0),
                          gen.manual_seed(452), dev)
    del arctic["x"]
    tokens = torch.randint(0, acfg.vocab, (1, 4096),
                           generator=gen.manual_seed(49), device=dev,
                           dtype=torch.int32)
    prefills.append(moe_prefill_run(f"{acfg.name} 1 layer B=1 T=4096", acfg,
                                    params, tokens))
    del params, tokens
    torch.cuda.empty_cache()
    print(f"[45-46] arctic done in {time.time() - t0:.1f}s", flush=True)
    return dict(vs_plain=[phi, arctic], ep=ep, prefill=prefills,
                serving=serving, decode_check=decode_check, card=smi)


# ---- training (phases 48-51) ----

TRAIN_CUT_ROWS = 1 << 20   # phases 49-50: each DLRM table cut to 2^20 rows
TRAIN_B = 4                # phase 51: train_4k's global batch, cut from 256
TRAIN_T = 4096             # phases 48, 50 and 51: train_4k's sequence
# phase 48's main-path heads: (config, B, T, H, Kh, dh)
FLASH_BWD_SHAPES = [("llama3.2-1b", 1, TRAIN_T, 32, 8, 64),
                    ("phi3.5-moe", 1, TRAIN_T, 32, 8, 128)]
LM100M_RUN = dict(steps=3, batch=8, seq=512)   # phase 51's train() runs
GRAD_TOL_BF16 = 2e-2       # phase 50: ||d|| / ||ref|| of a bf16 LM leaf
GRAD_TOL_F32 = 1e-4        # phase 50: max |d| / max |ref| of an f32 leaf
# phase 50, GraphCast's leaves: phase 9 finds both f32 forwards (kernel and
# plain) ~4e-4 off an f64 one (sums in other orders through 16 processor
# layers of 512-wide MLPs); a gradient goes back through all of them, and
# the plain step's index_add_ adds in an order that changes from run to
# run, so both f32 steps are held to the f64 step: the kernel step's
# worst leaf within this or twice the plain f32 step's worst, whichever
# is more (phase 9's rule for the forward)
GRAD_TOL_GRAPHCAST = 1e-3


def card_line(tag: str, smi: str) -> None:
    print(f"[{tag}] card: {smi}", flush=True)


def flash_bwd_excess(got, want) -> float:
    """The largest |got - want| over the forward's bf16 elementwise limit,
    2e-2 x (|want| + median |want|) (``flash_excess``)."""
    return flash_excess(got, want, torch.bfloat16)[1]


def flash_bwd_bound(B, T, H, Kh, dh) -> tuple[float, str, int, int]:
    """(bound ms, what bounds it, bytes, flops) of a causal bf16 backward:
    q, k, v, o and dout read once, lse read once, dq, dk and dv written
    once; 10 dh flops a head and causal pair (S, dP, dV, dK, dQ; S
    counted once) over the bf16 tensor cores' 989 TFLOP/s."""
    nbytes = 2 * B * T * dh * 2 * (H + 2 * Kh) + 2 * 2 * B * T * H * dh \
        + 4 * B * H * T
    flops = 10 * dh * B * H * (T * (T + 1) // 2)
    bytes_ms = 1e3 * nbytes / H100_BYTES_PER_S
    ops_ms = 1e3 * flops / H100_BF16_FLOPS
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes, flops)


def flash_bwd_case(name, B, T, H, Kh, dh, gen, dev) -> dict:
    """Phase 48 at one shape: the backward kernel against the plain
    backward on the forward kernel's o and lse, timed beside it, SDPA's
    backward and the bound; the lse against the plain forward's."""
    bf = torch.bfloat16
    q = torch.randn((B, T, H, dh), generator=gen, device=dev).to(bf)
    k, v = (torch.randn((B, T, Kh, dh), generator=gen, device=dev).to(bf)
            for _ in range(2))
    do = torch.randn((B, T, H, dh), generator=gen, device=dev).to(bf)
    o, lse = fa_ops._forward(q, k, v, True, with_lse=True)
    tag = f"flash bwd {name} (B={B}, T={T}, H={H}, Kh={Kh}, dh={dh})"
    plain_o, plain_lse = flash_attention_fwd_ref(q, k, v)
    lse_err = float((lse - plain_lse).abs().max())
    if not lse_err < 1e-3:
        raise AssertionError(f"{tag}: the stored lse is {lse_err} off the "
                             f"plain forward's")
    del plain_o, plain_lse
    kern = lambda: fa_ops.flash_attention_bwd(q, k, v, o, lse, do)  # noqa
    plain = lambda: flash_attention_bwd_ref(q, k, v, o, lse, do)  # noqa
    before = fa_ops.bwd_launches
    got, again = kern(), kern()
    torch.cuda.synchronize()
    if fa_ops.bwd_launches != before + 2:
        raise AssertionError(f"{tag}: {fa_ops.bwd_launches - before} "
                             f"backward launches, not 2")
    want = plain()
    excess, err = {}, {}
    for n, a, b, w in zip(("dq", "dk", "dv"), got, again, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: {n} differs between two launches")
        excess[n] = flash_bwd_excess(a, w)
        err[n] = float((a.float() - w).abs().max())
    if not max(excess.values()) <= 1:
        raise AssertionError(f"{tag}: off by {excess} x the elementwise "
                             f"limit (max |d| {err})")
    # a planted fault the limit must reject: K and V of the next KV head
    fault = flash_attention_bwd_ref(q, k.roll(1, dims=2), v.roll(1, dims=2),
                                    o, lse, do)
    fault_excess = max(flash_bwd_excess(a, w) for a, w in zip(fault, want))
    del fault, got, again
    if not fault_excess > 1:
        raise AssertionError(f"{tag}: the limit passes a planted fault "
                             f"({fault_excess})")
    G = H // Kh
    qs = q.transpose(1, 2).detach().requires_grad_()
    ks, vs = (t.repeat_interleave(G, dim=2).transpose(1, 2).detach()
              .requires_grad_() for t in (k, v))
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    dos = do.transpose(1, 2)
    library = lambda: torch.autograd.grad(  # noqa: E731
        lib_out, (qs, ks, vs), dos, retain_graph=True)
    # SDPA's backward under the same limit, a number only: its dk and dv
    # summed over the G copies of each KV head, in f32
    lq, lk, lv = (t.transpose(1, 2).float() for t in library())
    lib_excess = {n: flash_bwd_excess(a, w) for n, a, w in zip(
        ("dq", "dk", "dv"),
        (lq, *(t.reshape(B, T, Kh, G, dh).sum(3) for t in (lk, lv))), want)}
    del lq, lk, lv, want
    # each launch of the backward alone, on buffers of its own (the prep
    # pass first: the others read its scratch)
    bufs = fa_ops.bwd_buffers(q, k, v)
    split = {part: cuda_ms(lambda p=bit: fa_ops.bwd_launch(
        q, k, v, o, lse, do, True, bufs, p), budget_ms=100) for part, bit in (
            ("prep", fa_ops.BWD_PREP), ("dkdv", fa_ops.BWD_DKDV),
            ("dq", fa_ops.BWD_DQ))}
    del bufs
    bound, by, nbytes, flops = flash_bwd_bound(B, T, H, Kh, dh)
    row = dict(shape=name, B=B, T=T, H=H, Kh=Kh, dh=dh, max_abs_err=err,
               excess=excess, fault_excess=fault_excess, lse_max_abs_err=lse_err,
               library_excess=lib_excess, split_ms=split,
               ms=cuda_ms(kern), plain_ms=cuda_ms(plain, min_reps=1),
               library_ms=cuda_ms(library), bound_ms=bound, bound_by=by,
               bytes=nbytes, flops=flops)
    del lib_out
    row.update(tflops=flops / row["ms"] / 1e9,
               vs_library=row["ms"] / row["library_ms"],
               bound_share=bound / row["ms"])
    # the forward: training (lse stored) and serving (lse off)
    row.update(fwd_lse_ms=cuda_ms(lambda: fa_ops._forward(q, k, v, True,
                                                          True)),
               fwd_serve_ms=cuda_ms(lambda: fa_ops._forward(q, k, v, True,
                                                            False)))
    print(f"[48] {tag}: kernel {row['ms']:.4f} ms ({row['tflops']:.2f} "
          f"TFLOP/s, {100 * row['bound_share']:.2f}% of the bound, "
          f"{row['vs_library']:.3f}x SDPA's backward), plain "
          f"{row['plain_ms']:.4f} ms, SDPA backward {row['library_ms']:.4f} "
          f"ms, bound {bound:.4f} ms by {by} ({flops / 1e9:.1f} Gflop at 989 "
          f"TFLOP/s, {nbytes / 1e9:.4f} GB); dq/dk/dv at {excess} x the "
          f"elementwise limit (max |d| {err}), a planted fault at "
          f"{fault_excess:.3g} x, SDPA's backward at {lib_excess} x; lse "
          f"max |d| {lse_err:.3g}; launches alone (ms) {split}; forward "
          f"with lse {row['fwd_lse_ms']:.4f} ms, serving (lse off) "
          f"{row['fwd_serve_ms']:.4f} ms", flush=True)
    return row


def flash_bwd_ptxas() -> list[dict]:
    """Phase 48: one row a backward kernel instance (kernel and head width
    read from the mangled name) from the flash library's ptxas report,
    printed with any ptxas warning on wgmma; raises if one spills."""
    report = fa_ops.build()[1]
    rows = []
    for name, info in _build.ptxas_functions(report).items():
        m = re.search(r"(fa_bwd_\w+?)ILi(\d+)E", name)
        if m:
            rows.append(dict(kernel=m[1], dh=int(m[2]), **info))
    for r in sorted(rows, key=lambda r: (r["kernel"], r["dh"])):
        print(f"[48] ptxas {r['kernel']} dh={r['dh']}: {r.get('registers')} "
              f"registers, {r.get('spill_stores')} / {r.get('spill_loads')} "
              f"bytes spill stores / loads, {r.get('stack')} bytes stack",
              flush=True)
    for line in report.splitlines():
        if "fa_bwd" in line and ("wgmma" in line or "setmaxnreg" in line):
            print(f"[48] ptxas: {line.strip()}", flush=True)
    want = {(k, dh) for k in ("fa_bwd_prep", "fa_bwd_dkdv", "fa_bwd_dq")
            for dh in fa_ops.HEAD_DIMS}
    got = {(r["kernel"], r["dh"]) for r in rows}
    spills = [r for r in rows if r.get("spill_stores", 1)
              or r.get("spill_loads", 1)]
    if got != want or spills:
        raise AssertionError(f"flash backward instances {sorted(got)} (want "
                             f"{sorted(want)}); spilling: {spills}")
    return rows


def flash_bwd_phase(smi, dev) -> dict:
    """Phase 48: the flash backward kernel at smoke and main-path shapes."""
    t0 = time.time()
    card_line("48", smi)
    ptxas = flash_bwd_ptxas()
    gen = torch.Generator(device=dev).manual_seed(48)
    rows = [flash_bwd_case(f"smoke dh{dh}", 2, 300, 4, 2, dh, gen, dev)
            for dh in (16, 32, 64, 128)]
    rows += [flash_bwd_case(*shape, gen, dev) for shape in FLASH_BWD_SHAPES]
    torch.cuda.empty_cache()
    print(f"[48] done in {time.time() - t0:.1f}s", flush=True)
    return dict(shapes=rows, ptxas=ptxas, card=smi)


def random_graph(n, e, gen, dev):
    """``e`` edges over ``n`` nodes drawn on the card, sorted by
    destination, int32 [2, e]."""
    src = torch.randint(0, n, (e,), generator=gen, device=dev,
                        dtype=torch.int32)
    dst = torch.sort(torch.randint(0, n, (e,), generator=gen, device=dev,
                                   dtype=torch.int32))[0]
    return torch.stack([src, dst])


def ogb_dims() -> dict:
    return dict(next(s for s in gnn_shapes()
                     if s.name == "ogb_products").dims)


def lm_cfg_for(arch: str, layers: int):
    """``arch``'s published config cut to ``layers`` layers."""
    return dataclasses.replace(ARCHS[arch].config, n_layers=layers)


def plain_spmm_dx(g, src, dst, n, coeff):
    """dx = A^T g of the plain backward (``index_add_``), dx only."""
    rows, valid = source_rows(src, n)
    msgs = scatter_spmm_bwd_ref(g, dst, n) * coeff[:, None]
    return torch.zeros_like(g).index_add_(0, rows[valid], msgs[valid])


def dlrm_cut_cfg():
    return dataclasses.replace(DLRM_RM2, vocab_sizes=tuple(
        min(v, TRAIN_CUT_ROWS) for v in DLRM_RM2.resolved_vocabs()))


def dlrm_train_batch(cfg, dev, step=0):
    b = recsys_batch(RecSysBatchSpec(
        recsys_shapes()[0].dim("batch"), cfg.n_dense, cfg.n_sparse,
        cfg.lookups_per_field, cfg.resolved_vocabs()), step)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def spmm_bag_bwd_phase(smi, dev) -> dict:
    """Phase 49: the SpMM kernel over the transposed edges and the bag
    backward kernel, each against its plain backward and a library call."""
    t0 = time.time()
    card_line("49", smi)
    gen = torch.Generator(device=dev).manual_seed(49)
    ogb = ogb_dims()
    N, E = ogb["n_nodes"], ogb["n_edges"]
    ei = random_graph(N, E, gen, dev)
    coeff = sym_norm_coeff(ei, N)
    torch.cuda.synchronize()
    t1 = time.time()
    tr = spmm_ops.transpose_edges(ei[0], ei[1], N, N)
    torch.cuda.synchronize()
    transpose_s = time.time() - t1
    cperm = coeff[tr.perm].contiguous()
    at = torch.sparse_csr_tensor(tr.rowptr, tr.src, cperm, size=(N, N))
    spmm_rows = []
    for D in (16, 7):
        g = torch.randn((N, D), generator=gen, device=dev)
        kern = lambda: spmm_ops.launch(  # noqa: E731
            g, tr.src, cperm, tr.rowptr, N, transposed=True)
        plain = lambda: plain_spmm_dx(g, ei[0], ei[1], N, coeff)  # noqa
        library = lambda: torch.sparse.mm(at, g)  # noqa: E731
        err = check(f"spmm bwd D={D}", kern(), plain(), 1e-4)
        lib_err = check(f"sparse.mm D={D}", library(), plain(), 1e-4)
        # through the autograd Function: one transposed launch a backward
        x = torch.randn((N, D), generator=gen, device=dev,
                        requires_grad=True)
        before = spmm_ops.bwd_launches
        out = spmm_ops.spmm_sorted_coo(x, ei[0], ei[1], N, coeff, None, tr)
        (dx,) = torch.autograd.grad(out, x, g)
        if spmm_ops.bwd_launches != before + 1:
            raise AssertionError("spmm: the backward made no transposed "
                                 "launch")
        check(f"spmm autograd D={D}", dx, plain(), 1e-4)
        nbytes = 2 * N * D * 4 + 2 * E * 4 + (N + 1) * 4
        bound = 1e3 * nbytes / H100_BYTES_PER_S
        row = dict(D=D, n_nodes=N, n_edges=E, max_abs_err=err,
                   library_max_abs_err=lib_err, ms=cuda_ms(kern),
                   plain_ms=cuda_ms(plain), library_ms=cuda_ms(library),
                   bound_ms=bound, bound_by="bytes", bytes=nbytes,
                   transpose_s=transpose_s)
        spmm_rows.append(row)
        print(f"[49] spmm backward ogb_products D={D}: kernel over the "
              f"transposed edges {row['ms']:.4f} ms, plain (index_add_) "
              f"{row['plain_ms']:.4f} ms, torch.sparse.mm (CSR A^T) "
              f"{row['library_ms']:.4f} ms, bound {bound:.4f} ms by bytes "
              f"({nbytes / 1e9:.3f} GB); max |d| {err:.3g} (sparse.mm "
              f"{lib_err:.3g}); transposed edges built once in "
              f"{transpose_s:.3f}s", flush=True)
        del x, out, dx, g
    del ei, coeff, tr, cperm, at
    torch.cuda.empty_cache()

    # ---- the bag backward at train_batch on the cut tables, and skew4 ----
    cfg = dlrm_cut_cfg()
    tables = bag_ops.prepare_tables(dlrm.init_dlrm_params(cfg, gen)["tables"])
    idx = dlrm_train_batch(cfg, dev)["sparse"]
    bag_rows = [bag_bwd_case("train_batch", tables, idx, gen, dev)]
    bag_rows.append(bag_bwd_case(
        "skew4", tables, skew4_indices(tables, *idx.shape, gen), gen, dev))
    del tables, idx
    torch.cuda.empty_cache()
    print(f"[49] done in {time.time() - t0:.1f}s", flush=True)
    return dict(spmm=spmm_rows, bag=bag_rows[0], bag_skew4=bag_rows[1],
                card=smi)


def skew4_indices(tables, B, F, L, gen) -> torch.Tensor:
    """Phase 49's skewed batch: [B, F, L] int32, each lookup's row
    floor(V_f u^4) for u uniform from ``gen`` (at V = 1,024 about 17.7% of
    a field's lookups, ~46K at train_batch, read row 0)."""
    dev = tables[0].device
    V = torch.tensor([t.shape[0] for t in tables], dtype=torch.float64,
                     device=dev)[None, :, None]
    u = torch.rand((B, F, L), generator=gen, device=dev, dtype=torch.float64)
    return (V * u ** 4).floor().clamp_max(V - 1).to(torch.int32)


def bag_bwd_case(name, tables, idx, gen, dev) -> dict:
    """Phase 49's bag backward at one batch: the call (``launch_bwd``)
    equal bit for bit to ``embedding_bags_bwd_ordered`` and to itself
    twice, within 1e-5 of the plain ``index_add_`` sum taken in float64
    (the f32 one's distance printed), its untouched rows
    +0.0 where the allocator hands it a freed buffer of NaN; the call, its
    parts alone (the key pass, both sorts, the segments and rows kernels)
    and the plain and library backwards timed, beside the bound and the
    gather floor."""
    vocabs = [t.shape[0] for t in tables]
    B, Fn, L = idx.shape
    D, total, n = tables.D, tables.total, idx.numel()
    gout = torch.randn((B, Fn, D), generator=gen, device=dev)
    kern = lambda: bag_ops.launch_bwd(tables, idx, gout)  # noqa: E731
    plain = lambda: embedding_bags_bwd_ref(vocabs, idx, gout)  # noqa: E731
    before = bag_ops.bwd_launches, bag_ops.bwd_key_launches
    got, again = kern(), kern()
    if (bag_ops.bwd_launches, bag_ops.bwd_key_launches) != (
            before[0] + 2, before[1] + 2):
        raise AssertionError(f"bag backward {name}: not one launch of each "
                             f"kernel a call")
    ordered = embedding_bags_bwd_ordered(vocabs, idx, gout,
                                         segment=bag_ops.SEGMENT)
    if not all(map(same_bits, got, ordered)):
        raise AssertionError(f"bag backward {name}: not the ordered sum's "
                             f"bits")
    if not all(map(same_bits, got, again)):
        raise AssertionError(f"bag backward {name}: two calls differ")
    touched = [(w != 0).any(1) for w in ordered]
    del again, ordered
    # the kernel held to the plain sum taken in float64: the plain f32
    # index_add_ adds by atomics in an order that changes from run to run,
    # and its own rounding at skew4's hot rows has come within 1e-5 and
    # over it; the kernel's bits are the same every run
    exact = bag_bwd_f64(vocabs, idx, gout)
    err = max(check(f"bag backward {name} field {f}", a, e, 1e-5)
              for f, (a, e) in enumerate(zip(got, exact)))
    want = plain()
    vs64 = {which: max(float((a.double() - e).abs().max())
                       / max(1.0, float(e.abs().max()))
                       for a, e in zip(res, exact))
            for which, res in (("kernel", got), ("index_add_", want))}
    vs_plain = max(float((a - w).abs().max()) / max(1.0, float(w.abs().max()))
                   for a, w in zip(got, want))
    del got, want, exact
    # the allocator's only free block poisoned with NaN: every allocation
    # of the call comes out of it, the output too
    torch.cuda.empty_cache()
    nbytes_out = total * D * 4
    poison = torch.full((nbytes_out // 4 + (1 << 28),), float("nan"),
                        device=dev)
    lo, hi = poison.data_ptr(), poison.data_ptr() + poison.numel() * 4
    del poison
    got = kern()
    start = got[0].data_ptr()
    if not (lo <= start and start + nbytes_out <= hi):
        raise AssertionError(f"bag backward {name}: the output missed the "
                             f"poisoned block")
    for f, (a, u) in enumerate(zip(got, touched)):
        if not (a[~u].view(torch.int32) == 0).all():
            raise AssertionError(f"bag backward {name} field {f}: an "
                                 f"untouched row is not +0.0")
    untouched = sum(int((~u).sum()) for u in touched)
    del got, touched
    torch.cuda.empty_cache()
    # the parts alone
    keys, pos = bag_ops.bwd_key_pass(tables, idx)
    sorted_k, sorted_p, _ = bag_ops.bwd_keys(tables, idx)
    grad = torch.empty((total, D), device=dev)

    def part(which):
        return lambda: bag_ops.bwd_kernel(sorted_k, sorted_p, gout, None,
                                          grad, L, "sum", which)
    parts = dict(
        keys_ms=cuda_ms(lambda: bag_ops.bwd_key_pass(tables, idx)),
        sort_cub_ms=cuda_ms(lambda: bag_ops.bwd_sort(keys, pos, total)),
        # the other candidate: torch.sort of the int32 keys, all 32 bits
        sort_torch_ms=cuda_ms(lambda: torch.sort(keys, stable=True)),
        segments_ms=cuda_ms(part(bag_ops.BWD_SEGMENTS)),
        rows_ms=cuda_ms(part(bag_ops.BWD_ROWS)))
    valid = sorted_k[sorted_k < total]
    runs = torch.unique_consecutive(valid, return_counts=True)[1]
    starts = torch.cumsum(runs, 0) - runs
    spanning = int(((starts // bag_ops.SEGMENT) != (
        (starts + runs - 1) // bag_ops.SEGMENT)).sum())
    hottest = int(runs.max()) if runs.numel() else 0
    del keys, pos, sorted_k, sorted_p, grad, valid, runs, starts
    # the library's backward: F.embedding_bag over the tables side by side
    first = torch.tensor([0] + vocabs[:-1], device=dev).cumsum(0)
    flat = (idx.long() + first[None, :, None]).reshape(B * Fn, L)
    weight = torch.cat(list(tables)).requires_grad_()
    lib_out = F.embedding_bag(flat, weight, mode="sum")
    library = lambda: torch.autograd.grad(  # noqa: E731
        lib_out, weight, gout.reshape(B * Fn, D), retain_graph=True)
    # the bound: the indices and bag gradients read once, the dense
    # gradients written whole; the gather floor: every bag gradient read
    # from memory once a lookup
    nbytes = n * 4 + gout.numel() * 4 + nbytes_out
    floor_bytes = n * 4 + n * D * 4 + nbytes_out
    row = dict(batch=name, B=B, F=Fn, L=L, D=D, rows=total,
               touched_rows=total - untouched, untouched_rows=untouched,
               runs_spanning_segments=spanning, hottest_row_lookups=hottest,
               segment=bag_ops.SEGMENT, sort="cub",
               sort_bits=bag_ops.bwd_bits(n, total), max_abs_err=err,
               max_abs_err_against="index_add_ in float64",
               rel_err=vs_plain, rel_err_vs_f64=vs64,
               ms=cuda_ms(kern), **parts, plain_ms=cuda_ms(plain),
               library_ms=cuda_ms(library), bound_ms=1e3 * nbytes
               / H100_BYTES_PER_S, bound_by="bytes", bytes=nbytes,
               gather_floor_ms=1e3 * floor_bytes / H100_BYTES_PER_S,
               gather_floor_bytes=floor_bytes,
               zero_fill=False,
               bits_equal_ordered=True, same_bits_twice=True,
               poisoned_zeros=True)
    del lib_out, weight, flat
    print(f"[49] bag backward {name} (B={B}, {Fn} x {L} lookups, D={D}, "
          f"{total} rows, {total - untouched} touched, the hottest read "
          f"{hottest} times, {spanning} runs over several segments of "
          f"{bag_ops.SEGMENT}): the call {row['ms']:.4f} ms against its "
          f"bound {row['bound_ms']:.4f} ms by bytes ({nbytes / 1e9:.3f} GB: "
          f"indices, bag gradients, the dense gradients written whole; "
          f"{row['bound_ms'] / row['ms']:.1%} of it) and its gather floor "
          f"{row['gather_floor_ms']:.4f} ms ({floor_bytes / 1e9:.3f} GB: "
          f"each bag gradient read once a lookup); alone: the key pass "
          f"{parts['keys_ms']:.4f} ms, the sort over {row['sort_bits']} "
          f"bits of int32 keys by CUB {parts['sort_cub_ms']:.4f} ms and by "
          f"torch.sort {parts['sort_torch_ms']:.4f} ms (CUB's ships), the "
          f"segments kernel {parts['segments_ms']:.4f} ms, the rows kernel "
          f"{parts['rows_ms']:.4f} ms; no zero fill; plain "
          f"(index_add_) {row['plain_ms']:.4f} ms, F.embedding_bag backward "
          f"{row['library_ms']:.4f} ms; the ordered sum's bits, the same "
          f"bits twice, max |d| {err:.3g} against the plain sum in f64 "
          f"(of max(1, max |ref|): the kernel {vs64['kernel']:.3g}, f32 "
          f"index_add_ {vs64['index_add_']:.3g}; the kernel against f32 "
          f"index_add_ {vs_plain:.3g})"
          f", {untouched} untouched rows +0.0 over a poisoned allocator",
          flush=True)
    return row


def bag_bwd_f64(vocabs, idx, gout) -> list:
    """The tables' gradients (sum, no weights) by ``index_add_`` in
    float64: phase 49's yardstick for both f32 backwards."""
    (B, Fn, L), D = idx.shape, gout.shape[2]
    out = []
    for f, V in enumerate(vocabs):
        i = idx[:, f].long()
        i = torch.where(i < 0, i + V, i)
        keep = ((i >= 0) & (i < V)).reshape(-1)
        terms = gout[:, f].double()[:, None, :].expand(B, L, -1)
        out.append(torch.zeros((V, D), dtype=torch.float64,
                               device=gout.device).index_add_(
            0, i.reshape(-1)[keep], terms.reshape(B * L, D)[keep]))
    return out


@contextlib.contextmanager
def plain_kernels():
    """Every model kernel replaced by its plain version on the card: the
    flash forward and backward, the SpMM (both directions) and the bag
    forward and backward.  The wrappers and their autograd Functions look
    these names up at each call."""
    def fa_forward(q, k, v, causal, with_lse):
        if with_lse:
            return flash_attention_fwd_ref(q, k, v, causal)
        return flash_attention_ref(q, k, v, causal), None

    def fa_backward(q, k, v, o, lse, dout, causal=True):
        return tuple(t.to(q.dtype) for t in flash_attention_bwd_ref(
            q, k, v, o, lse, dout, causal))

    def spmm_launch(x, src, coeff, rowptr, n_nodes, shape=None,
                    transposed=False):
        dst = torch.repeat_interleave(
            torch.arange(n_nodes, device=x.device), rowptr.diff().long())
        e = dst.shape[0]
        msgs = x if src is None else x[src[:e].long()]
        if coeff is not None:
            msgs = msgs * coeff[:e, None]
        return torch.zeros((n_nodes, x.shape[1]), device=x.device) \
            .index_add_(0, dst, msgs[:e])

    def bag_launch(tables, indices, weights=None, combiner="sum",
                   shape=None):
        return embedding_bags_ref(list(tables), indices, weights, combiner)

    def bag_bwd(tables, indices, gout, weights=None, combiner="sum"):
        return embedding_bags_bwd_ref([t.shape[0] for t in tables], indices,
                                      gout, weights, combiner)
    with mock.patch.object(fa_ops, "_forward", fa_forward), \
            mock.patch.object(fa_ops, "flash_attention_bwd", fa_backward), \
            mock.patch.object(spmm_ops, "launch", spmm_launch), \
            mock.patch.object(bag_ops, "launch", bag_launch), \
            mock.patch.object(bag_ops, "launch_bwd", bag_bwd):
        yield


@contextlib.contextmanager
def pinned_routes(record: list, replay: bool):
    """Each MoE layer's top-k experts: recorded in call order, or (with
    ``replay``) those recorded taken in place of the router's own, with
    the gates renormalised over them and the aux loss on them (phase 47's
    way with the decode steps).  The kernel and the plain attention round
    differently, so a near-tie token may route elsewhere; on the same
    experts the two grad steps compute the same function.  A replay
    appends the count of tokens whose own top-k differs to ``record``."""
    route, it, parted = transformer._route, iter(list(record)), [0]

    def wrapped(cfg, lp, xs):
        gates, topv, topi, aux = route(cfg, lp, xs)
        if not replay:
            record.append(topi)
            return gates, topv, topi, aux
        want = next(it)
        parted[0] += int((want != topi).any(-1).sum())
        topv = gates.gather(-1, want)
        topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
        frac_t = F.one_hot(want[:, 0], cfg.n_experts).float().mean(0)
        return gates, topv, want, cfg.n_experts * (
            frac_t * gates.mean(0)).sum()
    with mock.patch.object(transformer, "_route", wrapped):
        yield
    if replay:
        record.append(parted[0])


def launch_counts() -> dict:
    return dict(flash=fa_ops.launches, flash_bwd=fa_ops.bwd_launches,
                spmm=spmm_ops.launches, spmm_bwd=spmm_ops.bwd_launches,
                bag=bag_ops.launches, bag_bwd=bag_ops.bwd_launches,
                bag_bwd_keys=bag_ops.bwd_key_launches)


def grad_step(loss_fn, params):
    """(loss, gradients of every parameter leaf) of one step."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    torch.cuda.synchronize()
    return loss.detach().float(), grads


def leaf_dist(a, b) -> tuple[float, float]:
    """(max |a - b| / max |b|, ||a - b|| / ||b||) of one gradient leaf."""
    a, b = a.double(), b.double()
    d = a - b
    return (float(d.abs().max()) / max(float(b.abs().max()), 1e-30),
            float(d.norm()) / max(float(b.norm()), 1e-30))


def family_case(tag, loss_fn, params, kernels, bf16, moe=False,
                tol=None, loss64=None, parts=None) -> dict:
    """Phase 50 at one family: the grad step through the kernels (each of
    ``kernels`` launched) against the step through the plain versions
    (none launched), the loss and every leaf; a MoE step's plain run on
    the kernel run's experts (``pinned_routes``).  With ``loss64`` (a
    float64 loss in plain torch ops) both f32 steps are held to its
    gradient instead: the kernel step's worst leaf no farther from it
    than ``tol`` or twice the plain step's worst, whichever is more; the
    kernel step's distance from the plain one is then a number only.
    With ``parts``, one more kernel step under ``torch.profiler``
    (``step_breakdown``) gives its device time by those parts."""
    t0 = time.time()
    before = launch_counts()
    routes: list = []
    with pinned_routes(routes, False) if moe else contextlib.nullcontext():
        k_loss, k_grads = grad_step(loss_fn, params)
    launched = {n: c - before[n] for n, c in launch_counts().items()}
    if not all(launched[n] > 0 for n in kernels):
        raise AssertionError(f"{tag}: kernel launches {launched}, need "
                             f"each of {kernels}")
    t_kern = time.time() - t0
    before = launch_counts()
    with plain_kernels(), (pinned_routes(routes, True) if moe
                           else contextlib.nullcontext()):
        p_loss, p_grads = grad_step(loss_fn, params)
    parted = routes[-1] if moe else None
    r_grads = grad_step(loss64, params)[1] if loss64 else None
    if launch_counts() != before:
        raise AssertionError(f"{tag}: the plain step launched a kernel")
    for p in tree_leaves(params):
        p.requires_grad_(False)
    tol = tol or (GRAD_TOL_BF16 if bf16 else GRAD_TOL_F32)
    loss_d = abs(float(k_loss) - float(p_loss))
    worst_max, worst_norm = 0.0, 0.0
    for i, (a, b) in enumerate(zip(k_grads, p_grads)):
        d_max, d_norm = leaf_dist(a, b)
        if not torch.isfinite(a).all():
            raise AssertionError(f"{tag}: leaf {i} has a non-finite entry")
        if not loss64 and (d_norm if bf16 else d_max) > tol:
            raise AssertionError(f"{tag}: leaf {i} {tuple(a.shape)} off by "
                                 f"{d_max:.3g} of max |ref|, {d_norm:.3g} "
                                 f"of ||ref||")
        worst_max, worst_norm = max(worst_max, d_max), max(worst_norm, d_norm)
    vs64 = None
    if loss64:
        kern64, plain64 = ([max((leaf_dist(a, r)[0], i, tuple(a.shape))
                                for i, (a, r) in enumerate(zip(g, r_grads)))
                            for g in (k_grads, p_grads)])
        limit = max(tol, 2 * plain64[0])
        vs64 = dict(kernel=kern64[0], plain=plain64[0], limit=limit)
        if not kern64[0] <= limit:
            raise AssertionError(
                f"{tag}: leaf {kern64[1]} {kern64[2]} of the kernel step off "
                f"the f64 step by {kern64[0]:.3g} of max |ref|; the plain "
                f"f32 step's worst (leaf {plain64[1]}) {plain64[0]:.3g}, limit "
                f"{limit:.3g}")
    if not loss_d <= (1e-2 if bf16 else 1e-5) * max(1.0, abs(float(p_loss))):
        raise AssertionError(f"{tag}: loss {float(k_loss)} vs plain "
                             f"{float(p_loss)}")
    row = dict(family=tag, loss=float(k_loss), plain_loss=float(p_loss),
               leaves=len(k_grads), launches=launched,
               max_rel_err=worst_max, max_norm_rel_err=worst_norm,
               kernel_step_s=t_kern, routes_parted=parted, vs_f64=vs64)
    held = (f"the worst leaf of the kernel step {vs64['kernel']:.3g} of its "
            f"max |ref| off the f64 step, the plain f32 step's "
            f"{vs64['plain']:.3g} (limit {vs64['limit']:.3g}: max({tol:g}, "
            f"2x the plain)); the kernel step against the plain one"
            if loss64 else f"limit {tol:g} of "
            f"{'||ref||' if bf16 else 'max |ref|'}")
    print(f"[50] {tag}: loss {float(k_loss):.6f} (plain {float(p_loss):.6f}); "
          f"{len(k_grads)} gradient leaves, {held}: the worst at "
          f"{worst_max:.3g} of its max |ref| and {worst_norm:.3g} of its "
          f"||ref||; launches {dict((n, c) for n, c in launched.items() if c)}"
          + (f"; the plain run on the kernel run's experts ({parted} "
             f"token-layers' own routers parted)" if moe else ""),
          flush=True)
    del k_grads, p_grads
    if parts:
        row["breakdown"] = step_breakdown(lambda: grad_step(loss_fn, params),
                                          parts)
        for p in tree_leaves(params):
            p.requires_grad_(False)
        b = row["breakdown"]
        print(f"[50] {tag}: one kernel grad step under torch.profiler: "
              + (f"wall {b['wall_s']:.4f} s, device {b['device_ms']:.3f} ms "
                 f"(idle share <= {b['idle_share']:.3f}); by part "
                 f"{ {k: round(v, 4) for k, v in b['parts_ms'].items()} } ms;"
                 f" the largest others "
                 f"{[(k, round(v, 4)) for k, v in b['top_other_ms']]}"
                 if "parts_ms" in b else f"not measured: {b['reason']}"),
              flush=True)
    return row


def graphcast_train_case(gen, dev):
    """Phase 50's GraphCast step: (cfg, params, batch) on full_graph_sm,
    regression targets from ``gen``."""
    spec = next(s for s in gnn_shapes() if s.name == "full_graph_sm")
    cfg = dataclasses.replace(gnn_archs.GRAPHCAST,
                              d_in=dict(spec.dims)["d_feat"])
    g = build_graph(cfg, spec, np.random.default_rng(0), device=dev)
    n = g.x.shape[0]
    batch = dict(graph=g, labels=torch.randn((n, cfg.d_out), generator=gen,
                                             device=dev),
                 mask=torch.ones(n, device=dev))
    return cfg, gnn.init_gnn_params(cfg, gen), batch


def graphcast_loss64(cfg, batch):
    """``gnn.gnn_loss``'s regression loss of GraphCast with everything in
    float64: ``plain_forward`` (``index_add_`` sums, no kernel) and the
    masked mean square error without the loss's cast to f32.  Each
    processor block is recomputed in the backward (its activations at
    f64 over the multimesh's edges would not fit the card), under the
    same plain sums."""
    labels, mask = batch["labels"].double(), batch["mask"].double()
    block = gnn._interaction_block

    def plain_block(*args):
        with mock.patch.object(gnn, "scatter_sum", index_add_sum):
            return block(*args)

    def remat(*args):
        return torch.utils.checkpoint.checkpoint(plain_block, *args,
                                                 use_reentrant=False)

    def loss(params):
        with mock.patch.object(gnn, "_interaction_block", remat):
            out = plain_forward(cfg, params, batch["graph"], torch.float64)
        err = (out - labels).square().mean(-1)
        return (err * mask).sum() / mask.sum().clamp(min=1.0)
    return loss


def family_cases(gen, dev):
    """Phase 50's grad steps in order, each drawn from ``gen`` once the
    one before it is done with: (tag, loss_fn, params, kernels, options
    of ``family_case``) a family."""
    T = TRAIN_T
    for arch, layers in (("llama3.2-1b", 2), ("phi3.5-moe-42b-a6.6b", 1)):
        cfg = lm_cfg_for(arch, layers)
        toks = torch.randint(0, cfg.vocab, (1, T + 1), generator=gen,
                             device=dev, dtype=torch.int32)
        params = transformer.init_lm_params(cfg, gen)
        batch = dict(tokens=toks[:, :-1].contiguous(),
                     targets=toks[:, 1:].contiguous())
        yield (f"{arch} {layers} layer(s) T={T}",
               lambda p, cfg=cfg, batch=batch: transformer.lm_loss(
                   cfg, p, batch), params, ("flash", "flash_bwd"),
               dict(bf16=True, moe=bool(cfg.n_experts)))
        del toks, params, batch
        torch.cuda.empty_cache()
    # gcn-cora on ogb_products (the graph drawn on the card)
    d = ogb_dims()
    cfg = dataclasses.replace(gnn_archs.GCN_CORA, d_in=d["d_feat"])
    ei = random_graph(d["n_nodes"], d["n_edges"], gen, dev)
    g = gnn.add_transposed(cfg, gnn.sort_edges(cfg, gnn.Graph(
        x=torch.randn((d["n_nodes"], d["d_feat"]), generator=gen,
                      device=dev), edge_index=ei)))
    batch = dict(graph=g, labels=torch.randint(
        0, cfg.d_out, (d["n_nodes"],), generator=gen, device=dev,
        dtype=torch.int32), mask=torch.ones(d["n_nodes"], device=dev))
    yield ("gcn-cora ogb_products",
           lambda p, cfg=cfg, batch=batch: gnn.gnn_loss(cfg, p, batch),
           gnn.init_gnn_params(cfg, gen), ("spmm", "spmm_bwd"),
           dict(bf16=False))
    del g, ei, batch
    torch.cuda.empty_cache()
    # graphcast on full_graph_sm, held to its f64 step
    cfg, params, batch = graphcast_train_case(gen, dev)
    yield ("graphcast full_graph_sm",
           lambda p, cfg=cfg, batch=batch: gnn.gnn_loss(cfg, p, batch),
           params, ("spmm",),
           dict(bf16=False, tol=GRAD_TOL_GRAPHCAST,
                loss64=graphcast_loss64(cfg, batch)))
    del params, batch
    torch.cuda.empty_cache()
    # DLRM-RM2 train_batch on the cut tables
    cfg = dlrm_cut_cfg()
    params = dlrm.init_dlrm_params(cfg, gen)
    batch = dlrm_train_batch(cfg, dev)
    yield ("dlrm-rm2 train_batch (cut tables)",
           lambda p, cfg=cfg, batch=batch: dlrm.dlrm_loss(cfg, p, batch),
           params, ("bag", "bag_bwd", "bag_bwd_keys"),
           dict(bf16=False, parts=DLRM_STEP_PARTS))
    del params, batch
    torch.cuda.empty_cache()


def family_phase(smi, dev) -> dict:
    """Phase 50: one grad step a family against its plain version."""
    t0 = time.time()
    card_line("50", smi)
    set_dist_mesh(None)
    gen = torch.Generator(device=dev).manual_seed(50)
    rows = []
    for case in family_cases(gen, dev):
        tag, loss_fn, params, kernels, options = case
        rows.append(family_case(tag, loss_fn, params, kernels, **options))
        del case, loss_fn, params, options
    print(f"[50] done in {time.time() - t0:.1f}s", flush=True)
    return dict(families=rows, card=smi,
                bag_bwd_launches=rows[-1]["launches"]["bag_bwd"],
                bag_bwd_key_launches=rows[-1]["launches"]["bag_bwd_keys"],
                bag_step_breakdown=rows[-1].get("breakdown"),
                spmm_bwd_launches=rows[2]["launches"]["spmm_bwd"])


STEP_PARTS = (("flash forward", ("fa_fwd_tc",)),
              ("flash backward", ("fa_bwd_",)),
              ("matmuls", ("gemm", "nvjet", "xmma", "cutlass")))
# phase 50's DLRM step: the bag backward's kernels (key pass, segments,
# rows), its sort (CUB's radix sort kernels), the bag forward
DLRM_STEP_PARTS = (("bag backward kernels", ("bag_bwd_",)),
                   ("bag backward sort", ("deviceradixsort",)),
                   ("bag forward", ("bag_tile_kernel", "bag_chunk_kernel")),
                   ("matmuls", ("gemm", "nvjet", "xmma", "cutlass")))


def step_breakdown(fn, parts=STEP_PARTS) -> dict:
    """Two calls of ``fn`` under ``torch.profiler``: the first a warm-up
    whose trace is dropped (the profiler's start-up skews the first), the
    second traced.  Of that one: the wall, the device time by part
    (``parts`` by kernel name; the rest "other", its largest kernels
    named; the profiler's own step annotation left out), the kernels a
    part counted, and the idle share 1 - device / wall (an upper bound:
    the profiler's host cost inflates the wall).  Where the profiler
    gives no device time, or no kernel of one of ``parts`` (a trace that
    misses a launched kernel cannot be trusted for the rest), only the
    reason."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    err = profiler_error(prof.start)
    if err:
        return dict(reason=err)
    wall = 0.0
    try:
        fn()
        torch.cuda.synchronize()
        err = profiler_error(prof.step)
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
        err = err or profiler_error(prof.step)
    finally:
        err = profiler_error(prof.stop) or err
    if err:
        return dict(reason=err)
    by_part, other = {name: 0.0 for name, _ in parts}, {}
    by_part["other"] = 0.0
    counts = dict.fromkeys(by_part, 0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA \
                or e.key.startswith("ProfilerStep"):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        part = next((name for name, keys in parts
                     if any(k in e.key.lower() for k in keys)), "other")
        by_part[part] += us / 1e3
        counts[part] += e.count
        if part == "other":
            other[e.key[:70]] = us / 1e3
    device_ms = sum(by_part.values())
    if not device_ms:
        return dict(reason="no device time in the trace")
    missing = [name for name, _ in parts if not counts[name]]
    if missing:
        return dict(reason=f"no kernel of {missing} in the trace (kernels "
                    f"by part {counts})")
    top = sorted(other.items(), key=lambda kv: -kv[1])[:6]
    return dict(wall_s=wall, device_ms=device_ms, parts_ms=by_part,
                kernels=counts, idle_share=1 - device_ms / 1e3 / wall,
                top_other_ms=top)


def to_dev(tree, dev):
    return tree_map(lambda a: torch.as_tensor(a).to(dev), tree)


def train_phase(smi, dev) -> dict:
    """Phase 51: llama3.2-1b train_4k at full width and depth through
    ``steps.build_plan``, across a kill and a restore; ``train()`` on
    lm100m with and without compression."""
    t0 = time.time()
    card_line("51", smi)
    bundle = ARCHS["llama3.2-1b"]
    spec = spec_shape("train_4k", "lm_train", seq_len=TRAIN_T,
                      global_batch=TRAIN_B)
    # remat on (the registry's config has it off): each layer under
    # torch.utils.checkpoint, as jax.checkpoint
    plan = steps.build_plan(bundle, spec, make_host_mesh(1, 1, device=dev),
                            lm_overrides=dict(remat=True))
    set_dist_mesh(None)
    cfg = dataclasses.replace(bundle.config, remat=True)
    bspec = LMBatchSpec(TRAIN_B, TRAIN_T, cfg.vocab, seed=0)
    batches = [to_dev(lm_batch(bspec, s), dev) for s in range(4)]

    def fresh():
        params = transformer.init_lm_params(
            cfg, torch.Generator(device=dev).manual_seed(0))
        for a, m in zip(tree_leaves(params), tree_leaves(plan.args[0])):
            assert a.shape == m.shape and a.dtype == m.dtype
        return params, init_adamw(params)

    def run(params, opt, which, record):
        for s in which:
            torch.cuda.synchronize()
            t = time.time()
            params, opt, loss, gnorm = plan.step(params, opt, batches[s])
            torch.cuda.synchronize()
            record.append(dict(step=s, s=time.time() - t, loss=float(loss),
                               gnorm=float(gnorm)))
        return params, opt

    params, opt = fresh()
    fa_ops.launches = fa_ops.bwd_launches = 0
    fa_ops.path_launches = dict.fromkeys(fa_ops.PATHS, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    straight = []
    with warnings.catch_warnings(record=True) as caught, \
            lm_train.deterministic(dev, warn_only=True):
        warnings.simplefilter("always")
        params, opt = run(params, opt, range(4), straight)
    peak = torch.cuda.max_memory_allocated()
    fwd, bwd = fa_ops.launches, fa_ops.bwd_launches
    blockers = sorted({str(w.message).split("\n")[0] for w in caught
                       if "deterministic" in str(w.message)})
    if fwd == 0 or bwd == 0:
        raise AssertionError(f"train_4k: flash launches {fwd} forward, {bwd} "
                             f"backward")
    if not all(math.isfinite(r["loss"]) for r in straight):
        raise AssertionError(f"train_4k: losses {straight}")
    step_s = float(np.median([r["s"] for r in straight[1:]]))
    tokens = TRAIN_B * TRAIN_T
    print(f"[51] llama3.2-1b train_4k ({cfg.n_layers} layers, remat, "
          f"B={TRAIN_B}, T={TRAIN_T}, AdamW): steps {[round(r['s'], 4) for r in straight]} s, "
          f"losses {[round(r['loss'], 4) for r in straight]}; {step_s:.4f} s "
          f"a step (median of steps 2-4) = {tokens / step_s:.1f} tokens/s; "
          f"peak {peak / 2**30:.2f} GiB; flash launches {fwd / 4:.0f} forward "
          f"(with the remat recompute) and {bwd / 4:.0f} backward a step "
          f"({fa_ops.path_launches}); ops without a deterministic kernel: "
          f"{blockers or 'none'}", flush=True)
    # the straight run's end state to host memory: a second run beside it
    # on the card would need ~72 of its 80 GB (an earlier phase's leftover
    # reservations made that run out of memory)
    final_p, final_m, final_v = (tree_map(lambda t: t.to("cpu"), tree)
                                 for tree in (params, opt.m, opt.v))
    del params, opt
    torch.cuda.empty_cache()

    # 2 steps, save, kill, restore, 2 steps
    p2, o2 = fresh()
    resumed = []
    with lm_train.deterministic(dev, warn_only=True):
        p2, o2 = run(p2, o2, range(2), resumed)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        ck = Checkpointer(d)
        t = time.time()
        ck.save(2, (p2, o2))
        save_s = time.time() - t
        nbytes = ck.last["bytes"]
        del p2, o2                              # the kill
        torch.cuda.empty_cache()
        t = time.time()
        (p3, o3), _, step = ck.restore((plan.args[0], plan.args[1]))
        p3, o3 = to_dev(p3, dev), to_dev(o3, dev)
        restore_s = time.time() - t
    assert step == 2 and int(o3.step) == 2
    with lm_train.deterministic(dev, warn_only=True):
        p3, o3 = run(p3, o3, range(2, 4), resumed)
    diffs = []
    for name, a, b in zip(("params", "m", "v"), (p3, o3.m, o3.v),
                          (final_p, final_m, final_v)):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            y = y.to(dev)
            if not torch.equal(x, y):
                diffs.append((name, tuple(x.shape),
                              float((x - y).abs().max())))
    same = not diffs
    losses_same = [r["loss"] for r in resumed] == [r["loss"]
                                                   for r in straight]
    print(f"[51] 2 + 2 steps across a save ({nbytes / 1e9:.2f} GB in "
          f"{save_s:.2f}s), a kill and a restore ({restore_s:.2f}s): params "
          f"and moments {'equal to the straight run bit for bit' if same else f'differ from the straight run: {diffs[:5]}'}; "
          f"losses {'equal' if losses_same else 'differ'}", flush=True)
    if not same and not blockers:
        raise AssertionError(f"the resumed run differs with no op named: "
                             f"{diffs[:5]}")
    del final_p, final_m, final_v
    # where a step's time goes: one more step under the profiler, and
    # AdamW's update alone by CUDA events (zero gradients; the state is
    # not used after)
    breakdown = step_breakdown(lambda: plan.step(p3, o3, batches[0]))
    zeros = tree_map(torch.zeros_like, p3)
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    a.record()
    adamw_update(AdamWConfig(), zeros, o3, p3)
    b.record()
    torch.cuda.synchronize()
    breakdown["adamw_ms"] = a.elapsed_time(b)
    if "parts_ms" in breakdown:
        print(f"[51] one train_4k step under torch.profiler: wall "
              f"{breakdown['wall_s']:.4f} s, device {breakdown['device_ms']:.1f}"
              f" ms (idle share <= {breakdown['idle_share']:.3f}); by part "
              f"{ {k: round(v, 1) for k, v in breakdown['parts_ms'].items()} }"
              f" ms; the largest others "
              f"{[(k, round(v, 1)) for k, v in breakdown['top_other_ms']]}; "
              f"AdamW's update alone {breakdown['adamw_ms']:.2f} ms",
              flush=True)
    else:
        print(f"[51] step breakdown not measured: {breakdown['reason']}; "
              f"AdamW's update {breakdown['adamw_ms']:.2f} ms", flush=True)
    del p3, o3, zeros
    torch.cuda.empty_cache()

    # train() on lm100m, with and without compression
    runs = {}
    for compress in (False, True):
        t = time.time()
        _, losses = lm_train.train(lm_train.PRESETS["lm100m"],
                                   ckpt_dir=None, compress=compress,
                                   device=dev, log_every=1, **LM100M_RUN)
        torch.cuda.synchronize()
        if not all(math.isfinite(x) for x in losses) \
                or len(losses) != LM100M_RUN["steps"]:
            raise AssertionError(f"train(lm100m, compress={compress}): "
                                 f"{losses}")
        runs["compress" if compress else "plain"] = dict(
            losses=losses, wall_s=time.time() - t)
    print(f"[51] train(lm100m, {LM100M_RUN}): "
          f"{ {k: [round(x, 4) for x in v['losses']] for k, v in runs.items()} }"
          f", wall {runs['plain']['wall_s']:.2f}s / "
          f"{runs['compress']['wall_s']:.2f}s (without / with --compress)",
          flush=True)
    torch.cuda.empty_cache()
    print(f"[51] done in {time.time() - t0:.1f}s", flush=True)
    return dict(steps=straight, resumed=resumed, step_s=step_s,
                tokens_per_s=tokens / step_s, peak_bytes=peak,
                flash_fwd_per_step=fwd / 4, flash_bwd_per_step=bwd / 4,
                flash_launches=fwd, flash_bwd_launches=bwd,
                bit_identical=same, diffs=diffs[:20], blockers=blockers,
                breakdown=breakdown,
                ckpt_bytes=nbytes, save_s=save_s, restore_s=restore_s,
                lm100m=runs, card=smi)


def training_phases(smi, dev) -> dict:
    """Phases 48-51."""
    t0 = time.time()
    out = dict(flash_bwd=flash_bwd_phase(smi, dev),
               bwd=spmm_bag_bwd_phase(smi, dev),
               families=family_phase(smi, dev),
               train=train_phase(smi, dev))
    out["wall_s"] = time.time() - t0
    print(f"[48-51] done in {out['wall_s']:.1f}s", flush=True)
    return out


def training_entries(tr) -> list:
    """The kernels line's entries of the two backward kernels."""
    main = next(r for r in tr["flash_bwd"]["shapes"]
                if r["shape"] == "llama3.2-1b")
    bag = tr["bwd"]["bag"]
    return [
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_bwd.cuh",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:71",
         "replaces_note": "no Pallas backward exists: the gradient of that "
                          "forward, which JAX takes by XLA's autodiff of "
                          "flash_attention_xla",
         "launches": tr["train"]["flash_bwd_launches"],
         "max_abs_err": max(main["max_abs_err"].values()),
         "ms": main["ms"], "plain_ms": main["plain_ms"],
         "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
         "library_ms": main["library_ms"],
         "shapes": tr["flash_bwd"]["shapes"], "train": tr["train"],
         "card": tr["flash_bwd"]["card"]},
        {"name": "embedding_bag_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/embedding_bag/csrc/"
                   "embedding_bag.cu",
         "replaces": "src/repro/kernels/embedding_bag/kernel.py:38",
         "replaces_note": "no Pallas backward exists: the gradient of that "
                          "forward, which JAX takes by XLA's autodiff of "
                          "the gather",
         "launches": tr["families"]["bag_bwd_launches"],
         "key_launches": tr["families"]["bag_bwd_key_launches"],
         "max_abs_err": bag["max_abs_err"], "ms": bag["ms"],
         "plain_ms": bag["plain_ms"],
         "bound_ms": bag["bound_ms"], "bound_by": "bytes",
         "library_ms": bag["library_ms"],
         "gather_floor_ms": bag["gather_floor_ms"], "shape": bag,
         "skew4": tr["bwd"]["bag_skew4"],
         "step_breakdown": tr["families"]["bag_step_breakdown"],
         "card": tr["bwd"]["card"]}]


def main() -> None:
    t_start = time.time()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda is not "
                         "available); the port's smoke runs on the card")

    # ---- 1. device ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(smi)
    print(f"[device] {kind} x{count}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)

    # ---- 2. build: one nvcc per kernel, all started together ----
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    builds = kernels.build_all()      # in the order of kernels.KERNELS
    build_s = time.time() - t0
    print(f"[build] {', '.join(b[0].name for b in builds[:-1])} and the "
          f"cycle kernels' tile library in {build_s:.1f}s (in parallel)")
    cca_ptxas = cycle_ptxas(builds[0][1] + builds[-1][1])

    # ---- 3a. kernel vs plain, pinned 8x8, chunk by chunk ----
    t0 = time.time()
    pinned = json.loads((ROOT / "tests" / "data"
                         / "pre_lanes_reference.json").read_text())
    eng = StreamingEngine(EngineConfig(**pinned["cfg"]), "bfs")
    eng.seed(0, 0.0)
    cfg, st, chunks, worst = eng.cfg, eng.state, 0, 0.0
    before = dict(ops.path_launches)
    for e in make_stream(StreamSpec(**pinned["spec"])):
        st, spill = load_stream(cfg, st, e)
        assert len(spill) == 0
        st, q = fresh_stats(st), False
        while not q:
            d, st, q = kernel_vs_plain(cfg, BFS, st, plain_on_cpu=True)
            worst, chunks = max(worst, d), chunks + 1
    on_path(before, "cluster", chunks)
    print(f"[3a] 8x8 pinned, cluster kernel {ops.cluster_geometry(cfg)} "
          f"(n_ctas, rows, bytes a CTA): kernel == plain on every leaf over "
          f"{chunks} chunks (max |d| {worst}; {time.time() - t0:.1f}s)",
          flush=True)

    # ---- 3b. kernel vs plain, 32x32 paper config, mid-stream states ----
    ci = dict(n_vertices=2000, n_edges=20_000)
    cfg_ci = paper_cfg(**ci)
    incs = make_stream(StreamSpec(increments=10, sampling="edge", seed=1,
                                  **ci))
    eng = StreamingEngine(cfg_ci, "bfs")
    eng.seed(0, 0.0)
    for i, e in enumerate(incs):
        if i in (2, 5, 8):
            st, _ = load_stream(eng.cfg, clone(eng.state), e)
            t0 = time.time()
            before = dict(ops.path_launches)
            d, sr, q = kernel_vs_plain(eng.cfg, BFS, fresh_stats(st), 512,
                                       ("cluster", "block"))
            if {p: ops.path_launches[p] - before[p] for p in ops.PATHS} \
                    != {"cluster": 1, "block": 1}:
                raise AssertionError("3b: not one launch on each kernel")
            worst = max(worst, d)
            print(f"[3b] 32x32 ci increment {i}: one K=512 chunk, the "
                  f"cluster kernel and the one-block kernel == plain on "
                  f"every leaf (cycle {int(sr.cycle)}, quiescent {q}, "
                  f"{time.time() - t0:.1f}s)", flush=True)
        eng.run_increment(e, max_cycles=2_000_000)
    want = bfs_levels(ci["n_vertices"], np.concatenate(incs), 0)
    assert (eng.values() == want).all(), "32x32 ci BFS != oracle"

    # ---- 4. fingerprints through the kernel ----
    t0 = time.time()
    before = dict(ops.path_launches)
    rows, vals = replay(pinned)
    assert rows == pinned["backends"]["jnp"]["increments"]
    assert (vals == np.float32(pinned["backends"]["jnp"]["values"])).all()
    print("[4] pinned 8x8 fingerprint reproduced exactly")
    fp = json.loads((ROOT / "src" / "repro_torch" / "data"
                     / "fingerprint_32x32.json").read_text())
    rows, vals = replay(fp)
    want_rows = [{k: r[k] for k in ("cycles", "hops", "execs", "stalls",
                                     "allocs")} for r in fp["increments"]]
    assert rows == want_rows, rows
    assert (vals == np.float32(fp["values"])).all()
    on_path(before, "cluster", None)
    print(f"[4] 32x32 fingerprint reproduced exactly "
          f"({sum(r['cycles'] for r in rows)} cycles; both fingerprints "
          f"{time.time() - t0:.1f}s, every launch on the cluster kernel)",
          flush=True)

    # ---- 5. the paper's stream at full size, through the kernel ----
    t0 = time.time()
    incs = make_stream(StreamSpec(increments=10, sampling="edge", seed=1,
                                  **PAPER_FULL))
    print(f"[5] stream generated in {time.time() - t0:.1f}s: "
          f"{sum(len(e) for e in incs)} edges", flush=True)
    cfg_p = paper_cfg(**PAPER_FULL)
    geometry = ops.cluster_geometry(cfg_p)
    eng = StreamingEngine(cfg_p, "bfs")
    eng.seed(0, 0.0)
    events = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with timed_launches(events):
        ops.launches = 0
        ops.path_launches = dict.fromkeys(ops.PATHS, 0)
        t0 = time.time()
        cycles = 0
        snapshot = None
        plain_rows = []
        for i, e in enumerate(incs):
            if i == len(incs) - 1:
                snapshot = clone(eng.state)
            r = eng.run_increment(e, max_cycles=2_000_000)
            cycles += r.cycles
            plain_rows.append(dict(cycles=r.cycles, hops=r.hops,
                                   execs=r.execs, stalls=r.stalls,
                                   allocs=r.allocs))
            print(f"  increment {i}: {len(e)} edges, {r.cycles} cycles, "
                  f"{r.hops} hops, {r.execs} execs, {r.stalls} stalls, "
                  f"{r.allocs} allocs", flush=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches, by_path = ops.launches, dict(ops.path_launches)
    if launches == 0:
        raise AssertionError("the main path launched no cycle kernel")
    if by_path != {"block": 0, "cluster": launches}:
        raise AssertionError(f"main-path launches by kernel {by_path}: not "
                             f"all on the cluster kernel")
    if (launches, cycles) != (102, 50_030):
        raise AssertionError(f"{launches} launches, {cycles} cycles: the "
                             f"paper stream runs 50,030 cycles in 102")
    kern_ms = sum(a.elapsed_time(b) for a, b in events)
    peak = torch.cuda.max_memory_allocated()
    got = eng.values()
    want = bfs_levels(PAPER_FULL["n_vertices"], np.concatenate(incs), 0)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert (got == want).all(), "paper-scale BFS != oracle"
    cells = cfg_p.n_cells
    print(f"[5] 50K/1M paper stream: {cycles} cycles in {wall:.3f}s wall "
          f"(host clock, ends in synchronize) = "
          f"{cycles * cells / wall:.4g} cell-cycles/s; {launches} launches "
          f"{by_path}, {kern_ms / launches:.4f} ms per launch by CUDA events "
          f"({1e6 * kern_ms / cycles:.1f} ns per machine cycle; kernel "
          f"{kern_ms / 1e3:.4f}s of the wall); peak "
          f"{peak / 2**20:.1f} MiB allocated; BFS == oracle", flush=True)

    # ---- 6. one K=512 chunk at full size: both kernels, plain, bound ----
    st, _ = load_stream(cfg_p, snapshot, incs[-1])
    st = fresh_stats(st)
    mutable = sum(t.numel() * t.element_size()
                  for k, t in st._asdict().items() if k != "io_edges")

    def time_chunk(fn, **kw):
        s = clone(st)
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        a.record()
        s2, qr = fn(cfg_p, BFS, s, 512, **kw)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b), s2, qr

    t_plain, s_plain, q_plain = time_chunk(cca_cycle_chunk_ref)
    times, d = {"cluster": [], "block": []}, 0.0
    for path in ("cluster", "block", "block", "cluster"):
        before = dict(ops.path_launches)
        t, s_kern, q_kern = time_chunk(ops.cca_cycle_chunk, path=path)
        on_path(before, path, 1)
        assert torch.equal(q_kern, q_plain)
        d = max(d, leaf_diff(s_kern, s_plain))
        times[path].append(t)
    ran = int(q_kern[1])
    t_kern, t_block = (float(np.mean(times[p])) for p in ("cluster",
                                                          "block"))
    consumed = int((s_kern.io_pos - st.io_pos).sum()) * 3 * 4
    bound_ms = 1e3 * (2 * mutable + consumed) / H100_BYTES_PER_S
    print(f"[6] full-size chunk ({ran} cycles), in turns cluster, block, "
          f"block, cluster: cluster kernel {geometry} (n_ctas, rows, bytes "
          f"a CTA) {times['cluster'][0]:.4f} / {times['cluster'][1]:.4f} ms "
          f"({1e6 * t_kern / ran:.1f} ns a cycle), one-block kernel "
          f"{times['block'][0]:.4f} / {times['block'][1]:.4f} ms "
          f"({1e6 * t_block / ran:.1f} ns a cycle; {t_block / t_kern:.2f}x "
          f"the cluster kernel), plain {t_plain:.1f} ms, bound "
          f"{bound_ms:.4f} ms (2 x {mutable / 2**20:.1f} MiB mutable state "
          f"over 3.35 TB/s); both kernels == plain (max |d| {d})",
          flush=True)

    # ---- 16-18. the paper experiments' branches, the experiments, replays
    worst = max(worst, branch_phases(pinned))
    experiments = experiment_phases(smi)
    pe._CACHE.clear()                 # seven engines' 0.8 GB IO buffers
    torch.cuda.empty_cache()
    engine_bench = replay_phases()

    # ---- 19. the trace rows' cost: the K=512 chunk of phase 6, in turns ----
    trace = torch.empty((512, 2), dtype=torch.int32, device=st.aq.device)
    turns = {"untraced": [], "traced": []}
    for which in ("untraced", "traced", "traced", "untraced"):
        before = dict(ops.path_launches)
        t, s_kern, q_kern = time_chunk(
            ops.cca_cycle_chunk, path="cluster",
            trace=trace if which == "traced" else None)
        on_path(before, "cluster", 1)
        assert torch.equal(q_kern, q_plain)
        d = max(d, leaf_diff(s_kern, s_plain))
        turns[which].append(t)
    want_rows = torch.full_like(trace, -1)
    cca_cycle_chunk_ref(cfg_p, BFS, clone(st), 512, want_rows)
    if not torch.equal(trace[:ran], want_rows[:ran]):
        raise AssertionError("19: the full-size chunk's trace rows differ "
                             "from the plain version's")
    t_traced, t_untraced = (float(np.mean(turns[k]))
                            for k in ("traced", "untraced"))
    print(f"[19] full-size chunk ({ran} cycles), in turns untraced, traced, "
          f"traced, untraced on the cluster kernel: untraced "
          f"{turns['untraced'][0]:.4f} / {turns['untraced'][1]:.4f} ms, "
          f"traced {turns['traced'][0]:.4f} / {turns['traced'][1]:.4f} ms "
          f"({t_traced / t_untraced:.4f}x); both == plain on every leaf, "
          f"the trace rows == the plain version's", flush=True)

    # ---- 20-22. lanes, parking, rhizomes and the max apps; the skew and
    # lanes experiments ----
    worst = max(worst, lane_rhizome_phases(), skew_state_phase())
    skew_replay = skew_replay_phases()
    skew_paper = skew_paper_phases()

    # ---- 23-26. telemetry: the kernels' telemetry instances, the
    # fingerprint, the three paths at full width, the cost ----
    d_tm, (cfg_t, st_t, s_plain_t) = telemetry_phase_kernels(pinned, cfg_p,
                                                             st)
    worst = max(worst, d_tm)
    telemetry_phase_replay()
    tm_paths = telemetry_phase_paths(incs, cfg_p, plain_rows, want)
    tm_cost = telemetry_phase_cost(cfg_t, st_t, s_plain_t, cfg_p, st,
                                   s_plain)
    del st_t, s_plain_t

    # ---- 27-30. faults, seals and repair: the kernels' fault instances,
    # the fingerprint, the paper stream under faults, the cost ----
    d_flt, (cfg_f, st_f, s_plain_f) = fault_phase_kernels(pinned, cfg_p, st)
    worst = max(worst, d_flt)
    flt_smokes = fault_phase_replay()
    flt_paths = fault_phase_paths(cfg_p, incs, want)
    flt_cost = fault_phase_cost(incs, cfg_p, st, s_plain, cfg_f, st_f,
                                s_plain_f)
    del st_f, s_plain_f

    # ---- 31-35. durable state, recovery and the ingest guard: kill and
    # resume at full size, recovery, the guard, the replays, the cost ----
    res_resume = resilience_phase_resume(cfg_p, incs, eng, want)
    res_recovery = resilience_phase_recovery(cfg_p, incs, want)
    res_guard = resilience_phase_guard(cfg_p, incs, want, plain_rows)
    res_replay = resilience_phase_replay()
    res_cost = resilience_phase_cost()

    # ---- 36-39. multi-tenant serving: the query-batched instances, the
    # fingerprint, bench_serve at full size, the paper stream under Q=8 ----
    d_mq, mq_chunk = mq_phase_kernels()
    worst = max(worst, d_mq)
    mq_replays = mq_phase_replay()
    mq_serve = mq_phase_serve()
    mq_paper = mq_phase_paper(1e6 * t_block / ran)

    # ---- 40-44. distribution: the grid tiled over ranks, one cycle a tile
    # step of the kernels' tile instance, the halo exchanged a cycle ----
    dist = dist_phases(cfg_p, st)

    # ---- 52-56. the sharded engine with every knob: the new tile
    # instances against the plain tile step, then the paper stream with
    # telemetry, the paper plan, a Q=8 batch and a traced stream, each
    # through the engine over four tiles ----
    tiles = tile_phases(cfg_p, st, incs, want, cca_ptxas)

    cca_entry = {
        "name": "cca_cycle_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/cca_cycle/csrc/"
                  "cca_cycle_cluster.cuh",
        "source_block": "src/repro_torch/kernels/cca_cycle/csrc/"
                        "cca_cycle.cu",
        "replaces": "src/repro/kernels/cca_cycle/kernel.py:43",
        "replaces_wrapper": "repro/kernels/cca_cycle/ops.py::cca_cycle_chunk",
        "path": "cluster", "n_ctas": geometry[0], "rows_per_cta": geometry[1],
        "smem_bytes_per_cta": geometry[2], "launches": launches,
        "launches_by_path": by_path, "equal_to_plain": True,
        "max_abs_err": max(worst, d), "ms": t_kern,
        "ms_per_launch": kern_ms / launches, "block_ms": t_block,
        "plain_ms": t_plain, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None, "chunk_cycles": ran, "ptxas": cca_ptxas,
        "branches": ["traces", "ingest_only", "random_allocator", "lanes",
                     "park", "rhizomes", "widest", "reliable", "telemetry",
                     "faults", "recovery", "ingest_guard", "qbatch",
                     "tile", "tile+telemetry", "tile+faults",
                     "tile+telemetry+faults", "tile+qbatch",
                     "tile+qbatch+telemetry", "tile+traces"],
        "tile": dict(
            main_path=dist["paper"], launches=dist["paper"]["tile_launches"],
            ms_per_cycle=dist["paper"]["ms_per_cycle"],
            exchange_ms_per_cycle=dist["paper"]["exchange_ms_per_cycle"],
            parity=dist["parity"], fingerprint=dist["fingerprint"],
            dist_bench=dist["bench"], gcn_partitioned=dist["gcn"],
            knobs=dict(
                instances=tiles["instances"],
                launches_by_instance={
                    "paper stream, telemetry (53)":
                        tiles["telemetry"]["launches"],
                    "paper stream, PAPER_PLAN to its livelock (54)":
                        tiles["faults"]["launches"],
                    "mid stream, PAPER_PLAN (54)":
                        tiles["faults"]["mid"]["launches"],
                    "Q=8 batch, 2K / 20K (55)": tiles["batch"]["launches"],
                    "paper stream, traced (56)":
                        tiles["traced"]["launches"]},
                telemetry=tiles["telemetry"], faults=tiles["faults"],
                batch=tiles["batch"], traced=tiles["traced"],
                knob_cost=tiles["knob_cost"],
                seconds={k: v for k, v in tiles.items()
                         if k.endswith("_s")})),
        "query_batched": dict(
            chunk_q8_k256=dict(path="block", ms=mq_chunk["ms"],
                               plain_ms=mq_chunk["plain_ms"],
                               bound_ms=mq_chunk["bound_ms"],
                               bound_by="bytes",
                               cycles=mq_chunk["cycles"]),
            launches=dict(mq_serve["query_launches"]),
            replays=mq_replays, serve_paper=mq_serve,
            paper_stream_q8=mq_paper),
        "telemetry": dict(tm_paths, **tm_cost),
        "faults": dict(
            smokes=flt_smokes,
            paper_stream={k: {m: v[m] for m in (
                "cycles", "launches", "wall_s", "increments", "livelock")
                if m in v} for k, v in flt_paths.items()},
            **flt_cost),
        "resilience": dict(
            resume=res_resume, recovery=res_recovery, guard=res_guard,
            replay=res_replay, checkpoint_cost=res_cost),
        "traced_ms": t_traced, "untraced_ms_in_turns": t_untraced,
        "paper_experiments": {
            "launches": experiments["launches"],
            "streams": [{k: v for k, v in r.items() if k != "per_increment"}
                        for r in experiments["streams"]]},
        "engine_bench": {k: {m: v[m] for m in ("cycles", "wall_s")}
                         for k, v in engine_bench.items()},
        "skew_fingerprint": skew_replay,
        "skew_paper": {f"rhizome_cap={R}": {
            k: r[k] for k in ("status", "all_cycles", "hops", "stalls",
                              "launches", "wall_s", "kernel_ms",
                              "ms_per_launch", "bound_ms", "livelock",
                              "vertex_object_stats") if k in r}
            for R, r in skew_paper.items()},
        "card": smi}
    del eng, snapshot, st, s_kern, s_plain
    torch.cuda.empty_cache()

    # ---- 7. the new kernels' ptxas reports (built in phase 2) ----
    print(f"[7] {builds[1][0].name} (built with the others in "
          f"{build_s:.1f}s)")
    print_ptxas(builds[1][1])
    bag_ptxas(builds[2][0].name, builds[2][1])

    spmm_entry = spmm_phases(smi, torch.device("cuda"))
    torch.cuda.empty_cache()
    bag_entry = dlrm_phases(smi, torch.device("cuda"))
    torch.cuda.empty_cache()          # DLRM's ~42 GiB freed before the LM

    # ---- 12. the flash-attention kernels' ptxas reports ----
    print(f"[12] {builds[3][0].name} (built with the others in "
          f"{build_s:.1f}s)")
    ptxas = flash_ptxas(builds[3][1])
    flash_entry = lm_phases(smi, torch.device("cuda"), ptxas)

    # ---- 45-47. MoE serving: the FFN against its plain version, EP, the
    # prefills and serve() at full width; two more main paths of flash ----
    t0 = time.time()
    moe = moe_phases(smi, torch.device("cuda"))
    runs = {"llama3.2-1b prefill_32k B=1 (5 forwards)":
            flash_entry["launches"]}
    by_path = dict(flash_entry["launches_by_path"])
    for r in moe["prefill"]:
        runs[f"{r['config']} {r['layers']} layer(s) B={r['B']} T={r['T']}"] \
            = r["flash_launches"]
        for k, n in r["flash_by_path"].items():
            by_path[k] += n
    flash_entry.update(launches=sum(runs.values()), launches_by_path=by_path,
                       launches_by_main_path=runs, moe=moe)
    print(f"[45-47] done in {time.time() - t0:.1f}s; flash launches by main "
          f"path {runs}", flush=True)
    torch.cuda.empty_cache()

    # ---- 48-51. training: the backward kernels, one step a family, the
    # training main path at full width ----
    tr = training_phases(smi, torch.device("cuda"))
    spmm_entry["backward"] = dict(
        rows=tr["bwd"]["spmm"], launches=tr["families"]["spmm_bwd_launches"],
        launches_path="phase 50's gcn-cora ogb_products grad step")
    bag_entry["backward"] = "embedding_bag_bwd"
    flash_entry["backward"] = "flash_attention_bwd"
    flash_entry["training"] = dict(
        forward_launches=tr["train"]["flash_launches"],
        families=tr["families"]["families"])
    print(f"[done] all phases in {time.time() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": [cca_entry, spmm_entry, bag_entry,
                                  flash_entry, *training_entries(tr)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
