#!/usr/bin/env python3
"""Smoke run of quiver_tpu_torch on one CUDA card: Reddit-size serving
(the device lane, then both lanes with the host sampler, then a fleet of
three replica processes, then under the sanitizer),
ogbn-products-size training of GraphSAGE, GAT and GCN with exact
inference, UVA and mixed sampling at products size, R-GAT at OGB-LSC
MAG240M widths, the nine user entry points (``quiver_tpu_torch.
examples``), and JAX's threefry draws (``sample_rng="key"``).

    python3 chip_smoke.py

Builds the port's six CUDA kernels from ``quiver_tpu_torch/csrc`` (at
first use, with nvcc, one process per source, all at once), then:

1. prints the card's name and power limit and the torch/CUDA versions;
2. builds the kernels and prints the build time, each kernel's registers
   and the card's L2 fetch granularity;
3. kernel phase: on a Reddit-sized graph, holds kernels B1 (both
   entries, at each hop of one bucket-2048 pass, on the frontier the
   kernel builds) and B2 against their plain PyTorch versions on the card
   at the main path's shapes, exactly, and times kernel, host launch,
   plain version and library call with CUDA events (B2 as
   ``lookup_device`` calls it, the frontier ids and the row order, in
   fp32 and bf16, through both routes, beside ``index_select`` on the
   mapped ids, with two bounds: ``b2_case``); the pass's lookup as three
   steps (clamp, order take, B2) and as one call of B2's entry, device
   time and device operations each (``lookup_span``); then the
   ``"pwindow"`` pipeline's host time, device span and device operations
   at each depth (each hop must add one B1 launch and no other operation)
   and its host profile; B1 is also timed with the L2 fetch granularity
   limit at 32 bytes (set, then restored);
4. serving phase (slice 1, the whole table on the card):
   RequestBatcher(mode="Device") -> InferenceServer_Debug -> GraphSAGE
   602 -> 256 -> 41 with fanouts [25, 10] and seeded random weights;
   warms every bucket, serves 64 requests of 1..512 ids from 4 client
   threads, checks every answer, recomputes served passes directly,
   checks one pass against the plain versions on the CPU, and checks that
   both kernels' launch counters rose while serving; then splits one
   bucket-2048 pass into sampling, lookup and model with CUDA events and
   lists its device time by kernel with ``torch.profiler``;
4b. weighted serving phase (slice 6): the same graph with edge weights
   from ``default_rng(SEED).random(E)`` and ``dedup="hop"``; serves the
   same 64-request plan (B3 27 times a hop of each chunk: bounds, total,
   24 CDF rounds, draws; B2 once a chunk; B1 never), holds one padded
   bucket-2048 pass (duplicate seeds) bitwise against the ``"xla"``
   pipeline on the card and its logits within CPU_TOL of the model on
   that batch, splits the pass, and runs its pipeline under
   ``"blocked:3"`` (B3 for every read, 27 launches a hop): bitwise equal
   to ``"xla"``, its span and peak memory beside ``"auto"``'s and
   ``"xla"``'s;
4c. host sampler phase (slice 9, (a)): the native host sampler's
   bucket-2048 ``sample_multihop`` on the Reddit graph, host ms at the
   default thread count and at 1, every hop checked (counts, rows,
   distinct positions, local ids); ``mode="CPU"`` on the card bitwise
   against ``device="cpu"``;
4d. hybrid serving phase (slice 9, (b)): ``generate_neighbour_num`` on
   the card (timed, against the CPU by the +-1 rule),
   ``calibrate_threshold``, then the 64-request plan through
   RequestBatcher(mode="Auto") -> HybridSampler(num_workers=2) ->
   InferenceServer_Debug (at the plan's median load when the calibrated
   threshold sends every request one way): both lanes answer, B2 once a
   device chunk and once a CPU-lane request, a CPU-lane answer equal to a
   direct forward, each lane's p50 and p99;
4e. resilient serving phase (slice 10): the same graph and model with
   the native host sampler as the failover route
   (``resilient_serving_phase``): the 64-request plan under QoS
   (QOS_TENANTS) and a 60 s deadline, every answer ok and recomputed;
   a ChaosPlan failing ``serving.device_lane`` BREAKER_FAILURES times
   (breaker closed -> open -> half_open -> closed, each failover answer
   equal to ``_infer_presampled`` of its batch, one no-route fault
   answered with ``ChaosFault``); a burst of BURST requests into lanes
   of BURST_DEPTH under 3x the bucket-2048 pass as deadline (every
   request answered, sheds by stage); ``/metrics`` and the debug routes
   on 127.0.0.1:0, the flight recorder's records, one request on the
   timeline, the profile's device rows for B1 and B2;
   ``serving_failover_total`` stays 0 in every step without a fault;
   then the plan's latency all at once and in phase 4's bursts, with
   QoS and telemetry on and off, each twice (``serving_overhead_ab``).
   Phase 4 also holds ``trace_scope(block=)`` around a bucket-2048
   lookup (B2) to the call's CUDA-event time, and the products
   ``"auto"`` lane (11) saves a checkpoint, restores it into a fresh
   model and Adam, and takes one more step from each: equal losses;
4f. streaming serving phase (slice 11, ``streaming_phase``): the Reddit
   graph as a ``StreamingGraph`` with per-edge int32 timestamps from
   SEED and the default delta capacity (65,536); (1) with no deltas a
   bucket-2048 pass through the overlay (B3, 5 launches a hop) bitwise
   against the frozen ``"pwindow"`` pass (B1) on the same key words,
   ``eid`` included, both timed; (2) after 2,112 inserts (64 onto the
   four largest rows), 256 base and 32 delta deletes, the overlay hop
   at both hops, windowed and not, bitwise against its plain version on
   the card (B3 5 or 7 launches a hop), the whole pass too, the snapshot
   build time, then a fold; (3) the 64-request plan served while an
   ``IngestLane`` with a WAL (``RecoveryManager`` under
   ``build/chip_smoke_stream``, fsync per append) applies STREAM_INSERTS
   inserts in batches of STREAM_BATCH and deletes STREAM_DELETES base
   edges, with one ``compact()`` at half the ingest: every request answered,
   every update acked ok, and a probe sampler (the plain hop) checks at
   every version it sees that each of STREAM_PROBES low-degree rows
   draws exactly its live neighbours (every acked insert at or before
   the version, no acked delete) and that no tombstoned edge is drawn in
   either hop; drained, a fold with a padded pass arriving 50 ms into it
   (timed: it waits for the graph lock), and the stream pass bitwise
   equal to a frozen pass on ``g.base``; (4) a checkpoint through the lane's
   barrier with a ``"200M"`` paged feature's page residency, a tail of
   STREAM_TAIL inserts and STREAM_TAIL_DELETES deletes, the manager
   closed and the graph dropped, ``boot()`` from the directory: base,
   tombstones, delta order and version equal the live ones, the same
   pass bitwise, and the restored pages serve rows (B5) bitwise equal
   to the source with no fault; snapshot build, overlay and frozen pass
   ms, fold pauses, WAL append p50, checkpoint bytes, write and verify
   seconds, replay seconds and serving p50/p99 under ingest printed;
4g. sharding phase (slice 12, ``sharding_phase``): ``MeshSampler``
   (``gather_mode="pallas"``: B3 five launches a hop a shard) and
   ``MeshFeature`` (B2 once a shard a gather, the max combine) over
   MESH_SHARDS shards that all name card 0 serve the 64-request plan in
   bucket-2048 passes: every hop's ``nbrs``/``mask``/``counts``/``eid``
   bitwise the single-device B1 hop's, every row ``lookup_device``'s,
   logits within CPU_TOL; ``DistFeature`` (a ``partition_without_
   replication`` book), ``RingFeature`` and ``HierFeature`` (a ``[2, 2]``
   mesh) look up ``[4, 2048]`` ids bitwise the table's;
   ``DistGraphSampler`` [25, 10] (``"blocked"``: B3) bitwise its
   ``"xla"`` run with no drops at exact caps; wall ms of each beside the
   single-device path;
4i. bf16 and ``from_mmap`` (slice 12, A5 and A4, ``bf16_phase``,
   ``mmap_phase``): the plan served by ``GraphSAGE(dtype=bfloat16)``
   over a bf16 table (B1, B2's bf16 route), three passes recomputed
   (answers the bf16 forward, within BF16_VS_FP32 of the fp32 model),
   p50/p99 beside phase 4's; Reddit's table saved under
   ``build/chip_smoke_mmap`` and opened with ``Feature.from_mmap(...,
   "200M")``: each request's frontier rows through the staged merge
   (B2) and the paged store (B5) bitwise the table's, ms a request;
5. B5 kernel phase (slice 2, the budgeted feature store): the feature
   under the reference's ``device_cache_size="200M"`` in degree order,
   paged, with a pool of every host page; stages the frontier of one
   bucket-2048 pass (the first stage faults every page it touches), holds
   kernel B5 against its plain version in fp32 and bf16, exactly, and
   times kernel, plain version and library call;
6. budgeted serving phase: the same 64-request plan through the unfused
   lane over that feature; checks every answer, recomputes three passes
   (rows bitwise equal to the source, logits equal to the full-cache
   server's fused forward within CPU_TOL), and checks that B5 launched
   while serving;
7. fallback and overlay phase: one bucket-2048 gather under the default
   page pool (it overflows: the staged merge serves it), and repeated
   gathers with paging off (the overlay serves hits); rows bitwise equal
   to the source;
8. splits one budgeted bucket-2048 pass into sampling, the read-back of
   ``n_id``, the host stage (plan and faults), the gather and the model,
   lists its device time by kernel with ``torch.profiler`` and its host
   time by function with cProfile;
9. B1 products phase (slice 5): on ``synthetic_products`` (2,449,029
   nodes, ~123.7M edges), B1's two entries at the three hops of one
   1,024-seed batch with fanouts [15, 10, 5] (frontiers of 1,024, 16,384
   and 180,224 ids), as in the kernel phase, and the ``"pwindow"``
   pipeline's cost by depth; then that batch's positional pipeline
   under ``"blocked:3"`` (B3 twice a hop), bitwise against ``"xla"``,
   with spans and peak memory as in 4b;
10. B3/B4 kernel phase (slices 3 and 4, training): at the last hop of that
   batch (the 180,224-long frontier, its 901,120 draws), holds B3's two
   entries and B4's fused and literal entries against their plain
   versions, exactly, times kernel, host launch, plain version and
   library call and the earlier two-step B4 (``index_select`` rows, then
   the literal entry), and checks that ``element_gather(fused=True)``
   allocates no ``[M, 128]`` rows;
11. fused training phase: the whole 100-wide table on the card, B2 at the
   step's lookup (the batch's 1,081,344 frontier ids through the row
   order, ``b2_case``), GraphSAGE
   100 -> 256 -> 256 -> 47 with dropout 0.5 and seeded weights, Adam at
   3e-3; 30 steps of ``make_fused_train_step`` under
   ``gather_mode="pallas"`` (B3 twice a hop, 6 times a step, B1 never)
   10 under ``"auto"``, the example's default (B1 once a hop, 3 times a
   step, B3 never), and 10 under ``"auto"`` with ``dedup="hop"`` and no
   caps (slice 6: B1's literal entry once a hop, then the reindex); B2
   once a step; the loss must fall in each; per lane the step split by
   CUDA events, one step under ``torch.profiler`` (B1's kernels and the
   sort, searchsorted and scatter kernels counted; under ``"hop"`` the
   launch counter shows B1 3 times in each profiled step and the profile
   at least once, as a capture may drop device events; the dedup's whole device time is the ``"hop"`` step's
   device time less the ``"none"`` step's), and one batch through ``make_fused_eval_fn``
   against the plain versions on the CPU within CPU_TOL; the ``"hop"``
   lane's first sampled batch bitwise against the ``"xla"`` pipeline on
   the card, and one call under ``bench.py``'s ``hop_caps`` (hop 1 must
   drop nodes; ``overflow_stats``), bitwise against ``"xla"`` too; then
   (slice 7) GAT at PyG's ``ogbn_products_gat.py`` widths and GCN at the
   GraphSAGE lane's, 10 steps each under ``"auto"`` (B1 3 times a step,
   B2 once; their losses are printed, not checked: see ``SAGE_LANE``);
12. two-stage training phase: ``device_cache_size="200M"`` (524,288 hot
   rows), ``SeedLoader(prefetch=2)`` over a sampler in
   ``gather_mode="lanes_fused"`` (B4 must launch 9 times per sampled
   batch), ``make_train_step``, 5 steps (the loss must fall), every
   gathered row bitwise equal to the source, peak device memory printed;
   then one batch split into sampling, read-back, host gather and
   training;
12b. data-parallel phase (slice 12, 4h, ``dp_phase``):
   ``make_train_step(mesh=)`` over DP_REPLICAS replicas on card 0,
   GraphSAGE at products' widths with dropout 0, DP_STEPS steps of 1,024
   seeds a replica (B1 and B2 in the sampling and lookups): each loss
   within rtol 1e-5 of the single-device step that takes the mean of the
   replicas' losses, the loss falling; then ``run_dist_training`` over 4
   shards of card 0 (20,000 nodes, 100 wide, [15, 10, 5]);
13. exact inference phase (slice 7): ``full_graph_inference`` of the
   trained GraphSAGE, GCN and GAT over all of products' edges in chunks
   of EDGE_CHUNK (time, peak memory, finite ``[N, 47]`` logits), and on a
   20,000-node graph against the same call on the CPU within CPU_TOL;
13b. slice 9 at products size: (c) UVA with a third of the edges hot
   (the split's build time; 10 batches with ``overlap`` on and off, ms
   and host ms a batch, bitwise equal, B1 3 times a batch; hop 1's hot
   rows, ``uva_budget=None`` and an all-hot budget against the device
   mode); (d) ``MixedGraphSageSampler`` 16 tasks for 2 epochs, each task
   once an epoch, the CPU share; (e) three ``TorchSampleLoader`` batches
   (``x`` the source rows, B2 once a batch);
14. R-GAT phase (slice 7, its main path): a synthetic graph with
   MAG240M's schema and average degrees (MAG_COUNTS: papers and authors
   cut to 2,000,000) and 12.4 GB of 768-wide tables on the card;
   ``HeteroGraphSageSampler.sample`` (B1's literal entry once a block, 5
   a step) -> ``HeteroFeature.lookup`` (B2 once a type, 3 a step) ->
   ``make_train_step(RGAT)`` at OGB-LSC's baseline widths for MAG_STEPS
   steps (the loss must fall); the step split by CUDA events, one step
   under the profiler, one batch under ``"pwindow"`` bitwise against
   ``"xla"``, and B1 and B2 at that batch's shapes against their plain
   versions (B2 per type as in ``b2_case``);
4j. fleet phase (slice 13, ``fleet_phase``, after R-GAT): the Reddit
   graph with phase 4f's timestamps checkpointed under
   ``build/chip_smoke_fleet`` with the table and the seeded weights; three
   replica processes on card 0 (``chip_smoke.py --fleet-replica SPEC``,
   each ``FleetReplica`` serving GraphSAGE through
   ``RequestBatcher(mode="Device")`` -> ``InferenceServer``: B3 in the
   overlay pass, B2 in the lookup): the leader ``r0`` boots cold (it
   builds every library into the empty shared cache,
   ``QUIVER_TPU_RECOVERY_CACHE_DIR``), followers ``r1`` and ``r2`` warm
   (``r2`` with a seeded ``fleet.serve`` fault every 4th request); a
   ``FleetRouter`` with federation on takes the 64-request plan in
   three phases (four clients, all at once with ``kill -9`` of ``r1``
   mid-burst, four clients) while the leader ingests phase 4f's mix
   through its lane (writes sent to ``router.write_path()``); ``r1``
   rejoins warm under its id (library hits, no build, sealed registry,
   staleness within ``fleet_max_staleness_lsn``); ingest stopped and
   caught up, FLEET_PROBES probes with fixed key words to each replica
   (``n_id`` bitwise equal to a pass in the parent over a read-only
   rebuild of the leader's root, logits within CPU_TOL, equal versions);
   B2/B3 launches from each process's counters; ``/metrics/fleet`` with
   every replica's series and ``timeline.export_fleet`` showing one
   re-dispatched trace on two replica tracks; then ``fleet_election=on``
   on a fresh root: ``kill -9`` of the leader mid-ingest, a follower
   promoted under a higher epoch, every acked write in the promoted WAL,
   writes acked by the promoted lane, the deposed epoch's append refused,
   zero lost answers;
4k. sanitizer phase (slice 14, ``sanitize_phase``, run last): the
   parent serves the 64-request plan through RequestBatcher(mode=
   "Device") -> InferenceServer_Debug unsanitized and takes the logits
   of fixed probe requests (SANITIZE_PROBES, fixed key words); a child
   (``chip_smoke.py --sanitize-child SPEC``, ``QUIVER_SANITIZE=1``,
   the graph and table handed over as ``.npy`` files under
   ``build/chip_smoke_sanitize``) imports the port under both witnesses,
   seeds the lock order from the port's own ``canonical_lock_edges``,
   serves the same plan (B1, B2: no sync inside ``"serving device
   loop"``, and once the clients run nothing leaves the card but one
   answer read-back a chunk), gathers SANITIZE_PAGED_LOOKUPS frontiers
   through the ``"200M"`` paged store (B5: none inside ``"paged
   gather"``, rows bitwise the table's), samples SANITIZE_MESH_HOPS hops
   over MESH_SHARDS shards of the card (B3: none inside ``"mesh
   combine"``), sends SANITIZE_MIXED request sizes inside the warmed
   buckets under ``count_jit_builds()`` (0 builds, 0 compiler runs),
   requires no lock-witness violation, then (read after all the above)
   one ``.item()``, one ``nonzero`` and the pre-repair pageable seed
   upload inside a region must each be recorded; the probes' logits
   must be bitwise the parent's; both runs' p50/p99 are printed; the
   child hands back every transfer it saw before the deliberate ones,
   each with its frame's path in the package (``Transfer.path``);
4l. lint phase (slice 15, ``lint_phase``, after 4k, in the parent): runs
   ``python -m quiver_tpu_torch.analysis quiver_tpu_torch
   --strict-baseline --format json`` on this tree (it must exit 0 with
   the fifteen rules) and prints its seconds and its census by rule (new,
   baselined, suppressed); then holds the sanitizer's run against it:
   every Python coercion (LINT_COERCIONS) the child observed in a frame
   of the package must sit on a line where QT001 or QT013 reports or is
   waived (an ``ignore[...]``, a ``sync-ok[...]`` or a baseline entry),
   or be one of LINT_BLIND_SPOTS, whose length it prints; it prints the
   distinct coercion lines matched by each code;
4m. examples phase (slice 16, ``examples_phase``, last): the nine user
   entry points of ``quiver_tpu_torch.examples`` in this process through
   ``main(argv, report=...)``, one after another, at their published
   widths with only epochs and steps cut (EXAMPLE_RUNS), and
   ``big_graph_single_chip`` once more under the paged store (B5); every
   launch counter set to 0 just before each call and read just after.
   Each must return 0, end with its summary line, have finite losses, show
   what its data can learn (the loss falls for Reddit, products and DGL;
   unsup's intra-community similarity is above the inter), and launch its
   kernels; each run's wall seconds, launches by kernel, step or epoch
   times and serving p50/p99 are printed;
4n. keyed phase (slices 17 and 18, ``--phases keyed``): the threefry
   kernel (``csrc/threefry_uniform.cu``, JAX's ``jax.random.uniform``)
   bitwise against its plain version on the card at KEYED_SHAPES (float
   bits compared), timed against its bound (the integer operations at
   the int32 issue rate: THREEFRY_INT_OPS, INT32_OPS_PER_S); B1's
   threefry instance (``csrc/window_sample.cu`` over ``threefry.cuh``)
   through both entries at the Reddit pass (KEYED_PASS), bitwise its
   plain version, timed against the larger of its sector bound and the
   cipher's integer issue, and its ``"blocked"`` pipeline's device
   operations a hop (B1 alone); after the bf16/mmap phase, the
   64-request plan served by a sampler under ``sample_rng="key"`` (the
   auto gather mode is then ``"blocked"``: B1's keyed pipeline entry
   once a hop, B2 once a pass, no threefry and no B3 launch), every
   served batch's ``n_id`` and masks bitwise the ``"xla"`` sampler's on
   the card; ``key=rng.key(s)`` under each RNG on the card against the
   CPU path the tests hold against JAX (no threefry launch under
   either); a keyed hop and pass fused, unfused (the threefry kernel and
   B3) and hashed (``"pwindow"``), each as device and host ms; then, at
   products size after the data-parallel phase, B1's threefry instance
   at products' hops against its plain version, and KEYED_STEPS fused
   steps under ``"key"`` in each of KEYED_LANES (``"pallas"``: the
   threefry kernel and B3; the default: B1's keyed entry), each from
   ``key=rng.key(i)``, finite losses and every batch bitwise
   ``"xla"``'s;
15. prints one ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --phases examples
    python3 chip_smoke.py --phases kernel,serving
    python3 chip_smoke.py --phases keyed

``--phases`` runs only the named phases (PHASES), with the shared setup
and the earlier phases whose results they need (PHASE_NEEDS); the
kernels line then holds the records those phases made.  An unknown name
exits 2.  Without the argument every phase runs.

Any failed check exits non-zero.  Without a CUDA card it exits 2 and
prints no result.

The Reddit graph has PyG Reddit's 232,965 nodes and asks
``synthetic_csr`` (lognormal degrees) for its 114,615,892 edges; flooring
each node's degree leaves 114,499,636, 0.1% fewer.  The JAX package's
``synthetic_reddit`` asks for a tenth of the edges; this run uses the
published count, so indices alone are ~458 MB on the card.  Nothing of
the products configuration is cut to size.  The MAG240M configuration
keeps every width and MAG240M's average degrees and cuts the paper and
author counts to 1/61 (MAG_COUNTS).
"""

from __future__ import annotations

import copy
import ctypes
import glob
import itertools
import json
import os
import queue
import subprocess
import sys
import threading
import time

import numpy as np

N_NODES = 232_965
N_EDGES = 114_615_892
DIM, HIDDEN, CLASSES = 602, 256, 41
FANOUTS = [25, 10]
SEED = 0
DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
SECTOR = 32  # bytes: the unit in which device memory is read
SPIN_CYCLES = 5_000_000  # about 2.5 ms of the card's clock (cuda_ms)
N_CLIENTS, PER_CLIENT, MAX_IDS = 4, 16, 512
CPU_TOL = dict(rtol=1e-5, atol=1e-5)  # fp32, CPU vs card summation order
# the budget of examples/ogbn_products_sage.py and of the reference's
# serving example: 87,091 of Reddit's 602-wide fp32 rows, 524,288 of
# products' 100-wide ones
HOT_BUDGET = "200M"
# slice 3: the training loop of examples/ogbn_products_sage.py at full width
P_DIM, P_HIDDEN, P_CLASSES = 100, 256, 47
P_FANOUTS = [15, 10, 5]
P_BATCH, P_LR = 1024, 3e-3
FUSED_STEPS, AUTO_STEPS, STAGED_STEPS = 30, 10, 5
# slice 7: GAT at PyG's examples/ogbn_products_gat.py widths (hidden 128 x
# 4 heads, 3 layers, fanouts [10, 10, 10], batch 512, Adam 1e-3) and GCN at
# the GraphSAGE lane's (OGB's products GCN width), both on products
FAMILY_STEPS = 10
GAT_HIDDEN, GAT_HEADS, GAT_FANOUTS, GAT_BATCH, GAT_LR = 128, 4, [10] * 3, \
    512, 1e-3
# exact inference: edges per chunk, so GAT's [chunk, 512] gather is 4 GB
EDGE_CHUNK = 2_000_000
# slice 7's main path: R-GAT at OGB-LSC MAG240M's baseline widths
# (examples/lsc/mag240m/rgnn.py in snap-stanford/ogb: 768-wide features
# for all three types, hidden 1024, 4 heads, 2 layers, 153 classes,
# dropout 0.5, Adam 1e-3, batch 1,024, fanouts [25, 15] per relation) on a
# synthetic graph with MAG240M's schema and average degrees; the paper and
# author counts are cut to 1/61 of MAG240M's (121,751,666 and 122,383,112),
# all 25,721 institutions kept
MAG_COUNTS = {"paper": 2_000_000, "author": 2_000_000, "institution": 25_721}
MAG_DEGREES = {("paper", "cites", "paper"): 10.66,
               ("author", "writes", "paper"): 3.17,
               ("institution", "employs", "author"): 0.364}
MAG_DIM, MAG_HIDDEN, MAG_HEADS, MAG_CLASSES = 768, 1024, 4, 153
MAG_FANOUTS, MAG_BATCH, MAG_LR, MAG_STEPS = [25, 15], 1024, 1e-3, 10
MAG_FRONTIERS = {"paper": 425_984, "author": 424_960, "institution": 384_000}
MAG_CHUNK_ROWS = 262_144  # feature rows drawn on the card at a time
# device operations counted by name in a step's profile (lower case)
KERNEL_FAMILIES = {"B1": ("window_sample_kernel",),
                   "sort_searchsorted_scatter": ("sort", "searchsorted",
                                                 "scatter"),
                   "sage_mean": ("sage_mean_fwd",),
                   "sage_mean_backward": ("sage_mean_bwd",),
                   "sage_act": ("sage_act_fwd",),
                   "sage_act_backward": ("sage_act_bwd",),
                   "sage_act_mean": ("sage_act_mean_fwd",),
                   "sage_act_mean_backward": ("sage_act_mean_bwd",),
                   "threshold_backward": ("threshold",)}
BLOCKED_MODE = "blocked:3"
# GraphSAGE's hand-written kernels, the mean's, the hidden layers'
# activation's and the two fused (launch counter names, profile families)
SAGE_KERNELS = ("sage_mean", "sage_mean_backward", "sage_act",
                "sage_act_backward", "sage_act_mean", "sage_act_mean_backward")


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str):
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 15, warm: int = 3) -> float:
    """Median device milliseconds of ``fn`` over ``reps`` runs, each
    bracketed by CUDA events.  A spin kernel runs first, so the host has
    enqueued the events and ``fn``'s launches before the card reaches
    them: the span is device time, not the host's launch time (which is
    longer than the kernel for calls under about 0.1 ms)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def host_ms(torch, fn, reps: int = 15) -> float:
    """Median host milliseconds to return from ``fn`` (its launch cost),
    the card drained before each call."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def sector_bytes(torch, *positions) -> int:
    """Bytes of the distinct 32-byte sectors of a 4-byte-element table that
    the element ``positions`` touch, together: the least a gather of them
    must read, each sector once however often it is hit (and never more
    than the table)."""
    pos = torch.cat([p.reshape(-1).to(torch.int64) for p in positions])
    return int(torch.unique(pos >> 3).numel()) * SECTOR


def seeded_model(torch, qt):
    """GraphSAGE 602 -> 256 -> 41, weights uniform in +-1/sqrt(fan_in)
    from a seeded generator."""
    model = qt.GraphSAGE(DIM, HIDDEN, CLASSES, num_layers=2, dropout=0.5,
                         device="cpu")
    g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for name, p in model.named_parameters():
            conv = model.convs[int(name.split(".")[1])]
            fan_in = (conv.lin_self if "lin_self" in name
                      else conv.lin_nbr).in_features
            bound = 1.0 / fan_in ** 0.5
            p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=g))
    return model


def frontier_of(torch, qt, topo, n_seeds: int, seed: int):
    """Host ``n_id`` of one padded pass of ``n_seeds`` random seeds."""
    sampler = qt.GraphSageSampler(topo, FANOUTS, device=DEV, seed=seed)
    ids = np.random.default_rng(seed).integers(0, N_NODES, n_seeds)
    with torch.inference_mode():
        return sampler.sample(ids).n_id.cpu().numpy()


def int_err(pairs) -> float:
    """Max absolute difference over pairs of integer tensors (0 if all
    are empty)."""
    return float(max([(a.long() - b.long()).abs().max().item()
                      for a, b in pairs if a.numel()] or [0]))


def b1_hops(torch, b1, ip, ix, seeds, fanouts, kw, where: str,
            sample_rng: str = "hash"):
    """Kernel B1 at each hop of one positional pipeline from ``seeds``,
    through both entries: the pipeline entry (one launch a hop under
    ``"pwindow"``, and under ``"blocked"`` with the key; it writes the
    hop's frontier tail, mask tail and local ids) and the literal entry,
    each held against its plain version exactly, on the frontier the
    kernel itself builds, with uniforms by ``sample_rng`` (the hash
    instance or the threefry one).  Times kernel (CUDA events), host
    launch and plain version per hop and entry; under the key the bound
    is the larger of the sector bytes' and the cipher's integer issue
    (``THREEFRY_INT_OPS`` for each draw whose uniform decides its
    position: a live seed's window wider than k).  Returns the cases and
    the final frontier and mask."""
    dev = ip.device
    t = seeds.shape[0]
    total = t
    for k in fanouts:
        total *= 1 + k
    frontier = torch.empty(total, dtype=torch.int32, device=dev)
    fmask = torch.empty(total, dtype=torch.bool, device=dev)
    frontier[:t] = seeds
    fmask[:t] = True
    ref_f, ref_m = frontier.clone(), fmask.clone()  # the plain version's
    cases = []
    for hop, k in enumerate(fanouts, 1):
        k0, k1 = int(kw[hop - 1, 0]), int(kw[hop - 1, 1])
        s, m, n = frontier[:t], fmask[:t], t * k

        def pipe():
            return b1.window_sample_frontier(ip, ix, frontier, fmask, t, k,
                                             k0, k1, sample_rng=sample_rng)

        def pipe_plain():
            return b1.window_sample_frontier_plain(
                ip, ix, ref_f, ref_m, t, k, k0, k1, sample_rng=sample_rng)

        def lit():
            return b1.window_sample(ip, ix, s, k, k0, k1, m,
                                    sample_rng=sample_rng)

        def lit_plain():
            return b1.window_sample_plain(ip, ix, s, k, k0, k1, m,
                                          sample_rng)

        got, want, lgot, lwant = pipe(), pipe_plain(), lit(), lit_plain()
        torch.cuda.synchronize()
        pairs = [(frontier[t:t + n], ref_f[t:t + n]),
                 (fmask[t:t + n], ref_m[t:t + n]),
                 (got.nbr_local, want.nbr_local), (got.counts, want.counts),
                 *zip(lgot, lwant)]
        for i, (a, b) in enumerate(pairs):
            check(torch.equal(a, b), f"B1 {where} hop {hop}: output {i} "
                  "differs from the plain version")
        check(torch.equal(frontier[t:t + n].view(t, k), torch.where(
            lgot.mask, lgot.nbrs, torch.zeros_like(lgot.nbrs))),
            f"B1 {where} hop {hop}: the two entries differ")
        err = int_err(pairs)
        # inputs read once (seeds and their mask; the distinct sectors of
        # indptr that live seeds' two words touch and of indices that the
        # draws touch), outputs written once (three per draw: frontier,
        # mask and local ids, or neighbours, mask and edge ids; counts)
        live = s[m].long()
        nbytes = (t * (4 + 1 + 4) + sector_bytes(torch, live, live + 1)
                  + sector_bytes(torch, lgot.eid[lgot.mask]) + n * (4 + 1 + 4))
        draws = int(lgot.counts.sum())
        bound = dict(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                     bound_by="bytes")
        if sample_rng == "key":
            wide = (ip[live + 1] - ip[live]) > k
            ciphered = int(wide.sum()) * k
            by_ops = ciphered * THREEFRY_INT_OPS / INT32_OPS_PER_S * 1e3
            bound.update(
                bytes_bound_ms=bound["bound_ms"], ops_bound_ms=by_ops,
                ciphered_draws=ciphered,
                # every slot ciphered, as the kernel does
                ops_bound_all_slots_ms=n * THREEFRY_INT_OPS
                / INT32_OPS_PER_S * 1e3,
                no_overlap_bound_ms=bound["bound_ms"] + by_ops)
            if by_ops > bound["bound_ms"]:
                bound.update(bound_ms=by_ops, bound_by="operations")
        for entry, fn, plain in (("pipeline", pipe, pipe_plain),
                                 ("literal", lit, lit_plain)):
            cases.append(dict(
                entry=entry, shape=f"{where} hop {hop}: B={t}, k={k}",
                sample_rng=sample_rng, max_abs_err=err, ms=cuda_ms(torch, fn),
                host_ms=host_ms(torch, fn), plain_ms=cuda_ms(torch, plain),
                draws=draws, **bound))
            if entry == "pipeline":
                # the scattered reads with 32-byte fetches (side timing)
                cases[-1]["ms_l2_fetch"] = dict(zip(
                    ("ms", "limit_bytes"), cuda_ms_at_fetch(torch, fn, 32)))
            print(f"B1 {entry} entry, {cases[-1]['shape']}: exact; "
                  f"{json.dumps(cases[-1])}", flush=True)
        del got, want, lgot, lwant
        t += n
    check(bool(fmask.any()) and not bool(fmask.all()),
          f"B1 {where}: the hops met no masked slot")
    return cases, frontier, fmask


def b1_record(b1, cases, name: str = "window_sample") -> dict:
    """B1's entry in the kernels line: the pipeline entry's times (what
    the main path runs) summed over the hops; each case listed.  Under
    the key (``name`` ``"window_sample_key"``) the bound sums the hops'
    bounds and says which of bytes and operations is the larger in
    sum."""
    pipe = [c for c in cases if c["entry"] == "pipeline"]
    lit = [c for c in cases if c["entry"] == "literal"]

    def total(cs, key):
        return float(sum(c[key] for c in cs))

    rec = dict(name=name, route="cuda", source=b1.SOURCE,
               replaces=b1.REPLACES,
               max_abs_err=max(c["max_abs_err"] for c in cases),
               ms=total(pipe, "ms"), plain_ms=total(pipe, "plain_ms"),
               bound_ms=total(pipe, "bound_ms"), bound_by="bytes",
               library_ms=None, host_ms=total(pipe, "host_ms"),
               literal_ms=total(lit, "ms"),
               literal_host_ms=total(lit, "host_ms"), cases=cases)
    if "ops_bound_ms" in pipe[0]:
        for key in ("bytes_bound_ms", "ops_bound_ms",
                    "ops_bound_all_slots_ms", "no_overlap_bound_ms"):
            rec[key] = total(pipe, key)
        rec["ciphered_draws"] = int(total(pipe, "ciphered_draws"))
        if rec["ops_bound_ms"] > rec["bytes_bound_ms"]:
            rec["bound_by"] = "operations"
    return rec


def kernel_phase(torch, qt, topo, feature, b1, b2):
    """Each kernel against its plain version at the main path's shapes
    (one bucket-2048 pass); returns the kernel records."""
    dev = torch.device(DEV)
    ip, ix = topo.to_device(dev)
    rng = np.random.default_rng(SEED + 1)
    kw = rng.integers(0, 2**32, size=(2, 2), dtype=np.uint32)

    # B1 at hop 1 (2048 seeds, k=25) and hop 2 (53,248 seeds, k=10, with
    # the pipeline's masked slots), through both entries
    seeds = torch.from_numpy(
        rng.integers(0, N_NODES, 2048).astype(np.int32)).to(dev)
    b1_cases, n_id, _ = b1_hops(torch, b1, ip, ix, seeds, FANOUTS, kw,
                                "Reddit")
    cost = pwindow_pipeline_phase(torch, ip, ix, seeds, kw, FANOUTS,
                                  "Reddit", b1)

    # B2 at the lookup of that pass, as Feature.lookup_device calls it:
    # 585,728 frontier ids and the feature's row order, rows of width 602
    check(n_id.shape[0] == 585_728, f"frontier {n_id.shape[0]}")
    b2_cases = [b2_case(torch, b2, "Reddit", feature.hot, n_id,
                        feature._order_dev)]
    bf16 = feature.hot.to(torch.bfloat16)
    b2_cases.append(b2_case(torch, b2, "Reddit", bf16, n_id,
                            feature._order_dev))
    del bf16
    span = lookup_span(torch, feature, n_id, b2)

    return [
        dict(b1_record(b1, b1_cases), pipeline_cost=cost),
        dict(name="gather_rows", route="cuda", source=b2.SOURCE,
             replaces=b2.REPLACES,
             max_abs_err=max(c["max_abs_err"] for c in b2_cases),
             ms=b2_cases[0]["ms"], plain_ms=b2_cases[0]["plain_ms"],
             bound_ms=b2_cases[0]["bound_ms"], bound_by="bytes",
             library_ms=b2_cases[0]["library_ms"],
             bound_all_draws_ms=b2_cases[0]["bound_all_draws_ms"],
             kernel_route=b2_cases[0]["route"], cases=b2_cases,
             lookup_span=span),
    ]


def b2_case(torch, b2, where: str, table, ids, order) -> dict:
    """Kernel B2's entry at one lookup of the main path, called as
    ``Feature.lookup_device`` calls it (the frontier ids and the feature's
    row order): the entry (its route picked by ``route``) and both routes
    held bitwise against the plain version; each timed whole (the grouped
    route's counting sort included) with CUDA events behind a spin kernel,
    beside the plain version and ``index_select`` on the mapped ids.  Two
    bounds frame the time: the least work (ids, the order entries and each
    distinct row read once, every output row written once) and the work
    when every draw reads its row."""
    m, n = ids.shape[0], table.shape[0]
    row = table.shape[1] * table.element_size()
    mapped = ids.to(torch.int64).clamp(0, n - 1)
    if order is not None:
        mapped = order[mapped]
    distinct = int(torch.unique(mapped).shape[0])
    want = b2.gather_rows_plain(table, ids, order)
    bits = {2: torch.int16, 4: torch.int32}[table.element_size()]
    got = {"entry": b2.gather_rows(table, ids, order)}
    for which in ("direct", "grouped"):
        got[which] = b2.gather_rows_route(table, ids, order, which)
    torch.cuda.synchronize()
    for name, g in got.items():
        check(torch.equal(g.view(bits), want.view(bits)),
              f"B2 {where} {table.dtype} ({name}) differs from the plain "
              "version")
    err = float((got["entry"].float() - want.float()).abs().max())
    del got, want
    id_bytes = m * ids.element_size()
    least = (id_bytes + (distinct * 4 if order is not None else 0)
             + distinct * row + m * row)
    every = id_bytes + (m * 4 if order is not None else 0) + 2 * m * row
    case = dict(
        shape=f"{where}: M={m}, N={n}, D={table.shape[1]}, "
              f"{str(table.dtype)[6:]}, {str(ids.dtype)[6:]} ids, "
              f"{'ordered' if order is not None else 'no order'}",
        route=b2.route(m, n, row), max_abs_err=err,
        ms=cuda_ms(torch, lambda: b2.gather_rows(table, ids, order)),
        direct_ms=cuda_ms(torch, lambda: b2.gather_rows_route(
            table, ids, order, "direct")),
        grouped_ms=cuda_ms(torch, lambda: b2.gather_rows_route(
            table, ids, order, "grouped")),
        host_ms=host_ms(torch, lambda: b2.gather_rows(table, ids, order)),
        plain_ms=cuda_ms(torch, lambda: b2.gather_rows_plain(table, ids,
                                                            order)),
        library_ms=cuda_ms(torch, lambda: torch.index_select(table, 0,
                                                             mapped)),
        bound_ms=least / HBM_BYTES_PER_S * 1e3,
        bound_all_draws_ms=every / HBM_BYTES_PER_S * 1e3,
        distinct_rows=distinct)
    print(f"B2 {case['shape']}: exact; {json.dumps(case)}", flush=True)
    return case


def lookup_span(torch, feature, n_id, b2) -> dict:
    """The Reddit pass's lookup two ways on the same ids: as the clamp,
    the order take and B2, three steps (how ``lookup_device`` ran before
    B2 took the clamp and the order), and as ``lookup_device`` now runs it,
    one call of B2's entry: device time (``cuda_ms``), host time and the
    device operations of each."""
    n = feature.node_count

    def separate():
        pos = n_id.to(torch.int64).clamp(0, n - 1)
        return b2.gather_rows(feature.hot, feature._order_dev[pos])

    def entry():
        return feature.lookup_device(n_id)

    check(torch.equal(separate(), entry()),
          "lookup_device differs from the separate clamp, take and gather")
    out = {}
    for name, fn in (("separate_steps", separate), ("one_entry", entry)):
        ops, _ = device_ops(torch, fn)
        out[name] = dict(ms=cuda_ms(torch, fn), host_ms=host_ms(torch, fn),
                         device_ops=len(ops) if ops else "not measured",
                         op_names=sorted(set(o[:60] for o in ops)))
    print("Reddit lookup span " + json.dumps(out), flush=True)
    return out


def stage_times(torch, server):
    """CUDA-event split of one bucket-2048 pass: sampling, feature
    lookup, model (median of 5)."""
    s = server.sampler
    ids = np.random.default_rng(SEED + 2).integers(0, N_NODES, 2048)
    out = {"sample": [], "lookup": [], "model": [], "pass_wall": []}
    with torch.inference_mode():
        for _ in range(7):
            kw = server.draw_key_words()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            n_id, _, _, blocks, _ = s.pipeline(s.seed_tensor(ids), kw)
            ev[1].record()
            x = server.feature.lookup_device(n_id)
            ev[2].record()
            y = server.model(x, blocks)
            ev[3].record()
            y.cpu()
            out["pass_wall"].append((time.perf_counter() - t0) * 1e3)
            out["sample"].append(ev[0].elapsed_time(ev[1]))
            out["lookup"].append(ev[1].elapsed_time(ev[2]))
            out["model"].append(ev[2].elapsed_time(ev[3]))
    return {k: float(np.median(v[2:])) for k, v in out.items()}


def pass_runner(forward, seed: int):
    """A zero-argument run of one bucket-2048 pass ``forward(ids,
    key_words)`` and its read-back, on ids and words drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N_NODES, 2048)
    kw = rng.integers(0, 2**32, size=(len(FANOUTS), 2), dtype=np.uint32)
    return lambda: forward(ids, kw).cpu()


PRIME_SPINS = 4  # spin kernels that open every profiler capture


def prime_capture(torch):
    """Open a ``torch.profiler`` capture with PRIME_SPINS short spin
    kernels and a 50 ms pause.  On the card's machine a capture can lose
    the device events of its first milliseconds (PERF.md §7); the spins
    and the pause take that loss in place of the run's own operations,
    and the counts leave the spins out (``is_prime``)."""
    for _ in range(PRIME_SPINS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(0.05)


def is_prime(name: str) -> bool:
    return "spin_kernel" in name


def device_profile(torch, run, wall_ms: float, top: int = 8,
                   families=None, tries: int = 3) -> dict:
    """``run()`` once warm, then once under ``torch.profiler``: device time
    by kernel or copy (the ``top`` largest), and the card's busy share of
    ``wall_ms``, the unprofiled run's wall time (one stream, so device
    events do not overlap and their sum is the busy time), and the count
    of device operations.  ``families`` maps a label to name fragments
    (matched without case): each label gets the count and device time of
    the operations whose names hold one.  A capture with no device event
    is taken again, up to ``tries`` times.  Each capture opens with
    ``prime_capture``; ``primes_seen`` says how many of its spins the
    profiler kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prime_capture(torch)
            run()
            torch.cuda.synchronize()
        by_name: dict = {}
        counts: dict = {}
        primes = 0
        for e in prof.events():
            # user annotations (e.g. Optimizer.step) span the kernels
            # inside them on the device track: count the kernels only
            if e.device_type != DeviceType.CUDA or e.is_user_annotation:
                continue
            if is_prime(e.name):
                primes += 1
                continue
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
            counts[e.name] = counts.get(e.name, 0) + 1
        if by_name:
            break
    busy_ms = sum(by_name.values()) / 1e3
    if busy_ms == 0:
        return {"device_ms": "not measured: the profiler saw no device "
                             "events"}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    out = dict(device_ms=busy_ms, busy_share=busy_ms / wall_ms,
               top=[dict(name=n[:100], ms=t / 1e3) for n, t in ranked],
               ops=sum(counts.values()), primes_seen=primes)
    if families:
        out["families"] = {}
        for label, frags in families.items():
            names = [n for n in by_name
                     if any(f in n.lower() for f in frags)]
            ms = sum(by_name[n] for n in names) / 1e3
            out["families"][label] = dict(
                count=sum(counts[n] for n in names), ms=ms,
                share=ms / busy_ms)
    return out


def family_count(prof: dict, label: str) -> int:
    """How many device operations of ``label``'s family a
    :func:`device_profile` counted (0 where it saw none)."""
    return prof.get("families", {}).get(label, {}).get("count") or 0


def request_plan():
    """The 64 requests both serving phases send, and the generator that
    drew them."""
    rng = np.random.default_rng(SEED + 3)
    plans = [[rng.integers(0, N_NODES, int(n)) for n in
              rng.integers(1, MAX_IDS + 1, PER_CLIENT)]
             for _ in range(N_CLIENTS)]
    return rng, plans


def serve(torch, qt, sampler, feature, model, kernels, hybrid=None,
          during=None):
    """Warm every bucket, then serve the request plan from N_CLIENTS
    threads through RequestBatcher(mode="Device") and
    InferenceServer_Debug, with each kernel's launch count set to 0 just
    before and read just after.  With ``hybrid``, ``(neighbour_num,
    threshold, cpu_sampler)``, the batcher runs ``mode="Auto"`` and a
    ``HybridSampler(num_workers=2)`` feeds the server's CPU lane.
    ``during()`` (which must not block) is called once the clients have
    started.  Checks every answer; returns the server, the answers, the
    requests sent, the launches and a summary."""
    streams = [queue.Queue() for _ in range(N_CLIENTS)]
    results: "queue.Queue" = queue.Queue()
    hs = None
    if hybrid is None:
        rb = qt.RequestBatcher(streams, mode="Device", result_queue=results)
    else:
        nn, threshold, cpu_sampler = hybrid
        rb = qt.RequestBatcher(streams, neighbour_num=nn,
                               threshold=threshold, mode="Auto",
                               result_queue=results)
        hs = qt.HybridSampler(cpu_sampler, rb.cpu_batched_queue,
                              num_workers=2, feature=feature,
                              result_queue=results)
    server = qt.InferenceServer_Debug(
        sampler, feature, model, rb.device_batched_queue,
        cpu_sampled_queue=None if hs is None else hs.sampled_queue,
        result_queue=results, seed=SEED)
    t0 = time.perf_counter()
    server.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    print(f"warmup of {len(server.BUCKETS)} buckets: {warmup_s:.3f} s",
          flush=True)
    server.pass_log.clear()
    rng, plans = request_plan()
    sent = {}

    def client(c):
        # bursts of four, so the device lane finds requests to coalesce
        for seq, ids in enumerate(plans[c]):
            req = qt.ServingRequest(ids=ids, client=c, seq=seq)
            sent[(c, seq)] = req
            streams[c].put(req)
            if seq % 4 == 3:
                time.sleep(0.02)

    from quiver_tpu_torch import telemetry

    def failovers():
        return sum(v for k, v in telemetry.snapshot()["counters"].items()
                   if k.startswith("serving_failover_total"))

    failovers_before = failovers()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    rb.start()
    if hs is not None:
        hs.start()
    server.start()
    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(c,))
               for c in range(N_CLIENTS)]
    for t in clients:
        t.start()
    if during is not None:
        during()
    answers = {}
    try:
        for _ in range(N_CLIENTS * PER_CLIENT):
            req, out = results.get(timeout=300)
            check(not isinstance(out, Exception), f"request failed: {out!r}")
            answers[(req.client, req.seq)] = out
    finally:
        served_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in kernels.items()}
        for t in clients:
            t.join(timeout=30)
        leaked = (rb.stop() + (hs.stop() if hs is not None else [])
                  + server.stop())
    check(not leaked and not any(t.is_alive() for t in clients),
          "serving threads did not stop")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    stats = server.stats()
    passes = list(server.pass_log)
    print(f"served {len(answers)} requests in {served_s:.3f} s over "
          f"{len(passes)} passes; launches while serving: "
          f"{json.dumps(launches)}; peak device memory {peak_gb:.2f} GiB",
          flush=True)
    print("stats " + json.dumps(stats), flush=True)

    check(len(answers) == N_CLIENTS * PER_CLIENT, "missing answers")
    for key, out in answers.items():
        check(out.shape == (len(sent[key].ids), CLASSES),
              f"answer {key} has shape {out.shape}")
        check(np.isfinite(out).all(), f"answer {key} is not finite")
    check(stats["count"] == len(answers), "stats count")
    check(failovers() == failovers_before,
          "serving_failover_total moved in a run that injects no fault")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched while serving")
    summary = dict(stats=stats, warmup_s=warmup_s, served_s=served_s,
                   passes=len(passes), peak_gib=peak_gb)
    return server, answers, sent, launches, rng, summary


def picked_passes(server):
    """Three served passes to recompute: a coalesced one, the one with the
    largest chunk, and the first (or, where those coincide, the next)."""
    passes = list(server.pass_log)
    coalesced = [p for p in passes if len(p[0]) > 1]
    check(coalesced, "no pass coalesced requests")
    check(len(passes) >= 3, f"only {len(passes)} passes served")
    picks = {id(p): p for p in (
        coalesced[0], max(passes, key=lambda p: len(p[1][0][0])),
        *passes)}
    return list(picks.values())[:3]


def serving_phase(torch, qt, topo, feat, feature, b1, b2):
    """Serve 64 requests through the port's full-width slice; returns the
    launch counts of the served run and a summary."""
    sampler = qt.GraphSageSampler(topo, FANOUTS, device=DEV, seed=SEED)
    model = seeded_model(torch, qt)
    model_cpu = copy.deepcopy(model)
    server, answers, sent, launches, rng, summary = serve(
        torch, qt, sampler, feature, model,
        {"window_sample": b1.window_sample, "gather_rows": b2.gather_rows})

    # recompute served passes directly from their recorded padded ids and
    # key words: a coalesced one, a chunked or top-bucket one, the first
    picks = picked_passes(server)
    top = server.BUCKETS[-1]
    for members, chunks in picks:
        total_ids = sum(len(sent[m].ids) for m in members)
        direct = np.concatenate([
            server.fused_forward(p, kw)[:min(top, total_ids - top * i)]
            .cpu().numpy() for i, (p, kw) in enumerate(chunks)])
        off = 0
        for m in members:
            n = len(sent[m].ids)
            check(np.array_equal(answers[m], direct[off: off + n]),
                  f"answer {m} differs from the direct forward of its pass")
            off += n
    print(f"recomputed {len(picks)} served passes (sizes "
          f"{[len(c[0][0]) for _, c in picks]}, "
          f"{max(len(m) for m, _ in picks)} requests coalesced): "
          "answers equal", flush=True)

    # one small pass against the plain versions on the CPU
    sampler_cpu = qt.GraphSageSampler(topo, FANOUTS, device="cpu")
    feature_cpu = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                             device="cpu").from_cpu_tensor(feat)
    check(np.array_equal(feature_cpu.feature_order, feature.feature_order),
          "feature order differs between card and CPU")
    ref = qt.InferenceServer(sampler_cpu, feature_cpu, model_cpu, None)
    padded = server._pad_ids(rng.integers(0, N_NODES, 50))
    kw = server.draw_key_words()
    n_card = sampler.sample(padded, key_words=kw).n_id.cpu()
    n_cpu = sampler_cpu.sample(padded, key_words=kw).n_id
    check(torch.equal(n_card, n_cpu), "card frontier differs from the CPU's")
    y_card = server.fused_forward(padded, kw).cpu()
    y_cpu = ref.fused_forward(padded, kw)
    err = float((y_card - y_cpu).abs().max())
    check(torch.allclose(y_card, y_cpu, **CPU_TOL),
          f"card logits differ from the CPU's by {err}")
    print(f"CPU reference pass (bucket {len(padded)}, frontier "
          f"{n_cpu.shape[0]}): frontier equal, logits max abs err {err:.3e}",
          flush=True)

    stages = stage_times(torch, server)
    print("bucket-2048 pass split (ms, median of 5) " + json.dumps(stages),
          flush=True)
    prof = device_profile(torch, pass_runner(server.fused_forward, SEED + 4),
                          stages["pass_wall"])
    print("bucket-2048 pass on the card (torch.profiler) " + json.dumps(prof),
          flush=True)
    # slice 10: trace_scope(block=) around a bucket-2048 pass's lookup
    n_id = sampler.sample(rng.integers(0, N_NODES, 2048),
                          key_words=server.draw_key_words()).n_id
    summary.update(stages_ms=stages, device_profile=prof,
                   trace_scope=trace_scope_check(torch, feature, n_id))
    return launches, summary


def weighted_serving_phase(torch, qt, topo, feature, b2, b3):
    """Reddit serving with edge weights (``default_rng(SEED).random(E)``)
    and ``dedup="hop"``: the request plan through ``serve``; B3 reads
    every hop's bounds, totals, 24 CDF rounds and draws (27 launches a hop
    of each pass's chunk, B1 none), B2 the lookup.  One padded
    bucket-2048 pass (its duplicate seeds are the bucket's pad) against
    the ``"xla"`` pipeline on the card, bit for bit, and its logits within
    CPU_TOL of the model on that pipeline's batch; the pass split; then
    the same pass's pipeline under BLOCKED_MODE (``blocked_phase``).
    Returns the launches and a summary."""
    from quiver_tpu_torch.sampler import run_pipeline

    t0 = time.perf_counter()
    w = np.random.default_rng(SEED).random(topo.edge_count, dtype=np.float32)
    sampler = qt.GraphSageSampler(topo, FANOUTS, device=DEV, seed=SEED,
                                  edge_weights=w, dedup="hop")
    del w
    torch.cuda.synchronize()
    print(f"weighted sampler {sampler!r}: cumulative weights on the card "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    model = seeded_model(torch, qt)
    server, _, _, launches, rng, summary = serve(
        torch, qt, sampler, feature, model,
        {"element_gather": b3.element_gather, "gather_rows": b2.gather_rows})
    chunks = sum(len(log) for _, log in server.pass_log)
    per_chunk = len(FANOUTS) * (1 + 1 + 24 + 1)
    check(launches["element_gather"] == per_chunk * chunks,
          f"B3 launched {launches['element_gather']} times for {chunks} "
          f"weighted chunks, not {per_chunk} a chunk")
    check(launches["gather_rows"] == chunks,
          f"B2 launched {launches['gather_rows']} times for {chunks} chunks")

    ip, ix = topo.to_device(DEV)
    cw = sampler._cum_weights
    padded = server._pad_ids(rng.integers(0, N_NODES, 1500))
    check(len(padded) == 2048, f"padded to {len(padded)}")
    kw = server.draw_key_words()
    seeds = sampler.seed_tensor(padded)
    with torch.inference_mode():
        got = sampler.pipeline(seeds, kw)
        want = run_pipeline("hop", ip, ix, seeds, kw, FANOUTS,
                            gather_mode="xla", cum_weights=cw)
        check_same_sample(torch, got, want, "weighted Reddit hop vs xla")
        y = server.fused_forward(padded, kw).cpu()
        y_plain = server.model(feature.lookup_device(want[0]),
                               want[3]).cpu()
    err = float((y - y_plain).abs().max())
    check(bool(torch.isfinite(y).all()) and y.shape == (2048, CLASSES),
          "weighted logits")
    check(torch.allclose(y, y_plain, **CPU_TOL),
          f"weighted logits differ from the xla batch's by {err}")
    sizes = dict(padded=[int(b.nbr_local.shape[0]) for b in got[3][::-1]]
                 + [int(got[0].shape[0])],
                 valid=[int(b.num_targets) for b in got[3][::-1]]
                 + [int(got[2])])
    print(f"weighted hop bucket-2048 pass: batch equal to xla, bit for bit; "
          f"logits max abs err {err:.3e}; frontiers {json.dumps(sizes)}",
          flush=True)
    stages = stage_times(torch, server)
    print("weighted hop bucket-2048 pass split (ms, median of 5) "
          + json.dumps(stages), flush=True)
    hprof = host_profile(torch, lambda: sampler.pipeline(seeds, kw))
    print("weighted hop pipeline on the host (cProfile, own time) "
          + json.dumps(hprof), flush=True)
    blocked = blocked_phase(torch, "Reddit weighted hop", lambda mode:
                            run_pipeline("hop", ip, ix, seeds, kw, FANOUTS,
                                         gather_mode=mode, cum_weights=cw),
                            b3, per_chunk)
    summary.update(stages_ms=stages, logits_max_abs_err=err,
                   frontiers=sizes, chunks=chunks, blocked=blocked,
                   host_profile=hprof)
    return launches, summary


# -- slice 2: the budgeted feature store --------------------------------------

def budgeted_feature(qt, topo, feat, pool_pages=None, paged=True):
    """``Feature(device_cache_size=HOT_BUDGET, csr_topo=topo)`` on the card,
    paged with ``pool_pages`` (``None``: the default pool) or not paged."""
    f = qt.Feature(device_cache_size=HOT_BUDGET, csr_topo=topo,
                   device=DEV).from_cpu_tensor(feat)
    check(0 < f.cache_count < N_NODES, f"budget holds {f.cache_count} rows")
    check(f.cold.is_pinned(), "the cold tail is not in pinned memory")
    if paged:
        f.enable_paging(pool_pages=pool_pages)
    return f


def feature_counters(qt) -> dict:
    """The port registry's counters: the one place every feature, paged
    store and sampler counts."""
    return dict(qt.telemetry.snapshot()["counters"])


def counters_added(qt, before: dict) -> dict:
    """The registry's counters that moved since ``before``, by how much."""
    return {k: v - before.get(k, 0) for k, v in feature_counters(qt).items()
            if v != before.get(k, 0)}


def b5_phase(torch, qt, topo, feat, feature, src, b5):
    """Kernel B5 against its plain version at the shapes of one budgeted
    bucket-2048 pass; returns the kernel record and the pass's ``n_id``."""
    dev = torch.device(DEV)
    store = feature.paged
    t = store.table
    check(t.pool_pages == t.n_host_pages, "the pool must hold every page")
    n_id = frontier_of(torch, qt, topo, 2048, SEED + 5)
    check(n_id.shape[0] == 585_728, f"frontier {n_id.shape[0]}")
    idx = feature.feature_order[n_id]
    host = {}
    for name in ("first stage (faults)", "second stage (hits)"):
        before = feature_counters(qt).get("feature_page_faults_total", 0)
        with feature._plock:
            t0 = time.perf_counter()
            plan = store.stage(idx)
            ms = (time.perf_counter() - t0) * 1e3
        host[name] = dict(ms=ms, faults=feature_counters(qt).get(
            "feature_page_faults_total", 0) - before)
        check(plan is not None, f"{name}: the pool overflowed")
    check(host["first stage (faults)"]["faults"] > 0, "no page faulted")
    check(host["second stage (hits)"]["faults"] == 0, "hits re-faulted")
    print(f"budgeted feature {feature!r}, {store!r}: cold rows "
          f"{int((idx >= feature.cache_count).sum())} of {len(idx)}; host "
          f"stage {json.dumps(host)}", flush=True)
    _, blk_pages, blk_np, row_lp, row_off, rank, B = plan
    plan_d = [torch.from_numpy(a).to(dev)
              for a in (blk_pages, row_lp, row_off, rank)]
    R = t.page_rows
    flat = (plan_d[0].long()[(plan_d[3].long() // store.block) * store.ppb
                             + plan_d[1].long()[plan_d[3].long()]] * R
            + plan_d[2].long()[plan_d[3].long()])  # library input, untimed
    distinct = int(torch.unique(flat).shape[0])
    want_rows = src[torch.from_numpy(n_id).to(dev).long()]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        frames = store.frames if dtype == torch.float32 else \
            store.frames.to(dtype)
        got = b5.page_gather(frames, *plan_d, store.block, store.ppb)
        want = b5.page_gather_plain(frames, *plan_d, store.block, store.ppb)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"B5 {dtype} differs from the plain "
              "version")
        check(torch.equal(got, want_rows.to(dtype)),
              f"B5 {dtype} rows differ from the source")
        row = DIM * frames.element_size()
        # distinct rows read, rows written, and per output row its rank,
        # row_lp and row_off entries; each block's page list entries
        nbytes = (distinct + B) * row + B * 3 * 4 + int(blk_np.sum()) * 4
        view = frames.view(-1, DIM)
        cases.append(dict(
            shape=f"B={B}, frames={tuple(frames.shape)}, {str(dtype)[6:]}",
            vector_bytes=b5.vector_bytes(row, frames.data_ptr(),
                                         got.data_ptr()),
            max_abs_err=float((got.float() - want.float()).abs().max()),
            ms=cuda_ms(torch, lambda: b5.page_gather(
                frames, *plan_d, store.block, store.ppb)),
            plain_ms=cuda_ms(torch, lambda: b5.page_gather_plain(
                frames, *plan_d, store.block, store.ppb)),
            library_ms=cuda_ms(torch, lambda: view.index_select(0, flat)),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, distinct_rows=distinct))
        print(f"B5 {dtype}: exact; {json.dumps(cases[-1])}", flush=True)
        del got, want, frames, view
    return dict(name="page_gather", route="cuda", source=b5.SOURCE,
                replaces=b5.REPLACES,
                max_abs_err=max(c["max_abs_err"] for c in cases),
                ms=cases[0]["ms"], plain_ms=cases[0]["plain_ms"],
                bound_ms=cases[0]["bound_ms"], bound_by="bytes",
                library_ms=cases[0]["library_ms"], cases=cases,
                host_stage_ms=host), n_id


def budgeted_serving_phase(torch, qt, topo, feature, full_feature, src,
                           b1, b5):
    """The slice-1 request plan through the unfused lane over the budgeted
    paged feature; returns the server, the launches of the served run and
    a summary."""
    sampler = qt.GraphSageSampler(topo, FANOUTS, device=DEV, seed=SEED)
    model = seeded_model(torch, qt)
    before = feature_counters(qt)
    server, answers, sent, launches, _, summary = serve(
        torch, qt, sampler, feature, model,
        {"window_sample": b1.window_sample, "page_gather": b5.page_gather})
    check(not server._fused, "a budgeted feature took the fused lane")
    check(feature.cold_cache is not None, "the server left the overlay off")
    moved = counters_added(qt, before)
    print("feature counters over warmup and serving "
          + json.dumps(moved), flush=True)
    check(moved.get("feature_page_fallback_total", 0) == 0,
          "a served pass fell back: the pool must hold every page")

    ref = qt.InferenceServer(sampler, full_feature, seeded_model(torch, qt),
                             None)
    check(ref._fused, "the full-cache reference is not fused")
    picks = picked_passes(server)
    top = server.BUCKETS[-1]
    err = 0.0
    for members, chunks in picks:
        total_ids = sum(len(sent[m].ids) for m in members)
        direct = []
        for i, (p, kw) in enumerate(chunks):
            with torch.inference_mode():
                batch = sampler.sample(p, key_words=kw)
                x = feature[batch.n_id.cpu().numpy()]
                check(torch.equal(x, src[batch.n_id.long()]),
                      "budgeted rows differ from the source")
                y = server.model(x, batch.layers)
            y_ref = ref.fused_forward(p, kw)
            err = max(err, float((y - y_ref).abs().max()))
            check(torch.allclose(y, y_ref, **CPU_TOL),
                  f"budgeted logits differ from the full-cache ones by {err}")
            direct.append(y[:min(top, total_ids - top * i)].cpu().numpy())
        direct = np.concatenate(direct)
        off = 0
        for m in members:
            n = len(sent[m].ids)
            check(np.array_equal(answers[m], direct[off: off + n]),
                  f"answer {m} differs from the direct forward of its pass")
            off += n
    print(f"recomputed {len(picks)} budgeted passes (sizes "
          f"{[len(c[0][0]) for _, c in picks]}): rows equal the source, "
          f"logits within {err:.3e} of the full-cache server", flush=True)
    summary.update(feature_counters=moved, logits_max_abs_err=err)
    return server, launches, summary


def fallback_overlay_phase(torch, qt, topo, feat, src, n_id):
    """The default page pool overflows on a bucket-2048 frontier (the
    staged merge serves it); with paging off, the overlay serves repeated
    gathers.  Rows bitwise equal to the source; returns a summary."""
    dev = torch.device(DEV)
    before = feature_counters(qt)
    f = budgeted_feature(qt, topo, feat)
    t = f.paged.table
    check(t.pool_pages == max(8, t.n_host_pages // 4),
          f"default pool {t.pool_pages}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = f[n_id]
    torch.cuda.synchronize()
    staged_ms = (time.perf_counter() - t0) * 1e3
    check(f.paged.fallbacks == 1, "the default pool did not overflow")
    check(torch.equal(rows, src[torch.from_numpy(n_id).to(dev).long()]),
          "fallback rows differ from the source")
    out = dict(default_pool_pages=t.pool_pages, host_pages=t.n_host_pages,
               staged_gather_ms=staged_ms,
               counters=counters_added(qt, before))
    del f, rows

    f = budgeted_feature(qt, topo, feat, paged=False).enable_cold_cache()
    small = frontier_of(torch, qt, topo, 256, SEED + 6)
    want = src[torch.from_numpy(small).to(dev).long()]
    for _ in range(3):
        check(torch.equal(f[small], want), "overlay rows differ from the "
              "source")
    st = f.stats()["cold_cache"]
    check(st["hits"] > 0 and st["misses"] > 0, f"overlay stats {st}")
    out["overlay"] = dict(rows=len(small), **st)
    print("fallback and overlay " + json.dumps(out), flush=True)
    return out


def budgeted_stage_times(torch, server) -> dict:
    """Split of one budgeted bucket-2048 pass (median of 5): sampling by
    CUDA events; the read-back of ``n_id`` and the host stage (feature
    order, plan and faults) by the host clock; the gather (plan copy and
    B5) and the model by CUDA events; and the pass as the server runs it
    (``unfused_forward`` and the answer's read-back) by the host clock."""
    feature, store = server.feature, server.feature.paged
    rng = np.random.default_rng(SEED + 7)
    ids = rng.integers(0, N_NODES, 2048)
    keys = ("sample", "readback", "host_stage", "gather", "model",
            "pass_split_wall", "pass_wall")
    out = {k: [] for k in keys}
    with torch.inference_mode():
        for _ in range(7):
            kw = server.draw_key_words()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            batch = server.sampler.sample(ids, key_words=kw)
            ev[1].record()
            ev[1].synchronize()
            t1 = time.perf_counter()
            n_id = batch.n_id.cpu().numpy()
            t2 = time.perf_counter()
            with feature._plock:
                plan = store.stage(feature.feature_order[n_id])
                t3 = time.perf_counter()
                ev[2].record()
                x = store.finish(plan)
            ev[3].record()
            y = server.model(x, batch.layers)
            ev[4].record()
            y.cpu()
            t4 = time.perf_counter()
            torch.cuda.synchronize()
            t5 = time.perf_counter()
            server.unfused_forward(ids, kw).cpu()
            out["pass_wall"].append((time.perf_counter() - t5) * 1e3)
            out["sample"].append(ev[0].elapsed_time(ev[1]))
            out["readback"].append((t2 - t1) * 1e3)
            out["host_stage"].append((t3 - t2) * 1e3)
            out["gather"].append(ev[2].elapsed_time(ev[3]))
            out["model"].append(ev[3].elapsed_time(ev[4]))
            out["pass_split_wall"].append((t4 - t0) * 1e3)
    return {k: float(np.median(v[2:])) for k, v in out.items()}


def host_profile(torch, run, top: int = 10) -> list:
    """``run()`` once warm, then once under cProfile: the functions with
    the most host time of their own.  cProfile slows Python calls, not the
    numpy and torch work inside them, so the shares lean towards
    Python-heavy functions."""
    import cProfile
    import pstats

    run()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    run()
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
    return [dict(fn=f"{f[0].rsplit('/', 1)[-1]}:{f[1]}:{f[2]}", calls=v[1],
                 own_ms=v[2] * 1e3, cum_ms=v[3] * 1e3) for f, v in rows]


# -- slice 3: GraphSAGE training at ogbn-products width ---------------------

def l2_fetch_granularity(torch, set_to=None) -> int:
    """``cudaLimitMaxL2FetchGranularity`` of the current device, in bytes,
    read through ``cudaDeviceGetLimit`` of the toolkit's ``libcudart``
    (after ``cudaDeviceSetLimit`` to ``set_to`` bytes where given): whether
    a 32-byte sector read fetches more.  The port never sets it."""
    from torch.utils.cpp_extension import CUDA_HOME

    libs = sorted(glob.glob(os.path.join(CUDA_HOME or "/usr/local/cuda",
                                         "lib64", "libcudart.so*")))
    check(libs, f"no libcudart under {CUDA_HOME}")
    cudart = ctypes.CDLL(libs[0])
    limit_max_l2_fetch_granularity = 0x05  # cudaLimit in driver_types.h
    if set_to is not None:
        rc = cudart.cudaDeviceSetLimit(limit_max_l2_fetch_granularity,
                                       ctypes.c_size_t(set_to))
        check(rc == 0, f"cudaDeviceSetLimit: CUDA error {rc}")
    value = ctypes.c_size_t()
    rc = cudart.cudaDeviceGetLimit(ctypes.byref(value),
                                   limit_max_l2_fetch_granularity)
    check(rc == 0, f"cudaDeviceGetLimit: CUDA error {rc}")
    return value.value


def cuda_ms_at_fetch(torch, fn, nbytes: int):
    """``cuda_ms(fn)`` with the L2 fetch granularity limit set to
    ``nbytes``, then restored; returns the time and the limit the card
    took."""
    before = l2_fetch_granularity(torch)
    try:
        took = l2_fetch_granularity(torch, nbytes)
        return cuda_ms(torch, fn), took
    finally:
        check(l2_fetch_granularity(torch, before) == before,
              "the L2 fetch granularity was not restored")


def products_data(qt):
    """The products graph (``synthetic_products``), 100-wide features made
    as ``examples/ogbn_products_sage.py``'s synthetic fallback makes them
    (a 47-column one-hot of a random label, then 53 columns of
    N(0, 0.5)), the labels and the train half of the nodes."""
    topo = qt.synthetic_products(SEED)
    n = topo.node_count
    rng = np.random.default_rng(SEED)
    labels = rng.integers(0, P_CLASSES, n).astype(np.int32)
    feat = np.empty((n, P_DIM), np.float32)
    feat[:, :P_CLASSES] = np.eye(P_CLASSES, dtype=np.float32)[labels]
    feat[:, P_CLASSES:] = rng.normal(0, 0.5, (n, P_DIM - P_CLASSES))
    train = rng.permutation(n)[: n // 2]
    return topo, feat, labels, train


def products_model(torch, qt):
    """GraphSAGE 100 -> 256 -> 256 -> 47, dropout 0.5, weights uniform in
    +-1/sqrt(fan_in) from a seeded generator, on the card."""
    model = qt.GraphSAGE(P_DIM, P_HIDDEN, P_CLASSES, num_layers=3,
                         dropout=0.5, device="cpu")
    g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for name, p in model.named_parameters():
            conv = model.convs[int(name.split(".")[1])]
            fan_in = (conv.lin_self if "lin_self" in name
                      else conv.lin_nbr).in_features
            bound = 1.0 / fan_in ** 0.5
            p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=g))
    return model.to(DEV)


def family_model(torch, qt, family: str):
    """GAT (GAT_HIDDEN x GAT_HEADS, 3 layers) or GCN (P_HIDDEN, 3 layers)
    for products, dropout 0.5, initialised on the CPU after
    ``torch.manual_seed(SEED)``, then moved to the card."""
    torch.manual_seed(SEED)
    if family == "GAT":
        model = qt.GAT(P_DIM, GAT_HIDDEN, P_CLASSES, num_layers=3,
                       heads=GAT_HEADS, dropout=0.5, device="cpu")
    else:
        model = qt.GCN(P_DIM, P_HIDDEN, P_CLASSES, num_layers=3, dropout=0.5,
                       device="cpu")
    return model.to(DEV)


# ``learns``: whether the lane must show a falling loss.  The synthetic
# products graph has uniform random neighbours (no homophily) and a node's
# label is readable only from its own features: GraphSAGE keeps them in a
# weight of their own, while GCN and GAT mix them with k random
# neighbours' at every layer (a share of about 1/(k+1) a layer), so their
# losses stay near ln(47) and are printed, not checked
SAGE_LANE = dict(family="GraphSAGE", model=products_model, fanouts=P_FANOUTS,
                 batch=P_BATCH, lr=P_LR, learns=True)
GAT_LANE = dict(family="GAT", fanouts=GAT_FANOUTS, batch=GAT_BATCH, lr=GAT_LR,
                model=lambda torch, qt: family_model(torch, qt, "GAT"),
                learns=False)
GCN_LANE = dict(family="GCN", fanouts=P_FANOUTS, batch=P_BATCH, lr=P_LR,
                model=lambda torch, qt: family_model(torch, qt, "GCN"),
                learns=False)


def frontier_sizes(B: int):
    """Frontier lengths of the positional pipeline: B, B(1+k1), ..."""
    out = [B]
    for k in P_FANOUTS:
        out.append(out[-1] * (1 + k))
    return out


def products_batch(torch, dev, train):
    """The products batch the kernel phases read: the first P_BATCH train
    seeds on ``dev`` and one key-word pair per hop."""
    kw = np.random.default_rng(SEED + 11).integers(
        0, 2**32, size=(len(P_FANOUTS), 2), dtype=np.uint32)
    return torch.from_numpy(train[:P_BATCH].astype(np.int32)).to(dev), kw


def products_hops(torch, ip, ix, train):
    """The element reads of each hop of one products batch (P_BATCH
    seeds, fanouts P_FANOUTS) as the fused lane makes them: per hop, the
    frontier ids at which ``indptr`` is read at ``s`` and ``s + 1``, and
    the draw positions at which ``indices`` is read."""
    from quiver_tpu_torch.ops.sample import (_hash_uniform,
                                             _stratified_positions)
    from quiver_tpu_torch.sampler import run_pipeline

    dev = ip.device
    seeds, kw = products_batch(torch, dev, train)
    sizes = frontier_sizes(P_BATCH)
    hops = []
    with torch.inference_mode():
        for h, k in enumerate(P_FANOUTS):
            if h == 0:
                n_id, fmask = seeds, torch.ones_like(seeds, dtype=torch.bool)
            else:
                n_id, fmask, _, _, _ = run_pipeline(
                    "none", ip, ix, seeds, kw[:h], P_FANOUTS[:h],
                    gather_mode="xla")
            check(n_id.shape[0] == sizes[h],
                  f"hop-{h + 1} frontier {n_id.shape[0]}")
            start = ip[n_id.long()]
            deg = torch.where(fmask, ip[n_id.long() + 1] - start,
                              torch.zeros_like(start))
            u = _hash_uniform(int(kw[h, 0]), int(kw[h, 1]),
                              (n_id.shape[0], k), device=dev)
            pos = (start[:, None] + _stratified_positions(u, deg, k))
            check(pos.numel() == sizes[h] * k,
                  f"hop-{h + 1} draws {pos.numel()}")
            hops.append((n_id.to(torch.int32).contiguous(),
                         pos.reshape(-1).to(torch.int32).contiguous()))
    return hops


def b1_products_phase(torch, topo, train, b1):
    """Kernel B1 at the three hops of the products batch that
    ``products_hops`` reads (frontiers of 1,024, 16,384 and 180,224 ids,
    fanouts 15, 10, 5), both entries against their plain versions; the
    frontier it builds must equal the ``"xla"`` pipeline's; then the
    ``"pwindow"`` pipeline's cost by depth.  Returns the cases and that
    cost."""
    from quiver_tpu_torch.sampler import run_pipeline

    dev = torch.device(DEV)
    ip, ix = topo.to_device(dev)
    seeds, kw = products_batch(torch, dev, train)
    cases, n_id, fmask = b1_hops(torch, b1, ip, ix, seeds, P_FANOUTS, kw,
                                 "products")
    want = run_pipeline("none", ip, ix, seeds, kw, P_FANOUTS,
                        gather_mode="xla")
    check(torch.equal(n_id, want[0]) and torch.equal(fmask, want[1]),
          "B1's products frontier differs from the xla pipeline's")
    cost = pwindow_pipeline_phase(torch, ip, ix, seeds, kw, P_FANOUTS,
                                  "products", b1)
    return cases, cost


LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy",
                "cudaMemset", "cuMemset")  # host calls that run a device op


def device_ops(torch, fn, tries: int = 3) -> tuple:
    """Names of the device operations (kernels, copies, fills) of one
    ``fn()`` under ``torch.profiler``, after a warm call, and the count of
    the host's runtime calls in that capture that start one (``LAUNCH_CALLS``;
    fewer device operations than these means the capture dropped device
    events).  A capture that holds no device event at all is taken again,
    up to ``tries`` times (the profiler on the card sometimes returns an
    empty capture); an empty list means not measured.  Each capture opens
    with ``prime_capture``, whose spins and their launches are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prime_capture(torch)
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        ops = [e.name for e in events
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation and not is_prime(e.name)]
        if ops:
            return ops, sum(e.device_type == DeviceType.CPU
                            and e.name.startswith(LAUNCH_CALLS)
                            for e in events) - PRIME_SPINS
    return [], 0


def pipeline_cost(torch, run_pipeline, ip, ix, seeds, kw, fanouts,
                  gather_mode="pwindow", complete=None,
                  tries: int = 1, sample_rng: str = "hash") -> list:
    """One ``run_pipeline`` call at each depth of ``fanouts`` (its first 1,
    2, ... hops): the host time to return (its launches, median of 15), the
    device span (CUDA events behind a spin kernel) and the device
    operations by name (none where the profiler saw none); each depth
    after the first also gets its hop's share, the difference from the
    depth before, where both were profiled.  ``complete(depth, by_name,
    n_ops, api_launches)`` judges a capture whole; a depth whose capture
    is not is profiled again, up to ``tries`` captures, and its row says
    how many it took (``captures``)."""
    rows = []
    for depth in range(1, len(fanouts) + 1):
        def fn():
            return run_pipeline("none", ip, ix, seeds, kw[:depth],
                                fanouts[:depth], gather_mode=gather_mode,
                                sample_rng=sample_rng)

        for capture in range(1, tries + 1):
            ops, api_launches = device_ops(torch, fn)
            by_name: dict = {}
            for name in ops:
                by_name[name[:90]] = by_name.get(name[:90], 0) + 1
            if complete is None or complete(depth, by_name, len(ops),
                                            api_launches):
                break
        row = dict(depth=depth, host_ms=host_ms(torch, fn),
                   device_ms=cuda_ms(torch, fn), device_ops=len(ops),
                   api_launches=api_launches, ops=by_name,
                   captures=capture)
        if rows:
            row["hop_host_ms"] = row["host_ms"] - rows[-1]["host_ms"]
        if rows and ops and rows[-1]["device_ops"]:
            row["hop_device_ops"] = len(ops) - rows[-1]["device_ops"]
            row["hop_ops"] = {n: c - rows[-1]["ops"].get(n, 0)
                              for n, c in by_name.items()
                              if c != rows[-1]["ops"].get(n, 0)}
        rows.append(row)
    return rows


def pwindow_pipeline_phase(torch, ip, ix, seeds, kw, fanouts, where, b1,
                           gather_mode: str = "pwindow",
                           sample_rng: str = "hash"):
    """The pipeline's cost per depth (``pipeline_cost``) under
    ``gather_mode`` and ``sample_rng`` (``"pwindow"`` under the hash, or
    ``"blocked"`` under the key: B1's pipeline entry either way); checks
    that it launches B1 once a hop and that each hop adds no device
    operation but B1's kernel: the hop's frontier, mask and local ids come
    from that launch alone."""
    from quiver_tpu_torch.sampler import run_pipeline

    mode = dict(gather_mode=gather_mode, sample_rng=sample_rng)
    before = b1.window_sample.launches
    run_pipeline("none", ip, ix, seeds, kw, fanouts, **mode)
    check(b1.window_sample.launches - before == len(fanouts),
          f"{where}: the {gather_mode} pipeline launched B1 "
          f"{b1.window_sample.launches - before} times for "
          f"{len(fanouts)} hops")
    # the profiler on the card sometimes drops a device event from a
    # capture (PERF.md): a depth's capture that holds fewer B1 kernels than
    # the counter says that depth launched, or fewer device operations than
    # the host's runtime calls that start one, is taken again, up to eight
    # captures a depth; a hop's added operations are compared by name
    # between two whole captures, and by the host's calls otherwise
    launched = []
    for depth in range(1, len(fanouts) + 1):
        before = b1.window_sample.launches
        run_pipeline("none", ip, ix, seeds, kw[:depth], fanouts[:depth],
                     **mode)
        launched.append(b1.window_sample.launches - before)

    def b1_in(row):
        return sum(c for n, c in row["ops"].items()
                   if "window_sample_kernel" in n)

    def whole(depth, by_name, n_ops, api_launches):
        return n_ops >= api_launches and b1_in({"ops": by_name}) >= \
            launched[depth - 1]

    rows = pipeline_cost(torch, run_pipeline, ip, ix, seeds, kw, fanouts,
                         complete=whole, tries=8, **mode)
    print(f"{where} {gather_mode} pipeline, cost by depth "
          + json.dumps(dict(fanouts=list(fanouts), B=int(seeds.shape[0]),
                            rows=rows, **mode)), flush=True)
    hprof = host_profile(torch, lambda: run_pipeline(
        "none", ip, ix, seeds, kw, fanouts, **mode))
    print(f"{where} {gather_mode} pipeline on the host (cProfile, own "
          "time) " + json.dumps(hprof), flush=True)
    check(rows[0]["device_ops"] and rows[-1]["device_ops"],
          f"{where}: the profiler saw no device operation")

    def whole_row(row):
        return row["device_ops"] >= row["api_launches"]

    for i, (row, n) in enumerate(zip(rows, launched)):
        check(n == row["depth"], f"{where}: {n} B1 launches at depth "
              f"{row['depth']}")
        if not row["device_ops"]:
            continue
        # the launch counter holds B1 to one launch a hop exactly; a
        # capture still short of it after eight is held to at least one
        check(1 <= b1_in(row) <= n and (b1_in(row) == n or not whole_row(
            row)), f"{where}: {b1_in(row)} B1 kernels in the profile of "
            f"{row['depth']} hops")
        if i and rows[i - 1]["device_ops"]:
            # the host's calls that start a device operation are never
            # dropped: a hop makes exactly one, and the profile's B1 count
            # says it is B1's launch
            calls = row["api_launches"] - rows[i - 1]["api_launches"]
            check(calls == 1, f"{where}: hop {row['depth']} made {calls} "
                  "calls that start a device operation")
        if "hop_device_ops" in row and whole_row(row) and whole_row(
                rows[i - 1]):
            check(row["hop_device_ops"] == 1 and all(
                "window_sample_kernel" in n for n in row["hop_ops"]),
                f"{where}: hop {row['depth']} added {row['hop_ops']}")
    # the deepest pipeline's other operations are the first depth's
    if whole_row(rows[0]) and whole_row(rows[-1]):
        others = [{n: c for n, c in r["ops"].items()
                   if "window_sample_kernel" not in n} for r in (rows[0],
                                                                 rows[-1])]
        check(others[0] == others[1], f"{where}: the operations besides "
              f"B1 grew with depth: {others}")
    return rows


def b3_b4_phase(torch, qt, topo, train, b3, b4):
    """Kernels B3 and B4 against their plain versions at the shapes of
    the last hop of one products batch: B3's pair read of ``indptr`` at
    the 180,224-long hop-3 frontier and its read of ``indices`` at the
    901,120 draws; B4's fused entry at the three reads ``"lanes_fused"``
    makes (``indptr`` at ``s`` and ``s + 1``, ``indices``), beside the
    earlier two-step form (``index_select`` rows, then the literal B4).
    Times kernel, plain version and library call.  Returns the two kernel
    records (times summed over a hop's reads)."""
    from quiver_tpu_torch.ops import fastgather

    dev = torch.device(DEV)
    ip, ix = topo.to_device(dev)
    ip2d, ix2d = ip.view(-1, 128), ix.view(-1, 128)
    hops = products_hops(torch, ip, ix, train)

    def bound_ms(nbytes):
        return nbytes / HBM_BYTES_PER_S * 1e3

    def err(a, b):
        return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0

    # B3: the pair read and the single read, as the fused lane's hop 3
    n_id, pos = hops[-1]
    m1, m2 = n_id.shape[0], pos.shape[0]
    lo, hi = b3.element_gather_pair(ip2d, n_id)
    got = b3.element_gather(ix2d, pos)
    want_lo, want_hi = b3.element_gather_pair_plain(ip2d, n_id)
    want = b3.element_gather_plain(ix2d, pos)
    torch.cuda.synchronize()
    pair_ids = torch.stack([n_id.long(), n_id.long() + 1]).clamp(
        0, ip.shape[0] - 1)  # the library call's input, made untimed
    pos64 = pos.long().clamp(0, ix.shape[0] - 1)
    check(torch.equal(lo, want_lo) and torch.equal(hi, want_hi),
          "B3 pair read differs from the plain version")
    check(torch.equal(torch.stack([lo, hi]), ip[pair_ids]),
          "B3 pair read differs from the table")
    check(torch.equal(got, want), "B3 indices read differs from the plain "
          "version")
    check(torch.equal(got, ix[pos64]), "B3 indices read differs from the "
          "table")
    b3_cases = [
        dict(shape=f"indptr pair: M={m1}",
             max_abs_err=max(err(lo, want_lo), err(hi, want_hi)),
             ms=cuda_ms(torch, lambda: b3.element_gather_pair(ip2d, n_id)),
             host_ms=host_ms(torch, lambda: b3.element_gather_pair(ip2d,
                                                                   n_id)),
             plain_ms=cuda_ms(torch, lambda: b3.element_gather_pair_plain(
                 ip2d, n_id)),
             library_ms=cuda_ms(torch, lambda: torch.take(ip, pair_ids)),
             # the sectors s and s + 1 touch, ids read once, two outputs
             bound_ms=bound_ms(sector_bytes(torch, pair_ids) + m1 * 12)),
        dict(shape=f"indices: M={m2}", max_abs_err=err(got, want),
             ms=cuda_ms(torch, lambda: b3.element_gather(ix2d, pos)),
             host_ms=host_ms(torch, lambda: b3.element_gather(ix2d, pos)),
             plain_ms=cuda_ms(torch, lambda: b3.element_gather_plain(ix2d,
                                                                     pos)),
             library_ms=cuda_ms(torch, lambda: torch.take(ix, pos64)),
             bound_ms=bound_ms(sector_bytes(torch, pos64) + m2 * 8)),
    ]
    for c in b3_cases:
        print(f"element_gather {c['shape']}: exact; {json.dumps(c)}",
              flush=True)
    del lo, hi, got, want, want_lo, want_hi

    # B4: the fused entry at the reads "lanes_fused" makes, beside the
    # two-step form and the literal entry alone
    reads = [("indptr start", ip2d, n_id), ("indptr end", ip2d, n_id + 1),
             ("indices", ix2d, pos)]
    b4_cases = []
    clamped = []
    for name, t2d, idx in reads:
        idx = idx.to(torch.int32).clamp(0, t2d.numel() - 1)  # as _gather
        clamped.append(idx)
        m = idx.shape[0]
        row, lane = idx >> 7, idx & 127
        got = b4.lane_select_rows(t2d, row, lane)
        want = b4.lane_select_plain(t2d.index_select(0, row), lane)
        rows = t2d.index_select(0, row)
        literal = b4.lane_select(rows, lane)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"B4 {name} differs from the plain "
              "version")
        check(torch.equal(literal, want), f"B4 literal {name} differs from "
              "the plain version")
        check(torch.equal(got, t2d.reshape(-1)[idx.long()]),
              f"B4 {name} differs from the table")
        idx64, lanes64 = idx.long(), lane.long()[:, None]
        b4_cases.append(dict(
            shape=f"{name}: M={m}", max_abs_err=max(err(got, want),
                                                    err(literal, want)),
            ms=cuda_ms(torch, lambda: b4.lane_select_rows(t2d, row, lane)),
            host_ms=host_ms(torch, lambda: b4.lane_select_rows(t2d, row,
                                                               lane)),
            plain_ms=cuda_ms(torch, lambda: b4.lane_select_plain(
                t2d.index_select(0, row), lane)),
            library_ms=cuda_ms(torch, lambda: torch.take(t2d, idx64)),
            # the distinct sectors read, row and lane ids, the output
            bound_ms=bound_ms(sector_bytes(torch, idx) + m * 12),
            two_step_ms=cuda_ms(torch, lambda: b4.lane_select(
                t2d.index_select(0, row), lane)),
            row_gather_ms=cuda_ms(torch, lambda: t2d.index_select(0, row)),
            literal_ms=cuda_ms(torch, lambda: b4.lane_select(rows, lane)),
            literal_library_ms=cuda_ms(
                torch, lambda: torch.gather(rows, 1, lanes64)),
            rows_bytes=rows.numel() * rows.element_size()))
        print(f"lane_select {name}: exact; {json.dumps(b4_cases[-1])}",
              flush=True)
        del got, want, rows, literal, idx64, lanes64

    # fastgather.element_gather(fused=True) allocates no [M, 128] rows
    idx = clamped[2]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = fastgather.element_gather(ix2d, idx, fused=True)
    torch.cuda.synchronize()
    fused_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rows = ix2d.index_select(0, idx >> 7)
    two_step = b4.lane_select(rows, idx & 127)
    del rows
    torch.cuda.synchronize()
    two_step_peak = torch.cuda.max_memory_allocated() - base
    check(torch.equal(got, two_step), "fused and two-step B4 differ")
    check(fused_peak < idx.shape[0] * 512 / 16,
          f"element_gather(fused=True) peaked at {fused_peak} B")
    memory = dict(m=idx.shape[0], fused_peak_bytes=fused_peak,
                  two_step_peak_bytes=two_step_peak)
    print("B4 hop-3 indices read, peak device memory " + json.dumps(memory),
          flush=True)

    def total(cs, key):
        return float(sum(c[key] for c in cs))

    # B4's bound: the hop's three reads together read each sector they
    # touch once (the two indptr reads share most of theirs)
    b4_bound = bound_ms(sector_bytes(torch, clamped[0], clamped[1])
                        + sector_bytes(torch, clamped[2])
                        + sum(c.shape[0] for c in clamped) * 12)
    b3_record = dict(
        name="element_gather", route="cuda", source=b3.SOURCE,
        replaces=b3.REPLACES,
        max_abs_err=max(c["max_abs_err"] for c in b3_cases),
        ms=total(b3_cases, "ms"), plain_ms=total(b3_cases, "plain_ms"),
        bound_ms=total(b3_cases, "bound_ms"), bound_by="bytes",
        library_ms=total(b3_cases, "library_ms"),
        host_ms=total(b3_cases, "host_ms"), cases=b3_cases)
    b4_record = dict(
        name="lane_select", route="cuda", source=b4.SOURCE,
        replaces=b4.REPLACES,
        max_abs_err=max(c["max_abs_err"] for c in b4_cases),
        ms=total(b4_cases, "ms"), plain_ms=total(b4_cases, "plain_ms"),
        bound_ms=b4_bound, bound_by="bytes",
        library_ms=total(b4_cases, "library_ms"),
        host_ms=total(b4_cases, "host_ms"),
        two_step_ms=total(b4_cases, "two_step_ms"),
        literal_ms=total(b4_cases, "literal_ms"),
        literal_library_ms=total(b4_cases, "literal_library_ms"),
        memory=memory, cases=b4_cases)
    check(b4_record["ms"] < b4_record["two_step_ms"],
          "fused B4 is not faster than index_select and the literal B4")
    return b3_record, b4_record


def batches(torch, train, labels_d, n: int, seed: int, size: int = P_BATCH):
    """``n`` batches of ``size`` shuffled train seeds and their labels, on
    the card."""
    order = np.random.default_rng(seed).permutation(train)
    for i in range(n):
        s = torch.from_numpy(order[i * size:(i + 1) * size]
                             .astype(np.int32)).to(DEV)
        yield s, labels_d[s.long()]


def fused_step_split(torch, qt, sampler, feature, model, opt, seeds, labels,
                     mask) -> dict:
    """One fused step's stages by CUDA events (median of 5 after 2 warm):
    sampling, lookup, forward and loss, backward, optimizer."""
    from quiver_tpu_torch.parallel.train import masked_cross_entropy

    keys = ("sample", "lookup", "forward", "backward", "optimizer")
    out = {k: [] for k in keys}
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    model.train()
    for _ in range(7):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        kw = sampler.draw_key_words()
        ev[0].record()
        n_id, _, _, blocks, _ = sampler.pipeline(seeds, kw, weighted=False)
        ev[1].record()
        x = feature.lookup_device(n_id)
        ev[2].record()
        opt.zero_grad(set_to_none=True)
        loss = masked_cross_entropy(model(x, blocks, generator=gen), labels,
                                    mask)
        ev[3].record()
        loss.backward()
        ev[4].record()
        opt.step()
        ev[5].record()
        ev[5].synchronize()
        for i, k in enumerate(keys):
            out[k].append(ev[i].elapsed_time(ev[i + 1]))
    return {k: float(np.median(v[2:])) for k, v in out.items()}


def fused_lane(torch, qt, topo, feature, labels_d, train, mode, steps,
               counters, per_step, dedup="none", spec=None):
    """One lane of ``make_fused_train_step`` over the whole-table
    ``feature``: a sampler in ``gather_mode=mode``, a seeded model and
    Adam (``spec``: the model family, its fanouts, batch and rate;
    GraphSAGE's lane when ``None``), ``steps`` steps on the first batches
    of one shuffle (the loss must fall where ``spec["learns"]``; each
    kernel of ``counters`` must launch ``per_step[name]`` times a step).
    Then the step split, one step under the profiler, and one batch
    through ``make_fused_eval_fn``.  The profile counts B1's kernels and
    the sort, searchsorted and scatter kernels (the reindex's largest, not
    all of its operations) and their share of the step; under
    ``dedup="hop"`` the launch counter and the profile must both show B1
    once a hop in every profiled step.
    Returns the launches, a summary, and what the CPU check needs: the
    model, the eval ids and words, and the card's logits."""
    spec = spec or SAGE_LANE
    fanouts, size = spec["fanouts"], spec["batch"]
    lane = repr(mode) if dedup == "none" else f"{mode!r} dedup={dedup!r}"
    if spec is not SAGE_LANE:
        lane = f"{spec['family']} {lane}"
    t0 = time.perf_counter()
    sampler = qt.GraphSageSampler(topo, fanouts, device=DEV, seed=SEED,
                                  gather_mode=mode, dedup=dedup)
    model = spec["model"](torch, qt)
    opt = torch.optim.Adam(model.parameters(), lr=spec["lr"])
    step = qt.make_fused_train_step(sampler, feature, model, opt, seed=SEED)
    ones = torch.ones((size,), dtype=torch.bool, device=DEV)
    torch.cuda.synchronize()
    print(f"fused lane {lane}: {feature!r}, {sampler!r}; set up in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    losses, wall, dev_ms = [], [], []
    for seeds, lab in batches(torch, train, labels_d, steps, SEED + 12,
                              size):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        losses.append(step(seeds, lab, ones))
        b.record()
        b.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(a.elapsed_time(b))
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = torch.stack(losses).cpu().numpy()
    check(np.isfinite(losses).all(), f"a {lane} step loss is not finite")
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    if spec["learns"]:
        check(last < first,
              f"the {lane} loss did not fall: {first} -> {last}")
    # the step replays the model's kernels from CUDA graphs: the host
    # launches them in the capture's warm-up pass and in the capture
    # itself, not in a replay; every batch has one shape, so the first
    # call captures and no call runs eagerly
    captures, eager = step.train.captures, step.train.eager_calls
    check((captures, eager) == (1, 0), f"{lane}: {captures} captures and "
          f"{eager} eager calls in {steps} steps of one shape")
    passes = 2 * captures + eager
    for name, n in launches.items():
        k = passes if name.startswith("sage_") else steps
        check(n == per_step[name] * k, f"{lane}: {name} launched {n} "
              f"times in {k} passes of {steps} steps, not "
              f"{per_step[name]} a pass")
    summary = dict(family=spec["family"], fanouts=fanouts, batch=size,
                   lr=spec["lr"], gather_mode=mode, dedup=dedup, steps=steps,
                   losses=losses.tolist(), loss_first5_mean=first,
                   loss_last5_mean=last,
                   step_wall_ms=float(np.median(wall[2:])),
                   step_event_ms=float(np.median(dev_ms[2:])),
                   launches=launches, peak_gib=peak_gib,
                   captures=captures, eager_calls=eager)
    print(f"fused training {lane} " + json.dumps(summary), flush=True)
    if spec is SAGE_LANE and dedup == "none" and mode == "auto":
        summary["checkpoint"] = checkpoint_check(torch, qt, sampler, feature,
                                                 model, opt, train, labels_d,
                                                 steps, spec)

    # the step split and one step under the profiler
    seeds, lab = next(batches(torch, train, labels_d, 1, SEED + 13, size))
    split = fused_step_split(torch, qt, sampler, feature, model, opt, seeds,
                             lab, ones)
    print(f"fused step split {lane} (CUDA events, ms, median of 5) "
          + json.dumps(split), flush=True)
    runs = [0]

    def profiled_step():
        runs[0] += 1
        step(seeds, lab, ones)

    b1_fn = counters.get("window_sample")
    b1_before = b1_fn.launches if b1_fn is not None else 0
    mean_before = {k: counters[k].launches for k in SAGE_KERNELS}
    prof = device_profile(torch, profiled_step, summary["step_wall_ms"],
                          top=12, families=KERNEL_FAMILIES)
    if spec is SAGE_LANE:
        # the replayed step runs the hand-written mean, activation and
        # fused kernels per_step times, though the host launches none: the
        # profile must count each kernel so (taken up to 8 times, since
        # the card's profiler drops device events from some captures),
        # and ReLU's threshold_backward, which the activation's backward
        # replaced, not at all
        for _ in range(7):
            if all(family_count(prof, k) == per_step[k]
                   for k in SAGE_KERNELS):
                break
            prof = device_profile(torch, profiled_step,
                                  summary["step_wall_ms"], top=12,
                                  families=KERNEL_FAMILIES)
        for k in SAGE_KERNELS:
            host = counters[k].launches - mean_before[k]
            check(host == 0, f"{lane}: the host launched {k} {host} times "
                  f"in {runs[0]} replayed steps")
            check(family_count(prof, k) == per_step[k], f"{lane}: "
                  f"{family_count(prof, k)} {k} kernels in the profile of "
                  f"one replayed step, not {per_step[k]}")
        thr = family_count(prof, "threshold_backward")
        check(thr == 0, f"{lane}: {thr} threshold_backward kernels in the "
              "profile of one replayed step")
    if dedup == "hop":
        # the launch counter holds B1 to exactly once a hop in every run
        # of the step, the profiled ones too; the profile must show B1 on
        # the card, but the card's profiler drops device events from some
        # captures (PERF.md §7), so a capture is taken up to 8 times for
        # the full count and then held to between one and a hop's count,
        # as the R-GAT step's is
        n_b1 = per_step["window_sample"]
        for _ in range(7):
            if family_count(prof, "B1") >= n_b1:
                break
            prof = device_profile(torch, profiled_step,
                                  summary["step_wall_ms"], top=12,
                                  families=KERNEL_FAMILIES)
        b1_ops = family_count(prof, "B1")
        ran = b1_fn.launches - b1_before
        check(ran == n_b1 * runs[0], f"{lane}: B1 launched {ran} times in "
              f"{runs[0]} profiled steps, not {n_b1} a step")
        check(1 <= b1_ops <= n_b1, f"{lane}: {b1_ops} B1 kernels in the "
              "profile of one step")
    print(f"fused step {lane} on the card (torch.profiler) "
          + json.dumps(prof), flush=True)
    summary.update(split_ms=split, device_profile=prof)

    ids = train[-size:]
    kw = sampler.draw_key_words()
    y_card = qt.make_fused_eval_fn(sampler, feature, model)(ids, kw).cpu()
    return launches, summary, (model, ids, kw, y_card)


def checkpoint_check(torch, qt, sampler, feature, model, opt, train,
                     labels_d, steps: int, spec) -> dict:
    """Slice 10's checkpoint on the card: ``save_checkpoint`` of the
    trained model and its Adam state into ``build/chip_smoke_ckpt``, a
    fresh seeded model and optimizer restored from it with
    ``load_checkpoint``, then one more fused step from each on the same
    batch, key words and dropout seed: the losses must be equal bit for
    bit."""
    import shutil

    from quiver_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                   load_checkpoint,
                                                   save_checkpoint)

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    path = save_checkpoint(root, qt.TrainState(model, opt), steps,
                           extra={"lane": spec["family"]})
    save_s = time.perf_counter() - t0
    fresh = spec["model"](torch, qt)
    fresh_opt = torch.optim.Adam(fresh.parameters(), lr=spec["lr"])
    t0 = time.perf_counter()
    _, step = load_checkpoint(root, qt.TrainState(fresh, fresh_opt))
    load_s = time.perf_counter() - t0
    check(latest_checkpoint(root) == path and step == steps,
          f"checkpoint resolved {latest_checkpoint(root)} at step {step}")
    seeds, lab = next(batches(torch, train, labels_d, 1, SEED + 14,
                              spec["batch"]))
    ones = torch.ones((spec["batch"],), dtype=torch.bool, device=DEV)
    kw = sampler.draw_key_words()
    losses = [qt.make_fused_train_step(sampler, feature, m, o,
                                       seed=SEED + 15)(seeds, lab, ones, kw)
              for m, o in ((model, opt), (fresh, fresh_opt))]
    check(torch.equal(losses[0], losses[1]),
          f"the restored model's next loss {float(losses[1])!r} differs "
          f"from the original's {float(losses[0])!r}")
    out = dict(path=os.path.relpath(path, os.path.dirname(root)),
               bytes=os.path.getsize(path), save_s=save_s, load_s=load_s,
               next_loss=float(losses[0]), bitwise_equal=True)
    shutil.rmtree(root, ignore_errors=True)
    print("checkpoint round trip " + json.dumps(out), flush=True)
    return out


def hop_caps(batch_size: int, sizes) -> list:
    """``bench.py``'s frontier caps for ``dedup="hop"``: half of each
    hop's bound without dedup, at least ``batch_size + 1``."""
    p, caps = batch_size, []
    for k in sizes:
        p *= 1 + k
        caps.append(max(batch_size + 1, p // 2))
    return caps


def check_same_sample(torch, got, want, what: str):
    """Two ``run_pipeline`` results, bit for bit: ``n_id``, its mask,
    ``num_nodes``, every block's ``nbr_local``, ``mask`` and
    ``num_targets``, and ``drops``."""
    for name, a, b in zip(("n_id", "n_id_mask", "num_nodes"), got[:3],
                          want[:3]):
        check(torch.equal(a, b), f"{what}: {name} differs")
    check(len(got[3]) == len(want[3]), f"{what}: block counts differ")
    for i, (a, b) in enumerate(zip(got[3], want[3])):
        for name in ("nbr_local", "mask", "num_targets"):
            check(torch.equal(getattr(a, name), getattr(b, name)),
                  f"{what}: block {i} {name} differs")
    check(torch.equal(got[4], want[4]), f"{what}: drops differ")


def hop_batch_phase(torch, qt, topo, seeds, b1) -> dict:
    """Step 1's sampled batch of the ``dedup="hop"`` lane (its seeds and
    the first words of a sampler seeded as the lane's is), under
    ``"auto"`` (B1's literal entry once a hop), against the ``"xla"``
    pipeline on the card, bit for bit; padded frontiers 1,024, 16,384,
    180,224 and 1,081,344.  Then one sampling call under ``bench.py``'s
    ``hop_caps``, whose first hop must drop nodes, against ``"xla"`` with
    the same caps."""
    from quiver_tpu_torch.sampler import run_pipeline

    ip, ix = topo.to_device(DEV)
    sampler = qt.GraphSageSampler(topo, P_FANOUTS, device=DEV, seed=SEED,
                                  dedup="hop")
    kw = sampler.draw_key_words()
    before = b1.window_sample.launches
    got = sampler.pipeline(seeds, kw)
    torch.cuda.synchronize()
    check(b1.window_sample.launches - before == len(P_FANOUTS),
          "the hop pipeline did not launch B1 once a hop")
    want = run_pipeline("hop", ip, ix, seeds, kw, P_FANOUTS,
                        gather_mode="xla")
    check_same_sample(torch, got, want, "products hop step 1 vs xla")
    padded = [int(b.nbr_local.shape[0]) for b in got[3][::-1]]
    padded.append(int(got[0].shape[0]))
    check(padded == frontier_sizes(P_BATCH), f"hop frontiers {padded}")
    out = dict(padded=padded, valid=[int(b.num_targets) for b in
                                     got[3][::-1]] + [int(got[2])])

    caps = hop_caps(P_BATCH, P_FANOUTS)
    capped = qt.GraphSageSampler(topo, P_FANOUTS, device=DEV, dedup="hop",
                                 frontier_caps=caps)
    before = feature_counters(qt)
    batch = capped.sample(seeds, key_words=kw)
    drops = capped.overflow_stats()
    check(drops[0] > 0, f"hop 1 dropped no node under caps {caps}")
    want = run_pipeline("hop", ip, ix, seeds, kw, P_FANOUTS, caps,
                        gather_mode="xla")
    check_same_sample(torch, (batch.n_id, batch.n_id_mask, batch.num_nodes,
                              batch.layers, batch.drops), want,
                      "capped products hop vs xla")
    out.update(caps=caps, drops=drops.tolist(),
               drops_counter=counters_added(qt, before).get(
                   "sampler_frontier_drops_total{mode=gpu}", 0.0),
               capped_num_nodes=int(batch.num_nodes))
    print("products hop batch: equal to xla, bit for bit "
          + json.dumps(out), flush=True)
    return out


def blocked_phase(torch, where: str, run, b3, b3_per_call: int) -> dict:
    """``run(mode)`` (one ``run_pipeline`` call) under BLOCKED_MODE against
    ``"xla"``, bit for bit, with B3 launched ``b3_per_call`` times (every
    read of the mode is B3's); then each of BLOCKED_MODE, ``"auto"`` and
    ``"xla"``: its sample span (CUDA events behind a spin kernel, median
    of 5; the host's launches show in it when they outlast the spin), the
    host time to return (``host_ms``), the device time of its operations
    (``torch.profiler``) and the device memory it allocates above what was
    allocated before it (peak)."""
    before = b3.element_gather.launches
    got = run(BLOCKED_MODE)
    n = b3.element_gather.launches - before
    check(n == b3_per_call, f"{where} {BLOCKED_MODE}: B3 launched {n} "
          f"times, not {b3_per_call}")
    check_same_sample(torch, got, run("xla"),
                      f"{where} {BLOCKED_MODE} vs xla")
    out = {}
    for mode in (BLOCKED_MODE, "auto", "xla"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run(mode)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        span = cuda_ms(torch, lambda: run(mode), reps=5, warm=1)
        prof = device_profile(torch, lambda: run(mode), span, top=3)
        out[mode] = dict(span_ms=span,
                         host_ms=host_ms(torch, lambda: run(mode), reps=5),
                         device_ms=prof["device_ms"],
                         device_ops=prof.get("ops"),
                         peak_extra_gib=peak / 2**30)
    print(f"{where} pipeline under {BLOCKED_MODE}: equal to xla, bit for "
          "bit " + json.dumps(out), flush=True)
    return out


def fused_training_phase(torch, qt, topo, feat, labels, train, b1, b2, b3):
    """The fused lane, the whole table on the card, B2 for the lookup, in
    three lanes (``fused_lane``): ``"pallas"`` (B3 for every element
    gather, twice a hop) for FUSED_STEPS steps; ``"auto"``, the example's
    default, which is ``"pwindow"`` (B1 once a hop, B3 never), for
    AUTO_STEPS steps; and ``"auto"`` under ``dedup="hop"`` with no caps
    (B1's literal entry once a hop, then the reindex) for AUTO_STEPS
    steps, with ``hop_batch_phase``; then GAT and GCN (slice 7) under
    ``"auto"`` for FAMILY_STEPS steps each (GAT_LANE, GCN_LANE).  Then each
    lane's eval batch against the plain versions on the CPU within
    CPU_TOL.  Returns each lane's launches and summary, and its trained
    model, by lane, B2's products record and SAGE's kernels' records
    (``sage_mean_records``, ``sage_act_records``)."""
    t0 = time.perf_counter()
    feature = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                         device=DEV).from_cpu_tensor(feat)
    check(feature.cache_count == topo.node_count, "the table is not whole")
    labels_d = torch.from_numpy(labels).to(DEV)
    print(f"whole products table on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    b2_products = b2_products_case(torch, topo, feature, train, b2)
    from quiver_tpu_torch.ops.cuda import sage_act as sa
    from quiver_tpu_torch.ops.cuda import sage_act_mean as sam
    from quiver_tpu_torch.ops.cuda import sage_mean as sm

    sage_records = (sage_mean_records(torch, topo, feature, train, sm)
                    + sage_act_records(torch, sa)
                    + sage_act_mean_records(torch, sam, sa, sm))
    counters = {"window_sample": b1.window_sample,
                "element_gather": b3.element_gather,
                "gather_rows": b2.gather_rows,
                "sage_mean": sm.sage_mean,
                "sage_mean_backward": sm.sage_mean_backward,
                "sage_act": sa.sage_act,
                "sage_act_backward": sa.sage_act_backward,
                "sage_act_mean": sam.sage_act_mean,
                "sage_act_mean_backward": sam.sage_act_mean_backward}
    n_hops = len(P_FANOUTS)
    # SAGE under dedup="hop": the mean kernel once a layer, its backward
    # at every layer but the first (B2's rows take no gradient), the
    # activation kernels at each hidden layer (dropout 0.5); under
    # dedup="none" (positional blocks) the mean at layer 0 alone and each
    # hidden layer's activation fused with the next layer's mean; GAT and
    # GCN launch none
    sage = dict(sage_mean=n_hops, sage_mean_backward=n_hops - 1,
                sage_act=n_hops - 1, sage_act_backward=n_hops - 1,
                sage_act_mean=0, sage_act_mean_backward=0)
    fused = dict(sage_mean=1, sage_mean_backward=0, sage_act=0,
                 sage_act_backward=0, sage_act_mean=n_hops - 1,
                 sage_act_mean_backward=n_hops - 1)
    other = dict.fromkeys(SAGE_KERNELS, 0)
    b1_lane = dict(window_sample=n_hops, element_gather=0, gather_rows=1)
    lanes = {}
    for label, mode, dedup, steps, per_step, spec in (
            ("pallas", "pallas", "none", FUSED_STEPS,
             dict(window_sample=0, element_gather=2 * n_hops,
                  gather_rows=1, **fused), None),
            ("auto", "auto", "none", AUTO_STEPS, dict(b1_lane, **fused),
             None),
            ("auto hop", "auto", "hop", AUTO_STEPS, dict(b1_lane, **sage),
             None),
            # slice 7: GAT and GCN through the same fused step
            ("gat", "auto", "none", FAMILY_STEPS, dict(
                b1_lane, window_sample=len(GAT_LANE["fanouts"]), **other),
             GAT_LANE),
            ("gcn", "auto", "none", FAMILY_STEPS, dict(b1_lane, **other),
             GCN_LANE)):
        lanes[label] = fused_lane(torch, qt, topo, feature, labels_d, train,
                                  mode, steps, counters, per_step, dedup,
                                  spec)
    seeds, _ = next(batches(torch, train, labels_d, 1, SEED + 12))
    hop_checks = hop_batch_phase(torch, qt, topo, seeds, b1)
    del feature
    torch.cuda.empty_cache()

    # each lane's eval batch through the plain versions on the CPU, with
    # the same words
    feature_cpu = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                             device="cpu").from_cpu_tensor(feat)
    out, models = {}, {}
    for label, (launches, summary, (model, ids, kw, y_card)) in lanes.items():
        mode = summary["gather_mode"]
        t0 = time.perf_counter()
        sampler_cpu = qt.GraphSageSampler(topo, summary["fanouts"],
                                          device="cpu", gather_mode=mode,
                                          dedup=summary["dedup"])
        y_cpu = qt.make_fused_eval_fn(sampler_cpu, feature_cpu,
                                      copy.deepcopy(model).cpu())(ids, kw)
        err = float((y_card - y_cpu).abs().max())
        check(y_card.shape == (summary["batch"], P_CLASSES) and
              bool(torch.isfinite(y_card).all()), f"{label!r} eval logits")
        check(torch.allclose(y_card, y_cpu, **CPU_TOL),
              f"{label!r}: card eval logits differ from the CPU's by {err}")
        print(f"fused eval batch {label!r} against the CPU's plain versions: "
              f"logits max abs err {err:.3e} (CPU pass "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
        summary["eval_logits_max_abs_err"] = err
        out[label] = (launches, summary)
        models[label] = model
    out["auto hop"][1]["batch_checks"] = hop_checks
    return out, models, b2_products, sage_records


def b2_products_case(torch, topo, feature, train, b2) -> dict:
    """B2 at the fused step's lookup: the frontier of the products batch
    (1,081,344 ids, the ``"pwindow"`` pipeline's) through the 100-wide
    table's row order, as ``lookup_device`` calls it (``b2_case``)."""
    from quiver_tpu_torch.sampler import run_pipeline

    dev = torch.device(DEV)
    ip, ix = topo.to_device(dev)
    seeds, kw = products_batch(torch, dev, train)
    with torch.inference_mode():
        n_id = run_pipeline("none", ip, ix, seeds, kw, P_FANOUTS,
                            gather_mode="pwindow")[0]
    check(n_id.shape[0] == frontier_sizes(P_BATCH)[-1],
          f"products frontier {n_id.shape[0]}")
    return b2_case(torch, b2, "products", feature.hot, n_id,
                   feature._order_dev)


def sage_mean_records(torch, topo, feature, train, sm) -> list:
    """SAGEConv's neighbour mean at the fused step's three layers: the
    products batch's blocks (the ``"pwindow"`` pipeline's layout and
    padding), layer 0 over the batch's looked-up 100-wide rows, layers 1
    and 2 over seeded 256-wide rows.  Each kernel bitwise its plain version;
    timed beside its bound (valid rows, indices and masks read once, the
    output written once; the backward writes ``[N, D]`` once and reads the
    mean's and the self rows' gradients), the plain version and the library
    chain it replaced: ``index_select``, the broadcast mask, ``sum`` and the
    divide forward; autograd's backward of that chain and of the self
    rows' slice (two zero-filled ``[N, D]``, the ``index_add``, their sum)
    for the backward, and ``index_add`` alone beside it.  Layer 0's input
    takes no gradient in the step, so the backward runs at layers 1 and
    2.  Returns the forward's and the backward's kernel records."""
    from quiver_tpu_torch.sampler import run_pipeline

    dev = torch.device(DEV)
    ip, ix = topo.to_device(dev)
    seeds, kw = products_batch(torch, dev, train)
    with torch.no_grad():  # the blocks and rows feed autograd below
        n_id, _, _, blocks, _ = run_pipeline("none", ip, ix, seeds, kw,
                                             P_FANOUTS, gather_mode="pwindow")
        x0 = feature.lookup_device(n_id)
    g = torch.Generator(device=dev).manual_seed(SEED)

    def chain(x, nbr, mask):
        t, k = nbr.shape
        x_src = x.index_select(0, nbr.reshape(-1)).reshape(t, k, x.shape[1])
        m = mask[..., None].to(x.dtype)
        return (x_src * m).sum(dim=1) / torch.clamp_min(m.sum(dim=1), 1.0)

    fwd, bwd = [], []
    for layer, blk in enumerate(blocks):
        nbr, mask = blk.nbr_local, blk.mask
        t, k = nbr.shape
        x = x0 if layer == 0 else torch.randn(
            (t + t * k, P_HIDDEN), generator=g, device=dev)
        n, d = x.shape
        check(n == t + t * k, f"SAGE layer {layer}: {n} rows for {t} x {k}")
        valid = int(mask.sum())
        row = d * x.element_size()
        slots = t * k * (nbr.element_size() + 1)
        shape = f"layer {layer}: T={t}, k={k}, N={n}, D={d}"
        got, want = sm.sage_mean(x, nbr, mask), sm.sage_mean_plain(x, nbr,
                                                                   mask)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"sage_mean {shape} differs from the "
              "plain version")
        fwd.append(dict(
            shape=shape, valid_slots=valid,
            max_abs_err=float((got - chain(x, nbr, mask)).abs().max()),
            ms=cuda_ms(torch, lambda: sm.sage_mean(x, nbr, mask)),
            host_ms=host_ms(torch, lambda: sm.sage_mean(x, nbr, mask)),
            plain_ms=cuda_ms(torch, lambda: sm.sage_mean_plain(x, nbr, mask)),
            library_ms=cuda_ms(torch, lambda: chain(x, nbr, mask)),
            bound_ms=(valid * row + t * row + slots) / HBM_BYTES_PER_S * 1e3))
        print(f"sage_mean {shape}: exact; {json.dumps(fwd[-1])}", flush=True)
        if layer == 0:
            continue
        gm = torch.randn((t, d), generator=g, device=dev)
        gs = torch.randn((t, d), generator=g, device=dev)
        got = sm.sage_mean_backward(gm, nbr, mask, n, gs)
        want = sm.sage_mean_backward_plain(gm, nbr, mask, n, gs)
        xr = x.clone().requires_grad_()

        def autograd_chain():
            return torch.autograd.grad((chain(xr, nbr, mask), xr[:t]), xr,
                                       (gm, gs))[0]

        torch.cuda.synchronize()
        check(torch.equal(got, want), f"sage_mean_backward {shape} differs "
              "from the plain version")
        flat = nbr.reshape(-1).long()
        src = (gm / mask.sum(1, keepdim=True).clamp_min(1)).repeat_interleave(
            k, dim=0)
        bwd.append(dict(
            shape=shape, valid_slots=valid,
            max_abs_err=float((got - autograd_chain()).abs().max()),
            ms=cuda_ms(torch, lambda: sm.sage_mean_backward(gm, nbr, mask, n,
                                                            gs)),
            host_ms=host_ms(torch, lambda: sm.sage_mean_backward(
                gm, nbr, mask, n, gs)),
            plain_ms=cuda_ms(torch, lambda: sm.sage_mean_backward_plain(
                gm, nbr, mask, n, gs)),
            library_ms=cuda_ms(torch, autograd_chain),
            index_add_ms=cuda_ms(torch, lambda: torch.zeros_like(x).index_add_(
                0, flat, src)),
            bound_ms=(n * row + 2 * t * row + slots) / HBM_BYTES_PER_S * 1e3))
        print(f"sage_mean_backward {shape}: exact; {json.dumps(bwd[-1])}",
              flush=True)
        del xr, got, want, src
    records = []
    for name, cases in (("sage_mean", fwd), ("sage_mean_backward", bwd)):
        records.append(dict(
            name=name, route="cuda", source=sm.SOURCE, replaces=sm.REPLACES,
            max_abs_err=max(c["max_abs_err"] for c in cases),
            **{key: float(sum(c[key] for c in cases)) for key in (
                "ms", "plain_ms", "bound_ms", "library_ms", "host_ms")},
            bound_by="bytes", cases=cases))
    return records


def sage_act_records(torch, sa) -> list:
    """GraphSAGE's hidden-layer activation at the products step's two
    hidden layers (layer 0: 180,224 targets, layer 1: 16,384; 256 wide,
    fp32, dropout 0.5), over seeded addends, a keep draw and a gradient.
    Each kernel bitwise its plain version, and the Function's gradient
    bitwise autograd's of the chain; timed beside its bound (the forward
    reads ``a``, ``b`` and ``keep`` and writes ``y`` and the code byte; the
    backward reads ``dy`` and the byte and writes ``dx``), the plain
    version, and the chain it replaced: ``F.relu(a + b) * keep / (1 - p)``
    forward, autograd's backward of it (the division's, the product's and
    ``threshold_backward``) backward.  Returns the forward's and the
    backward's kernel records."""
    import torch.nn.functional as F

    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    p = 0.5
    fwd, bwd = [], []
    for layer, t in enumerate(frontier_sizes(P_BATCH)[-2:0:-1]):
        shape = f"layer {layer}: T={t}, H={P_HIDDEN}"
        a, b, dy = (torch.randn((t, P_HIDDEN), generator=g, device=dev)
                    for _ in range(3))
        keep = torch.empty_like(a).bernoulli_(1.0 - p, generator=g)
        y, code = sa.sage_act(a, b, keep, p)
        y_p, code_p = sa.sage_act_plain(a, b, keep, p)
        dx = sa.sage_act_backward(dy, code, p)
        dx_p = sa.sage_act_backward_plain(dy, code, p)
        ar, br = a.clone().requires_grad_(), b.clone().requires_grad_()
        chain = F.relu(ar + br) * keep / (1.0 - p)
        dx_chain, = torch.autograd.grad(chain, ar, dy, retain_graph=True)
        torch.cuda.synchronize()
        check(torch.equal(y.view(torch.int32), y_p.view(torch.int32))
              and torch.equal(code, code_p),
              f"sage_act {shape} differs from the plain version")
        check(torch.equal(dx.view(torch.int32), dx_p.view(torch.int32)),
              f"sage_act_backward {shape} differs from the plain version")
        check(torch.equal(dx.view(torch.int32), dx_chain.view(torch.int32)),
              f"sage_act_backward {shape} differs from the chain's autograd")
        n = a.numel()
        fwd.append(dict(
            shape=shape,
            ms=cuda_ms(torch, lambda: sa.sage_act(a, b, keep, p)),
            host_ms=host_ms(torch, lambda: sa.sage_act(a, b, keep, p)),
            plain_ms=cuda_ms(torch, lambda: sa.sage_act_plain(a, b, keep, p)),
            library_ms=cuda_ms(torch, lambda: F.relu(a + b) * keep / (1 - p)),
            bound_ms=n * (4 * 4 + 1) / HBM_BYTES_PER_S * 1e3))
        print(f"sage_act {shape}: exact; {json.dumps(fwd[-1])}", flush=True)
        bwd.append(dict(
            shape=shape,
            ms=cuda_ms(torch, lambda: sa.sage_act_backward(dy, code, p)),
            host_ms=host_ms(torch, lambda: sa.sage_act_backward(dy, code,
                                                                p)),
            plain_ms=cuda_ms(torch, lambda: sa.sage_act_backward_plain(
                dy, code, p)),
            library_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                chain, ar, dy, retain_graph=True)),
            bound_ms=n * (2 * 4 + 1) / HBM_BYTES_PER_S * 1e3))
        print(f"sage_act_backward {shape}: exact; {json.dumps(bwd[-1])}",
              flush=True)
        del ar, br, chain
    records = []
    for name, cases in (("sage_act", fwd), ("sage_act_backward", bwd)):
        rec = dict(name=name, route="cuda", source=sa.SOURCE,
                   replaces=sa.REPLACES, max_abs_err=0.0,
                   **{key: float(sum(c[key] for c in cases)) for key in (
                       "ms", "plain_ms", "bound_ms", "library_ms",
                       "host_ms")},
                   bound_by="bytes", cases=cases)
        rec["layer0_bound_share"] = cases[0]["bound_ms"] / cases[0]["ms"]
        records.append(rec)
    return records


def sage_act_mean_records(torch, sam, sa, sm) -> list:
    """A hidden layer's activation fused with the next layer's mean at the
    products step's two positional blocks (0 to 1: 16,384 targets, k =
    10, 180,224 rows; 1 to 2: 1,024 targets, k = 15, 16,384 rows; 256
    wide, fp32, dropout 0.5; about one slot in eight masked), over seeded
    addends, a keep draw and two gradients.  Outputs and the addends'
    gradient bitwise the chain's kernels (``SageAct``, then ``SageMean``
    over the positional ``nbr_local``) and the plain versions; timed beside
    the bound (the forward reads ``a``, ``b`` and ``keep`` and writes the
    code, ``x_self`` and the mean; the backward reads both gradients and
    the code and writes ``dx``), the plain version and that chain.
    Returns the forward's and the backward's kernel records."""
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    p, h = 0.5, P_HIDDEN
    sizes = frontier_sizes(P_BATCH)
    fanouts = P_FANOUTS[::-1]  # the blocks' k, outermost first
    fwd, bwd = [], []
    for layer in range(len(P_FANOUTS) - 1):
        t, k = sizes[-3 - layer], fanouts[layer + 1]
        n = t * (1 + k)
        shape = f"layer {layer} to {layer + 1}: T={t}, k={k}, N={n}, H={h}"
        a, b = (torch.randn((n, h), generator=g, device=dev)
                for _ in range(2))
        keep = torch.empty_like(a).bernoulli_(1.0 - p, generator=g)
        mask = torch.rand((t, k), generator=g, device=dev) < 0.87
        pos = (t + torch.arange(t * k, device=dev, dtype=torch.int32)
               ).view(t, k)
        nbr = torch.where(mask, pos, torch.zeros_like(pos))
        gm, gs = (torch.randn((t, h), generator=g, device=dev)
                  for _ in range(2))

        def chain():
            ar, br = a.clone().requires_grad_(), b.clone().requires_grad_()
            outs = sm.SageMean.apply(sa.SageAct.apply(ar, br, keep, p), nbr,
                                     mask)
            return outs + torch.autograd.grad(outs, (ar, br), (gm, gs))

        def fused():
            ar, br = a.clone().requires_grad_(), b.clone().requires_grad_()
            outs = sam.SageActMean.apply(ar, br, keep, p, mask)
            return outs + torch.autograd.grad(outs, (ar, br), (gm, gs))

        mean, x_self, code = sam.sage_act_mean(a, b, keep, p, mask)
        dx = sam.sage_act_mean_backward(gm, gs, code, mask, p)
        plain = sam.sage_act_mean_plain(a, b, keep, p, mask)
        dx_p = sam.sage_act_mean_backward_plain(gm, gs, code, mask, p)
        want, got = chain(), fused()
        torch.cuda.synchronize()
        bits = [torch.equal(x.view(torch.int32), y.view(torch.int32))
                for x, y in zip(got, want)]
        check(all(bits), f"sage_act_mean {shape}: mean, self rows and both "
              f"gradients against the chain's kernels: {bits}")
        check(all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                  for x, y in ((mean, plain[0]), (x_self, plain[1]),
                               (dx, dx_p))) and torch.equal(code, plain[2]),
              f"sage_act_mean {shape} differs from the plain version")
        row, slots = h * 4, t * k
        fwd.append(dict(
            shape=shape, valid_slots=int(mask.sum()),
            ms=cuda_ms(torch, lambda: sam.sage_act_mean(a, b, keep, p,
                                                        mask)),
            host_ms=host_ms(torch, lambda: sam.sage_act_mean(a, b, keep, p,
                                                             mask)),
            plain_ms=cuda_ms(torch, lambda: sam.sage_act_mean_plain(
                a, b, keep, p, mask)),
            chain_ms=cuda_ms(torch, lambda: sm.sage_mean(
                sa.sage_act(a, b, keep, p)[0], nbr, mask)),
            bound_ms=(n * (3 * row + h) + 2 * t * row + slots)
            / HBM_BYTES_PER_S * 1e3))
        print(f"sage_act_mean {shape}: exact; {json.dumps(fwd[-1])}",
              flush=True)
        bwd.append(dict(
            shape=shape,
            ms=cuda_ms(torch, lambda: sam.sage_act_mean_backward(
                gm, gs, code, mask, p)),
            host_ms=host_ms(torch, lambda: sam.sage_act_mean_backward(
                gm, gs, code, mask, p)),
            plain_ms=cuda_ms(torch, lambda: sam.sage_act_mean_backward_plain(
                gm, gs, code, mask, p)),
            chain_ms=cuda_ms(torch, lambda: sa.sage_act_backward(
                sm.sage_mean_backward(gm, nbr, mask, n, gs), code, p)),
            bound_ms=(2 * t * row + n * (h + row) + slots)
            / HBM_BYTES_PER_S * 1e3))
        print(f"sage_act_mean_backward {shape}: exact; "
              f"{json.dumps(bwd[-1])}", flush=True)
        del a, b, keep, code, dx, plain, dx_p, want, got
    records = []
    for name, cases in (("sage_act_mean", fwd),
                        ("sage_act_mean_backward", bwd)):
        rec = dict(name=name, route="cuda", source=sam.SOURCE,
                   replaces=sam.REPLACES, max_abs_err=0.0,
                   **{key: float(sum(c[key] for c in cases)) for key in (
                       "ms", "plain_ms", "bound_ms", "chain_ms", "host_ms")},
                   bound_by="bytes", cases=cases)
        rec["layer0_bound_share"] = cases[0]["bound_ms"] / cases[0]["ms"]
        records.append(rec)
    return records


def staged_training_phase(torch, qt, topo, feat, labels, train, b2, b4):
    """The two-stage lane under the example's ``device_cache_size="200M"``:
    ``SeedLoader(prefetch=2)`` over a sampler in ``gather_mode=
    "lanes_fused"`` (B4 for every element gather) and a budgeted feature
    (hot rows through B2, cold rows through the staged merge), then
    ``make_train_step``, for STAGED_STEPS steps.  Every gathered row must
    equal the source.  Then a split of one batch run stage by stage.
    Returns the launches of the loop and a summary."""
    t0 = time.perf_counter()
    before = feature_counters(qt)
    feature = qt.Feature(device_cache_size=HOT_BUDGET, csr_topo=topo,
                         device=DEV).from_cpu_tensor(feat)
    want_hot = min(qt.parse_size(HOT_BUDGET) // (P_DIM * 4), topo.node_count)
    check(feature.cache_count == want_hot,
          f"the 200M budget holds {feature.cache_count} rows")
    check(feature.cache_count < topo.node_count, "the table fits the budget")
    check(feature.cold.is_pinned(), "the cold tail is not pinned")
    sampler = qt.GraphSageSampler(topo, P_FANOUTS, device=DEV, seed=SEED,
                                  gather_mode="lanes_fused")
    model = products_model(torch, qt)
    opt = torch.optim.Adam(model.parameters(), lr=P_LR)
    step = qt.make_train_step(model, opt, seed=SEED)
    src = torch.from_numpy(feat).to(DEV)
    sampled = []
    sample = sampler.sample

    def counted_sample(*a, **k):
        sampled.append(1)
        return sample(*a, **k)

    sampler.sample = counted_sample
    loader = qt.SeedLoader(train, sampler, feature, labels=labels,
                           batch_size=P_BATCH, prefetch=2, seed=SEED)
    torch.cuda.synchronize()
    print(f"two-stage lane: {feature!r}, {sampler!r}; set up in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    for fn in (b2.gather_rows, b4.lane_select):
        fn.launches = 0
    it = iter(loader)
    rec = {"wait": [], "train_wall": [], "train_event": [], "step_wall": []}
    losses = []
    try:
        for _ in range(STAGED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch, x, lab, mask = next(it)
            t1 = time.perf_counter()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            losses.append(step(x, batch.layers, lab, mask))
            b.record()
            b.synchronize()
            t2 = time.perf_counter()
            rec["wait"].append((t1 - t0) * 1e3)
            rec["train_wall"].append((t2 - t1) * 1e3)
            rec["train_event"].append(a.elapsed_time(b))
            rec["step_wall"].append((t2 - t0) * 1e3)
            check(torch.equal(x, src[batch.n_id.long()]),
                  "a gathered row differs from the source")
    finally:
        it.close()  # stops the loader's worker
    launches = {"lane_select": b4.lane_select.launches,
                "gather_rows": b2.gather_rows.launches,
                "sampled_batches": len(sampled)}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(launches["lane_select"] == 3 * len(P_FANOUTS) * len(sampled),
          f"B4 launched {launches['lane_select']} times for {len(sampled)} "
          "sampled batches")
    check(launches["gather_rows"] > 0, "B2 served no hot rows")
    losses = torch.stack(losses).cpu().numpy()
    check(np.isfinite(losses).all(), "a two-stage loss is not finite")
    check(losses[-2:].mean() < losses[:2].mean(),
          f"the two-stage loss did not fall: {losses.tolist()}")
    summary = {k: float(np.median(v[1:])) for k, v in rec.items()}
    summary.update(steps=STAGED_STEPS, losses=losses.tolist(),
                   launches=launches, peak_gib=peak_gib,
                   counters=counters_added(qt, before))
    print("two-stage training (ms, median after the first step) "
          + json.dumps(summary), flush=True)

    # one batch stage by stage, no prefetch: sample (events), read-back,
    # host stage and copy (feature[...], wall), train (events)
    sampler.sample = sample
    split = {k: [] for k in ("sample", "readback", "gather", "train",
                             "batch_wall")}
    for seeds, lab in batches(torch, train, torch.from_numpy(labels).to(DEV),
                              4, SEED + 14):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        batch = sampler.sample(seeds)
        ev[1].record()
        ev[1].synchronize()
        t1 = time.perf_counter()
        n_id = batch.n_id.cpu().numpy()
        t2 = time.perf_counter()
        x = feature[n_id]
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        ev[2].record()
        step(x, batch.layers, lab, torch.ones_like(seeds, dtype=torch.bool))
        ev[3].record()
        ev[3].synchronize()
        split["sample"].append(ev[0].elapsed_time(ev[1]))
        split["readback"].append((t2 - t1) * 1e3)
        split["gather"].append((t3 - t2) * 1e3)
        split["train"].append(ev[2].elapsed_time(ev[3]))
        split["batch_wall"].append((time.perf_counter() - t0) * 1e3)
    split = {k: float(np.median(v[1:])) for k, v in split.items()}
    split["host_share"] = (split["readback"] + split["gather"]) \
        / split["batch_wall"]
    print("two-stage batch split (ms, median of 3) " + json.dumps(split),
          flush=True)
    summary["split_ms"] = split
    feature.close()
    del feature, src, model, opt
    torch.cuda.empty_cache()
    return launches, summary


def full_graph_phase(torch, qt, topo, feat, models) -> dict:
    """Exact inference (``full_graph_inference``) on products for the
    trained GraphSAGE (the ``"auto"`` lane's), GCN and GAT, EDGE_CHUNK
    edges a chunk: host wall time, peak device memory, finite logits of
    ``[N, 47]``; then each model on a 20,000-node ``synthetic_csr`` graph
    on the card against the same call on CPU tensors within CPU_TOL."""
    x = torch.from_numpy(feat).to(DEV)
    out = {}
    for label, family in (("auto", "GraphSAGE"), ("gcn", "GCN"),
                          ("gat", "GAT")):
        model = models[label]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        y = qt.full_graph_inference(model, None, x, topo.indptr, topo.indices,
                                    edge_chunk=EDGE_CHUNK, device=DEV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(y.shape == (topo.node_count, P_CLASSES)
              and bool(torch.isfinite(y).all()),
              f"{family} full-graph logits {tuple(y.shape)} or not finite")
        out[family] = dict(wall_s=wall, chunks_a_pass=-(-topo.edge_count
                                                       // EDGE_CHUNK),
                           peak_extra_gib=(torch.cuda.max_memory_allocated()
                                           - base) / 2**30)
        print(f"full_graph_inference {family} on products "
              + json.dumps(out[family]), flush=True)
        del y
    del x
    torch.cuda.empty_cache()

    indptr, indices = qt.synthetic_csr(20_000, 200_000, seed=SEED + 30)
    xs = np.random.default_rng(SEED + 31).standard_normal(
        (20_000, P_DIM), dtype=np.float32)
    for label, family in (("auto", "GraphSAGE"), ("gcn", "GCN"),
                          ("gat", "GAT")):
        y_card = qt.full_graph_inference(models[label], None, xs, indptr,
                                         indices, edge_chunk=50_000,
                                         device=DEV).cpu()
        y_cpu = qt.full_graph_inference(copy.deepcopy(models[label]).cpu(),
                                        None, xs, indptr, indices,
                                        edge_chunk=50_000, device="cpu")
        err = float((y_card - y_cpu).abs().max())
        check(torch.allclose(y_card, y_cpu, **CPU_TOL),
              f"{family} full-graph logits on the card differ from the "
              f"CPU's by {err}")
        out[family]["small_graph_cpu_max_abs_err"] = err
        print(f"full_graph_inference {family}, 20,000 nodes: card against "
              f"CPU, max abs err {err:.3e}", flush=True)
    return out


def mag_data(torch, qt):
    """The MAG240M-schema graph, its feature tables and the paper labels.
    Each relation's CSR has Poisson(MAG_DEGREES) rows of uniform sources
    (rows are DST nodes).  Features are N(0, 0.25) noise drawn on the
    card from a seeded generator, MAG_CHUNK_ROWS rows at a time, into host
    tables; a paper's row also holds its label's centroid, one N(0, 1)
    vector per class (a class-conditional Gaussian mixture), so the loss
    can fall within a few steps.  (A one-hot label in 153 of the 768
    columns, as ``products_data`` makes products' rows, left the loss at
    ln(153) for 10 steps at Adam 1e-3.)"""
    rng = np.random.default_rng(SEED + 20)
    rels = {}
    for (s_t, name, d_t), avg in MAG_DEGREES.items():
        deg = rng.poisson(avg, MAG_COUNTS[d_t])
        indptr = np.zeros(len(deg) + 1, np.int64)
        np.cumsum(deg, out=indptr[1:])
        indices = rng.integers(0, MAG_COUNTS[s_t], int(indptr[-1]),
                               dtype=np.int32)
        rels[(s_t, name, d_t)] = qt.CSRTopo(indptr=indptr, indices=indices)
    topo = qt.HeteroCSRTopo(rels, MAG_COUNTS)
    labels = rng.integers(0, MAG_CLASSES, MAG_COUNTS["paper"]).astype(
        np.int32)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    labels_d = torch.from_numpy(labels).to(DEV).long()
    centroids = torch.randn((MAG_CLASSES, MAG_DIM), generator=gen,
                            device=DEV)
    tables = {}
    for t, n in MAG_COUNTS.items():
        host = torch.empty((n, MAG_DIM), dtype=torch.float32)
        for lo in range(0, n, MAG_CHUNK_ROWS):
            hi = min(lo + MAG_CHUNK_ROWS, n)
            rows = torch.randn((hi - lo, MAG_DIM), generator=gen,
                               device=DEV) * 0.5
            if t == "paper":
                rows += centroids[labels_d[lo:hi]]
            host[lo:hi].copy_(rows)
        tables[t] = host.numpy()
    return topo, tables, labels


def check_same_hetero(torch, got, want, what: str):
    """Two hetero batches, bit for bit: every type's ids and mask, every
    block's relation, ``nbr_local``, ``mask`` and ``num_targets``."""
    for t in want.n_id:
        check(torch.equal(got.n_id[t], want.n_id[t]), f"{what}: {t} ids")
        check(torch.equal(got.n_id_mask[t], want.n_id_mask[t]),
              f"{what}: {t} mask")
    for l, (gl, wl) in enumerate(zip(got.layers, want.layers, strict=True)):
        for a, b in zip(gl, wl, strict=True):
            check(a.relation == b.relation, f"{what}: layer {l} relations")
            for name in ("nbr_local", "mask", "num_targets"):
                check(torch.equal(getattr(a, name), getattr(b, name)),
                      f"{what}: layer {l} {a.relation} {name} differs")


def rgat_step_split(torch, sampler, hf, model, opt, seeds, labels,
                    mask) -> dict:
    """One R-GAT step's stages by CUDA events (median of 5 after 2 warm):
    sampling, lookup, forward and loss, backward, Adam."""
    from quiver_tpu_torch.parallel.train import masked_cross_entropy

    keys = ("sample", "lookup", "forward", "backward", "optimizer")
    out = {k: [] for k in keys}
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    model.train()
    for _ in range(7):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        batch = sampler.sample(seeds)
        ev[1].record()
        xs = hf.lookup(batch)
        ev[2].record()
        opt.zero_grad(set_to_none=True)
        loss = masked_cross_entropy(model(xs, batch, generator=gen), labels,
                                    mask)
        ev[3].record()
        loss.backward()
        ev[4].record()
        opt.step()
        ev[5].record()
        ev[5].synchronize()
        for i, k in enumerate(keys):
            out[k].append(ev[i].elapsed_time(ev[i + 1]))
        del batch, xs, loss
    return {k: float(np.median(v[2:])) for k, v in out.items()}


def hetero_kernel_cases(torch, b1, b2, topo, hf, sampler, batch, kw):
    """Kernels B1 (literal entry) at each block of one sampled batch and
    B2 at each type's lookup, held against their plain versions exactly on
    the batch's own inputs, timed against their bounds (B1 as in
    ``b1_hops``; B2 as in ``b2_case``), B2 beside ``index_select``."""
    b1_cases, b2_cases, i = [], [], 0
    for hop in sampler.plan(batch.batch_size)[0]:
        for blk in hop:
            s_t, _, d_t = blk.relation
            t, k = blk.t_len, blk.k
            ip, ix = topo.relations[blk.relation].to_device(DEV)
            s, m = batch.n_id[d_t][:t], batch.n_id_mask[d_t][:t]
            k0, k1 = int(kw[i, 0]), int(kw[i, 1])
            i += 1

            def lit():
                return b1.window_sample(ip, ix, s, k, k0, k1, m)

            def lit_plain():
                return b1.window_sample_plain(ip, ix, s, k, k0, k1, m)

            got, want = lit(), lit_plain()
            torch.cuda.synchronize()
            for name, a, b in zip(got._fields, got, want):
                check(torch.equal(a, b), f"B1 {blk.relation} {name} "
                      "differs from the plain version")
            live = s[m].long()
            nbytes = (t * (4 + 1) + sector_bytes(torch, live, live + 1)
                      + sector_bytes(torch, got.eid[got.mask])
                      + t * k * (4 + 1 + 4) + t * 4)
            b1_cases.append(dict(
                entry="literal", shape=f"MAG {'__'.join(blk.relation)}: "
                f"B={t}, k={k}", max_abs_err=int_err(zip(got, want)),
                ms=cuda_ms(torch, lit), host_ms=host_ms(torch, lit),
                plain_ms=cuda_ms(torch, lit_plain),
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                draws=int(got.counts.sum())))
            print(f"B1 literal entry, {b1_cases[-1]['shape']}: exact; "
                  f"{json.dumps(b1_cases[-1])}", flush=True)
    for t, f in hf.features.items():
        # what HeteroFeature.lookup hands lookup_device
        b2_cases.append(b2_case(torch, b2, f"MAG {t}", f.hot, batch.n_id[t],
                                f._order_dev))

    def total(cases, key):
        return float(sum(c[key] for c in cases))

    return ({k: total(b1_cases, k) for k in ("ms", "plain_ms", "bound_ms",
                                             "host_ms")} | {"cases": b1_cases},
            {k: total(b2_cases, k) for k in (
                "ms", "direct_ms", "grouped_ms", "plain_ms", "bound_ms",
                "bound_all_draws_ms", "library_ms")}
            | {"cases": b2_cases})


def rgat_phase(torch, qt, b1, b2):
    """Slice 7's main path, the loop of ``examples/mag240m_rgat.py`` at
    MAG240M's widths: ``HeteroGraphSageSampler.sample`` (B1's literal
    entry once a sampled block, 5 a step) -> ``HeteroFeature.lookup`` (B2
    once a type, 3 a step, the whole 12.4 GB of tables on the card) ->
    ``make_train_step(RGAT)``, MAG_STEPS steps; the loss must fall and
    stay finite.  Then the step split by CUDA events, one step under the
    profiler (busy share), one batch under ``"pwindow"`` against
    ``"xla"`` with the same words, bit for bit, and the kernels at that
    batch's shapes (``hetero_kernel_cases``).  Returns the loop's
    launches, a summary and B1's and B2's MAG records."""
    t0 = time.perf_counter()
    topo, tables, labels = mag_data(torch, qt)
    t_data = time.perf_counter() - t0
    hf = qt.HeteroFeature.from_cpu_tensors(
        tables, device_cache_size=max(a.nbytes for a in tables.values()),
        device=DEV)
    for t, f in hf.features.items():
        check(f.cache_count == MAG_COUNTS[t], f"the {t} table is not whole")
    table_gb = sum(a.nbytes for a in tables.values()) / 1e9
    del tables
    sampler = qt.HeteroGraphSageSampler(topo, MAG_FANOUTS, seed_type="paper",
                                        device=DEV, seed=SEED)
    _, lens = sampler.plan(MAG_BATCH)
    check(lens == MAG_FRONTIERS, f"MAG frontiers {lens}")
    torch.manual_seed(SEED)
    model = qt.RGAT({t: MAG_DIM for t in MAG_COUNTS}, MAG_HIDDEN,
                    MAG_CLASSES, len(MAG_FANOUTS), sampler.layer_relations(),
                    heads=MAG_HEADS, dropout=0.5, device="cpu").to(DEV)
    opt = torch.optim.Adam(model.parameters(), lr=MAG_LR)
    step = qt.make_train_step(model, opt, seed=SEED)
    labels_d = torch.from_numpy(labels).to(DEV)
    order = np.random.default_rng(SEED + 21).permutation(MAG_COUNTS["paper"])
    ones = torch.ones((MAG_BATCH,), dtype=torch.bool, device=DEV)

    def seeds_of(i):
        return torch.from_numpy(order[i * MAG_BATCH:(i + 1) * MAG_BATCH]
                                .astype(np.int32)).to(DEV)

    torch.cuda.synchronize()
    edges = {"__".join(r): c.edge_count for r, c in topo.relations.items()}
    print(f"MAG240M-schema graph {MAG_COUNTS}, edges {edges}, "
          f"{table_gb:.2f} GB of features on the card, frontiers {lens} "
          f"({sum(lens.values()):,} rows a step), "
          f"{sum(p.numel() for p in model.parameters()):,} R-GAT "
          f"parameters: data in {t_data:.2f} s, set up in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    b1.window_sample.launches = 0
    b2.gather_rows.launches = 0
    losses, wall, dev_ms = [], [], []
    for i in range(MAG_STEPS):
        seeds = seeds_of(i)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        a.record()
        batch = sampler.sample(seeds)
        xs = hf.lookup(batch)
        losses.append(step(xs, batch, labels_d[seeds.long()], ones))
        b.record()
        b.synchronize()
        wall.append((time.perf_counter() - t1) * 1e3)
        dev_ms.append(a.elapsed_time(b))
        del batch, xs
    launches = {"window_sample": b1.window_sample.launches,
                "gather_rows": b2.gather_rows.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = torch.stack(losses).cpu().numpy()
    check(np.isfinite(losses).all(), "an R-GAT loss is not finite")
    first, last = float(losses[:3].mean()), float(losses[-3:].mean())
    check(last < first, f"the R-GAT loss did not fall: {losses.tolist()}")
    n_blocks = sampler.num_blocks(MAG_BATCH)
    check(launches["window_sample"] == n_blocks * MAG_STEPS,
          f"R-GAT: B1 launched {launches['window_sample']} times in "
          f"{MAG_STEPS} steps, not {n_blocks} a step")
    check(launches["gather_rows"] == len(MAG_COUNTS) * MAG_STEPS,
          f"R-GAT: B2 launched {launches['gather_rows']} times in "
          f"{MAG_STEPS} steps, not {len(MAG_COUNTS)} a step")
    summary = dict(steps=MAG_STEPS, losses=losses.tolist(),
                   loss_first3_mean=first, loss_last3_mean=last,
                   step_wall_ms=float(np.median(wall[2:])),
                   step_event_ms=float(np.median(dev_ms[2:])),
                   launches=launches, peak_gib=peak_gib,
                   table_gb=table_gb, frontiers=lens, data_s=t_data)
    print("R-GAT training " + json.dumps(summary), flush=True)

    seeds, lab = seeds_of(MAG_STEPS), labels_d[seeds_of(MAG_STEPS).long()]
    split = rgat_step_split(torch, sampler, hf, model, opt, seeds, lab, ones)
    print("R-GAT step split (CUDA events, ms, median of 5) "
          + json.dumps(split), flush=True)

    def one_step():
        batch = sampler.sample(seeds)
        step(hf.lookup(batch), batch, lab, ones)

    # the launch counters above hold B1 to exactly n_blocks a step; the
    # profile must show B1 on the card, but on some machines the profiler
    # drops device events from every capture (runs saw 413 of a step's
    # 417 operations, 4 of its 5 B1 kernels), so it is taken up to three
    # times for the full count and then held to between one and n_blocks
    # B1 kernels
    for _ in range(3):
        prof = device_profile(torch, one_step, summary["step_wall_ms"],
                              top=12, families=KERNEL_FAMILIES)
        b1_ops = family_count(prof, "B1")
        if b1_ops == n_blocks:
            break
    print("R-GAT step on the card (torch.profiler) " + json.dumps(prof),
          flush=True)
    check(1 <= b1_ops <= n_blocks, f"R-GAT: {b1_ops} B1 kernels in the "
          "profile of one step")
    summary.update(split_ms=split, device_profile=prof)

    kw = sampler.draw_key_words(MAG_BATCH)
    got = sampler.sample(seeds, key_words=kw)
    xla = qt.HeteroGraphSageSampler(topo, MAG_FANOUTS, seed_type="paper",
                                    device=DEV, gather_mode="xla")
    check_same_hetero(torch, got, xla.sample(seeds, key_words=kw),
                      "MAG batch under pwindow vs xla")
    print("MAG batch under \"pwindow\" (B1): equal to \"xla\", bit for bit, "
          "per block and per type", flush=True)
    b1_mag, b2_mag = hetero_kernel_cases(torch, b1, b2, topo, hf, sampler,
                                         got, kw)
    del got, hf, model, opt, step, sampler, xla
    torch.cuda.empty_cache()
    return launches, summary, b1_mag, b2_mag


# slice 9: the host sampler and the paths built on it
HOST_BUCKET = 2048  # seeds of the timed host multi-hop sample
HOST_CHECK_ROWS = 4096  # targets of a hop whose rows are read in full
UVA_BATCHES = 10
MIXED_TASKS, MIXED_WORKERS = 16, 4
LOADER_BATCHES = 3


def check_host_hop(indptr, indices, targets, tmask, nbrs, mask, k, rows,
                   what: str):
    """One hop of the host sampler: ``min(deg, k)`` neighbours a valid
    target and none a masked one; for the targets ``rows``, a row of degree
    at most ``k`` returned whole in CSR order, and a longer one drawn at
    distinct positions (no id more often than the row holds it)."""
    deg = np.diff(indptr)[targets]
    check(np.array_equal(mask.sum(1), np.where(tmask, np.minimum(deg, k),
                                               0)),
          f"{what}: counts differ from min(deg, k)")
    for b in rows:
        if not tmask[b]:
            continue
        row = indices[indptr[targets[b]]: indptr[targets[b] + 1]]
        got = nbrs[b][mask[b]]
        if len(row) <= k:
            check(np.array_equal(got, row), f"{what}: row {b} not whole")
            continue
        vals, cnt = np.unique(row, return_counts=True)
        gv, gc = np.unique(got, return_counts=True)
        at = np.minimum(np.searchsorted(vals, gv), len(vals) - 1)
        check((vals[at] == gv).all(), f"{what}: row {b} has a non-neighbour")
        check((gc <= cnt[at]).all(), f"{what}: row {b} repeats a position")


def check_same_batch(torch, a, b, what: str):
    """Two ``SampledBatch``es bit for bit, on any devices."""
    for name in ("n_id", "n_id_mask", "num_nodes"):
        check(torch.equal(getattr(a, name).cpu(), getattr(b, name).cpu()),
              f"{what}: {name} differs")
    check(len(a.layers) == len(b.layers), f"{what}: block counts differ")
    for i, (x, y) in enumerate(zip(a.layers, b.layers)):
        for name in ("nbr_local", "mask", "num_targets"):
            check(torch.equal(getattr(x, name).cpu(), getattr(y, name).cpu()),
                  f"{what}: block {i} {name} differs")


def host_sampler_phase(torch, qt, topo) -> dict:
    """(a) The native host sampler at Reddit size: a bucket-2048
    ``sample_multihop`` with fanouts [25, 10], host ms (median of 5) at the
    default thread count and at 1, each hop checked (``check_host_hop``;
    local ids index the valid part of ``n_id``); then ``mode="CPU"`` on
    the card bitwise against the same calls with ``device="cpu"``."""
    from quiver_tpu_torch.cpp.native import CPUSampler

    indptr, indices = topo.indptr, topo.indices
    rng = np.random.default_rng(SEED + 20)
    seeds = rng.integers(0, N_NODES, HOST_BUCKET)
    out = {}
    for threads in (0, 1):
        s = CPUSampler(indptr, indices, n_threads=threads)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            res = s.sample_multihop(seeds, FANOUTS)
            times.append((time.perf_counter() - t0) * 1e3)
        out["ms_default_threads" if threads == 0 else "ms_1_thread"] = \
            float(np.median(times))
    out["threads_default"] = os.cpu_count()
    n_id, n_mask, num, blocks = res
    check(num == int(n_mask.sum()), "host num_nodes")
    t0 = time.perf_counter()
    for h, ((local, mask, nt), k) in enumerate(zip(blocks[::-1], FANOUTS)):
        t = local.shape[0]
        targets, tmask = n_id[:t], n_mask[:t]
        check(nt == int(tmask.sum()), f"host hop {h + 1}: num_targets")
        check((local[mask] < len(n_id)).all() and n_mask[local[mask]].all(),
              f"host hop {h + 1}: local ids outside the valid n_id")
        rows = (range(t) if t <= HOST_CHECK_ROWS else
                rng.choice(t, HOST_CHECK_ROWS, replace=False))
        check_host_hop(indptr, indices, targets, tmask, n_id[local], mask, k,
                       rows, f"host hop {h + 1}")
    out["check_s"] = time.perf_counter() - t0
    out["frontier"] = int(len(n_id))
    on_card = qt.GraphSageSampler(topo, FANOUTS, device=DEV, mode="CPU")
    on_host = qt.GraphSageSampler(topo, FANOUTS, device="cpu", mode="CPU")
    for i in range(3):
        ids = rng.integers(0, N_NODES, 512)
        got = on_card.sample(ids)
        check(got.n_id.device.type == "cuda", "CPU mode batch not on the card")
        check_same_batch(torch, got, on_host.sample(ids),
                         f"CPU mode call {i} on the card against the CPU")
    print("host sampler at Reddit size (bucket 2048, fanouts "
          f"{FANOUTS}) " + json.dumps(out), flush=True)
    return out


def hybrid_serving_phase(torch, qt, topo, feature, b1, b2):
    """(b) Reddit serving through both lanes: ``generate_neighbour_num``
    (``"expected"``) on the card, timed and held against the CPU by the
    rule of the tests (equal, or 1 off where the CPU's float is within
    1e-5 relative of an integer); ``calibrate_threshold``; then the
    64-request plan through RequestBatcher(mode="Auto") ->
    HybridSampler(num_workers=2) -> InferenceServer_Debug (at the plan's
    median load when the calibrated threshold sends every request one
    way).  Both lanes must answer; B2 launches once a device chunk and
    once a CPU-lane request, B1 twice a device chunk; one CPU-lane answer
    equals a direct forward of its batch within CPU_TOL, and a replay of
    the CPU lane's forwards launches B2 once each.  Returns the launches
    and a summary."""
    from quiver_tpu_torch.neighbour_num import expected_counts

    out = {}
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nn = qt.generate_neighbour_num(topo, FANOUTS, device=DEV)
        times.append((time.perf_counter() - t0) * 1e3)
    out["neighbour_num_card_ms"] = times
    ip, ix = topo.to_device(DEV)
    n, e = topo.node_count, topo.edge_count
    g_card = expected_counts(ip[: n + 1], ix[:e], n, FANOUTS).cpu().numpy()
    t0 = time.perf_counter()
    ipc = torch.from_numpy(topo.indptr.astype(np.int32))
    ixc = torch.from_numpy(topo.indices)
    g_host = expected_counts(ipc, ixc, n, FANOUTS).numpy()
    out["neighbour_num_host_ms"] = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(nn, g_card.astype(np.int64)),
          "neighbour_num differs from its own floats")
    host = g_host.astype(np.int64)
    diff = np.abs(nn - host)
    near = (np.abs(g_host - np.round(g_host))
            <= 1e-5 * np.maximum(np.abs(g_host), 1.0))
    check(not ((diff > 1) | ((diff == 1) & ~near)).any(),
          "neighbour_num on the card breaks the +-1 rule against the CPU")
    out["neighbour_num_off_by_one"] = int((diff == 1).sum())
    out["neighbour_num_max_rel_err"] = float(
        (np.abs(g_card - g_host) / np.maximum(np.abs(g_host), 1.0)).max())

    model = seeded_model(torch, qt).to(DEV).eval()
    dev_s = qt.GraphSageSampler(topo, FANOUTS, device=DEV, seed=SEED)
    cpu_s = qt.GraphSageSampler(topo, FANOUTS, device=DEV, mode="CPU")
    t0 = time.perf_counter()
    calibrated = qt.calibrate_threshold(dev_s, cpu_s, feature, model, nn,
                                        N_NODES, seed=SEED)
    out["calibrate_s"] = time.perf_counter() - t0
    out["calibrated_threshold"] = calibrated
    _, plans = request_plan()
    loads = [float(nn[ids].sum()) for plan in plans for ids in plan]
    threshold = calibrated
    if threshold < min(loads) or threshold >= max(loads):
        threshold = float(np.median(loads))
    out["threshold"] = threshold
    print(f"calibrated threshold {calibrated:.1f}, served at "
          f"{threshold:.1f} (plan loads {min(loads):.0f}..{max(loads):.0f})",
          flush=True)

    kernels = {"window_sample": b1.window_sample, "gather_rows": b2.gather_rows}
    server, answers, sent, launches, _, summary = serve(
        torch, qt, dev_s, feature, model, kernels,
        hybrid=(nn, threshold, cpu_s))
    cpu_log = list(server.cpu_log)
    chunks = sum(len(c) for _, c in server.pass_log)
    lanes = {lane: h.count for lane, h in server.lane_latency.items()}
    check(lanes["cpu"] >= 1 and lanes["device"] >= 1,
          f"a lane answered nothing: {lanes}")
    check(lanes["cpu"] == len(cpu_log), "CPU-lane log")
    check(launches["gather_rows"] == chunks + len(cpu_log),
          f"B2 launched {launches['gather_rows']} times for {chunks} "
          f"device chunks and {len(cpu_log)} CPU-lane requests")
    check(launches["window_sample"] == len(FANOUTS) * chunks,
          f"B1 launched {launches['window_sample']} times for {chunks} "
          "device chunks")
    client, seq, batch = cpu_log[0]
    with torch.inference_mode():
        direct = model(feature[batch.n_id], batch.layers)[
            : len(sent[(client, seq)].ids)].cpu().numpy()
    err = float(np.abs(answers[(client, seq)] - direct).max())
    check(np.allclose(answers[(client, seq)], direct, **CPU_TOL),
          f"CPU-lane answer differs from its direct forward by {err}")
    # the served count mixes both lanes' threads: replay the CPU lane's
    # forward alone on its logged batches, B2 counted (once a request)
    b2.gather_rows.launches = 0
    for client, seq, batch in cpu_log:
        again = qt.InferenceServer._infer_presampled(
            server, sent[(client, seq)], batch)
        check(np.allclose(again, answers[(client, seq)], **CPU_TOL),
              f"CPU-lane answer {(client, seq)} differs on a replay")
    replayed = b2.gather_rows.launches
    check(replayed == len(cpu_log), f"B2 launched {replayed} times in "
          f"{len(cpu_log)} replayed CPU-lane forwards")
    for lane, h in server.lane_latency.items():
        out[f"{lane}_lane"] = dict(requests=h.count,
                                   p50_ms=h.percentile(50) * 1e3,
                                   p99_ms=h.percentile(99) * 1e3)
    out.update(cpu_answer_max_abs_err=err, device_chunks=chunks,
               cpu_lane_replay_b2_launches=replayed, serving=summary)
    print("hybrid serving summary " + json.dumps(out), flush=True)
    return launches, out


# slice 10: serving's safeguards and telemetry on the Reddit slice
QOS_TENANTS = ("gold:rate=2000,burst=64,weight=8,priority=3;"
               "bronze:rate=2000,burst=64,weight=1,priority=0")
BREAKER_FAILURES, BREAKER_RESET_S = 3, 0.5
FAULT_REQUESTS = 10  # sent one at a time through the device fault
BURST, BURST_DEPTH = 256, 8


def trace_scope_check(torch, feature, n_id) -> dict:
    """``utils.trace.trace_scope(block=)`` around one B2 lookup of
    ``n_id`` must last at least the lookup's device time (CUDA events
    around the same call, inside the scope); without ``block`` the scope
    measures the launch."""
    from quiver_tpu_torch.utils import trace

    feature.lookup_device(n_id)
    torch.cuda.synchronize()
    trace.set_enabled(True)
    trace.reset_trace()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    try:
        torch.cuda.synchronize()
        # both events inside the scope: the host opens it before the card
        # reaches a, and closes it after the card passed b
        with trace.trace_scope("blocked", block=feature.hot):
            a.record()
            feature.lookup_device(n_id)
            b.record()
        torch.cuda.synchronize()
        event_ms = a.elapsed_time(b)
        with trace.trace_scope("launch"):
            feature.lookup_device(n_id)
        torch.cuda.synchronize()
        summary = trace.trace_summary()
    finally:
        trace.set_enabled(False)
        trace.reset_trace()
    out = dict(ids=int(n_id.shape[0]), event_ms=event_ms,
               blocked_scope_ms=summary["blocked"]["total_s"] * 1e3,
               launch_scope_ms=summary["launch"]["total_s"] * 1e3)
    check(out["blocked_scope_ms"] >= event_ms,
          f"trace_scope(block=) lasted {out['blocked_scope_ms']:.4f} ms, "
          f"under the B2 call's {event_ms:.4f} ms on the card")
    print("trace_scope(block=) around B2 " + json.dumps(out), flush=True)
    return out


def _take(results, n: int, ok: dict, errors: dict, timeout: float = 120.0):
    """Move ``n`` answers from ``results`` into ``ok`` (logits) and
    ``errors`` (exceptions), keyed by ``(client, seq)``."""
    for _ in range(n):
        req, out = results.get(timeout=timeout)
        (errors if isinstance(out, Exception) else ok)[
            (req.client, req.seq)] = out


def _counter(tel, name: str, **labels) -> float:
    from quiver_tpu_torch.telemetry.registry import metric_key

    return tel.snapshot()["counters"].get(metric_key(name, labels), 0.0)


def _pass_ms(torch, server) -> float:
    """Median host ms of five bucket-2048 passes through the server's
    forward, read back (after two warm)."""
    ids = np.random.default_rng(SEED + 20).integers(0, N_NODES, 2048)
    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server._run_bucketed(ids)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[2:]))


def _get(url: str):
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read().decode()


# the overhead A/B's configurations, run in this order and then reversed:
# (QoS, telemetry, phase 4's bursts of four rather than all at once)
OVERHEAD_RUNS = {"qos": (True, True, False), "plain": (False, True, False),
                 "off": (False, False, False), "bursts": (False, True, True),
                 "bursts_off": (False, False, True)}


def serve_plan_once(torch, qt, dev_s, feature, model, qos_on: bool,
                    telemetry_on: bool, bursts: bool) -> dict:
    """The 64-request plan once through a fresh RequestBatcher and
    InferenceServer_Debug, with QoS as in the resilient step (1) or none,
    with telemetry on or off, sent all at once (step (1)'s arrival) or by
    N_CLIENTS threads in bursts of four 20 ms apart (phase 4's).  Returns
    the exact p50 and p99 of the requests' latencies, admission to the
    answer's read, the server's own (``stats()``, admission to the end of
    the pass, from its histogram) and the passes."""
    from quiver_tpu_torch import config, telemetry as tel
    from quiver_tpu_torch.resilience import qos

    streams = [queue.Queue() for _ in range(N_CLIENTS)]
    results = queue.Queue()
    _, plans = request_plan()
    lat = []
    qos.reset()
    tel.set_enabled(telemetry_on)
    try:
        with config.override(qos_enabled=qos_on, qos_tenants=QOS_TENANTS,
                             qos_default_tenant="bronze",
                             serving_deadline_ms=60_000.0):
            rb = qt.RequestBatcher(streams, mode="Device",
                                   result_queue=results)
            server = qt.InferenceServer_Debug(
                dev_s, feature, model, rb.device_batched_queue,
                result_queue=results, seed=SEED)
            server.warmup()
            server.pass_log.clear()

            def client(c):
                for seq, ids in enumerate(plans[c]):
                    streams[c].put(qt.ServingRequest(
                        ids=ids, client=c, seq=seq,
                        tenant="gold" if c % 2 == 0 else "bronze"))
                    if bursts and seq % 4 == 3:
                        time.sleep(0.02)

            rb.start()
            server.start()
            clients = []
            try:
                if bursts:
                    clients = [threading.Thread(target=client, args=(c,))
                               for c in range(N_CLIENTS)]
                    for t in clients:
                        t.start()
                else:
                    for c in range(N_CLIENTS):
                        client(c)
                for _ in range(N_CLIENTS * PER_CLIENT):
                    req, o = results.get(timeout=120)
                    lat.append(time.perf_counter() - req.t_enqueue)
                    check(not isinstance(o, Exception),
                          f"overhead A/B: a request failed: {o!r}")
            finally:
                for t in clients:
                    t.join(timeout=30)
                leaked = rb.stop() + server.stop()
    finally:
        tel.set_enabled(True)
        qos.reset()
    check(not leaked, "overhead A/B threads did not stop")
    check(not server.failover_log, "a failover in the overhead A/B")
    p50, p99 = np.percentile(np.array(lat) * 1e3, [50, 99])
    stats = server.stats()
    return dict(p50_ms=float(p50), p99_ms=float(p99),
                server_p50_ms=stats["p50_latency_ms"],
                server_p99_ms=stats["p99_latency_ms"],
                passes=len(server.pass_log))


def serving_overhead_ab(torch, qt, dev_s, feature, model) -> dict:
    """Each OVERHEAD_RUNS configuration twice, in the order given and then
    reversed, so a drift of the host over the runs falls on every
    configuration alike; the registry and the flight recorder start empty,
    at their configured defaults.  Returns each one's numbers
    (``serve_plan_once``), a list of two each."""
    from quiver_tpu_torch import telemetry as tel

    tel.reset()
    order = list(OVERHEAD_RUNS) + list(reversed(OVERHEAD_RUNS))
    out = {name: {} for name in order}
    for name in order:
        qos_on, telemetry_on, bursts = OVERHEAD_RUNS[name]
        got = serve_plan_once(torch, qt, dev_s, feature, model, qos_on,
                              telemetry_on, bursts)
        for key, v in got.items():
            out[name].setdefault(key, []).append(v)
    print("serving overhead A/B (ms, two runs each) " + json.dumps(out),
          flush=True)
    return out


def resilient_serving_phase(torch, qt, topo, feature, b1, b2):
    """Slice 10: the Reddit slice served with its safeguards and
    telemetry, the native host sampler (``mode="CPU"``) as the failover
    route.  (1) QoS with two classes (QOS_TENANTS) and a 60 s deadline:
    the 64-request plan, every answer ok, recomputed passes equal, no
    failover; (2) a ChaosPlan fails ``serving.device_lane``
    BREAKER_FAILURES times: the breaker goes closed -> open -> half_open
    -> closed, each failover answer equals ``_infer_presampled`` of its
    logged batch (B2), then one fault with no route is answered with the
    typed error; (3) a burst of BURST requests into lanes of BURST_DEPTH
    under a deadline of 3x the median bucket-2048 pass: every request
    answered, with logits, ``LoadShed`` or ``DeadlineExceeded``, no
    failover; (4) ``/metrics`` and the debug routes served on
    127.0.0.1:0, the registry's device-lane count against the ok device
    answers, the flight recorder's error, slow and shed records, one
    request on the timeline, and the profile's rows for B1 and B2 on the
    card; (5) the plan's latency all at once and in bursts, with QoS and
    telemetry on and off (``serving_overhead_ab``).  Returns the launches
    of (1)-(3) (each kernel's count set to 0
    before each step and read after) and a summary."""
    from quiver_tpu_torch import config, telemetry as tel
    from quiver_tpu_torch.resilience import ChaosPlan, CircuitBreaker, \
        chaos, qos
    from quiver_tpu_torch.telemetry import export, flightrec, profile, \
        timeline

    class LoggedBreaker(CircuitBreaker):
        """The device lane's breaker, keeping its transitions."""

        def __init__(self, *a, **k):
            self.transitions = []
            super().__init__(*a, **k)

        def _transition(self, to):
            self.transitions.append(to)
            super()._transition(to)

    kernels = {"window_sample": b1.window_sample,
               "gather_rows": b2.gather_rows}
    launches = {name: 0 for name in kernels}

    def zero_launches():
        for fn in kernels.values():
            fn.launches = 0

    def read_launches() -> dict:
        got = {name: fn.launches for name, fn in kernels.items()}
        for name, n in got.items():
            launches[name] += n
        zero_launches()
        return got

    def failovers() -> float:
        return _counter(tel, "serving_failover_total",
                        direction="device_to_cpu")

    t_phase = time.perf_counter()
    tel.reset()
    qos.reset()
    model = seeded_model(torch, qt).to(DEV).eval()
    dev_s = qt.GraphSageSampler(topo, FANOUTS, device=DEV, seed=SEED)
    cpu_s = qt.GraphSageSampler(topo, FANOUTS, device=DEV, mode="CPU")
    out, steps_s, device_ok = {}, {}, 0

    # (1) QoS and deadlines, no fault
    t0 = time.perf_counter()
    with config.override(qos_enabled=True, qos_tenants=QOS_TENANTS,
                         qos_default_tenant="bronze",
                         serving_deadline_ms=60_000.0):
        streams = [queue.Queue() for _ in range(N_CLIENTS)]
        results = queue.Queue()
        rb = qt.RequestBatcher(streams, mode="Device", result_queue=results)
        server = qt.InferenceServer_Debug(
            dev_s, feature, model, rb.device_batched_queue,
            result_queue=results, seed=SEED, cpu_sampler=cpu_s)
        server.warmup()
        pass_ms = _pass_ms(torch, server)
        server.pass_log.clear()
        _, plans = request_plan()
        sent, ok, errors = {}, {}, {}
        tel.reset()
        zero_launches()
        rb.start()
        server.start()
        try:
            for c in range(N_CLIENTS):
                for seq, ids in enumerate(plans[c]):
                    req = qt.ServingRequest(
                        ids=ids, client=c, seq=seq,
                        tenant="gold" if c % 2 == 0 else "bronze")
                    sent[(c, seq)] = req
                    streams[c].put(req)
            _take(results, len(sent), ok, errors)
        finally:
            leaked = rb.stop() + server.stop()
        got = read_launches()
        check(not leaked, "QoS serving threads did not stop")
        check(not errors, f"the QoS step answered errors: "
              f"{list(errors.values())[:3]!r}")
        check(len(ok) == N_CLIENTS * PER_CLIENT, "the QoS step lost answers")
        for key, o in ok.items():
            check(o.shape == (len(sent[key].ids), CLASSES)
                  and np.isfinite(o).all(), f"QoS answer {key}")
        top = server.BUCKETS[-1]
        picks = picked_passes(server)
        for members, chunks in picks:
            total_ids = sum(len(sent[m].ids) for m in members)
            direct = np.concatenate([
                server.fused_forward(p, kw)[:min(top, total_ids - top * i)]
                .cpu().numpy() for i, (p, kw) in enumerate(chunks)])
            off = 0
            for m in members:
                n = len(sent[m].ids)
                check(np.array_equal(ok[m], direct[off: off + n]),
                      f"QoS answer {m} differs from its pass's recompute")
                off += n
        zero_launches()  # the recomputes are not the served run
        admitted = {t: _counter(tel, "serving_qos_admitted_total", tenant=t)
                    for t in ("gold", "bronze")}
        check(sum(admitted.values()) == len(sent),
              f"QoS admitted {admitted} of {len(sent)}")
        check(failovers() == 0,
              "a failover in the QoS step, which injects no fault")
        chunks = sum(len(c) for _, c in server.pass_log)
        check(got["window_sample"] == len(FANOUTS) * chunks
              and got["gather_rows"] == chunks,
              f"QoS step launches {got} for {chunks} chunks")
        device_ok += len(ok)
        stats = server.stats()
    out["qos"] = dict(tenants=QOS_TENANTS, deadline_ms=60_000.0,
                      p50_ms=stats["p50_latency_ms"],
                      p99_ms=stats["p99_latency_ms"],
                      admitted=admitted, answered_ok=len(ok),
                      passes=len(server.pass_log), chunks=chunks,
                      recomputed_passes=len(picks),
                      admit_window_ms=server._admit_window_s * 1e3,
                      launches=got, pass_2048_ms=pass_ms)
    qos.reset()
    steps_s["qos"] = time.perf_counter() - t0

    # (2) a device fault: breaker and failover through the host sampler
    t0 = time.perf_counter()
    slow_ms = 2 * pass_ms
    with config.override(serving_breaker_failures=BREAKER_FAILURES,
                         serving_breaker_reset_s=BREAKER_RESET_S,
                         flightrec_slow_ms=slow_ms, flightrec_capacity=2048):
        flightrec.reset()
        results = queue.Queue()
        q = queue.Queue()
        server = qt.InferenceServer_Debug(dev_s, feature, model, q,
                                          result_queue=results, seed=SEED,
                                          max_coalesce=1, cpu_sampler=cpu_s)
        br = server._breakers["device"] = LoggedBreaker("serving.device")
        plan = ChaosPlan(seed=SEED).fail("serving.device_lane",
                                         times=BREAKER_FAILURES)
        rng = np.random.default_rng(SEED + 21)
        sent, ok, errors = {}, {}, {}
        zero_launches()
        server.start()
        try:
            with chaos.active(plan):
                for seq in range(FAULT_REQUESTS):
                    if seq == 2 * BREAKER_FAILURES:
                        time.sleep(BREAKER_RESET_S * 1.2)
                    n = int(rng.integers(1, MAX_IDS + 1))
                    req = qt.ServingRequest(
                        ids=rng.integers(0, N_NODES, n), client=9, seq=seq)
                    sent[(9, seq)] = req
                    q.put(req)
                    _take(results, 1, ok, errors)  # one at a time
        finally:
            leaked = server.stop()
        got = read_launches()
        check(not leaked, "fault-step server threads did not stop")
        check(len(ok) + len(errors) == len(sent) and not errors,
              f"fault step: {len(ok)} ok and {len(errors)} errors for "
              f"{len(sent)} requests")
        check(br.transitions == ["open", "half_open", "closed"],
              f"the breaker went {['closed'] + br.transitions}")
        n_fail = len(server.failover_log)
        check(n_fail == 2 * BREAKER_FAILURES,
              f"{n_fail} failover answers, not {2 * BREAKER_FAILURES}")
        check(failovers() == n_fail,
              "serving_failover_total against the failover log")
        dev_chunks = sum(len(c) for _, c in server.pass_log)
        check(got["window_sample"] == len(FANOUTS) * dev_chunks
              and got["gather_rows"] == dev_chunks + n_fail,
              f"fault step launches {got} for {dev_chunks} device chunks "
              f"and {n_fail} failovers")
        device_ok += len(ok) - n_fail
        # each failover answer against a recompute of its logged batch
        for client, seq, batch in server.failover_log:
            req = sent[(client, seq)]
            again = qt.InferenceServer._infer_presampled(server, req, batch)
            check(np.array_equal(again, ok[(client, seq)]),
                  f"failover answer {seq} differs from its recompute")
        replayed = b2.gather_rows.launches
        zero_launches()
        check(replayed == n_fail, f"B2 launched {replayed} times in "
              f"{n_fail} failover recomputes")
        # one fault with no failover route: the typed error itself
        server = qt.InferenceServer_Debug(dev_s, feature, model, q,
                                          result_queue=results, seed=SEED,
                                          max_coalesce=1)
        server.start()
        try:
            with chaos.active(ChaosPlan().fail("serving.device_lane")):
                q.put(qt.ServingRequest(ids=np.arange(7), client=9,
                                        seq=FAULT_REQUESTS))
                _, err = results.get(timeout=120)
        finally:
            check(not server.stop(), "no-route server threads did not stop")
        read_launches()
        check(type(err).__name__ == "ChaosFault",
              f"the no-route fault was answered with {err!r}")
        out["fault"] = dict(requests=len(sent) + 1,
                            breaker=["closed"] + br.transitions,
                            failover_answers=n_fail,
                            device_chunks=dev_chunks,
                            failover_recompute_b2=replayed,
                            no_route_answer=type(err).__name__,
                            launches=got)
        steps_s["fault"] = time.perf_counter() - t0

        # (3) overload: a burst into small lanes under a tight deadline
        t0 = time.perf_counter()
        deadline_ms = 3 * pass_ms
        before = failovers()
        with config.override(serving_queue_depth=BURST_DEPTH,
                             serving_deadline_ms=deadline_ms):
            stream, results = queue.Queue(), queue.Queue()
            rb = qt.RequestBatcher([stream], mode="Device",
                                   result_queue=results)
            server = qt.InferenceServer_Debug(
                dev_s, feature, model, rb.device_batched_queue,
                result_queue=results, seed=SEED, cpu_sampler=cpu_s)
            rng = np.random.default_rng(SEED + 22)
            burst = [qt.ServingRequest(
                ids=rng.integers(0, N_NODES, int(rng.integers(1, MAX_IDS))),
                client=10, seq=i) for i in range(BURST)]
            zero_launches()
            rb.start()
            server.start()
            ok, errors = {}, {}
            try:
                for req in burst:
                    stream.put(req)
                _take(results, BURST, ok, errors)
            finally:
                leaked = rb.stop() + server.stop()
        got = read_launches()
        check(not leaked, "overload threads did not stop")
        kinds = {}
        for e in errors.values():
            kinds[type(e).__name__] = kinds.get(type(e).__name__, 0) + 1
        check(len(ok) + len(errors) == BURST,
              f"{len(ok) + len(errors)} answers to {BURST} requests")
        check(set(kinds) <= {"LoadShed", "DeadlineExceeded"},
              f"overload answered {kinds}")
        check(errors, "the burst shed nothing")
        check(failovers() == before,
              "a failover in the overload step, which injects no fault")
        shed = {k: v for k, v in tel.snapshot()["counters"].items()
                if k.startswith("serving_shed_total")}
        chunks = sum(len(c) for _, c in server.pass_log)
        check(got["window_sample"] == len(FANOUTS) * chunks
              and got["gather_rows"] == chunks,
              f"overload launches {got} for {chunks} chunks")
        device_ok += len(ok)
        out["overload"] = dict(burst=BURST, depth=BURST_DEPTH,
                               deadline_ms=deadline_ms, answered_ok=len(ok),
                               answered_errors=kinds, shed_by_stage=shed,
                               passes=len(server.pass_log), launches=got)
        print("overload: " + json.dumps(out["overload"]), flush=True)
        steps_s["overload"] = time.perf_counter() - t0

        # (4) observability
        t0 = time.perf_counter()
        snap = tel.snapshot()
        h = snap["histograms"].get("serving_request_seconds{lane=device}")
        n_hist = sum(h["counts"]) if h else 0
        n_ok = _counter(tel, "serving_requests_total", lane="device",
                        status="ok")
        check(n_hist == n_ok == device_ok,
              f"serving_request_seconds{{lane=device}} counts {n_hist}, "
              f"serving_requests_total {n_ok}, answers {device_ok}")
        reasons = {}
        for rec in flightrec.get_recorder().records():
            reasons[rec["reason"]] = reasons.get(rec["reason"], 0) + 1
        check({"error", "slow", "shed"} <= set(reasons),
              f"the flight recorder kept {reasons}")
        # one request on the timeline
        results, q = queue.Queue(), queue.Queue()
        server = qt.InferenceServer_Debug(dev_s, feature, model, q,
                                          result_queue=results, seed=SEED)
        server.start()
        try:
            check(timeline.enable(), "the timeline did not start")
            req = qt.ServingRequest(ids=np.arange(100), client=11, seq=0)
            q.put(req)
            _, o = results.get(timeout=120)
            timeline.disable()
            profile.enable()
            for i in range(3):
                server._run_bucketed(np.random.default_rng(i).integers(
                    0, N_NODES, 2048))
            profile.disable()
            srv = server.expose_metrics(port=0, host="127.0.0.1")
            pages = {}
            for route in ("/metrics", "/metrics.json", "/debug/requests",
                          "/debug/breakers", "/debug/qos",
                          "/debug/programs"):
                code, body = _get(srv.url + route)
                check(code == 200, f"{route} answered {code}")
                pages[route] = body
        finally:
            timeline.disable()
            profile.disable()
            check(not server.stop(), "observability threads did not stop")
        zero_launches()
        check("serving_requests_total{" in pages["/metrics"],
              "/metrics lacks serving_requests_total")
        for route in ("/metrics.json", "/debug/requests", "/debug/breakers",
                      "/debug/qos", "/debug/programs"):
            json.loads(pages[route])
        mine = [(e["name"], e["ph"])
                for e in timeline.chrome_trace()["traceEvents"]
                if e.get("args", {}).get("trace_id") == req.trace.trace_id]
        for want in (("request.enqueue", "i"), ("dequeue", "i"),
                     ("infer", "X"), ("request", "X")):
            check(want in mine, f"the timeline lacks {want}: {mine}")
        rows = {r["key"].strip("'"): r for r in profile.top_programs(50)}
        for name in ("window_sample_frontier", "gather_rows"):
            check(name in rows and rows[name]["device"],
                  f"no device row for {name} in the profile: {list(rows)}")
        out["observability"] = dict(
            device_lane_count=n_hist, flight_records=reasons,
            breakers=json.loads(pages["/debug/breakers"]),
            timeline_events=len(mine),
            profile={k: {f: v[f] for f in ("calls", "device", "mean_ms",
                                           "device_mean_ms")}
                     for k, v in rows.items()},
            metrics_bytes=len(pages["/metrics"]))
        steps_s["observability"] = time.perf_counter() - t0
    lanes = {}
    for key, d in tel.snapshot()["histograms"].items():
        if key.startswith("serving_request_seconds{"):
            hh = tel.Histogram(bounds=d["bounds"])
            hh.merge_dict(d)
            lanes[key] = dict(count=hh.count, p50_ms=hh.percentile(50) * 1e3,
                              p99_ms=hh.percentile(99) * 1e3)
    out.update(lanes=lanes, counters={
        k: v for k, v in tel.snapshot()["counters"].items()
        if k.startswith(("serving_", "chaos_"))})
    # (5) the plan's latency by arrival, QoS and telemetry; its launches
    # are not the phase's
    t0 = time.perf_counter()
    out["overhead"] = serving_overhead_ab(torch, qt, dev_s, feature, model)
    zero_launches()
    steps_s["overhead_ab"] = time.perf_counter() - t0
    out.update(steps_s=steps_s, phase_s=time.perf_counter() - t_phase,
               launches=dict(launches))
    print("resilient serving summary " + json.dumps(out), flush=True)
    flightrec.reset()
    tel.reset()
    return launches, out


def uva_phase(torch, qt, topo, train, b1) -> dict:
    """(c) UVA at ogbn-products size: ``uva_budget = edge_count * 4 // 3``
    (as ``bench.py``'s ``sampling_uva`` section sets it), fanouts
    [15, 10, 5], batches of P_BATCH train seeds.  Times the ``UVAGraph``
    build, then UVA_BATCHES batches with ``overlap=True`` (B1 counted: 3 a
    batch), the same batches with ``overlap=False``, and again with
    ``gather_mode="xla"`` (the plain hop on the hot tier, B1 never), all
    three bitwise equal; hop 1's hot rows against the device mode's hop 1,
    and ``uva_budget=None`` and an all-hot budget bitwise against the
    device mode, for the same words."""
    e = topo.edge_count
    budget = e * 4 // 3
    rng = np.random.default_rng(SEED + 30)
    kws = rng.integers(0, 2**32, (UVA_BATCHES, len(P_FANOUTS), 3),
                       dtype=np.uint32)
    seeds = [train[i * P_BATCH: (i + 1) * P_BATCH]
             for i in range(UVA_BATCHES)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    uva = qt.UVAGraph(topo, budget, device=DEV)
    torch.cuda.synchronize()
    out = dict(build_s=time.perf_counter() - t0, budget_bytes=budget,
               **uva.stats())
    runs = {}
    for label, overlap, mode, per_batch in (
            ("overlap", True, "auto", len(P_FANOUTS)),
            ("serial", False, "auto", len(P_FANOUTS)),
            ("plain", True, "xla", 0)):
        timings = {}
        s = qt.GraphSageSampler(topo, P_FANOUTS, device=DEV, mode="UVA",
                                uva_budget=budget, uva_overlap=overlap,
                                uva_timings=timings, gather_mode=mode)
        s._uva = uva  # the runs share the split built and timed above
        s.sample(seeds[0], key_words=kws[0])  # warm
        timings.clear()
        before = feature_counters(qt)
        b1.window_sample.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batches = [s.sample(seeds[i], key_words=kws[i])
                   for i in range(UVA_BATCHES)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = b1.window_sample.launches
        check(launches == per_batch * UVA_BATCHES,
              f"UVA {label}: B1 launched {launches} times for "
              f"{UVA_BATCHES} batches")
        seeds_by = counters_added(qt, before)
        hot = seeds_by.get("uva_seeds_total{tier=hot}", 0.0)
        cold = seeds_by.get("uva_seeds_total{tier=cold}", 0.0)
        runs[label] = batches
        out[label] = dict(
            ms_per_batch=wall * 1e3 / UVA_BATCHES,
            host_ms_per_batch=timings.get("host_s", 0.0) * 1e3 / UVA_BATCHES,
            hot_seed_share=hot / max(hot + cold, 1.0),
            cold_seed_share=cold / max(hot + cold, 1.0), b1_launches=launches)
    out["serial_over_overlap"] = (out["serial"]["ms_per_batch"]
                                  / out["overlap"]["ms_per_batch"])
    for i, a in enumerate(runs["overlap"]):
        check_same_batch(torch, a, runs["serial"][i],
                         f"UVA batch {i}, overlap on and off")
        check_same_batch(torch, a, runs["plain"][i],
                         f"UVA batch {i}, B1 against the plain hop")
    # hop 1: the hot seeds' rows equal the device mode's for the same words
    hop1 = qt.GraphSageSampler(topo, P_FANOUTS[:1], device=DEV,
                               gather_mode="xla")
    d = hop1.sample(seeds[0], key_words=kws[0][:1, :2])
    u = runs["overlap"][0]
    hot = torch.from_numpy(uva.is_hot[seeds[0]]).to(DEV)
    ub, db = u.layers[-1], d.layers[-1]
    check(torch.equal(ub.mask[hot], db.mask[hot]),
          "UVA hop 1 hot-row masks differ from the device mode's")
    check(torch.equal(u.n_id[ub.nbr_local.long()][hot],
                      d.n_id[db.nbr_local.long()][hot]),
          "UVA hop 1 hot-row neighbours differ from the device mode's")
    out["hop1_hot_rows_checked"] = int(hot.sum())
    device_mode = qt.GraphSageSampler(topo, P_FANOUTS, device=DEV)
    want = device_mode.sample(seeds[0], key_words=kws[0][:, :2])
    none = qt.GraphSageSampler(topo, P_FANOUTS, device=DEV, mode="UVA")
    check(none.mode == "GPU", "uva_budget=None is not the device mode")
    check_same_batch(torch, none.sample(seeds[0], key_words=kws[0][:, :2]),
                     want, "uva_budget=None against the device mode")
    allhot = qt.GraphSageSampler(topo, P_FANOUTS, device=DEV, mode="UVA",
                                 uva_budget=e * 4)
    check_same_batch(torch, allhot.sample(seeds[0], key_words=kws[0]), want,
                     "an all-hot UVA budget against the device mode")
    check(allhot._uva.cold_edges == 0, "all-hot budget left cold edges")
    print("UVA at ogbn-products size " + json.dumps(out), flush=True)
    return out


def mixed_phase(torch, qt, topo, train) -> dict:
    """(d) ``MixedGraphSageSampler("TPU_CPU_MIXED")`` at products size:
    MIXED_TASKS tasks of P_BATCH seeds for 2 epochs, every task yielded
    once an epoch; the CPU share each epoch."""
    from quiver_tpu_torch.mixed import RangeSampleJob

    job = RangeSampleJob(train[: MIXED_TASKS * P_BATCH].copy(), P_BATCH,
                         seed=SEED)
    mixed = qt.MixedGraphSageSampler(topo, P_FANOUTS, job, device=DEV,
                                     mode="TPU_CPU_MIXED",
                                     num_workers=MIXED_WORKERS)
    out = []
    for epoch in range(2):
        share = mixed._decide_cpu_share(len(job))
        seen, sources = [], {"tpu": 0, "cpu": 0}
        t0 = time.perf_counter()
        for batch, src in mixed:
            seen.append(tuple(batch.n_id[: batch.batch_size].cpu().tolist()))
            sources[src] += 1
            check(batch.n_id.device.type == "cuda",
                  f"mixed {src} batch not on the card")
        wall = time.perf_counter() - t0
        tasks = sorted(tuple(job[i].tolist()) for i in range(len(job)))
        check(sorted(seen) == tasks,
              f"mixed epoch {epoch}: tasks not yielded once each")
        check(sources["cpu"] == share, f"mixed epoch {epoch}: CPU share")
        out.append(dict(epoch=epoch, cpu_share=share / len(job),
                        sources=sources, epoch_s=wall,
                        avg_device_task_ms=mixed.avg_tpu_time * 1e3,
                        avg_cpu_task_ms=mixed.avg_cpu_time * 1e3))
    print("mixed sampler at ogbn-products size " + json.dumps(out),
          flush=True)
    return {"epochs": out}


def interop_phase(torch, qt, topo, feat, labels, train, b2) -> dict:
    """(e) LOADER_BATCHES ``TorchSampleLoader`` batches at products size
    on the card (the whole table in degree order: B2 once a batch): ``x``
    bitwise the source rows of ``n_id``, ``y`` the seeds' labels, the
    edge lists int64 on the card."""
    feature = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                         device=DEV).from_cpu_tensor(feat)
    sampler = qt.GraphSageSampler(topo, P_FANOUTS, device=DEV, seed=SEED)
    loader = qt.TorchSampleLoader(train, sampler, feature, labels=labels,
                                  batch_size=P_BATCH, seed=SEED)
    b2.gather_rows.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # islice asks the loader for no batch past the last one kept
    got = list(itertools.islice(loader, LOADER_BATCHES))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = b2.gather_rows.launches
    for i, (n_id, bs, adjs, x, y) in enumerate(got):
        host_ids = n_id.cpu().numpy()
        check(x.device.type == "cuda" and n_id.device.type == "cuda",
              "loader batch not on the card")
        check(torch.equal(x.cpu(), torch.from_numpy(feat[host_ids])),
              f"loader batch {i}: x differs from the source rows")
        check(np.array_equal(y.cpu().numpy(), labels[host_ids[:bs]]),
              f"loader batch {i}: labels differ")
        check(len(adjs) == len(P_FANOUTS) and all(
            ei.dtype == torch.int64 for ei, _, _ in adjs),
              f"loader batch {i}: edge lists")
        check(all(ei.device.type == "cuda" for ei, _, _ in adjs),
              f"loader batch {i}: edge lists not on the card")
    check(len(got) == LOADER_BATCHES, "loader batches")
    check(launches == LOADER_BATCHES,
          f"B2 launched {launches} times for {LOADER_BATCHES} loader batches")
    out = dict(batches=LOADER_BATCHES, ms_per_batch=wall * 1e3 / len(got),
               b2_launches=launches)
    print("TorchSampleLoader at ogbn-products size " + json.dumps(out),
          flush=True)
    return out


# slice 11: streaming serving under ingest, durability, warm restart
STREAM_INSERTS = 8192       # edge inserts ingested while the plan is served
STREAM_BATCH = 64           # edges an insert or delete request carries
STREAM_DELETES = 1024       # existing base edges deleted while serving
STREAM_PROBES = 256         # seeds whose every live neighbour a hop draws
STREAM_PROBE_INSERTS = 8    # inserts onto each probe seed (degree <= 17)
STREAM_TAIL = 1024          # inserts after the checkpoint, replayed at boot
STREAM_TAIL_DELETES = 64    # base deletes after the checkpoint, replayed
STREAM_TS_MAX = 2**30       # per-edge timestamps in [0, STREAM_TS_MAX)
STREAM_WINDOW = (STREAM_TS_MAX // 4, 3 * STREAM_TS_MAX // 4)
STREAM_INFLIGHT = 16        # ingest requests in flight at once
STREAM_RESTORE_IDS = 256   # rows gathered through the "200M" feature


def same_draws(torch, got, want, what: str):
    """``check_same_sample`` and every block's ``eid``."""
    check_same_sample(torch, got, want, what)
    for i, (a, b) in enumerate(zip(got[3], want[3])):
        check(torch.equal(a.eid, b.eid), f"{what}: block {i} eid differs")


def _delete_positions(rng, base, rows, n):
    """``n`` distinct base edge positions: one of each of ``rows`` that
    has an edge, the rest random."""
    first = base.indptr[rows][base.degree[rows] > 0]
    rest = rng.choice(base.edge_count, 4 * n, replace=False)
    pos = np.concatenate([first, rest[~np.isin(rest, first)]])[:n]
    check(len(np.unique(pos)) == n, "delete positions repeat")
    return pos


def _row_of(base, pos):
    return np.searchsorted(base.indptr, pos, side="right") - 1


def overlay_hop_case(torch, snap, seeds, fmask, k, kw, window, b3) -> dict:
    """One overlay hop through B3 (``"pwindow"``) against its plain
    version (``"xla"``) on the card, bitwise, with its launches."""
    from quiver_tpu_torch.ops.sample import sample_neighbors_overlay

    args = (snap.indptr, snap.indices, snap.tomb, snap.d_indptr,
            snap.d_indices, seeds, k, int(kw[0]), int(kw[1]), fmask,
            snap.base_ts, snap.d_ts, window)
    b3.element_gather.launches = 0
    got = sample_neighbors_overlay(*args, "pwindow")
    launches = b3.element_gather.launches
    check(launches == (7 if window else 5),
          f"overlay hop launched B3 {launches} times")
    want = sample_neighbors_overlay(*args, "xla")
    for name, a, b in zip(("nbrs", "mask", "counts", "eid"), got, want):
        check(torch.equal(a, b), f"overlay hop k={k}: {name} differs "
              "from its plain version")
    m = got.mask
    return dict(
        k=k, seeds=int(seeds.shape[0]), windowed=window is not None,
        b3_launches=launches, max_abs_err=0,
        delta_draws=int((got.eid[m] >= snap.epad).sum()),
        masked=int((~m).sum()),
        ms=cuda_ms(torch, lambda: sample_neighbors_overlay(*args,
                                                           "pwindow")),
        plain_ms=cuda_ms(torch, lambda: sample_neighbors_overlay(*args,
                                                                 "xla")))


def streaming_phase(torch, qt, topo, feat, feature, b1, b2, b3, b5):
    """Slice 11 on the card: Reddit as a ``StreamingGraph`` with per-edge
    timestamps, served while it ingests, folded, checkpointed and booted
    again.  Returns the main path's launches and a summary."""
    import shutil
    from collections import Counter

    from quiver_tpu_torch import telemetry
    from quiver_tpu_torch.recovery.checkpoint import read_checkpoint
    from quiver_tpu_torch.telemetry.registry import metric_key
    from quiver_tpu_torch.recovery.manager import RecoveryManager
    from quiver_tpu_torch.stream import IngestLane, StreamingGraph, compact

    dev = torch.device(DEV)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_stream")
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(SEED + 11)
    out = dict(card=card_line())
    # its own CSRTopo over the same host arrays: a fold invalidates the
    # base it replaces, and the other phases keep theirs
    base = qt.CSRTopo(indptr=topo.indptr, indices=topo.indices)
    ts = rng.integers(0, STREAM_TS_MAX, base.edge_count, dtype=np.int32)
    g = StreamingGraph(base, edge_ts=ts, device=DEV)
    check(g._delta.capacity == 65_536, "delta capacity is not the default")
    g.attach_feature(feature)
    t0 = time.perf_counter()
    g.snapshot()
    torch.cuda.synchronize()
    out["first_snapshot_s"] = time.perf_counter() - t0
    try:
        # (1) zero deltas: the overlay (B3) against the frozen pass (B1)
        seeds = torch.from_numpy(
            rng.integers(0, N_NODES, 2048).astype(np.int32)).to(dev)
        kw = rng.integers(0, 2**32, (2, 2), dtype=np.uint32)
        stream = qt.GraphSageSampler(g, FANOUTS, device=DEV, return_eid=True)
        frozen = qt.GraphSageSampler(base, FANOUTS, device=DEV, dedup="none",
                                     return_eid=True)
        check(stream.gather_mode == "pwindow", stream.gather_mode)
        b3.element_gather.launches = 0
        got = stream.pipeline(seeds, kw)
        b3_zero = b3.element_gather.launches
        b1.window_sample.launches = 0
        want = frozen.pipeline(seeds, kw)
        b1_zero = b1.window_sample.launches
        check(b3_zero == 5 * len(FANOUTS) and b1_zero == len(FANOUTS),
              f"zero-delta pass: B3 {b3_zero}, B1 {b1_zero} launches")
        same_draws(torch, got, want, "zero-delta overlay (B3) vs B1")
        out["zero_delta"] = dict(
            bitwise_equal=True, b3_launches=b3_zero, b1_launches=b1_zero,
            overlay_pass_ms=cuda_ms(torch, lambda: stream.pipeline(seeds,
                                                                   kw)),
            frozen_pass_ms=cuda_ms(torch, lambda: frozen.pipeline(seeds,
                                                                  kw)))
        print("zero-delta overlay pass " + json.dumps(out["zero_delta"]),
              flush=True)

        # (2) the overlay hop against its plain version, with deltas,
        # tombstones and a window; the snapshot build time
        hubs = np.argsort(base.degree)[-4:]
        src = np.concatenate([rng.integers(0, N_NODES, 2048),
                              np.repeat(hubs, 16)])
        dst = rng.integers(0, N_NODES, len(src))
        g.add_edges(src, dst, ts=rng.integers(0, STREAM_TS_MAX, len(src)))
        pos = _delete_positions(rng, base, np.array([], np.int64), 256)
        check(g.remove_edges(_row_of(base, pos), base.indices[pos]) == 256,
              "base deletes")
        g.remove_edges(src[:32], dst[:32])
        build = []
        for i in range(3):
            g.add_edges([i], [i + 1], ts=[0])
            t0 = time.perf_counter()
            snap = g.snapshot()
            torch.cuda.synchronize()
            build.append(time.perf_counter() - t0)
        out["snapshot_build_s"] = build
        n_id, n_mask = stream.pipeline(seeds, kw, snapshot=snap)[:2]
        t2 = 2048 * (1 + FANOUTS[0])
        cases = []
        for window in (None, STREAM_WINDOW):
            cases.append(overlay_hop_case(torch, snap, seeds, None,
                                          FANOUTS[0], kw[0], window, b3))
            cases.append(overlay_hop_case(torch, snap, n_id[:t2],
                                          n_mask[:t2], FANOUTS[1], kw[1],
                                          window, b3))
        check(all(c["delta_draws"] > 0 for c in cases), "no delta drawn")
        for window in (None, STREAM_WINDOW):
            plain = qt.GraphSageSampler(g, FANOUTS, device=DEV,
                                        gather_mode="xla", return_eid=True)
            same_draws(torch, stream.pipeline(seeds, kw, snapshot=snap,
                                              time_window=window),
                       plain.pipeline(seeds, kw, snapshot=snap,
                                      time_window=window),
                       f"overlay pass window={window} vs xla")
        out["overlay_hops"] = cases
        out["fold_idle"] = compact(g)
        print("overlay hops (B3 vs plain, bitwise) " + json.dumps(
            dict(snapshot_build_s=build, cases=cases,
                 fold_idle=out["fold_idle"])), flush=True)

        # (3) serve the plan while the lane ingests, durably, with one
        # fold mid-traffic
        mgr = RecoveryManager(os.path.join(root, "r"),
                              graph_factory=lambda: g)
        check(mgr.boot() is g, "the manager booted another graph")
        lane = IngestLane(g).start()
        mgr.attach_lane(lane)
        wal_s = []
        append = mgr.wal.append

        def timed_append(payload):
            t0 = time.perf_counter()
            lsn = append(payload)
            wal_s.append(time.perf_counter() - t0)
            return lsn

        mgr.wal.append = timed_append
        cur = g.base
        cand = np.nonzero(cur.degree <= FANOUTS[0] - STREAM_PROBE_INSERTS)[0]
        probes = rng.choice(cand, STREAM_PROBES, replace=False)
        # the other inserts avoid the probe rows, so a probe row never
        # holds more than FANOUTS[0] edges, tombstoned ones included
        others = np.setdiff1d(np.arange(N_NODES), probes)
        isrc = np.concatenate([np.repeat(probes, STREAM_PROBE_INSERTS),
                               rng.choice(others, STREAM_INSERTS
                                          - STREAM_PROBES
                                          * STREAM_PROBE_INSERTS)])
        isrc = isrc[rng.permutation(len(isrc))]
        check((cur.degree[probes] + np.bincount(
            isrc, minlength=N_NODES)[probes]).max() <= FANOUTS[0],
              "a probe row could exceed the fanout")
        idst = rng.integers(0, N_NODES, STREAM_INSERTS)
        its = rng.integers(0, STREAM_TS_MAX, STREAM_INSERTS)
        dpos = _delete_positions(rng, cur, probes, STREAM_DELETES)
        dsrc, ddst = _row_of(cur, dpos), cur.indices[dpos].astype(np.int64)
        ops = []
        for i in range(0, STREAM_INSERTS, STREAM_BATCH):
            ops.append(("add", isrc[i:i + STREAM_BATCH],
                        idst[i:i + STREAM_BATCH], its[i:i + STREAM_BATCH]))
            if (i // STREAM_BATCH) % 8 == 7:
                j = len([o for o in ops if o[0] == "remove"]) * STREAM_BATCH
                ops.append(("remove", dsrc[j:j + STREAM_BATCH],
                            ddst[j:j + STREAM_BATCH], None))
        check(sum(len(o[1]) for o in ops if o[0] == "remove")
              == STREAM_DELETES, "delete plan")
        acks, ingest_err, folds = {}, [], {}
        submitted = {}
        span = {}
        done = threading.Event()

        def take():
            item, outcome = lane.results.get(timeout=120)
            acks[submitted[id(item)]] = outcome

        def fold():
            while len(acks) < len(submitted):
                take()  # drained: every ack's version is exact
            span["fold"] = time.perf_counter()
            folds["mid"] = compact(g)

        def ingest():
            try:
                span["start"] = time.perf_counter()
                for i, (op, s_, d_, t_) in enumerate(ops):
                    if i == len(ops) // 2:
                        fold()
                    upd = lane.submit(s_, d_, ts=t_, op=op)
                    submitted[id(upd)] = i
                    while len(submitted) - len(acks) >= STREAM_INFLIGHT:
                        take()
                    time.sleep(0.001)
                while len(acks) < len(ops):
                    take()
                span["end"] = time.perf_counter()
            except BaseException as e:  # surfaced after the join
                ingest_err.append(e)

        probe_seeds = torch.from_numpy(np.concatenate(
            [probes, rng.integers(0, N_NODES, 1024 - STREAM_PROBES)]).astype(
                np.int32)).to(dev)
        # the probe draws through the plain hop ("xla", no kernel): B3's
        # launch count stays the served traffic's own, and B3 is held
        # bitwise against the plain hop in (2)
        sampler_p = qt.GraphSageSampler(g, FANOUTS, device=DEV,
                                        gather_mode="xla", return_eid=True,
                                        seed=SEED + 12)
        samples, probe_err = [], []

        def probe_once():
            snap = g.snapshot()
            n_id, _, _, blocks, _ = sampler_p.pipeline(
                probe_seeds, sampler_p.draw_key_words(), snapshot=snap)
            dead = 0
            for blk in blocks:  # every hop, every seed
                e = blk.eid[blk.mask]
                dead += int(snap.tomb[e[e < snap.epad]].sum())
            first = n_id[1024:1024 + STREAM_PROBES * FANOUTS[0]]
            samples.append((snap.version, dead,
                            first.view(STREAM_PROBES, -1).cpu().numpy(),
                            blocks[-1].mask[:STREAM_PROBES].cpu().numpy()))

        def probe():
            try:
                while not done.is_set():
                    probe_once()
                    time.sleep(0.05)
            except BaseException as e:  # surfaced after the join
                probe_err.append(e)

        threads = [threading.Thread(target=ingest),
                   threading.Thread(target=probe)]
        serve_sampler = qt.GraphSageSampler(g, FANOUTS, device=DEV,
                                            seed=SEED)
        model = seeded_model(torch, qt)
        served = {}

        def during():
            served["start"] = time.perf_counter()
            for t in threads:
                t.start()

        server, answers, _, launches, _, summary = serve(
            torch, qt, serve_sampler, feature, model,
            {"element_gather": b3.element_gather,
             "gather_rows": b2.gather_rows}, during=during)
        threads[0].join(timeout=300)
        done.set()
        threads[1].join(timeout=60)
        check(not any(t.is_alive() for t in threads), "stream threads hang")
        check(not ingest_err, f"ingest failed: {ingest_err!r}")
        check(not probe_err, f"a probe sample failed: {probe_err!r}")
        probe_once()  # at the last acked version
        bad = [i for i, o in acks.items()
               if not (isinstance(o, tuple) and o[0] == "ok"
                       and o[1] == len(ops[i][1]))]
        check(len(acks) == len(ops) and not bad,
              f"{len(acks)} of {len(ops)} updates acked; not ok: {bad[:5]}")
        last = max(o[2] for o in acks.values())
        check(samples[-1][0] >= last, "no probe sample after the last ack")
        check(folds.get("mid", {}).get("folded", 0) > 0,
              "the mid-traffic fold folded nothing")
        # every probe sample against the acked ops: a probe row's first
        # hop draws every live neighbour, so its multiset is exactly the
        # row before ingest, less the acked deletes, plus the acked
        # inserts, of every op acked at the sample's version or before
        col = {int(p): i for i, p in enumerate(probes)}
        want = {p: Counter(cur.indices[cur.indptr[p]:cur.indptr[p + 1]]
                           .tolist()) for p in col}
        order = sorted(acks, key=lambda i: acks[i][2])
        k = checked = visible = 0
        for version, dead, first, mask in sorted(samples,
                                                 key=lambda x: x[0]):
            check(dead == 0, f"a tombstoned edge was drawn at v{version}")
            while k < len(order) and acks[order[k]][2] <= version:
                op, s_, d_, _t = ops[order[k]]
                for u, v in zip(s_.tolist(), d_.tolist()):
                    if u in want:
                        want[u][v] += 1 if op == "add" else -1
                k += 1
            for p, c in want.items():
                drawn = Counter(first[col[p]][mask[col[p]]].tolist())
                check(drawn == +c, f"probe {p} at v{version}: drew "
                      f"{sorted(drawn.elements())}, live "
                      f"{sorted((+c).elements())}")
                checked += 1
                visible += sum(n for v, n in c.items() if n > 0)
        # drained: a fold, and a pass that arrives 50 ms into it waits
        # for the graph lock; then the next pass is a frozen pass on g.base
        fold_out = {}
        folder = threading.Thread(target=lambda: fold_out.update(compact(g)))
        padded = server._pad_ids(rng.integers(0, N_NODES, MAX_IDS))
        pkw = server.draw_key_words()
        folder.start()
        time.sleep(0.05)
        t0 = time.perf_counter()
        server.fused_forward(padded, pkw).cpu()
        out["pass_during_fold_s"] = time.perf_counter() - t0
        folder.join(timeout=120)
        check(not folder.is_alive() and fold_out, "the drained fold failed")
        out["fold_drained"] = fold_out
        post = qt.GraphSageSampler(g.base, FANOUTS, device=DEV, dedup="none",
                                   return_eid=True)
        same_draws(torch, stream.pipeline(seeds, kw), post.pipeline(seeds,
                                                                    kw),
                   "the folded stream pass vs a frozen pass on g.base")
        stats = summary["stats"]
        out["serving"] = dict(
            requests=len(answers), acks=len(acks),
            updates=dict(inserts=STREAM_INSERTS, deletes=STREAM_DELETES,
                         requests=len(ops)),
            p50_ms=stats.get("p50_latency_ms"),
            p99_ms=stats.get("p99_latency_ms"),
            passes=summary["passes"], served_s=summary["served_s"],
            ingest_s=span["end"] - span["start"],
            ingest_started_after_serving_s=span["start"] - served["start"],
            fold_mid_started_after_serving_s=span["fold"] - served["start"],
            pass_during_fold_s=out["pass_during_fold_s"],
            launches=launches, fold_mid=folds["mid"],
            wal_append_p50_ms=float(np.median(wal_s)) * 1e3,
            wal_append_p99_ms=float(np.percentile(wal_s, 99)) * 1e3,
            wal_appends=len(wal_s), probe_samples=len(samples),
            probe_rows_checked=checked, probe_neighbours_checked=visible,
            version=g.version)
        print("serving under ingest " + json.dumps(out["serving"]),
              flush=True)

        # (4) warm restart: checkpoint through the lane's barrier, a tail
        # of inserts and deletes, close, boot from the directory
        fb = budgeted_feature(qt, topo, feat)
        ids = rng.integers(0, N_NODES, STREAM_RESTORE_IDS)
        rows_fb = fb[ids]
        check(fb.paged.fallbacks == 0, "the restore gather overflowed")
        check(mgr.attach_feature("reddit_200M", fb) == 0, "a stale restore")
        t0 = time.perf_counter()
        path = mgr.checkpoint()
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ck = read_checkpoint(path)
        verify_s = time.perf_counter() - t0
        check(ck.graph_version == g.version, "checkpoint version")
        tail_src = rng.integers(0, N_NODES, STREAM_TAIL)
        tail_dst = rng.integers(0, N_NODES, STREAM_TAIL)
        tail_ts = rng.integers(0, STREAM_TS_MAX, STREAM_TAIL)
        tpos = rng.choice(g.base.edge_count, STREAM_TAIL_DELETES,
                          replace=False)
        tail = [lane.submit(tail_src[i:i + STREAM_BATCH],
                            tail_dst[i:i + STREAM_BATCH],
                            ts=tail_ts[i:i + STREAM_BATCH])
                for i in range(0, STREAM_TAIL, STREAM_BATCH)]
        tail.append(lane.submit(_row_of(g.base, tpos),
                                g.base.indices[tpos], op="remove"))
        for _ in tail:
            _, o = lane.results.get(timeout=120)
            check(isinstance(o, tuple) and o[0] == "ok", f"tail op: {o!r}")
        live = dict(indptr=g.base.indptr, indices=g.base.indices,
                    base_ts=g._base_ts, tomb=g._tomb.copy(),
                    delta=g._delta.live_edges(), version=g.version)
        check(live["tomb"].sum() == STREAM_TAIL_DELETES, "tail tombstones")
        live_pass = [t.cpu() if isinstance(t, torch.Tensor) else t
                     for t in stream.pipeline(seeds, kw)[:3]]
        lane.stop()
        mgr.close()
        g.close()
        del g, lane, stream, frozen, post, server, serve_sampler, sampler_p
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mgr2 = RecoveryManager(os.path.join(root, "r"))
        g2 = mgr2.boot()
        boot_s = time.perf_counter() - t0
        health = mgr2.health()
        check(health["state"] == "serving" and health["ready"],
              f"health after boot {health}")
        check(health["replayed_records"] == len(tail),
              f"replayed {health['replayed_records']} of {len(tail)}")
        for name in ("indptr", "indices"):
            check(np.array_equal(getattr(g2.base, name), live[name]),
                  f"restored base {name} differs")
        check(np.array_equal(g2._base_ts, live["base_ts"]),
              "restored timestamps differ")
        check(np.array_equal(g2._tomb, live["tomb"]), "restored tomb differs")
        for a, b in zip(g2._delta.live_edges(), live["delta"]):
            check(np.array_equal(a, b), "restored delta order differs")
        check(g2.version == live["version"], "restored version differs")
        s2 = qt.GraphSageSampler(g2, FANOUTS, device=DEV, return_eid=True)
        again = s2.pipeline(seeds, kw)[:3]
        for name, a, b in zip(("n_id", "n_id_mask", "num_nodes"), again,
                              live_pass):
            check(torch.equal(a.cpu(), b), f"restored pass: {name} differs")
        fb2 = budgeted_feature(qt, topo, feat)
        warmed = mgr2.attach_feature("reddit_200M", fb2)
        check(warmed > 0, "the coldcache restore warmed nothing")
        faults = feature_counters(qt).get("feature_page_faults_total", 0)
        b5.page_gather.launches = 0
        rows_fb2 = fb2[ids]
        b5_restore = b5.page_gather.launches
        check(b5_restore > 0, "B5 was not launched on the restored pages")
        check(feature_counters(qt).get("feature_page_faults_total", 0)
              == faults, "restored pages faulted again")
        src_rows = torch.from_numpy(feat[ids]).to(dev)
        check(torch.equal(rows_fb2, src_rows) and torch.equal(rows_fb,
                                                              src_rows),
              "restored rows differ from a fresh gather")
        res = fb2.paged.table.cache.node_of >= 0
        frames = fb.paged.table.hot_pages + np.nonzero(res)[0]
        check(torch.equal(fb2.paged.frames[frames], fb.paged.frames[frames]),
              "refilled pages differ from the faulted ones")
        out["restart"] = dict(
            checkpoint_bytes=os.path.getsize(path),
            checkpoint_write_s=write_s, checkpoint_verify_s=verify_s,
            boot_s=boot_s,
            replay_s=telemetry.snapshot()["gauges"].get(
                metric_key("recovery_replay_seconds", {})),
            replayed_records=health["replayed_records"],
            version=live["version"], pending=len(live["delta"][0]),
            tombstones=int(live["tomb"].sum()), coldcache_rows=warmed,
            b5_launches=b5_restore, bitwise_equal=True)
        print("warm restart " + json.dumps(out["restart"]), flush=True)
        mgr2.close()
        g2.close()
        del g2, s2, fb, fb2
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = dict(launches, page_gather=b5_restore)
    print("streaming serving summary " + json.dumps(out), flush=True)
    return launches, out


MESH_SHARDS = 4             # row shards of the mesh phase, all on card 0
DP_REPLICAS = 2             # data-parallel replicas of the products step
DP_STEPS = 10
# bf16 model against the fp32 model on the same rows: |delta| at most this
# share of the fp32 logits' largest magnitude (ROADMAP §C)
BF16_VS_FP32 = 2.0 ** -5


def plan_passes(bucket: int = 2048):
    """The 64-request plan's ids in request order, cut into passes of
    ``bucket`` seeds (the last padded with its first id): ``[(seeds,
    real)]``."""
    _, plans = request_plan()
    ids = np.concatenate([r for plan in plans for r in plan])
    out = []
    for i in range(0, len(ids), bucket):
        p = ids[i:i + bucket]
        real = len(p)
        if real < bucket:
            p = np.concatenate([p, np.full(bucket - real, p[0])])
        out.append((p.astype(np.int64), real))
    return out


def positional_pass(torch, qt, hop, seeds, kw, fanouts):
    """The positional pipeline over ``hop(frontier, k, words) ->
    SampleOut``: ``(frontier, blocks outermost first, hop outputs)``."""
    frontier = seeds.to(torch.int32)
    blocks, outs = [], []
    for l, k in enumerate(fanouts):
        F = frontier.shape[0]
        o = hop(frontier, k, kw[l])
        dev = frontier.device
        pos = (F + torch.arange(F, dtype=torch.int32, device=dev)[:, None] * k
               + torch.arange(k, dtype=torch.int32, device=dev))
        blocks.append(qt.LayerBlock(
            nbr_local=torch.where(o.mask, pos, torch.zeros_like(pos)),
            mask=o.mask,
            num_targets=torch.full((), F, dtype=torch.int32, device=dev)))
        outs.append(o)
        frontier = torch.cat([frontier, torch.where(
            o.mask, o.nbrs, torch.zeros_like(o.nbrs)).reshape(-1)])
    return frontier, tuple(blocks[::-1]), outs


def wall_ms(torch, fn):
    """Host milliseconds of ``fn()`` with the card drained before and
    after: the sharded paths are host loops over shards, so their cost is
    wall time, not one kernel's."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def warm_wall_ms(torch, fn, reps: int = 3) -> float:
    """Median :func:`wall_ms` of ``fn`` over ``reps`` calls after the
    caller's first (which pays the first use of each torch op)."""
    return float(np.median([wall_ms(torch, fn)[1] for _ in range(reps)]))


def sharding_phase(torch, qt, topo, feat, feature, b1, b2, b3):
    """Phase 4g (slice 12): the Reddit plan through ``MeshSampler``
    (``"pallas"``: B3 five launches a hop a shard) and ``MeshFeature``
    (B2 once a shard a gather) over MESH_SHARDS shards that all name card
    0, every hop and row bitwise the single-device path's (B1 hops,
    ``lookup_device``), logits within CPU_TOL; then ``DistFeature``,
    ``RingFeature`` and ``HierFeature`` lookups of ``[4, 2048]`` ids
    bitwise the table's, and ``DistGraphSampler`` [25, 10] under
    ``"blocked"`` (B3) bitwise its ``"xla"`` run with no drops."""
    from quiver_tpu_torch.mesh import MeshFeature, MeshSampler
    from quiver_tpu_torch.ops.sample import run_hop
    from quiver_tpu_torch.utils.mesh import Mesh

    card = torch.device(DEV)
    out = dict(card=card_line(), shards=MESH_SHARDS)
    mesh = qt.make_mesh(("shard",), devices=[card] * MESH_SHARDS)
    (ms, mf), build_ms = wall_ms(torch, lambda: (
        MeshSampler(topo.indptr, topo.indices, n_shards=MESH_SHARDS,
                    mesh=mesh, gather_mode="pallas"),
        MeshFeature(feat, n_shards=MESH_SHARDS, mesh=mesh)))
    out["build_ms"] = build_ms
    model = seeded_model(torch, qt).to(DEV).eval()
    passes = plan_passes()
    rng = np.random.default_rng(SEED + 50)
    kws = [rng.integers(0, 2**32, (len(FANOUTS), 2), dtype=np.uint32)
           for _ in passes]
    mf[np.arange(N_NODES)]  # first touch: every page faults in once
    torch.cuda.synchronize()

    def mesh_hop(f, k, w):
        return ms.sample(f, k, w)

    # the counted run: the mesh path alone
    for fn in (b1.window_sample, b2.gather_rows, b3.element_gather):
        fn.launches = 0
    got, times = [], dict(hop=[], gather=[], logits=[])
    with torch.inference_mode():
        for (seeds, real), kw in zip(passes, kws):
            sd = torch.from_numpy(seeds).to(DEV)
            (front, blocks, outs), t_hop = wall_ms(
                torch, lambda: positional_pass(torch, qt, mesh_hop, sd, kw,
                                               FANOUTS))
            x, t_g = wall_ms(torch, lambda: mf[front])
            y, t_m = wall_ms(torch, lambda: model(x, blocks)[:real])
            times["hop"].append(t_hop)
            times["gather"].append(t_g)
            times["logits"].append(t_m)
            got.append((front, outs, x, y))
    launches = dict(window_sample=b1.window_sample.launches,
                    gather_rows=b2.gather_rows.launches,
                    element_gather=b3.element_gather.launches)
    check(launches["window_sample"] == 0, "the mesh path launched B1")
    check(launches["gather_rows"] == MESH_SHARDS * len(passes),
          f"B2 launched {launches['gather_rows']} times, not once a shard "
          "a pass")
    check(launches["element_gather"]
          == 5 * MESH_SHARDS * len(FANOUTS) * len(passes),
          f"B3 launched {launches['element_gather']} times, not 5 a hop a "
          "shard")
    # the single-device path on the same words: B1 hops, one B2 lookup
    ip, ix = topo.to_device(DEV)

    def single_hop(f, k, w):
        return run_hop(ip, ix, f, k, int(w[0]), int(w[1]), None, "pwindow",
                       "hash")

    ref_times = dict(hop=[], gather=[])
    with torch.inference_mode():
        for (seeds, real), kw, (front, outs, x, y) in zip(passes, kws, got):
            sd = torch.from_numpy(seeds).to(DEV)
            (rfront, rblocks, routs), t_hop = wall_ms(
                torch, lambda: positional_pass(torch, qt, single_hop, sd, kw,
                                               FANOUTS))
            for h, (a, b) in enumerate(zip(outs, routs)):
                for f in ("nbrs", "mask", "counts", "eid"):
                    check(torch.equal(getattr(a, f), getattr(b, f)),
                          f"mesh hop {h} {f} differs from the single-device "
                          "hop")
            check(torch.equal(front, rfront), "mesh frontier differs")
            rx, t_g = wall_ms(torch, lambda: feature.lookup_device(rfront))
            check(torch.equal(x, rx), "mesh rows differ from lookup_device")
            ry = model(rx, rblocks)[:real]
            check(torch.allclose(y, ry, **CPU_TOL),
                  "mesh logits differ from the single-device logits")
            check(bool(torch.isfinite(y).all()), "mesh logits not finite")
            ref_times["hop"].append(t_hop)
            ref_times["gather"].append(t_g)
    del got
    torch.cuda.empty_cache()
    med = lambda v: float(np.median(v))  # noqa: E731
    out.update(passes=len(passes), launches=launches,
               mesh_ms=dict(two_hops=med(times["hop"]),
                            gather=med(times["gather"]),
                            model=med(times["logits"])),
               single_ms=dict(two_hops=med(ref_times["hop"]),
                              gather=med(ref_times["gather"])),
               mesh_stats=dict(restacks=mf.restacks, fallbacks=mf.fallbacks))
    print(f"mesh plan over {MESH_SHARDS} shards on {out['card']}: "
          f"{len(passes)} bucket-2048 passes bitwise the single-device "
          f"path; ms a pass (wall) two hops {out['mesh_ms']['two_hops']:.2f}"
          f" vs {out['single_ms']['two_hops']:.2f}, gather "
          f"{out['mesh_ms']['gather']:.2f} vs "
          f"{out['single_ms']['gather']:.2f}; launches "
          f"{json.dumps(launches)}", flush=True)
    del ms, mf
    torch.cuda.empty_cache()

    # DistFeature over partition_without_replication's book
    prng = np.random.default_rng(SEED + 51)
    parts = qt.partition_without_replication(
        [prng.random(N_NODES) for _ in range(MESH_SHARDS)])
    book = np.zeros(N_NODES, np.int32)
    for h, ids in enumerate(parts):
        book[ids] = h
    dmesh = qt.make_mesh(("data",), devices=[card] * MESH_SHARDS)
    ids = prng.integers(0, N_NODES, (MESH_SHARDS, 2048))
    want = torch.from_numpy(feat[ids]).to(DEV)
    info = qt.PartitionInfo(host=0, hosts=MESH_SHARDS, global2host=book)
    dist = {}
    b2.gather_rows.launches = 0
    df = qt.DistFeature.from_global_feature(feat, dmesh, info)
    rf = qt.RingFeature(feat, dmesh)
    hmesh = Mesh(np.array([card] * 4, dtype=object).reshape(2, 2),
                 ("dcn", "ici"))
    hf = qt.HierFeature.from_global_feature(feat, hmesh,
                                            hot_count=N_NODES // 4)
    for name, fn in (("dist", lambda: df.lookup(ids)),
                     ("ring", lambda: rf.lookup(ids)),
                     ("hier", lambda: hf.lookup(ids.reshape(2, 2, 2048)
                                                ).reshape(4, 2048, DIM))):
        before = b2.gather_rows.launches
        got_rows, first_ms = wall_ms(torch, fn)
        check(torch.equal(got_rows, want),
              f"{name} lookup differs from the table's rows")
        dist[name] = dict(b2_launches=b2.gather_rows.launches - before,
                          first_ms=first_ms, ms=warm_wall_ms(torch, fn))
        check(dist[name]["b2_launches"] > 0, f"{name} lookup launched no B2")
    check(int(df.overflow_stats().sum()) == 0, "DistFeature dropped queries")
    check(int(hf.traffic_stats()["drops"].sum()) == 0,
          "HierFeature dropped queries")
    dist["dist"]["overflow"] = int(df.overflow_stats().sum())
    dist["hier"]["dcn_crossings"] = int(
        hf.traffic_stats()["dcn_crossings"].sum())
    flat_ids = torch.from_numpy(ids.reshape(-1)).to(DEV)
    dist["single_lookup_ms"] = warm_wall_ms(
        torch, lambda: feature.lookup_device(flat_ids))
    del df, rf, hf, want
    torch.cuda.empty_cache()

    # DistGraphSampler [25, 10]: B3 ("blocked") against plain reads
    seeds = prng.integers(0, N_NODES, (MESH_SHARDS, 2048))
    kw = prng.integers(0, 2**32, (len(FANOUTS), MESH_SHARDS, 2),
                       dtype=np.uint32)
    ds = qt.DistGraphSampler(topo, dmesh, FANOUTS)
    check(ds.gather_mode == "blocked", f"resolved {ds.gather_mode!r}")
    b3.element_gather.launches = 0
    got_s, first_blocked = wall_ms(torch,
                                   lambda: ds.sample(seeds, key_words=kw))
    b3_dist = b3.element_gather.launches
    check(b3_dist == 2 * MESH_SHARDS * len(FANOUTS),
          f"DistGraphSampler launched B3 {b3_dist} times")
    ms_blocked = warm_wall_ms(torch, lambda: ds.sample(seeds, key_words=kw))
    ds.gather_mode = "xla"  # the same tables read by plain indexing
    want_s, _ = wall_ms(torch, lambda: ds.sample(seeds, key_words=kw))
    ms_xla = warm_wall_ms(torch, lambda: ds.sample(seeds, key_words=kw))
    for a, b in zip(got_s[:3], want_s[:3]):
        check(torch.equal(a, b), "DistGraphSampler blocked != xla")
    for a, b in zip(got_s[3], want_s[3]):
        check(torch.equal(a.nbr_local, b.nbr_local)
              and torch.equal(a.mask, b.mask),
              "DistGraphSampler blocks differ between blocked and xla")
    drops = int(ds.overflow_stats().sum())
    check(drops == 0, f"DistGraphSampler dropped {drops} at exact caps")
    # hop 1 against the graph: each seed draws min(deg, 25) neighbours,
    # every one an edge of its row (the draws' counters are the request
    # slots, so they are not the single-device sampler's draws)
    inner = got_s[3][-1]
    n_id = got_s[0].cpu().numpy()
    deg = np.diff(topo.indptr)
    for r in range(MESH_SHARDS):
        m = inner.mask[r].cpu().numpy()
        check(np.array_equal(m.sum(1), np.minimum(deg[seeds[r]],
                                                  FANOUTS[0])),
              f"rank {r}: hop-1 counts are not min(deg, {FANOUTS[0]})")
        t, j = np.nonzero(m)
        nbr = n_id[r][inner.nbr_local[r].cpu().numpy()[t, j]]
        rows = [np.arange(topo.indptr[s], topo.indptr[s + 1])
                for s in seeds[r]]
        edges = (np.repeat(np.arange(len(rows)), [len(x) for x in rows])
                 * N_NODES + topo.indices[np.concatenate(rows)])
        check(np.isin(t * N_NODES + nbr, edges).all(),
              f"rank {r}: a hop-1 neighbour is not an edge of its seed")
    dist["sampler"] = dict(first_ms_blocked=first_blocked,
                           ms_blocked=ms_blocked, ms_xla=ms_xla,
                           b3_launches=b3_dist, overflow=drops,
                           frontier=int(got_s[0].shape[1]))
    out["dist"] = dist
    print("sharded lookups and sampler " + json.dumps(dist), flush=True)
    del ds, got_s, want_s
    torch.cuda.empty_cache()
    return launches, b3_dist, out


def dp_phase(torch, qt, ptopo, pfeat, plabels, ptrain, b1, b2):
    """Phase 4h (slice 12): ``make_train_step(mesh=)`` over DP_REPLICAS
    replicas on card 0 at products' widths (GraphSAGE 100 -> 256 -> 256
    -> 47, fanouts [15, 10, 5], 1,024 seeds a replica, dropout 0 so the
    two steps compare), DP_STEPS steps, each loss within rtol 1e-5 of the
    single-device step that takes the mean of the replicas' losses; the
    loss must fall.  Then ``run_dist_training`` once at a small size."""
    from quiver_tpu_torch.dist.e2e import run_dist_training
    from quiver_tpu_torch.parallel.train import masked_cross_entropy

    card = torch.device(DEV)
    out = dict(card=card_line(), replicas=DP_REPLICAS)
    feature = qt.Feature(device_cache_size=pfeat.nbytes,
                         device=DEV).from_cpu_tensor(pfeat)
    sampler = qt.GraphSageSampler(ptopo, P_FANOUTS, device=DEV, seed=SEED)
    mesh = qt.make_mesh(("data",), devices=[card] * DP_REPLICAS)
    model = products_model(torch, qt)
    model.dropout = 0.0
    ref = copy.deepcopy(model)
    step = qt.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=P_LR), mesh=mesh)
    ref_opt = torch.optim.Adam(ref.parameters(), lr=P_LR)
    rng = np.random.default_rng(SEED + 60)
    labels_d = torch.from_numpy(plabels).to(DEV)
    losses, ref_losses, times, ref_times = [], [], [], []
    for fn in (b1.window_sample, b2.gather_rows):
        fn.launches = 0
    for s in range(DP_STEPS):
        seeds = ptrain[rng.choice(len(ptrain), DP_REPLICAS * P_BATCH,
                                  replace=False)].reshape(DP_REPLICAS, -1)
        kw = rng.integers(0, 2**32, (DP_REPLICAS, len(P_FANOUTS), 2),
                          dtype=np.uint32)
        batches = [sampler.sample(seeds[r], key_words=kw[r])
                   for r in range(DP_REPLICAS)]
        x = torch.stack([feature.lookup_device(b.n_id) for b in batches])
        blocks = tuple(qt.LayerBlock(
            nbr_local=torch.stack([b.layers[i].nbr_local for b in batches]),
            mask=torch.stack([b.layers[i].mask for b in batches]),
            num_targets=torch.stack([torch.as_tensor(b.layers[i].num_targets)
                                     for b in batches]))
            for i in range(len(P_FANOUTS)))
        lab = labels_d[torch.from_numpy(seeds.reshape(-1)).to(DEV)
                       .long()].view(DP_REPLICAS, -1)
        mask = torch.ones_like(lab, dtype=torch.bool)
        loss, t = wall_ms(torch, lambda: step(x, blocks, lab, mask))

        def ref_step():
            ref.train()
            ref_opt.zero_grad(set_to_none=True)
            ls = [masked_cross_entropy(
                ref(x[r], [qt.LayerBlock(nbr_local=blk.nbr_local[r],
                                         mask=blk.mask[r],
                                         num_targets=blk.num_targets[r])
                           for blk in blocks]), lab[r], mask[r])
                for r in range(DP_REPLICAS)]
            total = torch.stack(ls).mean()
            total.backward()
            ref_opt.step()
            return total.detach()

        rloss, rt = wall_ms(torch, ref_step)
        losses.append(float(loss))
        ref_losses.append(float(rloss))
        times.append(t)
        ref_times.append(rt)
        check(np.isclose(losses[-1], ref_losses[-1], rtol=1e-5, atol=0),
              f"step {s}: data-parallel loss {losses[-1]} vs single-device "
              f"{ref_losses[-1]}")
    launches = dict(window_sample=b1.window_sample.launches,
                    gather_rows=b2.gather_rows.launches)
    check(launches["window_sample"] > 0 and launches["gather_rows"] > 0,
          f"the data-parallel lane launched {launches}")
    check(np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"data-parallel loss did not fall: {losses}")
    t0 = time.perf_counter()
    e2e = run_dist_training(4, n_nodes=20_000, avg_deg=10, feat_dim=P_DIM,
                            batch_per_dev=256, sizes=P_FANOUTS, steps=3,
                            seed=SEED, devices=[card] * 4)
    e2e_s = time.perf_counter() - t0
    check(all(np.isfinite(e2e["losses"])), "run_dist_training not finite")
    check(int(e2e["sampler_overflow"].sum()) == 0
          and e2e["feature_overflow"] == 0, "run_dist_training dropped")
    out.update(losses=losses, ref_losses=ref_losses,
               step_ms=float(np.median(times)),
               ref_step_ms=float(np.median(ref_times)), launches=launches,
               run_dist_training=dict(losses=e2e["losses"], seconds=e2e_s))
    print("data-parallel products step " + json.dumps(out), flush=True)
    del feature, sampler, model, ref
    torch.cuda.empty_cache()
    return launches, out


def bf16_phase(torch, qt, topo, feat, feature, summary_fp32, b1, b2):
    """Phase 4i (slice 12), A5: the plan served with ``GraphSAGE(dtype=
    torch.bfloat16)`` over a bf16 table (B1, and B2's bf16 route), every
    answer finite, three served passes recomputed: their answers equal
    the bf16 forward widened to fp32, and within BF16_VS_FP32 of the fp32
    model on the fp32 table; p50/p99 beside the fp32 plan's."""
    f16 = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                     dtype=torch.bfloat16, device=DEV).from_cpu_tensor(feat)
    check(f16.hot.dtype == torch.bfloat16 and f16.cache_count == N_NODES,
          "bf16 feature is not whole and bf16")
    sampler = qt.GraphSageSampler(topo, FANOUTS, device=DEV, seed=SEED)
    m32 = seeded_model(torch, qt)
    m16 = qt.GraphSAGE(DIM, HIDDEN, CLASSES, num_layers=2, dropout=0.5,
                       device="cpu", dtype=torch.bfloat16)
    m16.load_state_dict(m32.state_dict())
    server, answers, sent, launches, _, summary = serve(
        torch, qt, sampler, f16, m16,
        {"window_sample": b1.window_sample, "gather_rows": b2.gather_rows})
    ref = qt.InferenceServer(sampler, feature, m32.to(DEV).eval(), None)
    top = server.BUCKETS[-1]
    worst = 0.0
    for members, chunks in picked_passes(server):
        total_ids = sum(len(sent[m].ids) for m in members)
        direct = []
        for i, (p, kw) in enumerate(chunks):
            n = min(top, total_ids - top * i)
            y16 = server.fused_forward(p, kw)[:n].float()
            y32 = ref.fused_forward(p, kw)[:n]
            err = float((y16 - y32).abs().max())
            bound = BF16_VS_FP32 * float(y32.abs().max())
            check(err <= bound, f"bf16 logits differ from fp32 by {err} > "
                  f"{bound}")
            worst = max(worst, err / float(y32.abs().max()))
            direct.append(y16.cpu().numpy())
        direct = np.concatenate(direct)
        off = 0
        for m in members:
            n = len(sent[m].ids)
            check(np.array_equal(answers[m], direct[off: off + n]),
                  f"bf16 answer {m} differs from its pass's forward")
            off += n
    out = dict(card=card_line(), launches=launches,
               p50_ms=summary["stats"]["p50_latency_ms"],
               p99_ms=summary["stats"]["p99_latency_ms"],
               fp32_p50_ms=summary_fp32["stats"]["p50_latency_ms"],
               fp32_p99_ms=summary_fp32["stats"]["p99_latency_ms"],
               worst_err_of_max=worst, peak_gib=summary["peak_gib"])
    print("bf16 serving " + json.dumps(out), flush=True)
    del f16, server
    torch.cuda.empty_cache()
    return launches, out


def mmap_phase(torch, qt, topo, feat, b2, b5):
    """Phase 4i (slice 12), A4: Reddit's table saved as ``.npy`` and
    opened with ``Feature.from_mmap(..., device_cache_size="200M")``: the
    frontier rows of each of the 64 requests, through the staged merge
    (B2 for hot rows, the cold rows read from the map) and then the paged
    store (B5, pages faulted from the map), bitwise the table's; the time
    a request."""
    import shutil

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_mmap")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    path = os.path.join(root, "reddit.npy")
    try:
        np.save(path, feat)
        src = torch.from_numpy(feat).to(DEV)
        sampler = qt.GraphSageSampler(topo, FANOUTS, device=DEV, seed=SEED)
        _, plans = request_plan()
        reqs = [r for plan in plans for r in plan]
        with torch.inference_mode():
            fronts = [sampler.sample(r).n_id for r in reqs]
        out = dict(card=card_line(), requests=len(reqs))
        for name, paged in (("staged", False), ("paged", True)):
            f = qt.Feature.from_mmap(path, device_cache_size=HOT_BUDGET,
                                     device=DEV)
            if paged:
                f.enable_paging(pool_pages=N_NODES)
            check(0 < f.cache_count < N_NODES, "from_mmap is not budgeted")
            b2.gather_rows.launches = b5.page_gather.launches = 0
            times = []
            for n_id in fronts:
                rows, ms_ = wall_ms(torch, lambda: f[n_id])
                times.append(ms_)
                check(torch.equal(rows, src[n_id.long()]),
                      f"from_mmap ({name}) rows differ from the table's")
            out[name] = dict(ms_per_request=float(np.median(times)),
                             gather_rows=b2.gather_rows.launches,
                             page_gather=b5.page_gather.launches,
                             hot_rows=f.cache_count)
            check((b5.page_gather.launches if paged
                   else b2.gather_rows.launches) > 0,
                  f"from_mmap ({name}) launched no kernel")
            f.close()
            del f
        print("from_mmap " + json.dumps(out), flush=True)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# slice 13 (phase 4j): the serving fleet.  Three replica processes on
# card 0 (a leader with the WAL and two followers tailing it) behind a
# FleetRouter; timeouts set on purpose (a Reddit snapshot rebuild holds
# the graph lock about 0.25 s, far under the heartbeat timeout)
FLEET_HEARTBEAT_S = 0.25
FLEET_HEARTBEAT_TIMEOUT_S = 2.0
FLEET_REQUEST_TIMEOUT_S = 30.0     # a request may queue behind passes
FLEET_ELECTION_POLL_S = 0.1
FLEET_ELECTION_STAGGER_S = 0.5
FLEET_SHIP_POLL_MS, FLEET_SHIP_GRACE_MS = 10.0, 60.0
FLEET_PARTITIONS = 64              # every member of 3 owns partitions
FLEET_SERVE_FAULT_EVERY = 4        # r2 answers every 4th `unavailable`
FLEET_INGEST_GAP_S = 0.1           # between two acked writes
FLEET_INGEST_CYCLES = 2            # passes over the 4f mix, at most
FLEET_PROBES = 4                   # probe requests sent to every replica
FLEET_BOOT_TIMEOUT_S = 300.0
# a probe asks for these key words: np.random.default_rng(seed)
FLEET_PROBE_SEED = SEED + 13
FLEET_TENANT_PROBE = "__probe"
FLEET_TENANT_CTL = "__ctl"


def fleet_probe_words(k: int) -> np.ndarray:
    """The ``[L, 2]`` key words probe ``k`` asks every replica for."""
    return np.random.default_rng(FLEET_PROBE_SEED + k).integers(
        0, 2**32, (len(FANOUTS), 2), dtype=np.uint32)


def fleet_server_class(torch, qt):
    """An ``InferenceServer`` whose device thread also answers probes: a
    ``ServingRequest`` carrying fixed key words, answered with the pass's
    logits, its ``n_id`` kept on the request."""
    from dataclasses import dataclass

    @dataclass
    class ProbeRequest(qt.ServingRequest):
        words: object = None
        n_id: object = None
        version: int = -1

    class FleetServer(qt.InferenceServer):
        def _infer_coalesced(self, reqs, stages=None, log=None):
            rest = [r for r in reqs if not isinstance(r, ProbeRequest)]
            outs = iter(super()._infer_coalesced(rest, stages, log)
                        if rest else ())
            return [self._probe(r) if isinstance(r, ProbeRequest)
                    else next(outs) for r in reqs]

        def _probe(self, r):
            s = self.sampler
            padded = self._pad_ids(np.asarray(r.ids))
            snap = s._stream.snapshot(s.device)
            with torch.inference_mode():
                n_id, _, _, blocks, _ = s.pipeline(
                    s.seed_tensor(padded), r.words, snapshot=snap)
                out = self.model(self.feature.lookup_device(n_id), blocks)
                r.n_id = n_id.cpu().numpy().copy()
            r.version = int(snap.version)
            return out[: len(r.ids)].float().cpu().numpy()

    return ProbeRequest, FleetServer


def fleet_digest(a: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def host_rss_gib():
    """This process's resident memory now (``/proc/self/statm``; the card
    machine's ``/proc`` keeps no high-water mark, and ``ru_maxrss``
    carries the parent's peak across ``exec``), or None where there is no
    ``statm``."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except (OSError, IndexError, ValueError):
        return None
    return pages * os.sysconf("SC_PAGE_SIZE") / 2**30


def host_available_gib():
    """The host's available memory (``MemAvailable``), or None."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) / 2**20
    except (OSError, ValueError):
        pass
    return None


def fleet_replica_main(spec_json: str) -> int:
    """One fleet member (``chip_smoke.py --fleet-replica SPEC``): boots a
    ``FleetReplica`` that serves Reddit GraphSAGE through
    ``RequestBatcher(mode="Device")`` -> ``InferenceServer`` (the overlay
    pass: B3; the whole-table lookup: B2), prints one ``ready`` line and
    serves until its stop file appears.  Besides ordinary requests its
    ``service_fn`` answers writes (``ingest:add``/``ingest:remove``, the
    leader's lane), probes (fixed key words, on the device thread) and
    control requests (launch counts, registry, memory)."""
    import hashlib

    import torch

    import quiver_tpu_torch as qt
    from quiver_tpu_torch import telemetry
    from quiver_tpu_torch.fleet import FleetReplica
    from quiver_tpu_torch.ops.cuda import element_gather as b3
    from quiver_tpu_torch.ops.cuda import gather_rows as b2
    from quiver_tpu_torch.ops.cuda import window_sample as b1
    from quiver_tpu_torch.recovery.registry import get_program_registry
    from quiver_tpu_torch.resilience import chaos
    from quiver_tpu_torch.telemetry import timeline

    spec = json.loads(spec_json)
    dev = torch.device(spec["device"])
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("fleet replica: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    telemetry.set_enabled(True)
    timeline.enable()
    if spec.get("serve_fault_every"):
        chaos.install(chaos.ChaosPlan(seed=SEED).fail(
            "fleet.serve", times=None, after=1,
            every=int(spec["serve_fault_every"])))
    cache_dir = spec["cache_dir"]
    cache_before = set(os.listdir(cache_dir))
    table = np.load(spec["table"])
    feature = qt.Feature(device_cache_size=table.nbytes,
                         device=dev).from_cpu_tensor(table)
    del table
    dim, hidden, classes = spec["widths"]
    fanouts = spec["fanouts"]
    model = qt.GraphSAGE(dim, hidden, classes, num_layers=len(fanouts),
                         dropout=0.5, device=dev)
    model.load_state_dict(torch.load(spec["weights"], weights_only=True))
    model.eval()
    ProbeRequest, FleetServer = fleet_server_class(torch, qt)
    counters = {"window_sample": b1.window_sample,
                "gather_rows": b2.gather_rows,
                "element_gather": b3.element_gather}
    held = {}
    waiting = {}
    wlock, seq_lock = threading.Lock(), threading.Lock()
    seq = itertools.count()

    def answers(results):
        # one reader of the server's result queue hands each answer to
        # the handler thread that waits for it
        while True:
            item = results.get()
            if item is None:
                return
            req, out = item
            slot = waiting.pop(req.seq, None)
            if slot is not None:
                slot[1] = out
                slot[0].set()

    def warmup(graph):
        sampler = qt.GraphSageSampler(graph, fanouts, device=dev, seed=SEED)
        streams = [queue.Queue()]
        results = queue.Queue()
        rb = qt.RequestBatcher(streams, mode="Device", result_queue=results)
        server = FleetServer(sampler, feature, model,
                             rb.device_batched_queue, result_queue=results,
                             seed=SEED)
        t0 = time.perf_counter()
        server.warmup()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        rb.start()
        server.start()
        reader = threading.Thread(target=answers, args=(results,),
                                  daemon=True, name="fleet-answers")
        reader.start()
        held.update(graph=graph, sampler=sampler, server=server, rb=rb,
                    stream=streams[0], results=results, reader=reader,
                    warmup_s=time.perf_counter() - t0)

    def submit(req):
        slot = [threading.Event(), None]
        waiting[req.seq] = slot
        held["stream"].put(req)
        if not slot[0].wait(FLEET_REQUEST_TIMEOUT_S):
            waiting.pop(req.seq, None)
            raise TimeoutError(f"no answer within {FLEET_REQUEST_TIMEOUT_S}"
                               " s")
        if isinstance(slot[1], Exception):
            raise slot[1]
        return slot[1]

    def write(op, ids):
        lane = rep.lane
        if lane is None:
            return {"status": "error", "error": "NotLeader"}
        a = np.asarray(ids, dtype=np.int64)
        n = len(a) // (3 if op == "add" else 2)
        src, dst = a[:n], a[n:2 * n]
        ts = a[2 * n:].astype(np.int32) if op == "add" else None
        with wlock:
            upd = lane.submit(src, dst, ts, op=op)
            while True:
                item, outcome = lane.results.get(
                    timeout=FLEET_REQUEST_TIMEOUT_S)
                if item is upd:
                    break
            if isinstance(outcome, Exception):
                raise outcome
            return {"acked": True, "op": op, "version": int(outcome[2]),
                    "wal_next_lsn": int(rep.manager.wal.next_lsn),
                    "epoch": int(rep.epoch)}

    def control(what):
        if what == "reset":
            for fn in counters.values():
                fn.launches = 0
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            return {"reset": True}
        reg = get_program_registry()
        st = reg.stats()
        return {
            "launches": {k: fn.launches for k, fn in counters.items()},
            "pcache_hits": reg.persistent_cache_hits,
            "new_cache_files": len(set(os.listdir(cache_dir))
                                   - cache_before),
            "post_seal_builds": {k: st.get(k, {}).get("post_seal_builds", 0)
                                 for k in ("kernel", "native")},
            "sealed": reg.sealed,
            "version": int(rep.graph.version),
            "device_peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                                if dev.type == "cuda" else 0.0),
            "host_rss_gib": host_rss_gib(),
            "role": rep.role, "epoch": int(rep.epoch)}

    def service(ids, tenant):
        tenant = tenant or ""
        if tenant.startswith("ingest:"):
            return write(tenant.split(":", 1)[1], ids)
        if tenant.startswith(FLEET_TENANT_CTL + ":"):
            return control(tenant.split(":", 1)[1])
        with seq_lock:
            n = next(seq)
        if tenant.startswith(FLEET_TENANT_PROBE + ":"):
            k = int(tenant.split(":", 1)[1])
            req = ProbeRequest(ids=np.asarray(ids, np.int64), client=0,
                               seq=n, words=fleet_probe_words(k))
            out = submit(req)
            return {"n_id_digest": fleet_digest(req.n_id.astype(np.int64)),
                    "n_id_len": int(len(req.n_id)), "version": req.version,
                    "logits": out.tolist()}
        req = qt.ServingRequest(ids=np.asarray(ids, np.int64), client=0,
                                seq=n, tenant=tenant or None)
        out = submit(req)
        return {"n": len(ids), "classes": out.argmax(1).tolist(),
                "digest": hashlib.sha256(out.tobytes()).hexdigest()[:16],
                "version": int(req.graph_version)
                if req.graph_version is not None else -1}

    t0 = time.perf_counter()
    rep = FleetReplica(spec["rid"], fleet_dir=spec["fleet_dir"],
                       root=spec["root"], role=spec["role"],
                       service_fn=service, warmup=warmup, seal=True,
                       heartbeat_s=FLEET_HEARTBEAT_S, catchup_timeout_s=120.0,
                       device=dev)
    rep.boot()
    boot_s = time.perf_counter() - t0
    ms = rep.expose_metrics()
    ready = dict(control("stats"), ready=True, rid=rep.replica_id,
                 pid=os.getpid(), port=rep.port, metrics_port=ms.port,
                 boot_s=boot_s, warmup_s=held.get("warmup_s"))
    print(json.dumps(ready), flush=True)
    stop_path = os.path.join(spec["fleet_dir"], f"stop-{rep.replica_id}")
    while not os.path.exists(stop_path):
        time.sleep(0.1)
    rep.stop()
    leaked = held["rb"].stop() + held["server"].stop()
    held["results"].put(None)
    held["reader"].join(timeout=10)
    if leaked:
        print(f"fleet replica {rep.replica_id}: threads did not stop",
              file=sys.stderr)
        return 1
    return 0


class FleetProc:
    """One replica process of the phase: spawned with ``subprocess`` (the
    parent holds a CUDA context and never forks), its standard error in a
    log file, its ``ready`` line read back."""

    def __init__(self, work: str, spec: dict, env: dict):
        self.rid = spec["rid"]
        self.spec = spec
        self.log_path = os.path.join(work, f"{self.rid}-{time.time_ns()}.log")
        self._log = open(self.log_path, "w")
        self.t_spawn = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--fleet-replica",
             json.dumps(spec)], cwd=os.path.dirname(os.path.abspath(
                 __file__)), env=env, stdout=subprocess.PIPE,
            stderr=self._log, text=True)
        self.ready = None

    def wait_ready(self) -> dict:
        deadline = time.time() + FLEET_BOOT_TIMEOUT_S
        while time.time() < deadline:
            line = self.proc.stdout.readline()
            if not line:
                break
            try:
                doc = json.loads(line)
            except ValueError:
                continue
            if doc.get("ready"):
                doc["spawn_to_ready_s"] = time.perf_counter() - self.t_spawn
                self.ready = doc
                return doc
        self.proc.kill()
        self.proc.wait(timeout=30)
        with open(self.log_path) as f:
            tail = f.read()[-4000:]
        fail(f"fleet replica {self.rid} died or hung during boot "
             f"(rc {self.proc.returncode}):\n{tail}")

    def kill9(self) -> int:
        os.kill(self.proc.pid, 9)
        return self.proc.wait(timeout=30)

    def stop(self) -> int:
        """Ask the replica to stop (its stop file) and reap it; a killed
        one is only reaped."""
        stop = os.path.join(self.spec["fleet_dir"], f"stop-{self.rid}")
        if self.proc.poll() is None:
            open(stop, "w").close()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
            os.remove(stop)
        self.proc.stdout.close()
        self._log.close()
        return self.proc.returncode


def fleet_send(host: str, port: int, doc: dict, timeout: float,
               retries: int = 4) -> dict:
    """One JSON line straight to a replica (no router); an honest
    ``unavailable`` (r2's seeded serve faults) is asked again."""
    import socket

    for _ in range(retries):
        with socket.create_connection((host, port), timeout=timeout) as c:
            c.sendall((json.dumps(doc) + "\n").encode())
            with c.makefile("rb") as f:
                reply = json.loads(f.readline())
        if reply.get("status") != "unavailable":
            return reply
    return reply


def fleet_ingest_ops(rng, base) -> list:
    """Phase 4f's insert/delete mix: STREAM_INSERTS inserts (with
    timestamps) in batches of STREAM_BATCH, a batch of base deletes after
    every eighth, STREAM_DELETES in all; each op as the ``ids`` of one
    write request."""
    n = base.node_count
    isrc = rng.integers(0, n, STREAM_INSERTS)
    idst = rng.integers(0, n, STREAM_INSERTS)
    its = rng.integers(0, STREAM_TS_MAX, STREAM_INSERTS)
    dpos = _delete_positions(rng, base, np.array([], np.int64),
                             STREAM_DELETES)
    dsrc, ddst = _row_of(base, dpos), base.indices[dpos].astype(np.int64)
    ops, j = [], 0
    for i in range(0, STREAM_INSERTS, STREAM_BATCH):
        sl = slice(i, i + STREAM_BATCH)
        ops.append(("add", np.concatenate([isrc[sl], idst[sl], its[sl]])))
        if (i // STREAM_BATCH) % 8 == 7:
            sl = slice(j, j + STREAM_BATCH)
            ops.append(("remove", np.concatenate([dsrc[sl], ddst[sl]])))
            j += STREAM_BATCH
    return ops


class FleetWriter:
    """The phase's writer: phase 4f's mix, one op at a time, each sent to
    the endpoint ``router.write_path()`` resolves and re-sent until a
    leader acks it (a write in flight at a leader's death is sent again:
    at least once, as the lane promises)."""

    def __init__(self, router, ops, cycles: int = FLEET_INGEST_CYCLES):
        self.router, self.ops, self.cycles = router, ops, cycles
        self.acks = []            # (t, replica, epoch, wal_next_lsn, op)
        self.write_s = []
        self.failures = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-writer")

    def start(self):
        self._thread.start()
        return self

    def _run(self):
        for _cycle in range(self.cycles):
            for op, ids in self.ops:
                while not self._stop.is_set():
                    info = self.router.write_path()
                    reply = None
                    if info is not None:
                        t0 = time.perf_counter()
                        try:
                            reply = fleet_send(info.host, info.port, {
                                "ids": ids.tolist(),
                                "tenant": f"ingest:{op}"},
                                FLEET_REQUEST_TIMEOUT_S)
                        except OSError:
                            reply = None
                    if reply is not None and reply.get("acked"):
                        self.write_s.append(time.perf_counter() - t0)
                        self.acks.append((time.perf_counter(),
                                          reply["replica"], reply["epoch"],
                                          reply["wal_next_lsn"], op))
                        break
                    self.failures += 1
                    time.sleep(0.05)
                if self._stop.wait(FLEET_INGEST_GAP_S):
                    return

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=FLEET_REQUEST_TIMEOUT_S + 10)
        check(not self._thread.is_alive(), "fleet writer did not stop")


def fleet_traffic(router, plans, at_once: bool, during=None) -> dict:
    """The 64-request plan through the router: four client threads in
    order (``at_once`` False) or every request on its own thread at once.
    ``during(answered)`` runs on the caller's thread while requests are
    out, given the count answered so far.  Every request ends as ``ok``,
    a typed ``shed``, ``error``, or ``NoReplicaAvailable``; anything else
    is ``unanswered``."""
    from quiver_tpu_torch.resilience.errors import NoReplicaAvailable

    reqs = [(c, s, ids) for c in range(len(plans))
            for s, ids in enumerate(plans[c])]
    counts = {"offered": len(reqs), "ok": 0, "shed": 0, "error": 0,
              "unroutable": 0, "unanswered": 0}
    lat, rep_lat, by_replica, why = [], [], {}, []
    lock = threading.Lock()
    done = [0]

    def one(c, s, ids):
        t0 = time.perf_counter()
        try:
            reply = router.request(ids.tolist(), seq=c * 1000 + s)
            status = reply.get("status", "error")
            key = status if status in ("ok", "shed") else "error"
        except NoReplicaAvailable as e:
            reply, key = None, "unroutable"
            why.append(str(e))
        except Exception as e:  # noqa: BLE001 -- counted: a lost answer
            reply, key = None, "unanswered"
            why.append(repr(e))
        dt = (time.perf_counter() - t0) * 1e3
        with lock:
            counts[key] += 1
            done[0] += 1
            lat.append(dt)
            if reply is not None and key == "ok":
                rep_lat.append(reply["latency_ms"])
                by_replica[reply["replica"]] = by_replica.get(
                    reply["replica"], 0) + 1
                check(len(reply["classes"]) == len(ids)
                      and all(0 <= x < CLASSES for x in reply["classes"]),
                      f"request ({c}, {s}) answered badly: {reply}")

    if at_once:
        threads = [threading.Thread(target=one, args=r) for r in reqs]
    else:
        def client(c):
            for s, ids in enumerate(plans[c]):
                one(c, s, ids)
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(len(plans))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    if during is not None:
        during(lambda: done[0])
    for t in threads:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in threads), "fleet clients hung")
    counts.update(
        wall_s=time.perf_counter() - t0,
        router_p50_ms=float(np.percentile(lat, 50)),
        router_p99_ms=float(np.percentile(lat, 99)),
        replica_p50_ms=float(np.percentile(rep_lat, 50)) if rep_lat
        else None,
        replica_p99_ms=float(np.percentile(rep_lat, 99)) if rep_lat
        else None, by_replica=by_replica, not_ok=sorted(set(why))[:4])
    if rep_lat:
        counts["hop_p50_ms"] = counts["router_p50_ms"] - \
            counts["replica_p50_ms"]
    check(counts["offered"] == counts["ok"] + counts["shed"]
          + counts["error"] + counts["unroutable"] + counts["unanswered"],
          f"fleet accounting: {counts}")
    check(counts["unanswered"] == 0, f"fleet lost answers: {counts}")
    check(counts["error"] == 0, f"fleet answered errors: {counts}")
    return counts


class FleetWatch:
    """Samples the followers' staleness (their membership records), the
    card's free memory and the host's available memory while traffic
    runs (the least of each is the four processes' peak together)."""

    def __init__(self, torch, directory, rids):
        self.torch, self.directory, self.rids = torch, directory, rids
        self.seconds, self.lsn, self.free_gib = [], [], []
        self.host_gib = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-watch")

    def _run(self):
        while not self._stop.wait(0.05):
            for rid in self.rids:
                info = self.directory.get(rid)
                if info is not None and info.role == "follower":
                    self.seconds.append(info.staleness_seconds)
                    self.lsn.append(info.staleness_lsn)
            if DEV == "cuda":
                self.free_gib.append(
                    self.torch.cuda.mem_get_info(0)[0] / 2**30)
            avail = host_available_gib()
            if avail is not None:
                self.host_gib.append(avail)

    def start(self):
        self._thread.start()
        return self

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(timeout=10)
        out = {}
        if self.seconds:
            out.update(staleness_s_p50=float(np.median(self.seconds)),
                       staleness_s_max=float(max(self.seconds)),
                       staleness_lsn_max=int(max(self.lsn)))
        if self.free_gib:
            out["card_free_gib_min"] = float(min(self.free_gib))
        if self.host_gib:
            out["host_available_gib_min"] = float(min(self.host_gib))
        return out


def wal_ops(wal_dir: str) -> dict:
    """``lsn -> (op, src, dst)`` of every intact edge record of a WAL,
    read from its segment files without opening the log."""
    from quiver_tpu_torch.fleet.shipping import list_segments, scan_frames
    from quiver_tpu_torch.recovery.wal import decode_edge_op

    out = {}
    for start, path in list_segments(wal_dir):
        with open(path, "rb") as f:
            frames, _torn = scan_frames(f.read())
        for i, (kind, payload, _off, _end) in enumerate(frames):
            if kind == "ok":
                try:
                    op, src, dst, _ts = decode_edge_op(payload)
                except Exception:  # noqa: BLE001 -- an abort record
                    continue
                out[start + i] = (op, np.asarray(src).tolist(),
                                  np.asarray(dst).tolist())
    return out


def fleet_phase(torch, qt, topo, feat, b2, b3) -> dict:
    """Slice 13 on the card (phase 4j): Reddit GraphSAGE served by a real
    fleet of three replica processes on card 0, through a ``kill -9`` of
    a follower with a warm rejoin, then a leader failover under
    ``fleet_election=on``.  Returns a summary; fails on any lost answer,
    any probe that differs, or any missed step."""
    import contextlib
    import shutil
    import urllib.request

    from quiver_tpu_torch import config as qconfig
    from quiver_tpu_torch import telemetry
    from quiver_tpu_torch.fleet import FleetRouter, MembershipDirectory
    from quiver_tpu_torch.fleet.election import (ElectionDirectory,
                                                 EpochFence, FencedWAL,
                                                 StaleEpochError)
    from quiver_tpu_torch.recovery.manager import RecoveryManager, set_active
    from quiver_tpu_torch.stream import StreamingGraph
    from quiver_tpu_torch.telemetry import export, timeline
    from quiver_tpu_torch.telemetry.registry import metric_key

    t_phase = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_fleet")
    shutil.rmtree(work, ignore_errors=True)
    root_a, cache_dir = os.path.join(work, "root"), os.path.join(work,
                                                                 "cache")
    fleet_a = os.path.join(work, "fleet")
    for d in (root_a, cache_dir, fleet_a):
        os.makedirs(d)
    out = dict(card=card_line(), timeouts=dict(
        heartbeat_s=FLEET_HEARTBEAT_S,
        heartbeat_timeout_s=FLEET_HEARTBEAT_TIMEOUT_S,
        request_timeout_s=FLEET_REQUEST_TIMEOUT_S,
        election_poll_s=FLEET_ELECTION_POLL_S,
        election_stagger_s=FLEET_ELECTION_STAGGER_S,
        ship_poll_ms=FLEET_SHIP_POLL_MS, ship_grace_ms=FLEET_SHIP_GRACE_MS))
    print("fleet timeouts " + json.dumps(out["timeouts"]), flush=True)

    # setup, once: the Reddit StreamingGraph with phase 4f's timestamps
    # checkpointed through a leader RecoveryManager, the table and the
    # seeded model's weights saved beside it
    t0 = time.perf_counter()
    base = qt.CSRTopo(indptr=topo.indptr, indices=topo.indices)
    ts = np.random.default_rng(SEED + 11).integers(
        0, STREAM_TS_MAX, base.edge_count, dtype=np.int32)
    g = StreamingGraph(base, edge_ts=ts, device=DEV)
    mgr = RecoveryManager(root_a, graph_factory=lambda: g, device=DEV)
    check(mgr.boot() is g, "the setup manager booted another graph")
    ckpt_path = mgr.checkpoint()
    mgr.close()
    set_active(None)
    del g, ts
    table_path = os.path.join(work, "table.npy")
    np.save(table_path, feat)
    weights_path = os.path.join(work, "weights.pt")
    torch.save(seeded_model(torch, qt).state_dict(), weights_path)
    out["setup_s"] = time.perf_counter() - t0
    print(f"fleet setup (checkpoint {os.path.getsize(ckpt_path)} B, table, "
          f"weights): {out['setup_s']:.2f} s", flush=True)

    def env(election: bool) -> dict:
        e = dict(os.environ,
                 QUIVER_TPU_RECOVERY_CACHE_DIR=cache_dir,
                 QUIVER_TPU_FLEET_SHIP_POLL_MS=str(FLEET_SHIP_POLL_MS),
                 QUIVER_TPU_FLEET_SHIP_GRACE_MS=str(FLEET_SHIP_GRACE_MS),
                 QUIVER_TPU_FLEET_HEARTBEAT_TIMEOUT_S=str(
                     FLEET_HEARTBEAT_TIMEOUT_S),
                 QUIVER_TPU_FLEET_ELECTION="on" if election else "off",
                 QUIVER_TPU_FLEET_ELECTION_POLL_S=str(FLEET_ELECTION_POLL_S),
                 QUIVER_TPU_FLEET_ELECTION_STAGGER_S=str(
                     FLEET_ELECTION_STAGGER_S),
                 PYTHONUNBUFFERED="1")
        return e

    def spec(rid, role, root, fleet_dir, fault=0):
        return dict(rid=rid, role=role, root=root, fleet_dir=fleet_dir,
                    cache_dir=cache_dir, table=table_path,
                    weights=weights_path, device=DEV,
                    widths=(DIM, HIDDEN, CLASSES), fanouts=FANOUTS,
                    serve_fault_every=fault)

    procs, procs_b = {}, {}
    routers = []
    # the router's per-replica breakers half-open 1 s after they trip, so
    # a replica that rejoins under a dead one's id is retried within the
    # phase (the default is 30 s)
    scope = contextlib.ExitStack()
    scope.enter_context(qconfig.override(serving_breaker_reset_s=1.0))
    out["timeouts"]["breaker_reset_s"] = 1.0
    telemetry.set_enabled(True)
    timeline_was_on = timeline.on()
    timeline.enable()
    metrics = None
    _rng, plans = request_plan()
    try:
        # -- (a) boot: the leader cold (it builds every kernel and native
        # library into the empty shared cache), then two followers warm
        procs["r0"] = FleetProc(work, spec("r0", "leader", root_a, fleet_a),
                                env(False))
        boots = {"r0": procs["r0"].wait_ready()}
        procs["r1"] = FleetProc(work, spec("r1", "follower", root_a,
                                           fleet_a), env(False))
        procs["r2"] = FleetProc(work, spec("r2", "follower", root_a, fleet_a,
                                           FLEET_SERVE_FAULT_EVERY),
                                env(False))
        boots.update(r1=procs["r1"].wait_ready(),
                     r2=procs["r2"].wait_ready())
        check(boots["r0"]["new_cache_files"] > 0,
              "the leader built nothing into the empty shared cache")
        for rid in ("r1", "r2"):
            b = boots[rid]
            check(b["pcache_hits"] > 0 and b["new_cache_files"] == 0,
                  f"follower {rid} did not join warm: {b}")
        out["boot"] = {rid: {k: b[k] for k in (
            "boot_s", "warmup_s", "spawn_to_ready_s", "pcache_hits",
            "new_cache_files", "version")} for rid, b in boots.items()}
        print(f"fleet boots (card: {card_line()}) " + json.dumps(
            out["boot"]), flush=True)

        directory = MembershipDirectory(
            fleet_a, heartbeat_timeout_s=FLEET_HEARTBEAT_TIMEOUT_S)
        router = FleetRouter(directory, partitions=FLEET_PARTITIONS,
                             scan_ttl_s=0.05,
                             request_timeout_s=FLEET_REQUEST_TIMEOUT_S,
                             federation=True).start_health_poller()
        routers.append(router)
        # one scan before traffic: concurrent first requests to a router
        # whose first scan is still running find its ring empty and are
        # answered NoReplicaAvailable (as JAX's router does)
        router.refresh(force=True)
        metrics = export.start_http_server(port=0)

        def ctl(rid, what):
            r = procs[rid].ready
            reply = fleet_send("127.0.0.1", r["port"], {
                "ids": [], "tenant": f"{FLEET_TENANT_CTL}:{what}"},
                FLEET_REQUEST_TIMEOUT_S)
            check(reply.get("status") == "ok", f"{rid} {what}: {reply}")
            return reply

        for rid in ("r0", "r1", "r2"):
            ctl(rid, "reset")
        rng = np.random.default_rng(SEED + 17)
        writer = FleetWriter(router, fleet_ingest_ops(rng, base)).start()
        watch = FleetWatch(torch, directory, ("r1", "r2")).start()
        phases = {}
        phases["baseline"] = fleet_traffic(router, plans, at_once=False)
        launches_pre = {rid: ctl(rid, "stats")["launches"]
                        for rid in ("r1",)}

        # -- (b) the burst: the plan at once, kill -9 of r1 mid-burst
        kill = {}

        def redispatched_r1():
            return telemetry.snapshot()["counters"].get(metric_key(
                "fleet_router_redispatch_total", {"replica": "r1"}), 0)

        def kill_mid_burst(answered):
            while answered() < 16:
                time.sleep(0.005)
            before = redispatched_r1()
            kill["t"] = time.perf_counter()
            kill["rc"] = procs["r1"].kill9()
            while redispatched_r1() == before and \
                    time.perf_counter() - kill["t"] < 60:
                time.sleep(0.002)
            kill["to_redispatch_s"] = time.perf_counter() - kill["t"]
            # -- (c) r1 rejoins warm under the same id, starting now
            kill["dead"] = procs.pop("r1")
            procs["r1"] = FleetProc(work, spec("r1", "follower", root_a,
                                               fleet_a), env(False))

        phases["burst"] = fleet_traffic(router, plans, at_once=True,
                                        during=kill_mid_burst)
        check(kill.get("rc") == -9, f"r1 was not killed: {kill}")
        check(redispatched_r1() > 0, "no request re-dispatched around r1")
        out["kill"] = dict(rc=kill["rc"], to_redispatch_s=kill.get(
            "to_redispatch_s"), redispatched=redispatched_r1())
        kill["dead"].stop()
        t0 = procs["r1"].t_spawn
        rejoin = procs["r1"].wait_ready()
        bound = qconfig.get_config().fleet_max_staleness_lsn
        deadline = time.time() + 60
        while time.time() < deadline:
            info = directory.get("r1")
            if (info is not None and info.state == "serving"
                    and info.staleness_lsn <= bound):
                break
            time.sleep(0.05)
        check(info is not None and info.staleness_lsn <= bound,
              f"rejoined r1 staleness {info}")
        rejoin.update(rejoin_s=time.perf_counter() - t0,
                      staleness_lsn=info.staleness_lsn, bound=bound)
        check(rejoin["pcache_hits"] > 0 and rejoin["new_cache_files"] == 0
              and rejoin["sealed"] and not any(
                  rejoin["post_seal_builds"].values()),
              f"r1 did not rejoin warm: {rejoin}")
        ctl("r1", "reset")
        out["rejoin"] = {k: rejoin[k] for k in (
            "boot_s", "warmup_s", "spawn_to_ready_s", "rejoin_s",
            "pcache_hits", "new_cache_files", "post_seal_builds",
            "staleness_lsn", "bound", "version")}
        print(f"fleet warm rejoin (card: {card_line()}) "
              + json.dumps(out["rejoin"]), flush=True)
        phases["cool"] = fleet_traffic(router, plans, at_once=False)
        check(phases["cool"]["by_replica"].get("r1", 0) > 0,
              "the rejoined r1 served no traffic")
        writer.stop()
        # the failover fleet's leader boots (on a fresh root and fleet
        # directory, election on) while A's probes run
        root_b, fleet_b = os.path.join(work, "root_b"), os.path.join(
            work, "fleet_b")
        os.makedirs(os.path.join(root_b, "ckpt"))
        os.makedirs(fleet_b)
        os.link(ckpt_path, os.path.join(root_b, "ckpt",
                                        os.path.basename(ckpt_path)))
        t_b = time.perf_counter()
        procs_b["r0"] = FleetProc(work, spec("r0", "leader", root_b,
                                             fleet_b), env(True))
        out["ingest"] = dict(acked=len(writer.acks), resent=writer.failures,
                             write_p50_ms=float(np.median(writer.write_s))
                             * 1e3, **watch.stop())
        check(writer.acks, "the leader acked no write")
        out["phases"] = phases
        print(f"fleet traffic (card: {card_line()}) " + json.dumps(
            dict(phases=phases, ingest=out["ingest"], kill=out["kill"])),
            flush=True)

        # -- (d) answers do not depend on the replica: every member has
        # folded in the last acked write (the frontier it reported)
        frontier = writer.acks[-1][3]
        deadline = time.time() + 60
        while time.time() < deadline:
            infos = [directory.get(r) for r in ("r0", "r1", "r2")]
            if all(i is not None and i.staleness_lsn == 0
                   and i.wal_next_lsn == frontier for i in infos):
                break
            time.sleep(0.05)
        check(all(i is not None and i.staleness_lsn == 0
                  and i.wal_next_lsn == frontier for i in infos),
              f"the fleet did not reach the frontier {frontier}: {infos}")
        ref_root = os.path.join(work, "probe_root")
        os.makedirs(os.path.join(ref_root, "ckpt"))
        for name in os.listdir(os.path.join(root_a, "ckpt")):
            os.link(os.path.join(root_a, "ckpt", name),
                    os.path.join(ref_root, "ckpt", name))
        shutil.copytree(os.path.join(root_a, "wal"),
                        os.path.join(ref_root, "wal"))
        ref_mgr = RecoveryManager(ref_root, device=DEV)
        ref_graph = ref_mgr.boot()
        ref_mgr.close()
        set_active(None)
        ref_sampler = qt.GraphSageSampler(ref_graph, FANOUTS, device=DEV)
        ref_feature = qt.Feature(device_cache_size=feat.nbytes,
                                 device=DEV).from_cpu_tensor(feat)
        ref_model = seeded_model(torch, qt).to(DEV).eval()
        buckets = tuple(qconfig.get_config().serving_buckets)
        from quiver_tpu_torch.serving import _pad_to_bucket

        probes, bitwise = [], True
        for k in range(FLEET_PROBES):
            ids = plans[k][0]
            snap = ref_graph.snapshot(torch.device(DEV))
            with torch.inference_mode():
                n_id, _, _, blocks, _ = ref_sampler.pipeline(
                    ref_sampler.seed_tensor(_pad_to_bucket(ids, buckets)),
                    fleet_probe_words(k), snapshot=snap)
                want = ref_model(ref_feature.lookup_device(n_id), blocks)[
                    : len(ids)].float().cpu().numpy()
            want_digest = fleet_digest(n_id.cpu().numpy().astype(np.int64))
            got = {}
            for rid in ("r0", "r1", "r2"):
                r = procs[rid].ready
                reply = fleet_send("127.0.0.1", r["port"], {
                    "ids": ids.tolist(),
                    "tenant": f"{FLEET_TENANT_PROBE}:{k}"},
                    FLEET_REQUEST_TIMEOUT_S)
                check(reply.get("status") == "ok", f"probe {k} {rid}: "
                      f"{ {x: reply[x] for x in reply if x != 'logits'} }")
                check(reply["n_id_digest"] == want_digest,
                      f"probe {k}: {rid}'s n_id differs from the parent's")
                check(reply["version"] == snap.version,
                      f"probe {k}: {rid} at version {reply['version']}, the "
                      f"parent's rebuild at {snap.version}")
                logits = np.asarray(reply["logits"], np.float32)
                check(logits.shape == want.shape and np.isfinite(
                    logits).all(), f"probe {k} {rid} logits")
                np.testing.assert_allclose(logits, want, **CPU_TOL)
                bitwise &= bool(np.array_equal(logits, want))
                got[rid] = reply["n_id_digest"]
            probes.append(dict(ids=len(ids), n_id_digest=want_digest[:16],
                               version=snap.version))
        out["probes"] = dict(cases=probes, n_id_bitwise=True,
                             logits_bitwise=bitwise, tolerance=CPU_TOL)
        print("fleet probes (n_id bitwise across r0, r1, r2 and the "
              "parent) " + json.dumps(out["probes"]), flush=True)
        del ref_graph, ref_sampler, ref_feature, ref_model
        torch.cuda.empty_cache()

        # -- (e) launches a replica, from each process's counters
        stats = {rid: ctl(rid, "stats") for rid in ("r0", "r1", "r2")}
        out["replicas"] = {rid: {k: s[k] for k in (
            "launches", "device_peak_gib", "host_rss_gib", "version")}
            for rid, s in stats.items()}
        out["replicas"]["r1"]["launches_before_kill"] = launches_pre["r1"]
        for rid, s in stats.items():
            for name in ("gather_rows", "element_gather"):
                check(s["launches"][name] > 0,
                      f"{rid} launched {name} no time while serving")
        print(f"fleet replicas (card: {card_line()}) "
              + json.dumps(out["replicas"]), flush=True)

        # -- (f) one observability plane
        fed = router.federation
        for _ in range(3):
            fed.scrape_once()
            time.sleep(0.3)
        with urllib.request.urlopen(metrics.url + "/metrics/fleet",
                                    timeout=30) as r:
            text = r.read().decode()
        for rid in ("r0", "r1", "r2"):
            check(f'replica="{rid}"' in text,
                  f"/metrics/fleet holds no series of {rid}")
        trace_path = timeline.export_fleet(os.path.join(work,
                                                        "fleet_trace.json"))
        with open(trace_path) as f:
            doc = json.load(f)
        track, by_tid, events = {}, {}, 0
        for e in doc["traceEvents"]:
            if e.get("ph") == "M":
                if e.get("name") == "process_name":
                    track[e["pid"]] = e["args"]["name"]
                continue
            events += 1
            tid = (e.get("args") or {}).get("trace_id")
            if tid:
                by_tid.setdefault(tid, set()).add(track.get(e["pid"]))
        procs_seen = sorted({track.get(e["pid"]) for e in doc["traceEvents"]
                             if e.get("ph") != "M"})
        check(len(procs_seen) >= 2, f"fleet trace from {procs_seen}")
        redis = [h for h in router.hop_records(limit=router.hop_capacity)
                 if len(h.get("attempts", ())) >= 2]
        both = [h for h in redis if sum(
            1 for t in by_tid.get(h["trace_id"], ())
            if t and t.startswith("replica")) >= 2]
        check(both, f"no re-dispatched trace on two replica tracks "
              f"({len(redis)} re-dispatched hops)")
        recon = fed.reconstruct(both[-1]["trace_id"])
        check(recon.get("found"), "fleet trace reconstruction")
        out["observability"] = dict(
            trace_events=events, trace_processes=procs_seen,
            redispatched_hops=len(redis), shown_on_two_replicas=len(both),
            example=dict(trace_id=both[-1]["trace_id"], attempts=[
                (a["replica"], a["outcome"])
                for a in both[-1]["attempts"]]),
            metrics_fleet_bytes=len(text))
        print("fleet observability " + json.dumps(out["observability"]),
              flush=True)
        # the router (its health poller) goes first, then the replicas
        router.close()
        routers.clear()
        for rid in list(procs):
            check(procs.pop(rid).stop() == 0,
                  f"replica {rid} did not stop cleanly")

        # -- (g) leader failover: election on, a fresh root and fleet
        procs = procs_b
        boots_b = {"r0": procs["r0"].wait_ready()}
        for rid in ("r1", "r2"):
            procs[rid] = FleetProc(work, spec(rid, "follower", root_b,
                                              fleet_b), env(True))
        for rid in ("r1", "r2"):
            boots_b[rid] = procs[rid].wait_ready()
        old_epoch = boots_b["r0"]["epoch"]
        check(old_epoch >= 1, f"the leader claimed no epoch: {boots_b}")
        directory_b = MembershipDirectory(
            fleet_b, heartbeat_timeout_s=FLEET_HEARTBEAT_TIMEOUT_S)
        router_b = FleetRouter(directory_b, partitions=FLEET_PARTITIONS,
                               scan_ttl_s=0.05,
                               request_timeout_s=FLEET_REQUEST_TIMEOUT_S
                               ).start_health_poller()
        routers.append(router_b)
        router_b.refresh(force=True)
        writer_b = FleetWriter(router_b, fleet_ingest_ops(
            np.random.default_rng(SEED + 19), base), cycles=1).start()
        phases_b = {}
        failover = {}

        def kill_leader(answered):
            while len(writer_b.acks) < 8 or answered() < 16:
                time.sleep(0.005)
            failover["t"] = time.perf_counter()
            failover["rc"] = procs["r0"].kill9()
            deadline = time.time() + 60
            while time.time() < deadline:
                info = directory_b.leader()
                if (info is not None and info.replica_id != "r0"
                        and info.epoch > old_epoch):
                    failover["to_promotion_s"] = (time.perf_counter()
                                                  - failover["t"])
                    failover["promoted"] = info.replica_id
                    failover["new_epoch"] = info.epoch
                    return
                time.sleep(0.01)

        phases_b["burst"] = fleet_traffic(router_b, plans, at_once=True,
                                          during=kill_leader)
        check(failover.get("rc") == -9, f"r0 was not killed: {failover}")
        check("promoted" in failover, f"no follower promoted: {failover}")
        check(failover["new_epoch"] > old_epoch,
              f"promotion epoch {failover['new_epoch']} <= {old_epoch}")
        # writes flow through router.write_path() to the promoted lane
        deadline = time.time() + 60
        while time.time() < deadline and sum(
                a[1] == failover["promoted"] for a in writer_b.acks) < 8:
            time.sleep(0.05)
        writer_b.stop()
        wp = router_b.write_path()
        check(wp is not None and wp.replica_id == failover["promoted"]
              and wp.epoch == failover["new_epoch"],
              f"write path after the failover: {wp}")
        promoted_acks = [a for a in writer_b.acks
                         if a[1] == failover["promoted"]]
        check(promoted_acks and all(a[2] == failover["new_epoch"]
                                    for a in promoted_acks),
              "no write acked by the promoted lane under its epoch")
        # every append the dead leader acknowledged (and every later one)
        # is in the promoted WAL: ack i is op i of the mix, its LSN the
        # frontier it reported less one
        acked = [a for a in writer_b.acks if a[1] == "r0"]
        check(acked, "the dead leader acked no write")
        on_disk = wal_ops(os.path.join(root_b, "wal"))
        ops_b = writer_b.ops
        n = STREAM_BATCH
        for i, (_t, rid, _ep, next_lsn, op) in enumerate(writer_b.acks):
            rec = on_disk.get(next_lsn - 1)
            check(rec is not None and rec[0] == op
                  and rec[1] == ops_b[i][1][:n].tolist()
                  and rec[2] == ops_b[i][1][n:2 * n].tolist(),
                  f"write {i} acked by {rid} (lsn {next_lsn - 1}) is not in "
                  "the promoted WAL")
        # an append stamped with the deposed epoch is refused
        class NeverWAL:
            def append(self, payload):
                fail("the fence let a deposed append through")

        fence = EpochFence(ElectionDirectory(fleet_b), old_epoch, "r0",
                           recheck_s=0.0)
        try:
            FencedWAL(NeverWAL(), fence).append(b"deposed-write")
            fail("the deposed epoch's append was not refused")
        except StaleEpochError:
            refused = True
        out["failover"] = dict(
            kill_rc=failover["rc"], old_epoch=old_epoch,
            new_epoch=failover["new_epoch"], promoted=failover["promoted"],
            kill_to_promotion_s=failover["to_promotion_s"],
            acked_by_dead_leader=len(acked),
            acked_by_promoted=len(promoted_acks),
            stale_epoch_append_refused=refused, resent=writer_b.failures,
            boot_s={rid: b["boot_s"] for rid, b in boots_b.items()},
            wall_s=time.perf_counter() - t_b, phases=phases_b)
        print(f"fleet leader failover (card: {card_line()}) "
              + json.dumps(out["failover"]), flush=True)
        router_b.close()
        routers.clear()
        for rid in list(procs):
            if rid != "r0":
                check(procs[rid].stop() == 0,
                      f"replica {rid} did not stop cleanly")
            else:
                procs[rid].stop()
            procs.pop(rid)
    finally:
        for r in routers:
            r.close()
        for p in {id(p): p for p in (*procs.values(),
                                     *procs_b.values())}.values():
            p.proc.kill()
            p.stop()
        if metrics is not None:
            metrics.close()
        if not timeline_was_on:
            timeline.disable()
        scope.close()
    out["phase_s"] = time.perf_counter() - t_phase
    shutil.rmtree(work, ignore_errors=True)
    return out


SANITIZE_PROBES = (50, 300, 2048)          # ids of each probe request
SANITIZE_MIXED = (1, 7, 33, 250, 1000, 2048, 3000)  # build-guard requests
SANITIZE_PAGED_LOOKUPS = 8                 # bucket-2048 frontiers gathered
SANITIZE_MESH_HOPS = 4                     # [2048, 25] hops over the mesh
SANITIZE_TIMEOUT_S = 900.0
SANITIZE_REGIONS = ("serving device loop", "paged gather", "mesh combine")


def sanitize_probes(server) -> list:
    """Digests of the logits of fixed probe requests under fixed key
    words, one fused forward each."""
    rng = np.random.default_rng(SEED + 21)
    out = []
    for n in SANITIZE_PROBES:
        ids = rng.integers(0, N_NODES, n)
        kw = rng.integers(0, 2**32, size=(len(FANOUTS), 2), dtype=np.uint32)
        y = server.fused_forward(server._pad_ids(ids), kw)[:n]
        out.append(fleet_digest(y.cpu().numpy()))
    return out


def _by_site(transfers) -> dict:
    out: dict = {}
    for t in transfers:
        key = f"{t.site} at {t.where}" + (f" in `{t.region}`" if t.region
                                          else "")
        out[key] = out.get(key, 0) + 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _in_region(violations, region: str) -> list:
    return [v.message for v in violations if f"`{region}`" in v.message]


# the transfer witness's sites that are a Python coercion, each a line of
# the package's code (its sync-debug warnings, "cuda sync", are the
# card's own waits: a copy from pageable memory, nonzero, a mask)
LINT_COERCIONS = (".item()", ".tolist()", ".cpu()", ".numpy()", "__array__",
                  "bool()", "int()", "float()", "__index__", ".to(cpu)",
                  "Event.synchronize", "Stream.synchronize")
# coercions the static rules cannot reach, "path:line" -> why; each is
# also listed in ROADMAP section C
LINT_BLIND_SPOTS: dict = {}


def _package_coercions(transfers) -> list:
    """The coercions made in frames of the package: one record per
    (site, path, line, region) with its count."""
    out: dict = {}
    for t in transfers:
        if t.path is None or t.site not in LINT_COERCIONS:
            continue
        key = (t.site, t.path, int(t.where.rsplit(":", 1)[1]), t.region)
        out[key] = out.get(key, 0) + 1
    return [dict(site=k[0], path=k[1], line=k[2], region=k[3], count=n)
            for k, n in sorted(out.items(), key=lambda kv: kv[0][1:3])]


def sanitize_child_main(spec_json: str) -> int:
    """Phase 4k's child (``chip_smoke.py --sanitize-child SPEC``, run with
    ``QUIVER_SANITIZE=1``): imports the port under both witnesses, seeds
    the lock order from the port's own static model, then drives the
    three no-sync regions on the card (fused serving of the 64-request
    plan, the ``"200M"`` store's paged gathers, the mesh combine), the
    build guard over mixed request sizes, and two deliberate syncs inside
    a region; prints one ``sanitize-child`` JSON line."""
    global DEV, N_NODES, DIM, HIDDEN, CLASSES
    spec = json.loads(spec_json)
    DEV, N_NODES = spec["device"], spec["n_nodes"]
    DIM, HIDDEN, CLASSES = spec["widths"]
    import torch

    if DEV == "cuda" and not torch.cuda.is_available():
        print("sanitize child: no CUDA device", file=sys.stderr)
        return 2
    check(os.environ.get("QUIVER_SANITIZE") == "1",
          "the sanitize child runs without QUIVER_SANITIZE=1")
    t_child = time.perf_counter()
    import quiver_tpu_torch as qt
    from quiver_tpu_torch.analysis import transfer_witness as tw
    from quiver_tpu_torch.analysis import witness
    from quiver_tpu_torch.analysis.concurrency import canonical_lock_edges
    from quiver_tpu_torch.analysis.core import load_contexts
    from quiver_tpu_torch.analysis.retrace_guard import count_jit_builds
    from quiver_tpu_torch.analysis.staging import no_sync, regions
    from quiver_tpu_torch.mesh import MeshSampler
    from quiver_tpu_torch.ops.cuda import element_gather as b3
    from quiver_tpu_torch.ops.cuda import gather_rows as b2
    from quiver_tpu_torch.ops.cuda import page_gather as b5
    from quiver_tpu_torch.ops.cuda import window_sample as b1

    check(witness.installed() and tw.installed() and regions.on(),
          "QUIVER_SANITIZE=1 did not install both witnesses")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = os.path.dirname(os.path.abspath(__file__))
    edges = canonical_lock_edges(load_contexts(["quiver_tpu_torch"],
                                               root=root))
    witness.seed_order(edges)
    out = dict(lock_edges_seeded=len(edges))

    topo = qt.CSRTopo(indptr=np.load(spec["indptr"]),
                      indices=np.load(spec["indices"]))
    feat = np.load(spec["table"])
    feature = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                         device=DEV).from_cpu_tensor(feat)
    sampler = qt.GraphSageSampler(topo, FANOUTS, device=DEV, seed=SEED)
    out["setup_s"] = time.perf_counter() - t_child

    # every transfer the phases below see, the deliberate ones (7)
    # excepted: the lint phase holds the package's coercions to its lint
    observed = []

    def drain():
        observed.extend(tw.transfers())
        return tw.drain()

    # (2) fused serving: every pass's forward inside "serving device loop"
    drain()
    mark = []   # the transfers made before the clients start: warm-up
    server, _, _, launches, _, summary = serve(
        torch, qt, sampler, feature, seeded_model(torch, qt),
        {"window_sample": b1.window_sample, "gather_rows": b2.gather_rows},
        during=lambda: mark.append(len(tw.transfers())))
    seen, viol = tw.transfers(), drain()
    chunks = sum(len(c) for _, c in server.pass_log)

    def readback(t):
        return (t.region is None and t.site == ".cpu()"
                and t.where.startswith("serving.py:"))

    readbacks = [t for t in seen if readback(t)]
    # once the clients run, nothing but the answers leaves the card
    outside = [t for t in seen[mark[0]:] if t.region is None
               and not readback(t)]
    out["serving"] = dict(
        launches=launches, p50_ms=summary["stats"]["p50_latency_ms"],
        p99_ms=summary["stats"]["p99_latency_ms"],
        warmup_buckets=len(server.BUCKETS), served_chunks=chunks,
        transfers_by_site=_by_site(seen),
        violations=_in_region(viol, "serving device loop"),
        other_violations=[v.message for v in viol])
    check(not viol, f"{len(viol)} sync(s) inside a region while serving: "
          + json.dumps([v.message for v in viol][:4]))
    check(len(readbacks) == len(server.BUCKETS) + chunks,
          f"{len(readbacks)} answer read-backs for "
          f"{len(server.BUCKETS)} warm-up and {chunks} served chunks")
    check(not outside, "a transfer outside the regions that is no answer "
          "read-back, while serving: " + json.dumps(_by_site(outside)))

    # (3) the "200M" store's lookups: B5 inside "paged gather"
    budgeted = budgeted_feature(qt, topo, feat, pool_pages=N_NODES)
    rng = np.random.default_rng(SEED + 22)
    frontiers = [sampler.sample(rng.integers(0, N_NODES, 2048),
                                key_words=server.draw_key_words()).n_id
                 .cpu().numpy() for _ in range(SANITIZE_PAGED_LOOKUPS)]
    if DEV == "cuda":
        torch.cuda.synchronize()
    drain()
    b5.page_gather.launches = 0
    rows = [budgeted[ids] for ids in frontiers]
    paged_launches = b5.page_gather.launches
    seen, viol = tw.transfers(), drain()
    for ids, r in zip(frontiers, rows):
        check(torch.equal(r, torch.from_numpy(feat[ids]).to(DEV)),
              "a paged lookup differs from the table")
    out["paged"] = dict(lookups=len(frontiers), b5_launches=paged_launches,
                        rows=int(sum(len(i) for i in frontiers)),
                        transfers_by_site=_by_site(seen),
                        violations=_in_region(viol, "paged gather"))
    check(paged_launches > 0, "B5 was not launched by the paged lookups")
    check(not viol, f"{len(viol)} sync(s) inside a region in the paged "
          "lookups: " + json.dumps([v.message for v in viol][:4]))
    del budgeted, rows

    # (4) the mesh combine: MeshSampler over MESH_SHARDS shards of the card
    mesh = qt.make_mesh(("shard",), devices=[torch.device(DEV)] * MESH_SHARDS)
    ms = MeshSampler(topo.indptr, topo.indices, n_shards=MESH_SHARDS,
                     mesh=mesh, gather_mode="pallas")
    hops = [(rng.integers(0, N_NODES, 2048),
             rng.integers(0, 2**32, size=2, dtype=np.uint32))
            for _ in range(SANITIZE_MESH_HOPS)]
    drain()
    b3.element_gather.launches = 0
    outs = [ms.sample(s, FANOUTS[0], kw) for s, kw in hops]
    mesh_launches = b3.element_gather.launches
    seen, viol = tw.transfers(), drain()
    for o in outs:
        check(tuple(o.nbrs.shape) == (2048, FANOUTS[0]),
              f"a mesh hop answered {tuple(o.nbrs.shape)}")
    out["mesh"] = dict(hops=len(outs), shards=MESH_SHARDS,
                       b3_launches=mesh_launches,
                       transfers_by_site=_by_site(seen),
                       violations=_in_region(viol, "mesh combine"))
    check(mesh_launches > 0, "B3 was not launched by the mesh hops")
    check(not viol, f"{len(viol)} sync(s) inside a region in the mesh "
          "hops: " + json.dumps([v.message for v in viol][:4]))
    del ms, outs

    # (6) the build guard: mixed sizes inside the warmed buckets
    with count_jit_builds() as c:
        for n in SANITIZE_MIXED:
            server._run_bucketed(rng.integers(0, N_NODES, n))
    viol = drain()
    out["build_guard"] = dict(sizes=list(SANITIZE_MIXED), builds=c.builds,
                              backend_compiles=c.backend_compiles,
                              sites=c.describe())
    check(not viol, "a sync inside a region in the build-guard requests")
    check(c.builds == 0 and c.backend_compiles == 0,
          f"requests inside the warm buckets built {c.describe()} and ran "
          f"the compiler {c.backend_compiles} time(s)")

    # (5) the lock witness over the whole child
    locks = witness.drain()
    out["lock_violations"] = [f"{v.kind}: {v.message}" for v in locks]
    check(not locks, f"{len(locks)} lock-witness violation(s): "
          + json.dumps(out["lock_violations"][:4]))

    # (8) fixed probes, held against the parent's unsanitized run
    out["probes"] = sanitize_probes(server)
    drain()

    out["coercions"] = _package_coercions(observed)

    # (7) teeth, read after everything above: one .item() and one
    # nonzero inside a region are one violation each
    x = torch.arange(1024, device=DEV)
    with no_sync("teeth: item"):
        x.sum().item()
    v_item = tw.drain()
    with no_sync("teeth: nonzero"):
        torch.nonzero(x > 3)
    v_nonzero = tw.drain()
    # the repair this slice made inside the fused region, undone for one
    # pass: the seeds' upload from pageable memory waits for the stream
    pinned = sampler.seed_tensor
    sampler.seed_tensor = lambda ids: torch.from_numpy(
        sampler._host_seeds(ids).astype(np.int32)).to(sampler.device)
    try:
        server._run_bucketed(rng.integers(0, N_NODES, 100))
    finally:
        sampler.seed_tensor = pinned
    v_pageable = tw.drain()
    out["teeth"] = dict(item=[v.message for v in v_item],
                        nonzero=[v.message for v in v_nonzero],
                        pageable_seed_upload=[v.message
                                              for v in v_pageable])
    check(len(v_pageable) >= 1 and all(
        "`serving device loop`" in v.message for v in v_pageable),
        "the pageable seed upload inside the fused region was not seen")
    check(len(v_item) == 1, f"a .item() in a region recorded {len(v_item)} "
          "violation(s), not 1")
    check(len(v_nonzero) == 1, f"a nonzero in a region recorded "
          f"{len(v_nonzero)} violation(s), not 1")
    out["child_s"] = time.perf_counter() - t_child
    print("sanitize-child " + json.dumps(out), flush=True)
    return 0


def sanitize_phase(torch, qt, topo, feat) -> dict:
    """Slice 14 on the card (phase 4k): the port under QUIVER_SANITIZE=1
    in a child process (the witnesses patch threading.Lock and
    torch.Tensor for the whole process; this one stays unpatched).  The
    parent serves the 64-request plan unsanitized and takes the fixed
    probes' logits; the child (``sanitize_child_main``) must show no
    sync in the three no-sync regions, no lock-order violation, no build
    after warm-up, both deliberate syncs, and the same probe logits bit
    for bit.  Returns a summary with both runs' p50/p99."""
    import shutil

    from quiver_tpu_torch.ops.cuda import gather_rows as b2
    from quiver_tpu_torch.ops.cuda import window_sample as b1

    t_phase = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_sanitize")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        spec = dict(device=DEV, n_nodes=N_NODES,
                    widths=[DIM, HIDDEN, CLASSES])
        for name, arr in (("indptr", topo.indptr), ("indices", topo.indices),
                          ("table", feat)):
            spec[name] = os.path.join(work, f"{name}.npy")
            np.save(spec[name], arr)
        feature = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                             device=DEV).from_cpu_tensor(feat)
        sampler = qt.GraphSageSampler(topo, FANOUTS, device=DEV, seed=SEED)
        server, _, _, launches, _, summary = serve(
            torch, qt, sampler, feature, seeded_model(torch, qt),
            {"window_sample": b1.window_sample,
             "gather_rows": b2.gather_rows})
        probes = sanitize_probes(server)
        del server, sampler, feature
        torch.cuda.empty_cache()

        env = dict(os.environ, QUIVER_SANITIZE="1")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--sanitize-child",
             json.dumps(spec)], cwd=os.path.dirname(os.path.abspath(
                 __file__)), env=env, capture_output=True, text=True,
            timeout=SANITIZE_TIMEOUT_S)
        child_wall_s = time.perf_counter() - t0
        child = None
        for line in proc.stdout.splitlines():
            if line.startswith("sanitize-child "):
                child = json.loads(line[len("sanitize-child "):])
            else:
                print(f"  [sanitize child] {line}", flush=True)
        check(proc.returncode == 0 and child is not None,
              f"the sanitize child failed (rc {proc.returncode}): "
              + proc.stderr[-4000:])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check(child["probes"] == probes,
          "probe logits differ between the sanitized child and the parent")
    out = dict(card=card_line(), child=child, child_wall_s=child_wall_s,
               plain=dict(p50_ms=summary["stats"]["p50_latency_ms"],
                          p99_ms=summary["stats"]["p99_latency_ms"],
                          launches=launches),
               probes_equal=True, phase_s=time.perf_counter() - t_phase)
    print("sanitizer: 64-request plan p50/p99 "
          f"{out['plain']['p50_ms']:.3f}/{out['plain']['p99_ms']:.3f} ms "
          f"plain, {child['serving']['p50_ms']:.3f}/"
          f"{child['serving']['p99_ms']:.3f} ms under QUIVER_SANITIZE=1 "
          f"({out['card']})", flush=True)
    return out


def _statement_span(tree, line: int):
    """(first, last) line of the innermost simple statement holding
    ``line`` (of a compound one, its header): where one Python statement
    runs over several lines, the frame's line and the finding's may be
    any two of them."""
    import ast

    best = None
    for node in ast.walk(tree):
        if not isinstance(node, ast.stmt) or not (
                node.lineno <= line <= node.end_lineno):
            continue
        body = getattr(node, "body", None)
        end = node.end_lineno
        if isinstance(body, list) and body:
            end = body[0].lineno - 1     # a compound statement's header
            if line > end:
                continue
        if best is None or (end - node.lineno) <= (best[1] - best[0]):
            best = (node.lineno, end)
    return best or (line, line)


def lint_phase(child: dict) -> dict:
    """Slice 15 (phase 4l, after 4k): the fifteen-rule lint of this tree
    under ``--strict-baseline``, and every coercion the sanitize child
    observed in the package held against its QT001 / QT013 lines."""
    import ast

    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "QUIVER_SANITIZE"}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "quiver_tpu_torch.analysis",
         "quiver_tpu_torch", "--strict-baseline", "--format", "json"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    lint_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"the port's lint exited {proc.returncode}:"
          f" {proc.stdout[-3000:]} {proc.stderr[-2000:]}")
    doc = json.loads(proc.stdout)
    from quiver_tpu_torch.analysis.rules import RULE_CLASSES

    codes = [cls.code for cls in RULE_CLASSES]
    check(codes == [f"QT{i:03d}" for i in range(1, 16)],
          f"the lint runs {codes}, not the fifteen rules QT001-QT015")
    census = {c: dict(new=0, baselined=0, suppressed=0) for c in codes}
    lines: dict = {}     # (path, line) -> {rule}
    for kind, key in (("findings", "new"), ("baselined", "baselined"),
                      ("suppressed", "suppressed")):
        for f in doc[kind]:
            census[f["rule"]][key] += 1
            if f["rule"] in ("QT001", "QT013"):
                lines.setdefault((f["path"], f["line"]), set()).add(
                    f["rule"])
    print(f"lint: {len(codes)} rules over {doc['files']} files in "
          f"{lint_s:.1f} s, exit 0; census (new/baselined/suppressed) "
          + ", ".join(f"{c} {v['new']}/{v['baselined']}/{v['suppressed']}"
                      for c, v in census.items()), flush=True)

    trees: dict = {}
    matched: dict = {}       # (path, line) -> rule
    unmatched = []
    for c in child["coercions"]:
        where = f"{c['path']}:{c['line']}"
        if where in LINT_BLIND_SPOTS:
            continue
        if c["path"] not in trees:
            with open(os.path.join(root, c["path"])) as fh:
                trees[c["path"]] = ast.parse(fh.read())
        lo, hi = _statement_span(trees[c["path"]], c["line"])
        rules = set().union(*[lines.get((c["path"], ln), set())
                              for ln in range(lo, hi + 1)])
        if rules:
            matched[(c["path"], c["line"])] = "/".join(sorted(rules))
        else:
            unmatched.append(f"{where} ({c['site']}, {c['count']}x"
                             + (f", in `{c['region']}`" if c["region"]
                                else "") + ")")
    by_code: dict = {}
    for rule in matched.values():
        by_code[rule] = by_code.get(rule, 0) + 1
    print(f"lint against the sanitizer: {len(child['coercions'])} "
          f"coercion site(s) in the package over "
          f"{sum(c['count'] for c in child['coercions'])} transfer(s); "
          f"{len(matched)} distinct line(s) matched "
          f"{json.dumps(by_code, sort_keys=True)}; "
          f"{len(LINT_BLIND_SPOTS)} named blind spot(s)", flush=True)
    check(not unmatched, "coercions the lint does not reach (no QT001/QT013 "
          "finding or waiver on the line): " + "; ".join(unmatched))
    return dict(card=card_line(), lint_s=lint_s, rules=codes,
                files=doc["files"], census=census,
                coercion_sites=child["coercions"],
                matched={f"{p}:{ln}": r for (p, ln), r in matched.items()},
                matched_by_code=by_code,
                blind_spots=len(LINT_BLIND_SPOTS))


# -- phase 4m: the user entry points -------------------------------------------

EXAMPLES_OUT = "chip_smoke_partition"  # preprocess_partition's --out, in build/
# each example at its published widths; only epochs and steps are cut
# (PERF.md section 4): (name, argv, config overrides, kernels that must
# launch, what its loss must show: "falls" (the mean of the last tenth of
# the steps below the first step's), "probe" (intra-community cosine
# similarity above the inter) or None (random labels, nothing to learn))
EXAMPLE_RUNS = (
    ("reddit_sage", ["--epochs", "1"], {},
     ("window_sample", "gather_rows"), "falls"),
    ("ogbn_products_sage", ["--force-synthetic", "--synthetic-nodes",
                            "2449029", "--cache", "1G", "--epochs", "1"], {},
     ("window_sample", "gather_rows"), "falls"),
    ("graph_sage_unsup", [], {}, ("window_sample", "gather_rows"), "probe"),
    ("papers100M_dist", ["--mesh-devices", str(MESH_SHARDS)], {},
     ("element_gather", "gather_rows"), None),
    ("mag240m_rgat", [], {}, ("window_sample", "gather_rows"), None),
    ("serving_reddit", [], {}, ("window_sample", "gather_rows"), None),
    ("preprocess_partition", None, {}, (), None),
    ("big_graph_single_chip", [], {}, ("window_sample", "gather_rows"),
     None),
    # the same under the paged store, its pool as large as the host tail
    ("big_graph_single_chip", [], dict(feature_paged="on",
                                       feature_page_pool=1 << 20),
     ("window_sample", "page_gather"), None),
    ("dgl_products_sage", [], {}, ("window_sample", "gather_rows"),
     "falls"),
)
# the line each example ends with, as its JAX script prints it
EXAMPLE_SUMMARY = {
    "reddit_sage": r"^epoch \d+: [\d.]+s, loss [\d.]+, batch acc [\d.]+$",
    "ogbn_products_sage": r"^full-graph val acc: [\d.]+$",
    "graph_sage_unsup": (r"^intra-community cos sim -?[\d.]+ vs inter "
                         r"-?[\d.]+$"),
    "papers100M_dist": (r"^\d+ DP steps x \d+ replicas x \d+ seeds in "
                        r"[\d.]+s \(\d+ ms/step\)$"),
    "mag240m_rgat": r"^\d+ R-GAT steps in [\d.]+s \(\d+ ms/step\)$",
    "serving_reddit": r"^served \d+: avg [\d.]+ms p99 [\d.]+ms \d+ rps$",
    "preprocess_partition": (r"^load_quiver_feature_partition round-trip "
                             r"OK; feed `book` to PartitionInfo"),
    "big_graph_single_chip": (r"^\d+ steps in [\d.]+s \(\d+ ms/step\), "
                              r"final loss [\d.]+$"),
    "dgl_products_sage": (r"^\d+ steps in [\d.]+s; loss [\d.]+ -> [\d.]+ "
                          r"\((dgl blocks|block_specs fallback)\)$"),
}


class _Tee:
    """Standard output that also keeps what passes through it."""

    def __init__(self, out):
        self.out, self.lines = out, []
        self._part = ""

    def write(self, s):
        self.out.write(s)
        self._part += s
        *done, self._part = self._part.split("\n")
        self.lines += done
        return len(s)

    def flush(self):
        self.out.flush()


def examples_phase(torch, qt, counters) -> dict:
    """Phase 4m: the nine examples of ``quiver_tpu_torch.examples`` on the
    card, one after another, in this process through ``main(argv)``
    (EXAMPLE_RUNS).  Every launch counter is 0 just before each call and
    read just after.  Each run must return 0, end with its summary line,
    have finite losses, show what its data can learn, and launch its
    kernels (every example but ``preprocess_partition`` at least one).
    Returns each run's record: wall seconds, launches by kernel, its
    summary line and times."""
    import contextlib
    import importlib
    import re
    import shutil

    from quiver_tpu_torch import config

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", EXAMPLES_OUT)
    shutil.rmtree(out_dir, ignore_errors=True)
    runs = []
    try:
        for name, argv, knobs, must, learns in EXAMPLE_RUNS:
            argv = (["--out", out_dir] if argv is None else list(argv))
            mod = importlib.import_module(f"quiver_tpu_torch.examples.{name}")
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            for c in counters.values():
                c.launches = 0
            tee, report = _Tee(sys.stdout), {}
            t0 = time.perf_counter()
            with config.override(**knobs), contextlib.redirect_stdout(tee):
                rc = mod.main(argv, report=report)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
            where = name + (" (paged)" if knobs else "")
            check(rc == 0, f"example {where} returned {rc}")
            check(tee.lines and re.match(EXAMPLE_SUMMARY[name],
                                         tee.lines[-1]),
                  f"example {where} did not end with its summary line: "
                  f"{tee.lines[-1:]}")
            losses = report.get("losses", [])
            check(all(np.isfinite(losses)), f"example {where}: a loss is "
                  "not finite")
            if learns == "falls":
                tail = max(1, len(losses) // 10)
                check(len(losses) > 1
                      and np.mean(losses[-tail:]) < losses[0],
                      f"example {where}: the loss did not fall "
                      f"({losses[:1]} -> {losses[-tail:]})")
            if learns == "probe":
                check(report["intra"] > report["inter"],
                      f"example {where}: intra-community similarity "
                      f"{report['intra']} not above inter {report['inter']}")
            for k in must:
                check(launches[k] > 0, f"example {where} launched no {k} "
                      "kernel")
            if name != "preprocess_partition":
                check(sum(launches.values()) > 0,
                      f"example {where} launched no kernel")
            rec = dict(example=name, argv=argv, knobs=knobs, wall_s=wall,
                       launches=launches, summary=tee.lines[-1],
                       first_loss=losses[0] if losses else None,
                       last_loss=losses[-1] if losses else None,
                       steps=len(losses))
            for key in ("epoch_s", "steps_s", "full_graph_s", "p50_ms",
                        "p99_ms", "avg_ms", "rps", "served", "lanes",
                        "intra", "inter", "val_acc", "full_graph_acc",
                        "fused", "replicas", "uva_split", "paged", "dgl"):
                if key in report:
                    rec[key] = report[key]
            if knobs:
                check(report.get("paged"), "the paged run built no paged "
                      "store")
            runs.append(rec)
            print(f"example {where}: {wall:.2f} s, launches "
                  + json.dumps({k: v for k, v in launches.items() if v}),
                  flush=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return dict(runs=runs, wall_s=sum(r["wall_s"] for r in runs))


# phase 4n: JAX's threefry key chain and sample_rng="key"
KEYED_SHAPES = ((2048, 25), (53_248, 10), (1024, 15), (16_384, 10),
                (180_224, 5), (15_360, 10), (153_600, 5), (12_345,))
KEYED_PASS = ((2048, 25), (53_248, 10))  # the Reddit bucket-2048 pass's hops
KEYED_STEPS = 10
# the kernel's integer operations an element: 2 counter injections, 20
# rounds of add, funnel-shift rotate and xor, 5 key injections of 2 adds,
# then xor, shift and or (csrc/threefry_uniform.cu)
THREEFRY_INT_OPS = 2 + 20 * 3 + 5 * 2 + 3
# of which the rotates, the round xors and the final xor, shift and or
# must issue on the int32 (ALU) pipe; the adds may also issue as IMAD on
# the fp32 (FMA) pipe
THREEFRY_ALU_OPS = 20 * 2 + 3
# the card's int32 issue rate: 67 TFLOP/s of fp32 (an FMA is 2 flops) over
# 128 fp32 lanes an SM, with 64 int32 lanes an SM (Hopper white paper)
FP32_LANE_OPS_PER_S = 67e12 / 2
INT32_OPS_PER_S = FP32_LANE_OPS_PER_S * 64 / 128


def threefry_bound(n: int):
    """The least time (ms) the card could take for ``n`` threefry uniforms,
    and what bounds it: the output's bytes at HBM_BYTES_PER_S or the
    integer operations at INT32_OPS_PER_S."""
    by_bytes = n * 4 / HBM_BYTES_PER_S * 1e3
    by_ops = n * THREEFRY_INT_OPS / INT32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def threefry_split_pipe_bound(n: int) -> float:
    """A lower floor (ms) than :func:`threefry_bound`'s: the adds issue on
    the fp32 pipe as IMAD, so the ALU-pipe operations at INT32_OPS_PER_S
    and all operations at both pipes' lanes (FP32_LANE_OPS_PER_S) bound
    the time, whichever is larger, with the output's bytes."""
    return max(n * 4 / HBM_BYTES_PER_S,
               n * THREEFRY_ALU_OPS / INT32_OPS_PER_S,
               n * THREEFRY_INT_OPS / FP32_LANE_OPS_PER_S) * 1e3


def threefry_cases(torch, qt, tf) -> list:
    """The threefry kernel against its plain version on the card at
    KEYED_SHAPES, bit for bit (float bits compared as int32), and timed:
    kernel, plain version, bound.  No PyTorch call computes JAX's bits
    (``torch.rand`` draws other numbers), so there is no library time."""
    from quiver_tpu_torch.utils import rng

    dev = torch.device(DEV)
    cases = []
    for i, shape in enumerate(KEYED_SHAPES):
        key = rng.split(rng.key(SEED + 40 + i), 2)[1]
        got = tf.threefry_uniform(key, shape, dev)
        want = tf.threefry_uniform_plain(key, shape, dev)
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        err = float((got - want).abs().max()) if got.numel() else 0.0
        check(same, f"threefry kernel differs from its plain version at "
              f"{shape} (max abs err {err})")
        check(bool(((got >= 0) & (got < 1)).all()),
              f"threefry uniforms outside [0, 1) at {shape}")
        n = got.numel()
        bound, by = threefry_bound(n)
        cases.append(dict(
            shape=list(shape), elements=n, bitwise=same, max_abs_err=err,
            ms=cuda_ms(torch, lambda: tf.threefry_uniform(key, shape, dev)),
            plain_ms=cuda_ms(torch, lambda: tf.threefry_uniform_plain(
                key, shape, dev), reps=5, warm=1),
            host_ms=host_ms(torch, lambda: tf.threefry_uniform(key, shape,
                                                               dev)),
            bound_ms=bound, bound_by=by,
            split_pipe_bound_ms=threefry_split_pipe_bound(n)))
    print("threefry kernel against its plain version (bitwise; ms) "
          + json.dumps(cases), flush=True)
    return cases


def threefry_record(tf, cases) -> dict:
    """The threefry kernel's entry in the kernels line: the Reddit pass's
    two hops (KEYED_PASS) summed, as B1's record sums its hops (the
    shapes it was first timed at; its launches are the keyed ``"pallas"``
    lane's, the path that still reaches it)."""
    main = [c for c in cases if tuple(c["shape"]) in KEYED_PASS]

    def total(key):
        return float(sum(c[key] for c in main))

    return dict(name="threefry_uniform", route="cuda", source=tf.SOURCE,
                replaces=tf.REPLACES,
                replaces_note="no TPU kernel: XLA's jax.random.uniform",
                max_abs_err=max(c["max_abs_err"] for c in cases),
                ms=total("ms"), plain_ms=total("plain_ms"),
                bound_ms=total("bound_ms"), bound_by="operations",
                split_pipe_bound_ms=total("split_pipe_bound_ms"),
                library_ms=None, host_ms=total("host_ms"), cases=cases)


def same_pipeline(torch, got, want, what: str) -> None:
    """Two ``run_pipeline`` results: frontier, its mask and every block's
    local ids and mask bitwise equal."""
    check(torch.equal(got[0], want[0]), f"{what}: n_id differs")
    check(torch.equal(got[1], want[1]), f"{what}: n_id mask differs")
    for a, b in zip(got[3], want[3]):
        check(torch.equal(a.nbr_local, b.nbr_local)
              and torch.equal(a.mask, b.mask), f"{what}: a block differs")


class KeyedLaunches:
    """B1's launches under the key (``window_sample.launches_key``) behind
    the ``launches`` attribute that ``serve`` and the lanes set to 0 and
    read, as they do a wrapper's own count."""

    def __init__(self, b1):
        self.fn = b1.window_sample

    @property
    def launches(self) -> int:
        return self.fn.launches_key

    @launches.setter
    def launches(self, n: int) -> None:
        self.fn.launches_key = n


def keyed_b1_phase(torch, topo, b1) -> dict:
    """B1's threefry instance at the Reddit bucket-2048 pass (KEYED_PASS)
    through both entries, bitwise its plain version (``"xla"`` reads,
    ``threefry_uniform_plain``) and timed against its bound
    (``b1_hops``); then the keyed ``"blocked"`` pipeline's device
    operations a depth: B1 alone a hop (``pwindow_pipeline_phase``).
    Returns the kernels line's record."""
    dev = torch.device(DEV)
    ip, ix = topo.to_device(dev)
    g = np.random.default_rng(SEED + 48)
    seeds = torch.from_numpy(g.integers(0, N_NODES, KEYED_PASS[0][0]).astype(
        np.int32)).to(dev)
    kw = g.integers(0, 2**32, (len(KEYED_PASS), 2), dtype=np.uint32)
    fanouts = [k for _, k in KEYED_PASS]
    cases, n_id, _ = b1_hops(torch, b1, ip, ix, seeds, fanouts, kw,
                             "Reddit keyed", "key")
    check(n_id.shape[0] == KEYED_PASS[-1][0] * (1 + KEYED_PASS[-1][1]),
          f"keyed frontier {n_id.shape[0]}")
    cost = pwindow_pipeline_phase(torch, ip, ix, seeds, kw, fanouts,
                                  "Reddit keyed", b1, gather_mode="blocked",
                                  sample_rng="key")
    rec = b1_record(b1, cases, name="window_sample_key")
    rec.update(pipeline_cost=cost, replaces_note=(
        "B1's threefry instance; JAX's keyed \"blocked\" hop is XLA's "
        "jax.random.uniform (jax_uniform) and its block gather"),
        jax_uniform="quiver_tpu/ops/sample.py:218")
    print("B1 keyed entry at the Reddit pass " + json.dumps(
        {k: v for k, v in rec.items() if k not in ("cases",
                                                   "pipeline_cost")}),
        flush=True)
    return rec


def keyed_hop_times(torch, qt, topo, b1, tf, b3) -> dict:
    """One Reddit hop (2048 seeds, k=25) and the bucket-2048 pass, three
    ways in one call, each as device ms and the host's ms to return from
    the call (its launches): under the key fused (``"blocked"``: B1's
    threefry instance, one launch a hop), under the key unfused (the hop
    as ``sample_hop(..., "blocked", "key")`` composed it before B1 drew
    threefry: B3's pair entry, a threefry launch, B3, the stratified math
    in torch; the pass as the generic loop over the same kernels, which
    is ``"pallas"``'s route), and the hash under ``"pwindow"`` (B1's hash
    instance).  Checks each way's launches a pass."""
    from quiver_tpu_torch.ops.sample import run_hop, sample_hop
    from quiver_tpu_torch.sampler import run_pipeline

    dev = torch.device(DEV)
    ip, ix = topo.to_device(dev)
    g = np.random.default_rng(SEED + 44)
    seeds = torch.from_numpy(g.integers(0, N_NODES, 2048).astype(
        np.int32)).to(dev)
    k0, k1 = (int(w) for w in g.integers(0, 2**32, 2, dtype=np.uint32))
    kw = g.integers(0, 2**32, (len(FANOUTS), 2), dtype=np.uint32)
    n_hops = len(FANOUTS)
    k = FANOUTS[0]
    ways = {
        "key fused": (
            lambda: run_hop(ip, ix, seeds, k, k0, k1, None, "blocked",
                            "key"),
            lambda: run_pipeline("none", ip, ix, seeds, kw, FANOUTS,
                                 gather_mode="blocked", sample_rng="key"),
            dict(b1=n_hops, b1_key=n_hops, threefry=0, b3=0)),
        "key unfused": (
            lambda: sample_hop(ip, ix, seeds, k, k0, k1, None, "blocked",
                               "key"),
            lambda: run_pipeline("none", ip, ix, seeds, kw, FANOUTS,
                                 gather_mode="pallas", sample_rng="key"),
            dict(b1=0, b1_key=0, threefry=n_hops, b3=2 * n_hops)),
        "hash pwindow": (
            lambda: run_hop(ip, ix, seeds, k, k0, k1, None, "pwindow",
                            "hash"),
            lambda: run_pipeline("none", ip, ix, seeds, kw, FANOUTS,
                                 gather_mode="pwindow", sample_rng="hash"),
            dict(b1=n_hops, b1_key=0, threefry=0, b3=0)),
    }

    def counts():
        return dict(b1=b1.window_sample.launches,
                    b1_key=b1.window_sample.launches_key,
                    threefry=tf.threefry_uniform.launches,
                    b3=b3.element_gather.launches)

    out = {}
    for label, (hop, one_pass, per_pass) in ways.items():
        before = counts()
        one_pass()
        torch.cuda.synchronize()
        ran = {n: c - before[n] for n, c in counts().items()}
        check(ran == per_pass, f"{label}: a pass launched {ran}, not "
              f"{per_pass}")
        out[label] = dict(hop_ms=cuda_ms(torch, hop),
                          hop_host_ms=host_ms(torch, hop),
                          pass_ms=cuda_ms(torch, one_pass),
                          pass_host_ms=host_ms(torch, one_pass),
                          launches_a_pass=ran)
    fused, flat = ways["key fused"][1](), ways["key unfused"][1]()
    torch.cuda.synchronize()
    same_pipeline(torch, fused, flat, "the fused keyed pass")
    for key in ("pass_ms", "pass_host_ms"):
        out[f"fused_over_pwindow_{key}"] = (out["key fused"][key]
                                            / out["hash pwindow"][key])
        out[f"unfused_over_fused_{key}"] = (out["key unfused"][key]
                                            / out["key fused"][key])
    print("a keyed hop and pass, fused and unfused, beside the hashed "
          "\"pwindow\" ones (device ms and host ms to return, median of "
          "15) " + json.dumps(out), flush=True)
    return out


def keyed_serving_phase(torch, qt, topo, feat, feature, b1, b2, b3, tf):
    """Phase 4n on the Reddit graph: the 64-request plan served by a
    sampler under ``sample_rng="key"`` (the auto gather mode, which is
    then ``"blocked"``: B1's keyed pipeline entry once a hop, B2 once a
    pass, no threefry and no B3 launch, warm-up included), every served
    batch's ``n_id`` and masks bitwise the same sampler's under ``"xla"``
    on the card; then ``key=rng.key(s)`` under each RNG on the card
    against the CPU path the tests hold against JAX (B1's hash instance
    under the hash, its keyed one under the key, no threefry launch under
    either); and the hop times."""
    from quiver_tpu_torch.utils import rng

    sampler = qt.GraphSageSampler(topo, FANOUTS, device=DEV, seed=SEED,
                                  sample_rng="key")
    check((sampler.gather_mode, sampler.sample_rng) == ("blocked", "key"),
          f"keyed sampler resolved to {sampler!r}")
    counters = {"window_sample": b1.window_sample,
                "window_sample_key": KeyedLaunches(b1),
                "gather_rows": b2.gather_rows}
    # kernels the keyed plan must not launch, from warm-up on
    absent = {"threefry_uniform": tf.threefry_uniform,
              "element_gather": b3.element_gather}
    for fn in absent.values():
        fn.launches = 0
    server, answers, sent, launches, _, summary = serve(
        torch, qt, sampler, feature, seeded_model(torch, qt), counters)
    launches.update({name: fn.launches for name, fn in absent.items()})
    chunks = [c for _, cs in server.pass_log for c in cs]
    n_hops = len(FANOUTS)
    for name, per in (("window_sample", n_hops),
                      ("window_sample_key", n_hops),
                      ("threefry_uniform", 0), ("element_gather", 0),
                      ("gather_rows", 1)):
        check(launches[name] == per * len(chunks),
              f"keyed serving: {name} launched {launches[name]} times in "
              f"{len(chunks)} passes, not {per} a pass")
    xla = qt.GraphSageSampler(topo, FANOUTS, device=DEV, gather_mode="xla",
                              sample_rng="key")
    with torch.inference_mode():
        for i, (padded, kw) in enumerate(chunks):
            seeds = sampler.seed_tensor(padded)
            same_pipeline(torch, sampler.pipeline(seeds, kw),
                          xla.pipeline(seeds, kw), f"keyed pass {i}")
    print(f"keyed serving: {len(chunks)} served batches bitwise the "
          "\"xla\" sampler's under the same key", flush=True)

    # from a seed alone, on the card and on the CPU
    ids = np.random.default_rng(SEED + 45).integers(0, N_NODES, 2048)
    seed_checks = {}
    for srng in ("hash", "key"):
        card_s = qt.GraphSageSampler(topo, FANOUTS, device=DEV,
                                     sample_rng=srng)
        cpu_s = qt.GraphSageSampler(topo, FANOUTS, device="cpu",
                                    sample_rng=srng)
        before = (b1.window_sample.launches, b1.window_sample.launches_key,
                  tf.threefry_uniform.launches)
        with torch.inference_mode():
            got = card_s.sample(ids, key=rng.key(SEED + 46))
            torch.cuda.synchronize()
            ran = tuple(a - b for a, b in zip(
                (b1.window_sample.launches, b1.window_sample.launches_key,
                 tf.threefry_uniform.launches), before))
            want = cpu_s.sample(ids, key=rng.key(SEED + 46))
        check(ran == (n_hops, n_hops if srng == "key" else 0, 0),
              f"{srng}: (B1, B1 keyed, threefry) launched {ran} in one "
              f"{n_hops}-hop sample")
        check(torch.equal(got.n_id.cpu(), want.n_id)
              and torch.equal(got.n_id_mask.cpu(), want.n_id_mask),
              f"{srng}: the card's n_id from key= differs from the CPU's")
        seed_checks[srng] = dict(gather_mode=card_s.gather_mode,
                                 b1_launches=ran[0], b1_key_launches=ran[1],
                                 threefry_launches=ran[2],
                                 frontier=int(got.n_id.shape[0]))
    print("key=rng.key(s) on the card against the CPU path: n_id equal "
          + json.dumps(seed_checks), flush=True)
    summary.update(launches=launches, served_batches=len(chunks),
                   from_a_seed=seed_checks,
                   hop_times=keyed_hop_times(torch, qt, topo, b1, tf, b3))
    return launches, summary


# the keyed products lanes: gather mode, then each kernel's launches a
# step by its count's name (B1 counted under both RNGs and under the key)
KEYED_LANES = (
    ("pallas", dict(window_sample=0, window_sample_key=0,
                    threefry_uniform=len(P_FANOUTS),
                    element_gather=2 * len(P_FANOUTS), gather_rows=1)),
    ("auto", dict(window_sample=len(P_FANOUTS),
                  window_sample_key=len(P_FANOUTS), threefry_uniform=0,
                  element_gather=0, gather_rows=1)),
)


def keyed_training_phase(torch, qt, topo, feat, labels, train, b1, b2, b3,
                         tf):
    """Phase 4n at products size: B1's threefry instance at products'
    three hops against its plain version (``b1_hops``), then KEYED_STEPS
    fused steps under ``sample_rng="key"`` in each of KEYED_LANES:
    ``gather_mode="pallas"`` (B3 twice a hop, one threefry launch a hop,
    B2 once a step) and the default (``"blocked"``: B1's keyed pipeline
    entry once a hop, B2 once a step), each step from
    ``key=rng.key(i)``; finite losses, and each step's batch bitwise the
    ``"xla"`` sampler's under the same key.  Returns the launches and
    summary of each lane and B1's products cases."""
    from quiver_tpu_torch.utils import rng

    t0 = time.perf_counter()
    feature = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                         device=DEV).from_cpu_tensor(feat)
    labels_d = torch.from_numpy(labels).to(DEV)
    ip, ix = topo.to_device(DEV)
    pseeds, pkw = products_batch(torch, torch.device(DEV), train)
    b1_cases, _, _ = b1_hops(torch, b1, ip, ix, pseeds, P_FANOUTS, pkw,
                             "products keyed", "key")
    xla = qt.GraphSageSampler(topo, P_FANOUTS, device=DEV, gather_mode="xla",
                              sample_rng="key")
    ones = torch.ones((P_BATCH,), dtype=torch.bool, device=DEV)
    counters = {"window_sample": b1.window_sample,
                "window_sample_key": KeyedLaunches(b1),
                "threefry_uniform": tf.threefry_uniform,
                "element_gather": b3.element_gather,
                "gather_rows": b2.gather_rows}
    out = {}
    for mode, per in KEYED_LANES:
        sampler = qt.GraphSageSampler(topo, P_FANOUTS, device=DEV, seed=SEED,
                                      gather_mode=mode, sample_rng="key")
        model = products_model(torch, qt)
        opt = torch.optim.Adam(model.parameters(), lr=P_LR)
        step = qt.make_fused_train_step(sampler, feature, model, opt,
                                        seed=SEED)
        torch.cuda.synchronize()
        print(f"keyed fused lane {mode!r}: {sampler!r}; set up in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        for fn in counters.values():
            fn.launches = 0
        losses, wall, steps = [], [], []
        for i, (seeds, lab) in enumerate(batches(torch, train, labels_d,
                                                 KEYED_STEPS, SEED + 47,
                                                 P_BATCH)):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            losses.append(step(seeds, lab, ones,
                               key=rng.key(SEED + 100 + i)))
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t1) * 1e3)
            steps.append(seeds)
        launches = {name: fn.launches for name, fn in counters.items()}
        for name, n in per.items():
            check(launches[name] == n * KEYED_STEPS,
                  f"keyed training ({mode}): {name} launched "
                  f"{launches[name]} times in {KEYED_STEPS} steps, not {n} "
                  "a step")
        losses = torch.stack(losses).cpu().numpy()
        check(np.isfinite(losses).all(),
              f"a keyed step's loss is not finite ({mode})")
        # each step's batch again, from the same key, through "xla"
        with torch.inference_mode():
            for i, seeds in enumerate(steps):
                words = sampler.words_of_key(rng.split(rng.key(
                    SEED + 100 + i))[0])
                same_pipeline(torch, sampler.pipeline(seeds, words, False),
                              xla.pipeline(seeds, words, False),
                              f"keyed step {i} ({mode})")
        summary = dict(steps=KEYED_STEPS, gather_mode=sampler.gather_mode,
                       sample_rng=sampler.sample_rng, launches=launches,
                       losses=losses.tolist(),
                       step_wall_ms=float(np.median(wall[2:])))
        print(f"keyed fused training ({mode}) " + json.dumps(summary),
              flush=True)
        out[mode] = (launches, summary)
        del step, opt, model
        t0 = time.perf_counter()
    del feature
    torch.cuda.empty_cache()
    return out, b1_cases


# the phases, in the order a whole run takes them; ``--phases`` names some
PHASES = (
    "kernel",         # 3: B1 and B2 against their plain versions (Reddit)
    "serving",        # 4: the device lane at Reddit width
    "weighted",       # 4b: weighted dedup="hop" serving, "blocked:3"
    "host_sampler",   # 4c: the native host sampler
    "hybrid",         # 4d: both serving lanes
    "resilient",      # 4e: QoS, a device fault, a burst
    "streaming",      # 4f: ingest, fold, checkpoint, boot
    "sharding",       # 4g: the mesh and the dist stores
    "bf16_mmap",      # 4i: bf16 serving, from_mmap
    "budgeted",       # 5-8: B5, the budgeted lane, fallback and overlay
    "products",       # 9-12: B1 at products' hops, B3/B4, both train lanes
    "dp",             # 12b (4h): the data-parallel step
    "full_graph",     # 13: exact inference of the trained models
    "products_host",  # 13b: UVA, the mixed sampler, the torch loader
    "rgat",           # 14: R-GAT at MAG240M widths
    "fleet",          # 4j: three replica processes
    "sanitize",       # 4k: serving under QUIVER_SANITIZE=1
    "lint",           # 4l: the lint against 4k's transfers
    "keyed",          # 4n: threefry keys, sample_rng="key" (Reddit, products)
    "examples",       # 4m: the nine user entry points
)
# what a phase needs from an earlier one (its results, not only the data)
PHASE_NEEDS = {"bf16_mmap": ("serving",), "full_graph": ("products",),
               "lint": ("sanitize",)}
# phases on the Reddit graph and table, and on the products data
REDDIT_PHASES = {"kernel", "serving", "weighted", "host_sampler", "hybrid",
                 "resilient", "streaming", "sharding", "bf16_mmap",
                 "budgeted", "fleet", "sanitize", "keyed"}
PRODUCTS_PHASES = {"products", "dp", "full_graph", "products_host", "keyed"}


def select_phases(argv) -> list:
    """The phases ``--phases a,b,...`` names, with those they need, in
    run order; every phase without the argument.  An unknown name exits
    with code 2."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="chip_smoke.py",
        description="Smoke run of quiver_tpu_torch on one CUDA card.")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run (with the shared "
                         "setup they need): " + ", ".join(PHASES))
    args = ap.parse_args(argv)
    if args.phases is None:
        return list(PHASES)
    names = [p.strip() for p in args.phases.split(",") if p.strip()]
    unknown = [p for p in names if p not in PHASES]
    if unknown or not names:
        ap.error(f"unknown phase(s) {unknown or names!r}; choose from "
                 + ", ".join(PHASES))
    want = set(names)
    for p in names:
        want.update(PHASE_NEEDS.get(p, ()))
    return [p for p in PHASES if p in want]


def main(argv=None) -> int:
    phases = select_phases(argv)
    want = set(phases)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        import quiver_tpu_torch as qt
    except ImportError as e:
        print(f"chip_smoke: quiver_tpu_torch not importable: {e}",
              file=sys.stderr)
        return 2
    from quiver_tpu_torch.ops.cuda import KERNELS, build
    from quiver_tpu_torch.ops.cuda import element_gather as b3
    from quiver_tpu_torch.ops.cuda import gather_rows as b2
    from quiver_tpu_torch.ops.cuda import lane_select as b4
    from quiver_tpu_torch.ops.cuda import page_gather as b5
    from quiver_tpu_torch.ops.cuda import sage_act as sa
    from quiver_tpu_torch.ops.cuda import sage_act_mean as sam
    from quiver_tpu_torch.ops.cuda import sage_mean as sm
    from quiver_tpu_torch.ops.cuda import threefry as tf
    from quiver_tpu_torch.ops.cuda import window_sample as b1
    from quiver_tpu_torch.sampler import run_pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}", flush=True)
    if len(phases) < len(PHASES):
        print(f"phases: {phases}", flush=True)

    t0 = time.perf_counter()
    build.build_all(KERNELS)
    print(f"built {list(KERNELS)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name in KERNELS:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    print(f"cudaLimitMaxL2FetchGranularity: {l2_fetch_granularity(torch)} B",
          flush=True)

    # the kernels line's records, by kernel; a phase that runs without the
    # one that measures a kernel adds its launches to a bare record
    recs = {}

    def kr(name: str) -> dict:
        return recs.setdefault(name, {"name": name})

    phase_s = {}
    slice12 = {}
    if want & REDDIT_PHASES:
        t0 = time.perf_counter()
        indptr, indices = qt.synthetic_csr(N_NODES, N_EDGES, seed=SEED)
        topo = qt.CSRTopo(indptr=indptr, indices=indices)
        feat = np.random.default_rng(SEED).standard_normal(
            (N_NODES, DIM), dtype=np.float32)
        feature = qt.Feature(device_cache_size=feat.nbytes, csr_topo=topo,
                             device=DEV).from_cpu_tensor(feat)
        topo.to_device(DEV)
        torch.cuda.synchronize()
        print(f"graph {topo!r}, features {feature!r}: set up in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

    if "kernel" in want:
        for rec in kernel_phase(torch, qt, topo, feature, b1, b2):
            recs[rec["name"]] = rec
    summary = None
    if "serving" in want:
        launches, summary = serving_phase(torch, qt, topo, feat, feature,
                                          b1, b2)
        for name in ("window_sample", "gather_rows"):
            kr(name)["launches"] = launches[name]
    launches_w = summary_w = None
    if "weighted" in want:
        launches_w, summary_w = weighted_serving_phase(
            torch, qt, topo, feature, b2, b3)
        kr("gather_rows")["launches_weighted_serving"] = \
            launches_w["gather_rows"]
        torch.cuda.empty_cache()

    # slice 9: the host sampler, then serving through both lanes
    host = summary_h9 = None
    if "host_sampler" in want:
        t0 = time.perf_counter()
        host = host_sampler_phase(torch, qt, topo)
        phase_s["host_sampler"] = time.perf_counter() - t0
    if "hybrid" in want:
        t0 = time.perf_counter()
        launches_h, summary_h9 = hybrid_serving_phase(torch, qt, topo,
                                                      feature, b1, b2)
        phase_s["hybrid_serving"] = time.perf_counter() - t0
        kr("window_sample")["launches_hybrid_serving"] = \
            launches_h["window_sample"]
        kr("gather_rows")["launches_hybrid_serving"] = \
            launches_h["gather_rows"]
        kr("gather_rows")["hybrid_cpu_lane_requests"] = \
            summary_h9["cpu_lane"]["requests"]
        torch.cuda.empty_cache()

    # slice 10: serving's safeguards and telemetry
    if "resilient" in want:
        launches_r10, summary_r10 = resilient_serving_phase(
            torch, qt, topo, feature, b1, b2)
        kr("window_sample")["launches_resilient_serving"] = \
            launches_r10["window_sample"]
        kr("gather_rows")["launches_resilient_serving"] = \
            launches_r10["gather_rows"]
        torch.cuda.empty_cache()

    # slice 11: streaming serving, durability and a warm restart
    launches_s11 = summary_s11 = None
    if "streaming" in want:
        t0 = time.perf_counter()
        launches_s11, summary_s11 = streaming_phase(
            torch, qt, topo, feat, feature, b1, b2, b3, b5)
        phase_s["streaming"] = time.perf_counter() - t0
        kr("gather_rows")["launches_streaming_serving"] = \
            launches_s11["gather_rows"]
        torch.cuda.empty_cache()

    # slice 12: sharding over a mesh on the card, bf16 models, from_mmap
    launches_m = b3_dist = None
    if "sharding" in want:
        t0 = time.perf_counter()
        launches_m, b3_dist, slice12["sharding"] = sharding_phase(
            torch, qt, topo, feat, feature, b1, b2, b3)
        phase_s["sharding"] = time.perf_counter() - t0
        kr("gather_rows")["launches_mesh_serving"] = \
            launches_m["gather_rows"]
        kr("gather_rows")["launches_dist_lookups"] = sum(
            v["b2_launches"] for k, v in slice12["sharding"]["dist"].items()
            if k in ("dist", "ring", "hier"))
    if "bf16_mmap" in want:
        t0 = time.perf_counter()
        launches_16, slice12["bf16"] = bf16_phase(
            torch, qt, topo, feat, feature, summary, b1, b2)
        kr("window_sample")["launches_bf16_serving"] = \
            launches_16["window_sample"]
        kr("gather_rows")["launches_bf16_serving"] = \
            launches_16["gather_rows"]
        slice12["mmap"] = mmap_phase(torch, qt, topo, feat, b2, b5)
        kr("gather_rows")["launches_mmap_staged"] = slice12["mmap"][
            "staged"]["gather_rows"]
        phase_s["bf16_and_mmap"] = time.perf_counter() - t0
        torch.cuda.empty_cache()

    # slices 17 and 18: the threefry kernel, B1's threefry instance, then
    # Reddit served under the key
    keyed = {}
    if "keyed" in want:
        t0 = time.perf_counter()
        tf_cases = threefry_cases(torch, qt, tf)
        b1_key = keyed_b1_phase(torch, topo, b1)
        launches_k, keyed["serving"] = keyed_serving_phase(
            torch, qt, topo, feat, feature, b1, b2, b3, tf)
        # the threefry kernel's launches are the keyed "pallas" lane's
        recs["threefry_uniform"] = dict(
            threefry_record(tf, tf_cases),
            launches_keyed_serving=launches_k["threefry_uniform"])
        recs["window_sample_key"] = dict(
            b1_key, launches=launches_k["window_sample_key"])
        for name in ("window_sample", "element_gather", "gather_rows"):
            kr(name)["launches_keyed_serving"] = launches_k[name]
        phase_s["keyed_serving"] = time.perf_counter() - t0
        torch.cuda.empty_cache()

    # slice 2: every feature below compares with the source table by its
    # own feature_order (each from_cpu_tensor rewrites topo.feature_order)
    if "budgeted" in want:
        src = torch.from_numpy(feat).to(DEV)
        t0 = time.perf_counter()
        budgeted = budgeted_feature(qt, topo, feat, pool_pages=N_NODES)
        torch.cuda.synchronize()
        print(f"budgeted feature built in {time.perf_counter() - t0:.2f} s",
              flush=True)
        b5_record, n_id = b5_phase(torch, qt, topo, feat, budgeted, src, b5)
        server_b, launches_b, summary_b = budgeted_serving_phase(
            torch, qt, topo, budgeted, feature, src, b1, b5)
        b5_record["launches"] = launches_b["page_gather"]
        b5_record["launches_per_pass"] = (launches_b["page_gather"]
                                          / summary_b["passes"])
        if launches_s11 is not None:
            b5_record["launches_coldcache_restore"] = \
                launches_s11["page_gather"]
        if "mmap" in slice12:
            b5_record["launches_mmap_paged"] = \
                slice12["mmap"]["paged"]["page_gather"]
        b5_record.update(recs.get("page_gather", {}))
        recs["page_gather"] = b5_record
        summary_b["fallback_overlay"] = fallback_overlay_phase(
            torch, qt, topo, feat, src, n_id)
        stages = budgeted_stage_times(torch, server_b)
        print("budgeted bucket-2048 pass split (ms, median of 5) "
              + json.dumps(stages), flush=True)
        prof = device_profile(torch, pass_runner(server_b.unfused_forward,
                                                 SEED + 8),
                              stages["pass_wall"])
        print("budgeted bucket-2048 pass on the card (torch.profiler) "
              + json.dumps(prof), flush=True)
        hprof = host_profile(torch, pass_runner(server_b.unfused_forward,
                                                SEED + 9))
        print("budgeted bucket-2048 pass on the host (cProfile, own time) "
              + json.dumps(hprof), flush=True)
        summary_b.update(stages_ms=stages, device_profile=prof,
                         host_profile=hprof)
    if summary is not None:
        print("summary " + json.dumps(summary), flush=True)
    if "budgeted" in want:
        print("budgeted summary " + json.dumps(summary_b), flush=True)
        del budgeted, server_b, src
    if want & REDDIT_PHASES:
        del feature
    torch.cuda.empty_cache()

    # slice 3: training at ogbn-products width
    if want & PRODUCTS_PHASES:
        t0 = time.perf_counter()
        ptopo, pfeat, plabels, ptrain = products_data(qt)
        ptopo.to_device(DEV)
        torch.cuda.synchronize()
        print(f"products graph {ptopo!r}, features {pfeat.shape}, "
              f"{len(ptrain)} train seeds: made in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    if "products" in want:
        b1_cases, b1_cost = b1_products_phase(torch, ptopo, ptrain, b1)
        products = b1_record(b1, b1_cases)
        kr("window_sample")["products"] = {k: products[k] for k in (
            "ms", "plain_ms", "bound_ms", "host_ms", "literal_ms",
            "literal_host_ms", "cases")}
        kr("window_sample")["products"]["pipeline_cost"] = b1_cost
        pip, pix = ptopo.to_device(DEV)
        pseeds, pkw = products_batch(torch, torch.device(DEV), ptrain)
        blocked_p = blocked_phase(
            torch, "products", lambda mode: run_pipeline(
                "none", pip, pix, pseeds, pkw, P_FANOUTS, gather_mode=mode),
            b3, 2 * len(P_FANOUTS))
        b3_record, b4_record = b3_b4_phase(torch, qt, ptopo, ptrain, b3, b4)
        if launches_w is not None:
            b3_record["launches_weighted_serving"] = \
                launches_w["element_gather"]
        if launches_s11 is not None:
            b3_record["launches_streaming_serving"] = \
                launches_s11["element_gather"]
            b3_record["streaming_overlay_hops"] = \
                summary_s11["overlay_hops"]
        if launches_m is not None:
            b3_record["launches_mesh_serving"] = launches_m["element_gather"]
            b3_record["launches_dist_sampler"] = b3_dist
        lanes, models, b2_products, sage_records = fused_training_phase(
            torch, qt, ptopo, pfeat, plabels, ptrain, b1, b2, b3)
        kr("gather_rows")["products"] = b2_products
        for rec in sage_records:
            r = kr(rec["name"])
            r.update(rec)
            for lane in ("pallas", "auto", "auto hop", "gat", "gcn"):
                key = f"launches_{lane.replace(' ', '_')}_training"
                r[key] = lanes[lane][0][rec["name"]]
        (launches_f, summary_f), (launches_a, summary_a), \
            (launches_h, summary_h) = (lanes["pallas"], lanes["auto"],
                                       lanes["auto hop"])
        b3_record["launches"] = launches_f["element_gather"]
        kr("window_sample")["launches_fused_training_auto"] = \
            launches_a["window_sample"]
        kr("window_sample")["launches_hop_training"] = \
            launches_h["window_sample"]
        kr("gather_rows")["launches_fused_training"] = \
            launches_f["gather_rows"]
        kr("gather_rows")["launches_hop_training"] = \
            launches_h["gather_rows"]
        for family in ("gat", "gcn"):
            for name in ("window_sample", "gather_rows"):
                kr(name)[f"launches_{family}_training"] = \
                    lanes[family][0][name]
        side = {}
        for name, summ in (("none", summary_a), ("hop", summary_h)):
            prof = summ["device_profile"]
            side[name] = dict(
                step_wall_ms=summ["step_wall_ms"],
                sample_span_ms=summ["split_ms"]["sample"],
                device_ms=prof["device_ms"],
                sort_searchsorted_scatter=prof.get("families", {}).get(
                    "sort_searchsorted_scatter"),
                busy_share=prof.get("busy_share"),
                peak_gib=summ["peak_gib"], losses=summ["losses"])
        if all(isinstance(side[n]["device_ms"], float) for n in side):
            # the dedup's whole device cost: sort, compares, cumsum, scatter
            side["hop"]["dedup_device_ms"] = (side["hop"]["device_ms"]
                                              - side["none"]["device_ms"])
        print("products fused training under \"auto\", dedup=\"hop\" beside "
              "dedup=\"none\" " + json.dumps(side), flush=True)
        launches_s, summary_s = staged_training_phase(
            torch, qt, ptopo, pfeat, plabels, ptrain, b2, b4)
        b4_record["launches"] = launches_s["lane_select"]
        kr("gather_rows")["launches_two_stage_training"] = \
            launches_s["gather_rows"]
        b3_record.update(recs.get("element_gather", {}))
        b4_record.update(recs.get("lane_select", {}))
        recs["element_gather"], recs["lane_select"] = b3_record, b4_record
    if "dp" in want:
        t0 = time.perf_counter()
        launches_dp, slice12["data_parallel"] = dp_phase(
            torch, qt, ptopo, pfeat, plabels, ptrain, b1, b2)
        phase_s["data_parallel"] = time.perf_counter() - t0
        kr("window_sample")["launches_dp_training"] = \
            launches_dp["window_sample"]
        kr("gather_rows")["launches_dp_training"] = \
            launches_dp["gather_rows"]
    if "keyed" in want:
        t0 = time.perf_counter()
        lanes_k, b1_key_p = keyed_training_phase(
            torch, qt, ptopo, pfeat, plabels, ptrain, b1, b2, b3, tf)
        keyed["training"] = {mode: summ for mode, (_, summ) in
                             lanes_k.items()}
        pallas_k, auto_k = lanes_k["pallas"][0], lanes_k["auto"][0]
        kr("threefry_uniform")["launches"] = pallas_k["threefry_uniform"]
        kr("threefry_uniform")["launches_keyed_training"] = \
            pallas_k["threefry_uniform"]
        kr("element_gather")["launches_keyed_training"] = \
            pallas_k["element_gather"]
        kr("window_sample")["launches_keyed_training"] = \
            auto_k["window_sample"]
        products_key = b1_record(b1, b1_key_p, name="window_sample_key")
        kr("window_sample_key").update(
            launches_keyed_training=auto_k["window_sample_key"],
            products={k: products_key[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "host_ms",
                "literal_ms", "literal_host_ms", "cases")})
        kr("gather_rows")["launches_keyed_training"] = {
            mode: launches["gather_rows"] for mode, (launches, _) in
            lanes_k.items()}
        phase_s["keyed_training"] = time.perf_counter() - t0
        keyed["phase_s"] = {k: phase_s[k] for k in (
            "keyed_serving", "keyed_training")}
        print("slices 17 and 18 summary " + json.dumps(keyed), flush=True)
    if "products" in want:
        print("fused training summary " + json.dumps(summary_f), flush=True)
        print("fused training summary, gather_mode=\"auto\" "
              + json.dumps(summary_a), flush=True)
        print("fused training summary, gather_mode=\"auto\", dedup=\"hop\" "
              + json.dumps(summary_h), flush=True)
    if summary_w is not None:
        print("weighted hop serving summary " + json.dumps(summary_w),
              flush=True)
    if "products" in want:
        print(f"{BLOCKED_MODE} summary " + json.dumps(dict(
            products=blocked_p,
            reddit_weighted_hop=(summary_w or {}).get("blocked"))),
            flush=True)
        print("two-stage training summary " + json.dumps(summary_s),
              flush=True)
        for family in ("gat", "gcn"):
            print(f"fused training summary, {family.upper()} "
                  + json.dumps(lanes[family][1]), flush=True)

    # slice 7: exact inference of the trained models, then R-GAT
    if "full_graph" in want:
        full = full_graph_phase(torch, qt, ptopo, pfeat, models)
        print("full_graph_inference summary " + json.dumps(full),
              flush=True)

    # slice 9 at products size: UVA, the mixed sampler, the torch loader
    if "products_host" in want:
        t0 = time.perf_counter()
        uva = uva_phase(torch, qt, ptopo, ptrain, b1)
        phase_s["uva"] = time.perf_counter() - t0
        kr("window_sample")["launches_uva"] = uva["overlap"]["b1_launches"]
        t0 = time.perf_counter()
        mixed = mixed_phase(torch, qt, ptopo, ptrain)
        phase_s["mixed"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        loader = interop_phase(torch, qt, ptopo, pfeat, plabels, ptrain, b2)
        phase_s["torch_loader"] = time.perf_counter() - t0
        kr("gather_rows")["launches_torch_loader"] = loader["b2_launches"]
    if want & {"host_sampler", "hybrid", "products_host"}:
        s9 = {}
        if host is not None:
            s9["host_sampler"] = host
        if summary_h9 is not None:
            s9["hybrid_serving"] = {k: v for k, v in summary_h9.items()
                                    if k != "serving"}
        if "products_host" in want:
            s9.update(uva=uva, mixed=mixed, torch_loader=loader)
        s9["phase_s"] = phase_s
        print("slice 9 summary " + json.dumps(s9), flush=True)
    torch.cuda.empty_cache()
    if want & PRODUCTS_PHASES:
        if "products" in want:
            del models, lanes, pip, pix, pseeds
        del ptopo, pfeat
    torch.cuda.empty_cache()
    if "rgat" in want:
        launches_r, summary_r, b1_mag, b2_mag = rgat_phase(torch, qt, b1, b2)
        kr("window_sample").update(
            launches_rgat_training=launches_r["window_sample"], mag=b1_mag)
        kr("gather_rows").update(
            launches_rgat_training=launches_r["gather_rows"], mag=b2_mag)
        print("R-GAT training summary " + json.dumps(summary_r), flush=True)
    if want & {"sharding", "bf16_mmap", "dp"}:
        slice12["phase_s"] = {k: phase_s[k] for k in (
            "sharding", "bf16_and_mmap", "data_parallel") if k in phase_s}
        print("slice 12 summary " + json.dumps(slice12), flush=True)

    # slice 13: the serving fleet, three replica processes on the card
    if "fleet" in want:
        torch.cuda.empty_cache()
        fleet = fleet_phase(torch, qt, topo, feat, b2, b3)
        for name in ("gather_rows", "element_gather"):
            kr(name)["launches_fleet_serving"] = {
                rid: r["launches"][name]
                for rid, r in fleet["replicas"].items()}
        print("slice 13 summary " + json.dumps(fleet), flush=True)

    # slice 14: the port under its sanitizer, in a child process
    if "sanitize" in want:
        torch.cuda.empty_cache()
        sanitize = sanitize_phase(torch, qt, topo, feat)
        for name in ("window_sample", "gather_rows"):
            kr(name)["launches_sanitized_serving"] = \
                sanitize["child"]["serving"]["launches"][name]
        kr("element_gather")["launches_sanitized_mesh"] = \
            sanitize["child"]["mesh"]["b3_launches"]
        kr("page_gather")["launches_sanitized_paged"] = \
            sanitize["child"]["paged"]["b5_launches"]
        print("slice 14 summary " + json.dumps(sanitize), flush=True)

    # slice 15: the fifteen-rule lint against the sanitizer's transfers
    if "lint" in want:
        t0 = time.perf_counter()
        lint = lint_phase(sanitize["child"])
        lint["phase_s"] = time.perf_counter() - t0
        print("slice 15 summary " + json.dumps(lint), flush=True)

    # slice 16: the user entry points
    if "examples" in want:
        if want & REDDIT_PHASES:
            del topo, feat
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        example_counters = {
            "window_sample": b1.window_sample,
            "gather_rows": b2.gather_rows,
            "element_gather": b3.element_gather,
            "lane_select": b4.lane_select,
            "page_gather": b5.page_gather,
            "threefry_uniform": tf.threefry_uniform,
            "sage_mean": sm.sage_mean,
            "sage_mean_backward": sm.sage_mean_backward,
            "sage_act": sa.sage_act,
            "sage_act_backward": sa.sage_act_backward,
            "sage_act_mean": sam.sage_act_mean,
            "sage_act_mean_backward": sam.sage_act_mean_backward}
        examples = examples_phase(torch, qt, example_counters)
        examples["phase_s"] = time.perf_counter() - t0
        for name in example_counters:
            by = {}
            for r in examples["runs"]:
                key = r["example"] + (" (paged)" if r["knobs"] else "")
                if r["launches"][name]:
                    by[key] = r["launches"][name]
            if by:
                kr(name)["launches_examples"] = by
        print("slice 16 summary " + json.dumps(examples), flush=True)

    # B1's threefry instance has its own record after B1's
    kernels = [recs[name] for name in ("window_sample", "window_sample_key",
                                       *KERNELS[1:-2], "sage_mean_backward",
                                       "sage_act", "sage_act_backward",
                                       "sage_act_mean",
                                       "sage_act_mean_backward")
               if name in recs]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fleet-replica"]:
        sys.exit(fleet_replica_main(sys.argv[2]))
    if sys.argv[1:2] == ["--sanitize-child"]:
        sys.exit(sanitize_child_main(sys.argv[2]))
    sys.exit(main(sys.argv[1:]))
