#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of GraftDB on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. It imports nothing of JAX and nothing of
the reference package (``repro``/``graftdb``); it puts ``src`` on the path
itself and drives ``graftdb_torch``. Phases:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels at SF-1 shapes: each kernel against its plain PyTorch version
   on the card (N = 65,536 probe keys into the orders-state table:
   1.5 M entries, 2^22 slots; the batch insert of the 1.5 M order keys
   into 2^22 slots, its plain version on host copies, and three more
   inserts: 2^19 keys into 2^20 slots with clusters that wrap round the
   table's end, a window overflow (17 keys on one home) and a duplicate
   key; the segmented sum of 65,536 rows into 8 and 4,096 groups and of
   the main path's largest row count, 129,246, into 4,096, each beside
   ``index_add_``; phase 7 times its passes apart; and the four probes at
   one key, whose event mean and device time are the launch floor; B5, on
   no engine path, has its host time per call recorded at 65,536 keys and
   its device time read in phase 7). Probe
   and insert outputs are integers (an insert's tables are compared where
   ``ok`` is 1, ``ok`` always) and the segmented sum fixes its order of
   additions, which its plain version repeats, so every comparison is
   exact;
4. main path: ``graftdb_torch.connect`` at TPC-H SF 1 with the default
   config (torch backend on the card, 65,536-row morsels), 12 sampled
   queries with staggered arrivals, in graft mode, isolated mode, and
   graft mode through the per-member loops, plus two concurrent q5s;
   every result equals the port's reference executor (rtol 1e-9), and
   the probe and chain kernels must have launched. Then the opt-in leg:
   graft mode with ``TorchBackend(use_insert_kernel=True,
   use_agg_kernel=True)``, its results within rtol 1e-5 of the reference
   executor (the aggregate kernel sums in float32), the batch-insert and
   segmented-sum kernels launched. Launch counts are reset before each of
   the two and read after it. The largest launch of each kernel is
   recorded and replayed against its plain version, and timed. Over the
   default legs the engine's calls that feed the fused chain and the
   probes (``TorchBackend.probe_chain``, ``probe_visible``, ``probe``,
   ``probe_visible_multi``) and the probe table's upkeep inside them
   (``_table_for``, and its growth ``_insert_keys``, of which the host
   insert ``_batch_insert`` and the upload are the rest) are counted and
   timed on the host, beside the legs' wall seconds; the four kernels of
   those calls also record their host time per call (``enqueue_ms``) on
   the replay and on phase 3's inputs;
4b. reuse-and-fault path: a repeat-heavy trace at SF 1 (24 arrivals
   drawn with Zipf(1.1) weights from a pool of 8 sampled instances, in 6
   bursts of 4 arrivals 0.01 virtual s apart, bursts 100 virtual s
   apart), in graft mode with ``retention="epoch"`` and
   ``memory_budget=0``, so that every retirement evicts, in four legs:
   ``reuse-live`` (no cache), ``reuse-cache`` (a cache that holds every
   artifact), ``reuse-cache-optin`` (the same with the opt-in kernels)
   and ``chaos`` (the cache and a ``FaultPlan`` of morsel, stall and
   rehydrate faults). Launch counts are reset before each leg and read
   after it. Every completed result equals the reference executor (rtol
   1e-9; 1e-5 with the opt-in kernels) and the cache legs' results equal
   the live leg's; both cache legs spill, hit and rehydrate; each leg with
   a cache probes rehydrated states and launches B1 and B2, one of them
   B4, and the opt-in leg launches B6 at least once per rehydrated hash
   state that was probed; the chaos leg injects faults and
   retries, and a query that does not complete ends cancelled, past its
   deadline or failed. Each leg records its wall and virtual seconds,
   cache, eviction and fault counters, the backend's host seconds in
   ``_table_for``, ``_insert_keys`` and ``_batch_insert``, and the device
   bytes allocated and the live probe tables after the leg and again after
   the session is closed and collected;
4c. batch-planning path: the reference batch sweep's queued-burst trace
   at SF 1 (6 bursts of 4 same-instant q3s, one segment a burst, dates
   ascending from 1996-06-24 to 1996-06-30 in steps of 2 days, so the
   narrowest member comes first; bursts 0.002 virtual s apart) in graft
   mode, default morsels, one worker and one partition, in two legs:
   ``batch-greedy`` (one arrival at a time) and ``batch-planned``
   (``batch_planning=True``, ``batch_window=0.0``: each burst is one
   cohort). Launch counts are reset before each leg and read after it.
   Every result of both legs equals the reference executor (rtol 1e-9) and
   the planned leg's equal the greedy leg's; the planned leg forms 6
   cohorts of 24 queries with a coverage gain, each query's stats carry
   its cohort record, and B1 launches in both legs (every probe of this
   trace runs inside the chain, so B2-B4 do not launch). A smaller trace
   of same-instant q5s (2 bursts of 4, one region a burst, dates 60 days
   apart up to 1994-06-30: windows of one width, shifted, so a cohort's
   members see different rows of one orders state) runs in the same two
   legs, ``batch-q5-greedy`` and ``batch-q5-planned``, with the same
   checks (2 cohorts of 8 queries), and B1 and a lens probe (B2 or B3)
   launch in each of its legs. Each leg records
   its wall and virtual seconds, the engine's row and batch counters, the
   launches of B1-B4, the backend's calls and host seconds (as in phase 4;
   ``_insert_keys``' calls are the probe tables' growth steps), the
   fallback counters and, for the planned leg, the host seconds in
   ``plan_cohort``. Then the serving plane (``graftdb_torch.
   connect_serving``) on the reference serve-fold workload (48 requests
   over 4 prompts with a 1,024-token prefix) isolated, folded and folded
   with ``batch_fold``: every request's extents add up to its prompt and
   the folded legs prefill fewer tokens; it runs on the host alone;
4d. mesh plane: phase 4's workload in graft mode on a one-shard mesh
   (``mesh-smoke``: results, per-query stats, counters and the clock
   bit-identical to phase 4's mesh-less graft leg, ``mesh_data_shards``
   1, no exchange rows, every B1 launch made by the shard-local chain,
   B2 and B4 launched), then mesh-less with ``partitions=workers=4``
   (``oracle-4``) and on four shards of the card (``mesh-4``: results
   equal to the reference executor at rtol 1e-9 and to ``oracle-4``
   within 1e-12, the columns that are bit-identical counted; a clock no
   earlier than the oracle's, exchange rows, rows on each of the four
   shards; ``validate_mesh_plane``, at each completion that leaves more
   live states' keys than the last check saw, over up to 2^21 of them,
   places every row on its shard). Launch counts are reset before each
   leg and read after it. Then the device plane at d = 2, 4 and 8: the
   exchange of the orders' 1.5 M keys routed as ``key_partition`` (its
   event mean, and the bytes its buffers would move per device, from
   their shapes), 256 keys at capacity
   4 recovered on grow and raising on raise, and the shard-local chain
   bit-identical to the unsharded one at 65,536 rows with d launches of
   B1; at d = 4 the partitioned join of lineitem's 6,003,210 order keys
   (width 3) to orders (width 2), every row hitting and the values equal
   to a host gather, the TPC-H Q1 groups summed over width 4 within 1e-4
   of a float64 host sum, both with their event means, and the
   db-plane record at 2^23 rows;
4e. closed loop (``repro_torch.launch.workload``, the twin of the
   reference's ``examples/concurrent_workload.py``) on phase 4's database:
   16 clients, each with one query outstanding, over
   ``client_sequences(db, 16, 2, seed=3)`` (the example's 10 queries a
   client cut to 2 for the phase's time on the card), through
   ``run_closed_loop``: the example's 16,384-row morsels, the torch
   backend on the card. On the work clock in the example's grid,
   ``isolated``, ``graft`` and ``graft-4w8p`` (4 workers, 8 partitions;
   the grid's ``qpipe_osp`` left out for the script's time, the CPU tests
   hold it); on the card's wall clock, one worker, ``wall-isolated`` and
   ``wall-graft``. Launch counts are reset before each leg and read
   after it. Every leg completes its 32 queries; every result equals the
   reference executor (rtol 1e-9; each distinct instance executed once,
   on four threads)
   and the first leg's result for the same client and position (rtol
   1e-9: modes add float64 sums in other orders); B1 launches in each
   graft leg. Each leg records its completions, clock seconds (virtual,
   or real on the wall clock), throughput, median and P95 latency, wall
   seconds, B1-B4 launches, fallback counters and the backend's host
   seconds in ``probe_chain``, ``probe_visible``, ``probe``,
   ``probe_visible_multi`` and ``_table_for``; graft's throughput and P95
   over isolated's on each clock are recorded, not checked. Results go
   to ``closed_loop`` in ``chip_smoke.json``;
5. twins: the same workload at SF 0.1 on the card and on the CPU (plain
   versions), in the default and the opt-in configuration, the repeat
   trace with a cache whose small memory tier demotes artifacts to the
   disk tier and the chaos leg's ``FaultPlan``, in both configurations,
   the burst trace with batch planning, the workload on a four-shard
   mesh, and the closed loop (``client_sequences(tdb, 16, 2, seed=3)`` in
   ``graft`` and ``graft-4w8p``: completions, the list of latencies,
   counters, clock and results) must give identical results, statuses,
   counters, admission logs,
   cohort plans, backend stats and virtual clocks (the mesh's
   ``mesh_stats()``, its shards' device names aside, and
   ``validate_mesh_plane`` records too, and the exchange of the orders'
   keys the same bits); and on the card a trace of bursts of one with
   batch planning on must be fingerprint-identical (results, counters,
   clock) to the same trace with it off;
6. kernel-ops path: ``repro_torch.kernels.ops.attention`` at
   recurrentgemma-9b's local attention (``[16, 4096, 256]``, window
   2,048) and starcoder2-7b's causal attention (``[36, 4096, 128]``),
   each in bf16 and again in float32, and ``ops.linear_recurrence`` at
   recurrentgemma-9b's RG-LRU width (``[2, 4096, 4096]`` float32), inputs
   from numpy with ``SEED``. Launch counts are reset before these five
   calls and read after them: ``flash_attention`` and ``linrec`` must have
   launched. Each output is then held against its kernel's plain version
   and the independent oracle of ``repro_torch.kernels.ref``, and timed
   beside them and (attention) ``scaled_dot_product_attention``; so are
   the ``kernels`` microbench's shapes (``benchmarks/run.py``), whose
   numbers go to the JSON file only. Each attention call also records its
   TFLOP/s over the whole 64 x 64 tiles the kernel computes and its share
   of the bound; the phase records the ptxas register and spill lines of
   each attention kernel instance and the tensor-core instructions
   (``HGMMA``, ``HMMA``) and TMA loads in the library's SASS, and fails
   unless the bf16 kernel holds ``wgmma`` and every float32 instance holds
   TF32 ``HMMA`` (``mma.sync``) and spills nothing. It records the
   recurrence kernel's ptxas register and spill lines, its launch (blocks
   of the grid, threads of a block, and the blocks an SM holds at once)
   and, from a profiler trace after the phase's event means, the kernels
   one call launches: it fails unless that is one;
6b. LM serving path: stablelm-3b at its published width and depth (2.8 B
   parameters, float32, drawn on the card from ``SEED``) through
   ``repro_torch.launch.serve.serve_fold`` on the reference serve
   driver's defaults (8 requests, a shared 48-token prefix, 8-token
   suffixes, 8 decoded tokens; tokens from ``default_rng(0)``): isolated
   and folded outputs must be identical and prefill 448 against 112
   tokens; each leg records its wall seconds, decode steps, the median
   CUDA-event ms of a step (``StepTimer``), steps and output tokens per
   second and the peak memory. Then, on one 56-token prompt, decode
   through the cache, the full forward and prefill over the served
   model's first k layers (k = 1, 2, 4, ..., 32): at k = 1 they must
   agree within 1e-4 of max |logit| (prefill's K/V with the decode
   cache's too); deeper ones are recorded, since the reference's init
   makes any two float32 orders part with depth. Then each other family at
   its published widths with its depth cut (``LM_CUTS``), its constant
   leaves drawn at random: card against the CPU on the final hidden
   states and the last 8 positions' logits, the MoE layer's experts equal
   on both devices, and decode as ``LM_CUTS`` says. Float32 products must
   not run in TF32. Launch counts are reset before the phase and read
   after it: no kernel of the port may launch. Results go to ``lm`` in
   ``chip_smoke.json``. The served model is drawn again from ``SEED`` for
   the last phase's trace, so that its 11.2 GB are free for 6c;
6c. LM training path: ``repro_torch.launch.train.main`` at stablelm-3b's
   published width and depth (2.8 B parameters, float32, ``adamw``, each
   period rematerialized), 4 steps of 1 x 4,096 tokens (one chip's share
   of the reference's ``train_4k``): every loss and grad norm finite; the
   median CUDA-event ms of steps 2-4 (``TrainTimer``), tokens/s, the
   model-FLOPs share (6 * N * tokens over the step, against the CUDA
   cores' FP32 peak and against the rate of float32 products as three
   TF32 products, both of ``launch/roofline.py``) and the peak memory. Then one step at each
   smoke config (and stablelm-3b at 2 microbatches, and at its published
   widths over 1 x 1,024 tokens at 1 layer and at 2 with the attention
   rescaled, ``TRAIN_WIDE``) on the card and the CPU from the same
   parameters and batch, held within the limits of ``TRAIN_TOL``. Then the driver at chatglm3-6b's smoke config, 6 steps
   with checkpoints every 3 under ``chiprun_out/train_resume``, resumed to
   9, against 9 steps without a break, with deterministic algorithms:
   the restored state equals the saved one, and the losses and the final
   state equal the unbroken run's, bit for bit. Float32 products must not
   run in TF32; no kernel of the port may launch. Results go to ``train``
   in ``chip_smoke.json``;
6d. dry run (``repro_torch.launch.dryrun``): (a) ``run_cell`` for
   stablelm-3b's train_4k, rwkv6-7b's prefill_32k and recurrentgemma-9b's
   train_4k on the 16 x 16 and 2 x 16 x 16 production meshes (each
   counted on ``meta`` once; the CPU tests and sweep count the other
   cells): every record ``ok``, its ``hlo_stats`` and seconds recorded,
   the two recurrent cells' collectives with the all-to-alls of their
   chunk scans (the collective model is arithmetic on the specs; the CPU
   tests hold it against XLA's programs); (b) phase 6c's own step
   (stablelm-3b, float32, ``adamw``, remat, 1 x 4,096 tokens): the op
   counter over the first step of 6c's
   run on the card (``TrainTimer(count_first=True)``) must give the
   ``meta`` count exactly, FLOPs and bytes (the ops whose calls differ are
   recorded); the specs' bytes on the one-shard mesh within 1% of the
   memory 6c's parameters and optimizer state take after its run
   (``torch.cuda.memory_allocated``); and 6c's median step at least the
   larger of the FLOPs over the FP32 peak (66.9 TFLOP/s) and the bytes
   over 3.35 TB/s; (c) the CLI's ``--db-plane`` at 16 x 16
   (the data plane on 16 shards of the card at 64 M rows), its record
   validated. Launch counts are reset before the phase and read after it
   (B1 launches in the db plane's chains). Results go to ``dryrun`` in
   ``chip_smoke.json``;
8. the example twins, run before phase 7 so that the traces stay last:
   ``examples/quickstart_torch.py``, ``examples/serve_folding_torch.py``
   and ``examples/concurrent_workload_torch.py`` on the card, each with
   launch counts reset before and read after it. The quickstart's Q_B
   must match the reference executor and B1 must launch (B1-B4's counts
   recorded); the serving twin, a host simulator, must print its lines
   and launch no kernel; the closed-loop twin must print its grid's four
   lines and launch B1. Results go to ``examples``;
7. the device time per call of the fused chain (its replay and phase 3's
   two-stage chain with grants, filters and a sink), of the probes B2, B4
   and B3 (their replays), of B5 at 65,536 keys, of the four probes at one
   key and of the recurrence at ``[2, 4096, 4096]``, by kernel, memset and
   copy; the mesh plane's exchange at each d, join and aggregate, as the
   sum of their kernels; one step of phase 6c's training run, drawn again
   from its seed (its kernels, their device time, the largest by name, the
   card's busy share in a step); the served model's decode step (its
   kernels and their device time, the card's busy share in a step); the
   segmented sum's phase-3 calls and its main-path
   replay: the two passes by device time; all from ``torch.profiler``
   traces, last, since a trace leaves every later launch slower on the
   host; then the segmented sum's event mean again after the traces. The
   four levels of the fused chain and of those three probes (event mean,
   host time per call, device time, engine call) go to ``launch_path`` in
   ``chip_smoke.json``, and so do B5's three (it has no engine call).

Comparisons are exact except for flash attention, which adds its
products in another order than its plain version and the full-softmax
oracle and, in bf16, rounds other values of ``p``. Every element must
lie within atol + rtol |want| + row_atol rms(want's row) of its plain
version and of the oracle, the row being the output vector of one query:
in float32 the reference's own tolerance (rtol 1e-5, atol 1e-4); in bf16
rtol 2e-2 and row_atol 0.1, no fixed atol. The outputs, and the errors
of rounding ``p``, shrink as a row sees more keys, so the bf16 limit
follows the row: the reference's atol of 0.2 passes an output that
leaves out a 64-key tile of the rows that see 512 keys or more
(``tests/test_torch_kernel_ops.py``). The linear recurrence
equals its plain version bit for bit and is held against the
step-by-step oracle at rtol/atol 1e-4.

Any failure exits non-zero. Before the last line come a JSON object with
each kernel's launches, error, time, plain time, bound and library time,
and the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT_DIR = ROOT / "chiprun_out"

#: the main path's TPC-H scale factor, the twin leg's, the number of
#: sampled queries and the seed of data and workload
SCALE = 1.0
TWIN_SCALE = 0.1
N_QUERIES = 12
SEED = 7

#: the kernel-ops path: attention calls (label, [BH, S, dh], dtype, window)
#: at the widths of configurations the reference ships, at its train_4k
#: sequence length, and the recurrence at recurrentgemma-9b's RG-LRU width
ATTENTION_CALLS = (
    ("recurrentgemma-9b bf16", (16, 4096, 256), "bfloat16", 2048),
    ("recurrentgemma-9b f32", (16, 4096, 256), "float32", 2048),
    ("starcoder2-7b bf16", (36, 4096, 128), "bfloat16", None),
    ("starcoder2-7b f32", (36, 4096, 128), "float32", None),
)
LINREC_SHAPE = (2, 4096, 4096)
#: flash attention's limits (``within``) by dtype: the reference's own in
#: float32; in bf16 its rtol, with a term that follows each row's RMS in
#: place of its atol of 0.2
ATTENTION_TOL = {"float32": dict(rtol=1e-5, atol=1e-4),
                 "bfloat16": dict(rtol=2e-2, row_atol=0.1)}
#: the reference's tolerance of the recurrence against its oracle
LINREC_TOL = dict(rtol=1e-4, atol=1e-4)
#: rows of the main path's largest segmented sum (SF 1, opt-in leg)
SEG_PATH_ROWS = 129_246

KERNELS = {
    "fused_chain": ("src/repro_torch/kernels/csrc/fused_chain.cu",
                    "src/repro/kernels/fused_chain.py:163"),
    "hash_probe_lens64": ("src/repro_torch/kernels/csrc/hash_probe.cu",
                          "src/repro/kernels/hash_probe.py:171"),
    "hash_probe_lens_multi64": ("src/repro_torch/kernels/csrc/hash_probe.cu",
                                "src/repro/kernels/hash_probe.py:242"),
    "hash_probe_lens": ("src/repro_torch/kernels/csrc/hash_probe.cu",
                        "src/repro/kernels/hash_probe.py:50"),
    "hash_probe_lens_multi": ("src/repro_torch/kernels/csrc/hash_probe.cu",
                              "src/repro/kernels/hash_probe.py:105"),
    "hash_build_insert": ("src/repro_torch/kernels/csrc/hash_probe.cu",
                          "src/repro/kernels/hash_probe.py:317"),
    "seg_aggregate": ("src/repro_torch/kernels/csrc/seg_aggregate.cu",
                      "src/repro/kernels/seg_aggregate.py:21"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:25"),
    "linrec": ("src/repro_torch/kernels/csrc/linrec.cu", "src/repro/kernels/linrec.py:26"),
}
#: kernels each path must launch: the default config's legs, and the
#: opt-in leg. ``hash_probe_lens_multi`` is on no engine path (the
#: backend probes through the 64-bit variant); phase 3 checks it.
MAIN_KERNELS = ("fused_chain", "hash_probe_lens64", "hash_probe_lens_multi64", "hash_probe_lens")
OPTIN_KERNELS = ("hash_build_insert", "seg_aggregate")
OPS_KERNELS = ("flash_attention", "linrec")
OPTIN = dict(use_insert_kernel=True, use_agg_kernel=True)
#: the kernels whose launch path this script measures at four levels: the
#: wrapper's event mean, its host time per call, the device time per launch
#: and the engine's own call (``launch_path`` in ``chip_smoke.json``)
LAUNCH_PATH = ("fused_chain", "hash_probe_lens64", "hash_probe_lens", "hash_probe_lens_multi64")
#: kernels timed over SEG_ITERS calls
MEAN_200 = ("seg_aggregate",) + LAUNCH_PATH
#: the engine's calls that feed them (B1, B2, B4, B3 in that order), timed
#: on the host over the default legs, and the backend's steps inside them:
#: the probe table's upkeep (``_table_for``), its growth (``_insert_keys``:
#: the host insert ``_batch_insert``, then the whole table uploaded again)
#: and the entry-indexed mirrors' upkeep
ENGINE_CALLS = ("probe_chain", "probe_visible", "probe", "probe_visible_multi", "_table_for",
                "_insert_keys", "_batch_insert", "_sync_mirrors")
#: the replayed calls' event means before the redesign of each kernel and
#: its launch path (this script on an NVIDIA H100 80GB HBM3 at 700.00 W;
#: ``PERF.md`` names the runs), kept beside this run's in the JSON file
EARLIER_REPLAY_MS = {
    "fused_chain": 0.09520800113677978,
    "hash_probe_lens64": 0.022011199593544008,
    "hash_probe_lens": 0.018113599717617036,
    "hash_probe_lens_multi64": 0.02624799907207489,
}
#: phase 3's labels of the probes at one key: their event mean and device
#: time are the launch floor, the least time a call of them takes
FLOOR = "_n1"
#: phase 3's calls beyond the probes at one key whose device time the last
#: phase reads: the rich chain, and B5, which no engine path launches, at
#: 65,536 keys (its three levels: event mean, host time per call, device
#: time)
TRACED_SF = ("fused_chain_rich", "hash_probe_lens_multi")


#: the first query id of a twin's runs (both devices number alike)
TWIN_QID_BASE = 1_000_000

#: phase 6b, the LM serving path: the served model (full width and depth,
#: float32) and the reference serve driver's defaults (requests, shared
#: prefix, suffix and decoded tokens a request)
LM_ARCH = "stablelm-3b"
LM_DEVICE = "cuda"
LM_REQUESTS, LM_PREFIX, LM_SUFFIX, LM_DECODE = 8, 48, 8, 8
#: the limit of every comparison of the phase, as a share of the largest
#: |reference| value: the paths sum in other orders in float32, and
#: TF32's 10-bit mantissa would move them by far more
LM_TOL = 1e-4
#: the served model's depths (its first k layers, and all of them) over
#: which decode, the full forward and prefill are compared; those up to
#: LM_HELD_DEPTH are held to LM_TOL
LM_DEPTHS = (1, 2, 4, 8, 16, 32)
LM_HELD_DEPTH = 1
#: each other family at its published widths, its depth cut (config
#: updates, what was cut), how its decode through the cache is held, and
#: the limit of its card-against-CPU comparisons. Decode: "forward",
#: against the forward's logits on the card; "cpu", against the same
#: decode on the CPU; None, forward only (pixtral-12b and dbrx-132b, which
#: the reference's decode test leaves out). rwkv6-7b's chunked forward
#: rounds its time-mix products' inputs to bf16 and its decode does not,
#: so the two differ by far more than 1e-4, in the reference too
#: (``tests/test_torch_models.py``); inputs that differ in their last
#: float32 bit round apart, so its forward on the card and the CPU is
#: held below that rounding's own effect in this run ("rounding": its
#: decode-against-forward gap). The reference's init scales q and k by 1/sqrt(heads),
#: not 1/sqrt(d_model), so their scores grow with d_model / heads (160 at
#: pixtral-12b's widths), and a score's absolute float32 rounding is a
#: softmax weight's relative error: at 1 layer pixtral-12b's card and CPU
#: differ by 2.4e-4 (NVIDIA H100 80GB HBM3 against its host's CPU), so it
#: is held to 1e-3. The depths are those at which two float32 orders
#: still agree (on that card, at 2 layers pixtral-12b differed by 3.8e-3
#: and seamless-m4t-large-v2 at 2 + 2 by 4.1e-3; the served model's depth
#: sweep shows the growth). LM_CUT_TOKENS text tokens; the logits of the
#: last LM_LAST positions compared
LM_CUTS = (
    ("recurrentgemma-9b", dict(n_layers=3), "1 period (rec, rec, attn) of 38 layers", "forward",
     LM_TOL),
    ("rwkv6-7b", dict(n_layers=2), "2 of 32 layers", "cpu", "rounding"),
    ("seamless-m4t-large-v2", dict(n_layers=1, n_encoder_layers=1),
     "1 of 24 encoder and 1 of 24 decoder layers", "forward", LM_TOL),
    ("pixtral-12b", dict(n_layers=1), "1 of 40 layers (with its 1,024 prefix embeds)", None,
     1e-3),
    ("dbrx-132b", dict(n_layers=1), "1 of 40 layers (16 experts, top-4)", None, LM_TOL),
)
LM_CUT_TOKENS = 32
LM_LAST = 8
#: the served model's decode step whose device time the last phase reads
#: from a profiler trace (``trace_lm``): its record and what builds the call
LM_TRACES = []


#: phase 6c, the LM training path: the train driver's arguments (the
#: published stablelm-3b, float32, ``adamw``, remat on; 1 x 4,096 tokens,
#: one chip's share of the reference's ``train_4k``: 256 x 4,096 on its
#: 256-chip mesh), and the steps whose CUDA-event median is the step time
TRAIN_ARCH = "stablelm-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 1, 4096, 4
TRAIN_TIMED = slice(1, None)
#: card against CPU, one step at each smoke config (and one family at 2
#: microbatches): of the CPU's value, the loss and grad norm; every
#: parameter within TRAIN_PARAM_TOL (a first step moves a parameter by
#: lr |u| with |u| = |g| / (|g| + eps) < 1, so two steps of opposite sign
#: differ by less than 2 * lr, and each result's float32 rounding adds an
#: ulp of the parameter), all but TRAIN_STRAY of them within 1e-5;
#: the moments within TRAIN_MOMENT_TOL of the tree's largest |moment|;
#: ``adamw_bf16``'s moments are rounded to bf16, and float32 moments a
#: rounding apart may round to neighbouring bf16 values, one bf16 ulp (at
#: most 2^-7 of the largest |moment|): TRAIN_BF16_MOMENT_TOL.
#: rwkv6-7b's chunk products round their inputs to bf16, and inputs that
#: differ in their last float32 bit round apart (``tests/test_torch_train.py``:
#: its gradients differ from the reference's by 1.5e-3 of their global
#: norm on the CPU), so it gets looser limits: the loss and grad norm
#: those of the CPU tests, its moments 5e-2 (1.3e-2 measured on an NVIDIA
#: H100 80GB HBM3 against its host's CPU), all but 1e-2 of its parameters
#: within 1e-5 (1.75e-3 measured there)
TRAIN_LR = 3e-4
TRAIN_PARAM_TOL = 2 * TRAIN_LR + 1e-6
TRAIN_TOL = {"loss": 1e-5, "grad_norm": 1e-5}
TRAIN_RWKV_TOL = {"loss": 1e-3, "grad_norm": 1e-2}
TRAIN_STRAY, TRAIN_RWKV_STRAY = 1e-4, 1e-2
TRAIN_MOMENT_TOL, TRAIN_BF16_MOMENT_TOL, TRAIN_RWKV_MOMENT_TOL = 1e-3, 2**-6, 5e-2
TRAIN_MICROBATCH_ARCH = "stablelm-3b"
#: the same step at TRAIN_ARCH's published widths (d_model 2,560, its
#: 50,304-token vocabulary and 6,912-wide FFN) over 1 x 1,024 tokens, the
#: depth cut so that the CPU's step stays short: the products at the full
#: run's widths, on cuBLAS against the CPU's. (label, config updates,
#: batch, seq, attention rescaled, held to the smoke configs' limits.)
#: As in phase 6b, the reference's init scales q and k so that a score's
#: float32 rounding becomes a softmax weight's relative error, and the
#: backward amplifies it layer on layer: at 1 layer the two devices agree
#: within those limits, at 2 they do not (grad norm 1.9e-5 of the CPU's,
#: 2.2e-4 of the parameters beyond 1e-5, on an NVIDIA H100 80GB HBM3
#: against its host's CPU), and with the attention weights rescaled to
#: their contracted widths (``attention_rescaled``) 2 layers agree again
#: (3.5e-6 of the largest moment). The 2-layer step at the reference's
#: init is recorded
TRAIN_WIDE = (
    ("1 layer", dict(n_layers=1), 1, 1024, False, True),
    ("2 layers, attention rescaled", dict(n_layers=2), 1, 1024, True, True),
    ("2 layers", dict(n_layers=2), 1, 1024, False, False),
)
#: the resume leg: the reference test's driver arguments (chatglm3-6b at
#: its smoke config), 6 steps with checkpoints every 3, then 9
TRAIN_RESUME = ["--arch", "chatglm3-6b", "--smoke", "--batch", "4", "--seq", "32",
                "--ckpt-every", "3"]
#: the train step whose device time the last phase reads from a profiler
#: trace (``trace_train``): its record and what builds the call
TRAIN_TRACES = []


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(fn, iters):
    """Mean milliseconds of ``fn`` over ``iters`` calls, CUDA events, after
    warm-up."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def enqueue_ms(fn, iters):
    """Host milliseconds per call of ``fn`` with no wait for the card: the
    wrapper's own cost, which sets the CUDA-event mean of a call whose
    kernels take less."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


def seg_entry_ms(codes, vals, n_groups):
    """Milliseconds per call of the segmented sum's launch on preallocated
    buffers (CUDA events): its two kernels and their launches without the
    wrapper's allocations, whose host time sets the wrapper's event mean
    at these sizes (``enqueue_ms``). ``seg_launch`` raises on a refused or
    failed launch, so no such call is timed."""
    from repro_torch.kernels import seg_aggregate as sa

    partial, out = sa.seg_buffers(n_groups, vals)
    return time_ms(lambda: sa.seg_launch(codes, vals, partial, out), SEG_ITERS)


#: the segmented sum's calls whose passes the last phase times apart
#: (``trace_seg_passes``): label, call and its ``index_add_`` twin
SEG_TRACES = []
#: calls per CUDA-event mean of the segmented sum and of ``LAUNCH_PATH``'s
#: kernels, whose host-bound means vary from call to call
SEG_ITERS = 200
#: the calls of ``LAUNCH_PATH``'s kernels and of the probes at one key whose
#: device time the last phase reads from a profiler trace
#: (``trace_launch_path``)
LAUNCH_TRACES = []
#: the mesh plane's calls whose device time the last phase reads from a
#: profiler trace (``trace_mesh``): their record and the call
MESH_TRACES = []


def seg_times(label, call, codes, vals, n_groups):
    """B7 beyond its event mean: its host time per call, its launch on
    preallocated buffers, and ``index_add_`` (zeros and the add: the same
    sums, in no fixed order) by event mean. Its passes are timed apart
    from a profiler trace only in the last phase, since a trace leaves the
    process's later launches slower on the host."""
    import torch

    def library():
        out = torch.zeros(n_groups, vals.shape[1], device=vals.device)
        return out.index_add_(0, codes, vals)

    SEG_TRACES.append((label, call, library))
    return {
        "library_ms": time_ms(library, SEG_ITERS),
        "enqueue_ms": enqueue_ms(call, SEG_ITERS),
        "entry_ms": seg_entry_ms(codes, vals, n_groups),
    }


def trace_launch_path(report):
    """Last phase, beside B7's traces: each recorded call of B1-B4 (and of
    the probes at one key) by device time per call from a profiler trace,
    by CUDA kernel, memset and copy (level c of ``launch_path`` in
    ``chip_smoke.json``)."""
    recs = report["launch_path"]["device_ms"] = {}
    for label, call in LAUNCH_TRACES:
        recs[label] = kernel_device_ms(call, 50)
        log(f"{label}: device ms per call {recs[label]}")
    sf = report["launch_path_sf_shapes"]
    b5 = report["launch_path"]["hash_probe_lens_multi"] = {
        label: {"ms": sf[label]["ms"], "enqueue_ms": sf[label]["enqueue_ms"],
                "device_ms": sum(recs[label].values())}
        for label in ("hash_probe_lens_multi", "hash_probe_lens_multi" + FLOOR)}
    log(f"hash_probe_lens_multi (on no engine path) at 65,536 keys and at one key: {b5}")


def trace_mesh(report):
    """Last phase: each recorded call of the mesh plane (the exchange at
    each d, the join and the aggregate) by device time per call, the sum
    of its CUDA kernels in a profiler trace, into its record beside the
    CUDA-event mean (``event_ms``), which the host's enqueue of about 30
    small kernels a shard sets."""
    for rec, call in MESH_TRACES:
        per_kernel = kernel_device_ms(call, 5)
        rec["device_ms"] = sum(per_kernel.values())
        rec["device_kernels"] = len(per_kernel)
        log(f"mesh {rec['label']}: {rec['device_ms']:.4f} ms on the device a call "
            f"({rec['device_kernels']} kernel names), {rec['event_ms']:.4f} ms by event mean")


def trace_seg_passes(report):
    """Last phase, after every event mean and leg: each recorded B7 call's
    two passes and ``index_add_`` by device time from a profiler trace,
    then the wrapper's event mean again, which shows what the traces cost
    each later launch on the host."""
    recs = {}
    for label, call, library in SEG_TRACES:
        recs[label] = {"passes_ms": kernel_device_ms(call, 50),
                       "library_device_ms": sum(kernel_device_ms(library, 50).values())}
    for label, call, _ in SEG_TRACES:
        recs[label]["ms_after_traces"] = time_ms(call, SEG_ITERS)
        log(f"seg_aggregate {label}: passes {recs[label]['passes_ms']}, index_add_ "
            f"{recs[label]['library_device_ms']:.5f} ms on the device; wrapper "
            f"{recs[label]['ms_after_traces']:.4f} ms after the traces")
    report["seg_traces"] = recs


def host_ms(fn):
    """Milliseconds of one call of ``fn`` on the host clock (for plain
    versions that run on host copies)."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def kernel_device_ms(fn, iters):
    """Mean device milliseconds per call of each CUDA kernel that ``fn``
    launches, by kernel name, from a ``torch.profiler`` trace of ``iters``
    calls after warm-up: the passes of a multi-kernel wrapper timed apart."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total[e.name] = total.get(e.name, 0.0) + e.time_range.elapsed_us()
    return {name: us / iters / 1e3 for name, us in total.items()}


def probe_touch(keys, tkeys):
    """What a bounded linear probe of ``keys`` must read: the distinct
    table slots it visits, the found slot per key (-1 on a miss) and the
    number of probe steps taken."""
    import torch

    from repro_torch.kernels.hash_probe import EMPTY, MAX_PROBE, _hash

    cap = tkeys.shape[0]
    keys64 = keys.to(torch.int64)
    pos = _hash(keys, cap)
    done = keys64 == EMPTY
    found = torch.full_like(keys64, -1)
    seen, steps = [], 0
    for _ in range(MAX_PROBE):
        live = ~done
        seen.append(pos[live])
        steps += int(live.sum())
        sk = tkeys[pos]
        hit = (sk == keys64) & live
        found = torch.where(hit, pos, found)
        done = done | hit | ((sk == EMPTY) & live)
        pos = (pos + 1) & (cap - 1)
    return int(torch.unique(torch.cat(seen)).numel()), found, steps


def bound(nbytes, ops, ops_per_s=None):
    """The least ms for ``nbytes`` of HBM traffic and ``ops`` operations at
    ``ops_per_s``, by default the CUDA cores' float32 rate (also the ALU
    rate of 32-bit integer work); the H100's peaks are those of
    ``launch/roofline.py``."""
    from repro_torch.launch import roofline

    bytes_ms = nbytes / roofline.H100_HBM_BW * 1e3
    ops_ms = ops / (ops_per_s or roofline.H100_FP32_FLOPS) * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def probe_bound(name, args):
    """Bytes a probe needs on these inputs: each key read and each output
    written once, each visited slot's key once, and the slot->entry id and
    lens words of each distinct matched entry once."""
    import torch

    keys, tkeys = args[0], args[1]
    n = keys.shape[0]
    slots, found, steps = probe_touch(keys, tkeys)
    hit = found[found >= 0]
    n_hit = int(torch.unique(hit).numel())
    nbytes = 4 * n + 4 * slots
    if name == "hash_probe_lens":
        nbytes += 4 * n_hit + 4 + 4 * n  # slot vis words, mask, slots out
    elif name == "hash_probe_lens_multi":
        nbytes += 4 * n_hit + 8 * n  # slot vis words, slots and words out
    else:
        entries = args[2][hit].to(torch.int64)
        n_ent = int(torch.unique(entries).numel())
        nbytes += 4 * n_hit + 8 * n_ent
        nbytes += 8 + 4 * n if name == "hash_probe_lens64" else 12 * n
    return bound(nbytes, 4 * steps + 4 * n)


def insert_bound(keys, cap, tkeys):
    """A batch insert must read each key once and write both tables and
    ``ok`` once; it hashes each key and compares once per probe step of
    its placement (counted from ``tkeys``, the sequential table)."""
    import torch

    from repro_torch.kernels.hash_probe import EMPTY, _hash

    slots = torch.nonzero(tkeys != EMPTY).squeeze(1)
    steps = int((((slots - _hash(tkeys[slots], cap)) & (cap - 1)) + 1).sum())
    n = keys.shape[0]
    return bound(4 * n + 8 * cap + 4, 4 * n + 2 * steps)


def seg_bound(codes, values, n_groups):
    """A segmented sum must read each code and value once, write each sum
    once, and add each value once."""
    n, v = values.shape
    return bound(4 * n + 4 * n * v + 4 * n_groups * v, n * v)


def attention_tile_flops(q, window):
    """Flops of the whole 64 x 64 tiles a kernel computes: per 64-query
    block, every 64-key tile from the window's first to the diagonal."""
    bh, s, dh = q.shape
    tiles = 0
    for r0 in range(0, s, 64):
        lo = 0 if window is None else max(0, r0 - window + 1) // 64
        tiles += r0 // 64 - lo + 1
    return 4 * dh * 64 * 64 * tiles * bh


def attention_bound(q, window):
    """Flash attention must read q, k and v and write o once, and do 4 dh
    flops (two products) per visible (query, key) pair, at the bf16
    tensor-core rate in bf16 and, in float32, at the fastest rate that
    holds float32's accuracy: three TF32 products (164.9 TFLOP/s, above the
    CUDA cores' 66.9)."""
    import torch

    from repro_torch.launch import roofline

    bh, s, dh = q.shape
    t = np.arange(s, dtype=np.int64)
    pairs = bh * int(np.minimum(t + 1, s if window is None else window).sum())
    rate = roofline.H100_BF16_FLOPS if q.dtype == torch.bfloat16 else roofline.H100_FP32X3_FLOPS
    return bound(4 * q.numel() * q.element_size(), 4 * dh * pairs, rate)


def linrec_bound(a):
    """The recurrence must read a and b and write h once (float32); it
    does a product and a sum per element."""
    return bound(12 * a.numel(), 2 * a.numel())


def chain_bound(spec, arrays, flat):
    """Bytes one chain launch needs: every row-length input and every
    output once, small parameter arrays whole, and of each table and
    entry-indexed mirror only what this launch's rows reach — the slots
    its probes visit and the entries they match. Rows reaching stage s > 0
    are taken as those matched at stage s-1 (a superset of the rows still
    owned there)."""
    import torch

    from repro_torch.kernels import fused_chain as fc

    stages, sink = spec
    n = arrays[0].shape[0]
    out = fc.split_outputs(spec, n, flat)
    kinds = fc.input_kinds(spec)
    nbytes = sum(4 * a.numel() for a, k in zip(arrays, kinds) if k == "row")
    nbytes += 4 * flat.numel()
    bl, bh, per_stage, sink_tabs = fc._unpack(spec, arrays)
    alive = (bl | bh) != 0
    ops = 0
    for s, ((key_mode, n_grants, g_attrs, filt), d) in enumerate(zip(stages, per_stage)):
        if key_mode == -1:
            keys = torch.where(alive, d["key"], fc.EMPTY)
        else:
            e = out[2 + key_mode].to(torch.int64)
            keys = torch.where(alive & (e >= 0), d["key"][e.clamp(min=0)], fc.EMPTY)
            nbytes += 4 * int(torch.unique(e[e >= 0]).numel())
        slots, _, steps = probe_touch(keys.to(torch.int32), d["tkeys"])
        ent = out[2 + s].to(torch.int64)
        n_ent = int(torch.unique(ent[ent >= 0]).numel())
        entry_arrays = 3 + (2 + 2 * g_attrs if n_grants else 0)  # tentry, lens, grants
        nbytes += 4 * slots + 4 * n_ent * entry_arrays
        small = [d["ttlo"], d["tthi"]]
        if n_grants:
            small += [d[k] for k in ("gbit", "gallow", "gcon", "glo", "ghi")]
        if filt is not None:
            small += [d[k] for k in ("flo", "fhi", "fcon", "fbit")]
            nbytes += 8 * n_ent * sum(1 for src in filt[1] if src != -1)
        nbytes += sum(4 * a.numel() for a in small)
        ops += 4 * steps + n * (24 + 8 * n_grants * max(g_attrs, 1))
        alive = ent >= 0
    if sink:
        nbytes += sum(4 * a.numel() for a in sink_tabs)
    return bound(nbytes, ops)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def pow2_at_least(x, lo=1):
    c = lo
    while c < x:
        c *= 2
    return c


def orders_table(db):
    """The orders-state probe table as the torch backend lays it out: the
    SF's order keys placed by the backend's own winner election at <= 50%
    load, entry-indexed lens words padded to a power of two."""
    from repro_torch.api.backends import TorchBackend, _ProbeTable
    from repro_torch.kernels.hash_probe import EMPTY

    keys = db["orders"].columns["o_orderkey"].astype(np.int64)
    ent = _ProbeTable()
    cap = pow2_at_least(2 * len(keys))
    ent.tkeys = np.full(cap, EMPTY, dtype=np.int32)
    ent.slot_entry = np.full(cap, -1, dtype=np.int64)
    if not TorchBackend._batch_insert(ent, keys, 0):
        raise RuntimeError("orders keys do not fit the bounded probe table")
    return keys, ent.tkeys, ent.slot_entry.astype(np.int32), pow2_at_least(len(keys), 256)


def kernel_inputs(db, n_probe=65_536, seed=0):
    """SF-shaped inputs of every kernel, by label: (kernel, arguments).
    Probe keys (half hits) against the orders table, entry-indexed lens
    words with a few live slots (and their slot-indexed low halves), a
    two-stage chain with grants, filters and a build sink, the order keys
    for a fresh 2^22-slot batch insert, and 65,536 rows of one float32
    value column summed into 8 and into 4,096 groups."""
    import torch

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    keys, tkeys, tentry, ecap = orders_table(db)
    e = len(keys)
    slots = rng.integers(0, 64, (e, 3), dtype=np.uint64)
    words = np.zeros(ecap, np.uint64)
    words[:e] = np.bitwise_or.reduce(np.uint64(1) << slots, axis=1)
    evlo = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    evhi = (words >> np.uint64(32)).astype(np.uint32).view(np.int32)
    probe = np.where(
        rng.random(n_probe) < 0.5, keys[rng.integers(0, e, n_probe)],
        int(keys.max()) + 1 + rng.integers(0, 1 << 20, n_probe),
    ).astype(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    k, tk, te, lo, hi = t(probe), t(tkeys), t(tentry), t(evlo), t(evhi)
    ones = torch.ones_like(tk)
    slot_vis = torch.where(te >= 0, lo[te.clamp(min=0).to(torch.int64)], 0)
    all_mask = torch.full((1,), -1, dtype=torch.int32)  # B4's mask, on the host
    lens_mask = torch.from_numpy(np.array([1 << 5, 1 << 7], np.uint32).view(np.int32))  # host

    # chain: stage 0 probes host keys into the orders table; stage 1
    # gathers keys through stage 0's entries into a second table
    def w(*shape):
        return t(rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32))

    def enc(vals):
        from repro_torch.kernels.fused_chain import total_order_u32

        hi_, lo_ = total_order_u32(vals)
        return t(hi_.view(np.int32)), t(lo_.view(np.int32))

    def bounds(shape):
        from repro_torch.kernels.fused_chain import total_order_u32

        vals = np.sort(rng.normal(size=shape + (2,)), axis=-1)
        lh, ll = total_order_u32(vals[..., 0].ravel())
        hh, hl = total_order_u32(vals[..., 1].ravel())
        lo_ = np.stack([lh, ll], -1).reshape(*shape, 2)
        hi_ = np.stack([hh, hl], -1).reshape(*shape, 2)
        return t(lo_.view(np.int32)), t(hi_.view(np.int32))

    bits_lo, bits_hi = w(n_probe), w(n_probe)
    ck = torch.from_numpy(keys[rng.integers(0, e, ecap)].astype(np.int32)).to(dev)
    arrays = [bits_lo, bits_hi]
    stages = []
    for s in range(2):
        arrays += [k if s == 0 else ck, tk, te, lo, hi, w(8, 256), w(8, 256)]
        glo, ghi = bounds((2, 2))
        arrays += [lo, hi, w(2, 2), w(2, 2), t(rng.integers(0, 2, (2, 2)).astype(np.int32)), glo, ghi]
        arrays += list(enc(rng.normal(size=ecap))) * 2
        srcs = (-1, s)
        arrays += list(enc(rng.normal(size=n_probe))) + list(enc(rng.normal(size=ecap)))
        flo, fhi = bounds((4, 2))
        arrays += [flo, fhi, t(rng.integers(0, 2, (4, 2)).astype(np.int32)), w(4, 2)]
        stages.append((-1 if s == 0 else 0, 2, 2, (4, srcs)))
    arrays += [w(8, 256) for _ in range(4)]
    rich = ((tuple(stages), True), arrays)
    # the main pipeline's shape: one grant-free stage, no filter, no sink
    plain_spec = (((-1, 0, 0, None),), False)
    simple = (plain_spec, [bits_lo, bits_hi, k, tk, te, lo, hi, arrays[7], arrays[8]])
    codes = {g: t(rng.integers(0, g, n_probe).astype(np.int32)) for g in (8, 4096)}
    vals = t(rng.normal(size=(n_probe, 1)).astype(np.float32))
    long_codes = t(rng.integers(0, 4096, SEG_PATH_ROWS).astype(np.int32))
    long_vals = t(rng.normal(size=(SEG_PATH_ROWS, 1)).astype(np.float32))
    one = t(keys[:1].astype(np.int32))  # an order key: a hit
    return {
        "hash_probe_lens": ("hash_probe_lens", (k, tk, ones, all_mask)),
        "hash_probe_lens64": ("hash_probe_lens64", (k, tk, te, lo, hi, lens_mask)),
        "hash_probe_lens_multi64": ("hash_probe_lens_multi64", (k, tk, te, lo, hi)),
        "hash_probe_lens_multi": ("hash_probe_lens_multi", (k, tk, slot_vis)),
        "hash_probe_lens" + FLOOR: ("hash_probe_lens", (one, tk, ones, all_mask)),
        "hash_probe_lens64" + FLOOR: ("hash_probe_lens64", (one, tk, te, lo, hi, lens_mask)),
        "hash_probe_lens_multi64" + FLOOR: ("hash_probe_lens_multi64", (one, tk, te, lo, hi)),
        "hash_probe_lens_multi" + FLOOR: ("hash_probe_lens_multi", (one, tk, slot_vis)),
        "fused_chain": ("fused_chain", simple),
        "fused_chain_rich": ("fused_chain", rich),
        "hash_build_insert": ("hash_build_insert", (t(keys.astype(np.int32)), len(tkeys))),
        **insert_inputs(keys, len(tkeys), rng, t),
        "seg_aggregate_g8": ("seg_aggregate", (codes[8], vals, 8)),
        "seg_aggregate_g4096": ("seg_aggregate", (codes[4096], vals, 4096)),
        "seg_aggregate_g4096_path_rows": ("seg_aggregate", (long_codes, long_vals, 4096)),
    }


def insert_inputs(order_keys, cap, rng, t):
    """Batch inserts beyond the SF-1 replay: 2^19 keys of distinct homes
    into 2^20 slots (load 0.5) with clusters of six keys on each of the
    last and the first slot, so they wrap round the end (``ok`` 1); 17 keys
    on one home among 2^16 in 2^18 slots, a certain window overflow; and
    the SF's order keys with one duplicate (``ok`` 0 for both)."""
    from repro_torch.kernels.hash_probe import keys_at

    big = 1 << 20
    homes = np.concatenate([[big - 1] * 6, [0] * 6, 8 + rng.choice(big - 16, big // 2 - 12,
                                                                  replace=False)])
    small = 1 << 18
    over = np.concatenate([[77] * 17, 100 + rng.choice(small - 200, (1 << 16) - 17, replace=False)])
    dup = order_keys.astype(np.int32).copy()
    dup[len(dup) // 2] = dup[7]
    return {
        "hash_build_insert_wrap": ("hash_build_insert",
                                   (t(keys_at(homes, big, rng.integers(big))), big)),
        "hash_build_insert_overflow": ("hash_build_insert",
                                       (t(keys_at(over, small, rng.integers(small))), small)),
        "hash_build_insert_duplicate": ("hash_build_insert", (t(dup), cap)),
    }


# ---------------------------------------------------------------------------
# kernel vs plain
# ---------------------------------------------------------------------------


def kernel_pair(name):
    from repro_torch.kernels import fused_chain as fc
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.kernels import seg_aggregate as sa

    if name == "fused_chain":
        return (lambda spec, arrays: fc.chain_launch(spec, arrays),
                lambda spec, arrays: fc.chain_plain(spec, arrays))
    if name == "hash_build_insert":
        # the plain version loops over host integers: it runs on CPU copies
        return hp.hash_build_insert, lambda keys, cap: hp.hash_build_insert_plain(keys.cpu(), cap)
    if name == "seg_aggregate":
        return sa.seg_aggregate, sa.seg_aggregate_plain
    return getattr(hp, name), getattr(hp, name + "_plain")


def max_abs_err(name, got, want):
    """Largest absolute difference of kernel and plain outputs; floats must
    also agree bit for bit. A batch insert's tables are compared only where
    ``ok`` is 1 (the kernel stops at its first failure); ``ok`` always."""
    import torch

    if name == "hash_build_insert" and int(want[2][0]) == 0:
        got, want = got[2:], want[2:]
    err = 0.0
    for g, w in zip(got, want):
        g, w = g.cpu(), w.cpu()
        if g.shape != w.shape:
            raise AssertionError(f"{name}: shape {tuple(g.shape)} != plain {tuple(w.shape)}")
        if not g.numel():
            continue
        if g.is_floating_point():
            err = max(err, float((g.double() - w.double()).abs().max()))
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                raise AssertionError(f"{name}: kernel and plain version differ in their bits")
        else:
            err = max(err, float((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def compare(name, args, timed=True, iters=20, label=None, trace=False):
    """Run a kernel and its plain version on the same card inputs; require
    exact equality; return error, times, bound and, where one PyTorch call
    computes the same function, that call's time. The kernels of
    ``LAUNCH_PATH`` and the traced calls also record their host time per
    call (``enqueue_ms``); with ``trace`` a call has its device time read in
    the last phase."""
    import torch

    kern, plain = kernel_pair(name)
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max_abs_err(name, got, want)
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain version (max abs {err})")
    rec = {"max_abs_err": err, "library_ms": None}
    if not timed:
        return rec
    if name == "hash_build_insert":
        rec["ok"] = int(want[2][0])
        rec["ms"] = time_ms(lambda: kern(*args), iters)
        rec["plain_ms"] = host_ms(lambda: plain(*args))
        rec["plain_on"] = "host"
        rec["bound_ms"], rec["bound_by"] = insert_bound(args[0], args[1], want[0])
        return rec
    rec["ms"] = time_ms(lambda: kern(*args), SEG_ITERS if name in MEAN_200 or trace else iters)
    rec["plain_ms"] = time_ms(lambda: plain(*args), max(2, iters // 4))
    if name in LAUNCH_PATH or trace:
        rec["enqueue_ms"] = enqueue_ms(lambda: kern(*args), SEG_ITERS)
    if trace:
        LAUNCH_TRACES.append((label, lambda: kern(*args)))
    if name == "fused_chain":
        rec["bound_ms"], rec["bound_by"] = chain_bound(args[0], args[1], got[0])
    elif name == "seg_aggregate":
        codes, vals, g = args
        rec["bound_ms"], rec["bound_by"] = seg_bound(codes, vals, g)
        rec.update(seg_times(label, lambda: kern(*args), codes, vals, g))
    else:
        rec["bound_ms"], rec["bound_by"] = probe_bound(name, args)
    return rec


class Recorder:
    """Keeps the largest call of each kernel wrapper that the backend
    makes (of the batch insert, the largest that built a servable table),
    so the main path's own inputs can be replayed after the legs. Tables
    and mirrors are kept by reference: the replay sees them as the backend
    left them (patched in place later). The per-row inputs of the chain and
    the keys of the probes are copied on the device when a larger call
    comes, since the backend stages them in buffers that later calls
    overwrite.

    It also times the backend's ``ENGINE_CALLS``: the engine's own calls
    that feed B1-B4 and the upkeep steps inside them, their number and
    host seconds, taken by ``engine_times``. With ``replay=False`` it only
    times them and keeps no call: the reuse phase reads device memory,
    which kept tables would hold."""

    def __init__(self, replay=True):
        import repro_torch.api.backends as backends
        from repro_torch.kernels.fused_chain import input_kinds

        self.mod = backends
        self.kinds = input_kinds
        self.calls = {}
        self.saved = {}
        self.engine = {name: [0, 0.0] for name in ENGINE_CALLS}
        self.methods = {}
        for name in ENGINE_CALLS:
            orig = backends.TorchBackend.__dict__[name]  # a staticmethod stays one
            self.methods[name] = orig
            if isinstance(orig, staticmethod):
                timed = staticmethod(self._timed(orig.__func__, self.engine[name]))
            else:
                timed = self._timed(orig, self.engine[name])
            setattr(backends.TorchBackend, name, timed)
        kept = (("hash_probe_lens", "hash_probe_lens"),
                ("hash_probe_lens64", "hash_probe_lens64"),
                ("hash_probe_lens_multi64", "hash_probe_lens_multi64"),
                ("chain_launch", "fused_chain"),
                ("hash_build_insert", "hash_build_insert"),
                ("seg_aggregate", "seg_aggregate"))
        for fn_name, name in kept if replay else ():
            orig = getattr(backends, fn_name)
            self.saved[fn_name] = orig
            setattr(backends, fn_name, self._wrap(orig, name))

    @staticmethod
    def _timed(orig, acc):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kw)
            finally:
                acc[0] += 1
                acc[1] += time.perf_counter() - t0

        return call

    def _wrap(self, orig, name):
        def call(*args, **kw):
            out = orig(*args, **kw)
            if name == "hash_build_insert" and not int(out[2][0]):
                return out  # keep the largest rebuild that built a table
            if name == "fused_chain":
                size = args[1][0].shape[0]
            elif name == "seg_aggregate":
                size = (args[0].shape[0], args[2])  # rows, then groups
            else:
                size = args[0].shape[0]
            best = self.calls.get(name)
            if best is None or size > best[0]:
                if name == "fused_chain":
                    spec, arrays = args
                    kept = (spec, [a.clone() if k == "row" else a
                                   for a, k in zip(arrays, self.kinds(spec))])
                elif name in ("hash_probe_lens64", "hash_probe_lens", "hash_probe_lens_multi64"):
                    kept = (args[0].clone(),) + tuple(args[1:])
                else:
                    kept = args
                self.calls[name] = (size, kept)
            return out

        return call

    def engine_times(self):
        """Calls and host seconds of each timed engine call since the last
        reading; the counts start again from 0."""
        out = {}
        for name, acc in self.engine.items():
            out[name] = {"calls": acc[0], "seconds": acc[1],
                         "ms_per_call": acc[1] / acc[0] * 1e3 if acc[0] else None}
            acc[0], acc[1] = 0, 0.0
        return out

    def restore(self):
        for fn_name, orig in self.saved.items():
            setattr(self.mod, fn_name, orig)
        for name, orig in self.methods.items():
            setattr(self.mod.TorchBackend, name, orig)


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------


def workload(db, n, seed):
    from repro_torch.relational import queries

    rng = np.random.default_rng(seed)
    qs, t = [], 0.0
    for _ in range(n):
        qs.append(queries.sample_query(db, rng, arrival=t))
        t += float(rng.choice([0.0, 0.001, 0.01]))
    return qs


def run_session(db, qs, qid_base=None, watch=None, **cfg):
    """One session over the workload; returns it, the futures and the wall
    seconds of ``run()``. With ``qid_base`` the i-th query gets the id
    ``qid_base + i`` (queries are numbered process-wide, and cohort plans
    and admission logs name them by id), so two runs compare by id. With
    ``watch``, ``watch(session)`` runs at each query's completion, while
    the queries still running hold their states; it submits nothing."""
    import dataclasses

    import graftdb_torch
    from repro_torch.relational import queries

    session = graftdb_torch.connect(db, graftdb_torch.EngineConfig(**cfg))
    built = [queries.make_query(db, q.template, q.params, arrival=q.arrival) for q in qs]
    if qid_base is not None:
        built = [dataclasses.replace(q, qid=qid_base + i) for i, q in enumerate(built)]
    futs = session.submit_all(built)
    t0 = time.perf_counter()
    session.run(None if watch is None else lambda fut: watch(session))
    return session, futs, time.perf_counter() - t0


def outcomes(futs):
    """Each query's result, or its status where it did not complete."""
    return [f.result() if f.status == "done" else f.status for f in futs]


def check_results(label, results, expected, rtol=1e-9):
    """Sorted-column allclose against the reference executor: same
    columns, same row counts, values within ``rtol``. Returns the largest
    relative difference seen."""
    worst = 0.0
    for i, (got, want) in enumerate(zip(results, expected)):
        if set(got) != set(want):
            raise AssertionError(f"{label}/q{i}: columns {sorted(got)} != {sorted(want)}")
        for k in want:
            a = np.sort(np.asarray(got[k], np.float64))
            b = np.sort(np.asarray(want[k], np.float64))
            if a.shape != b.shape:
                raise AssertionError(f"{label}/q{i}/{k}: shape {a.shape} vs {b.shape}")
            np.testing.assert_allclose(a, b, rtol=rtol, err_msg=f"{label}/q{i}/{k}")
            nz = b != 0
            if nz.any():
                worst = max(worst, float(np.max(np.abs(a[nz] - b[nz]) / np.abs(b[nz]))))
    return worst


def leg_summary(session, wall):
    c = session.counters
    return {
        "wall_s": wall,
        "now_s": session.now,
        "chain_launches": int(c["kernel_chain_launches"]),
        "fallbacks": {k: int(v) for k, v in c.items() if k.startswith("fallback_probes_")},
        "backend": session.backend.stats(),
    }


def cohort_plans(session):
    """The session's planned cohorts: id, admission time and plan."""
    return [(e["cohort"], e["t"], e["plan"].to_dict()) for e in session.cohort_log()]


def same_results(label, got, want):
    """Two lists of outcomes (:func:`outcomes`), bit for bit: the same
    status where a query did not complete, else the same columns with
    equal values."""
    for i, (a, b) in enumerate(zip(got, want)):
        if isinstance(a, str) or isinstance(b, str):
            if a != b:
                raise AssertionError(f"{label}/q{i}: status {a!r} != {b!r}")
            continue
        if set(a) != set(b):
            raise AssertionError(f"{label}/q{i}: columns {sorted(a)} != {sorted(b)}")
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{label}/q{i}/{k}")


def twin(db, qs, optin=False, probe=None, **cfg):
    """The same workload on the card and on the CPU must give identical
    runs, in the default config or (``optin``) with the opt-in kernels:
    results, the status of each query that did not complete, counters,
    admission logs, cohort plans, backend stats and clocks; and, with
    ``probe``, what ``probe(session)`` returns after the run (a dict,
    compared key by key and kept under ``"probe"``)."""
    from repro_torch.api.backends import TorchBackend

    runs = []
    for dev in ("cuda", "cpu"):
        where = dict(backend=TorchBackend(device=dev, **OPTIN)) if optin else dict(device=dev)
        session, futs, _ = run_session(db, qs, qid_base=TWIN_QID_BASE, **where, **cfg)
        admissions = [session._runner.admission_log.get(f.qid) for f in futs]
        runs.append((session, outcomes(futs), admissions, cohort_plans(session),
                     probe(session) if probe else {}))
    (s_gpu, r_gpu, a_gpu, p_gpu, x_gpu), (s_cpu, r_cpu, a_cpu, p_cpu, x_cpu) = runs
    same_results("twin (card vs CPU)", r_gpu, r_cpu)
    for k in x_gpu:
        if x_gpu[k] != x_cpu[k]:
            raise AssertionError(f"twin: {k} differ: {x_gpu[k]} != {x_cpu[k]}")
    if dict(s_gpu.counters) != dict(s_cpu.counters):
        diff = {k: (s_gpu.counters[k], s_cpu.counters.get(k)) for k in s_gpu.counters
                if s_gpu.counters[k] != s_cpu.counters.get(k)}
        raise AssertionError(f"twin: counters differ: {diff}")
    if a_gpu != a_cpu:
        raise AssertionError("twin: admission logs differ")
    if p_gpu != p_cpu:
        raise AssertionError("twin: cohort plans differ")
    if s_gpu.backend.stats() != s_cpu.backend.stats():
        raise AssertionError("twin: backend counters differ")
    if s_gpu.now != s_cpu.now:
        raise AssertionError(f"twin: clocks differ: {s_gpu.now!r} != {s_cpu.now!r}")
    out = {"now_s": s_gpu.now, "chain_launches": int(s_gpu.counters["kernel_chain_launches"]),
           "not_done": sum(isinstance(r, str) for r in r_gpu)}
    out.update({k: s_gpu.counters[k] for k in REUSE_COUNTERS + BATCH_COUNTERS})
    out["cohorts"] = len(p_gpu)
    if probe:
        out["probe"] = x_gpu
    s_gpu.close()
    s_cpu.close()
    return out


# ---------------------------------------------------------------------------
# the reuse-and-fault path
# ---------------------------------------------------------------------------

#: the repeat-heavy trace: the shape of the reference benchmark's
#: ``REPEAT_HEAVY`` (``benchmarks/fig10_open_loop.py``: each arrival drawn
#: with Zipf(1.1) weights from a pool of concrete instances), cut to a
#: smoke run: 24 arrivals from a pool of 8, in 6 bursts of 4 arrivals
#: 0.01 virtual s apart. Bursts start ``BURST_GAP_S`` apart, longer than
#: a burst's virtual makespan at SF 1 (the script checks it), so each
#: burst's states retire, evict and spill before the next burst arrives
REPEAT_POOL = 8
REPEAT_ARRIVALS = 24
REPEAT_ZIPF = 1.1
BURST = 4
BURST_STEP_S = 0.01
BURST_GAP_S = 100.0
#: every retirement evicts (and, with a cache, spills)
EVICT_ALL = dict(mode="graft", retention="epoch", memory_budget=0)
#: a memory tier that holds every artifact of the SF-1 trace
REUSE_CACHE_BUDGET = 32 << 30
#: the SF-0.1 twins' tiers: a small memory tier, so that artifacts demote
#: to the disk tier's ``.npz`` files
TWIN_CACHE = dict(reuse_cache_budget=1 << 20, reuse_disk_budget=4 << 30)
#: the chaos leg's fault rates, those of ``tests/test_chaos_fuzz.py``'s
#: ``FAULT_MIXES`` (morsel 0.01, stall 0.05, rehydrate 0.3), and its
#: retry limit
FAULT_RATES = {"morsel": 0.01, "stall": 0.05, "rehydrate": 0.3}
FAULT_RETRY_LIMIT = 2
#: kernels each cache leg must launch (B1, B2), and the kernel some cache
#: leg must launch (B4): on this trace's templates (q1, q3, q4, q10) the
#: engine's plain probe runs only where the chain and the lens probe
#: decline, which at SF 1 happens in the chaos leg alone
REUSE_KERNELS = ("fused_chain", "hash_probe_lens64")
REUSE_SOME_LEG = ("hash_probe_lens",)
#: the statuses a query that did not complete may end in
TERMINAL = ("cancelled", "deadline", "failed")
#: the engine counters each reuse leg and twin records
REUSE_COUNTERS = ("cache_hits", "cache_spills", "cache_evictions", "cache_corrupt",
                  "rehydrate_bytes", "cache_high_water_bytes", "cache_disk_high_water_bytes",
                  "evictions", "evicted_bytes", "faults_injected", "fault_retries",
                  "quarantined_states", "unfolds", "cancelled")


def repeat_instances(db, qrng, n, pool, zipf=REPEAT_ZIPF):
    """The reference benchmark's repeat-heavy instance stream
    (``benchmarks/common.py`` ``repeat_instances``): a pool of sampled
    (template, params) instances, each arrival drawn from it with
    Zipf(rank) weights. Returns the pool and each arrival's pool index."""
    from repro_torch.relational import queries

    inst = []
    for _ in range(pool):
        q = queries.sample_query(db, qrng)
        inst.append((q.template, q.params))
    ranks = np.arange(1, pool + 1, dtype=np.float64)
    w = ranks ** (-zipf)
    w /= w.sum()
    return inst, [int(i) for i in qrng.choice(pool, size=n, p=w)]


def burst_arrival(i):
    return (i // BURST) * BURST_GAP_S + (i % BURST) * BURST_STEP_S


def repeat_trace(db, seed):
    """The repeat trace's queries (arrivals in bursts), its pool and picks."""
    from repro_torch.relational import queries

    pool, picks = repeat_instances(db, np.random.default_rng(seed), REPEAT_ARRIVALS, REPEAT_POOL)
    qs = [queries.make_query(db, *pool[k], arrival=burst_arrival(i)) for i, k in enumerate(picks)]
    return qs, pool, picks


def fault_plan():
    import graftdb_torch

    return graftdb_torch.FaultPlan(seed=SEED, schedule=FAULT_RATES,
                                   retry_limit=FAULT_RETRY_LIMIT)


def faults_by_site(plane):
    """Draws and fired faults of each site: a fresh plane of the same plan
    replays the draws (a fire is a pure function of seed, site and index)."""
    from repro_torch.core.faults import SITES, FaultPlane

    replay = FaultPlane(plane.plan, {})
    return {site: {"draws": plane._calls[site],
                   "fired": sum(replay.fire(site) for _ in range(plane._calls[site]))}
            for site in SITES}


def table_bytes(ent):
    """Device bytes of one probe table and its entry-indexed mirrors."""
    import torch

    held = [ent.jkeys, ent.jentry, ent.jones, ent.jvlo, ent.jvhi, ent.jelo, ent.jehi]
    held += [t for rec in (ent.ords or {}).values() for t in rec[:2]]
    held += [rec[0] for rec in (ent.keycols or {}).values()]
    return sum(t.numel() * t.element_size() for t in held if isinstance(t, torch.Tensor))


def memory_record(backend):
    """Device bytes allocated (now and at the peak since the last reset),
    and the backend's live probe tables: all, those of evicted states, and
    their device bytes."""
    import torch

    tables = list(backend._tables.items())
    rec = {
        "memory_allocated": torch.cuda.memory_allocated(),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "live_tables": len(tables),
        "evicted_state_tables": sum(1 for st, _ in tables if st.evicted),
        "table_bytes": sum(table_bytes(e) for _, e in tables),
        "evicted_table_bytes": sum(table_bytes(e) for st, e in tables if st.evicted),
    }
    del tables
    return rec


class Rehydrations:
    """Counts the hash states the reuse plane rehydrates in a leg, and
    those of them the backend builds a probe table for (their first probe:
    a full rebuild, by B6 when the insert kernel is on)."""

    def __init__(self):
        import weakref

        from repro_torch.api import backends
        from repro_torch.core import reuse

        self.mods = (reuse.ReusePlane, backends.TorchBackend)
        self.orig = (reuse.ReusePlane.try_rehydrate_hash, backends.TorchBackend._table_for)
        self.built, self.probed = weakref.WeakSet(), weakref.WeakSet()
        self.n_built = self.n_probed = 0
        rehydrate, table_for = self.orig

        def counted_rehydrate(plane, *a, **kw):
            st = rehydrate(plane, *a, **kw)
            if st is not None:
                self.built.add(st)
                self.n_built += 1
            return st

        def counted_table_for(backend, state):
            if state in self.built and state not in self.probed:
                self.probed.add(state)
                self.n_probed += 1
            return table_for(backend, state)

        reuse.ReusePlane.try_rehydrate_hash = counted_rehydrate
        backends.TorchBackend._table_for = counted_table_for

    def take(self):
        out = {"hash_states_rehydrated": self.n_built, "rehydrated_states_probed": self.n_probed}
        self.n_built = self.n_probed = 0
        return out

    def restore(self):
        self.mods[0].try_rehydrate_hash, self.mods[1]._table_for = self.orig


def reuse_leg(db, qs, expected, label, cfg, rtol, timer, rehydrations):
    """One leg of the reuse phase: launch counts reset before it and read
    after it, every completed result within ``rtol`` of the reference
    executor, every other query in a terminal status, and the records of
    ``reuse_phase``. Returns the record and the results (None where a query
    did not complete)."""
    import gc

    import torch

    from repro_torch.kernels import _build

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    timer.engine_times()
    rehydrations.take()
    _build.reset_launch_counts()
    session, futs, wall = run_session(db, qs, **cfg)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    engine = timer.engine_times()
    statuses = [f.status for f in futs]
    bad = [(i, s) for i, s in enumerate(statuses) if s != "done" and s not in TERMINAL]
    if bad:
        raise AssertionError(f"{label}: queries neither done nor terminal: {bad}")
    done = [i for i, s in enumerate(statuses) if s == "done"]
    if "faults" not in cfg and len(done) < len(futs):
        raise AssertionError(f"{label}: {len(futs) - len(done)} queries did not complete")
    results = [futs[i].result() if i in done else None for i in range(len(futs))]
    worst = check_results(label, [results[i] for i in done], [expected[i] for i in done], rtol)
    stats = [f.stats() for f in futs]
    for b in range(0, len(futs), BURST):
        ends = [stats[i]["t_complete"] for i in range(b, min(b + BURST, len(futs))) if i in done]
        if b + BURST < len(futs) and ends and max(ends) >= qs[b + BURST].arrival:
            raise AssertionError(f"{label}: burst at {qs[b].arrival} s ends at {max(ends)} s, "
                                 f"after the next burst arrives")
    makespans = [max([stats[i]["t_complete"] for i in range(b, b + BURST) if i in done],
                     default=qs[b].arrival) - qs[b].arrival for b in range(0, len(futs), BURST)]
    served = [i for i in done if stats[i]["served_from_cache"]]
    lat = {i: futs[i].latency() for i in done}
    c = session.counters
    rec = {
        "wall_s": wall,
        "now_s": session.now,
        "max_rel_err": worst,
        "statuses": {s: statuses.count(s) for s in sorted(set(statuses))},
        "counters": {k: c[k] for k in REUSE_COUNTERS},
        "served_from_cache": len(served),
        "latency_s": {
            "cache_hit_arrivals": [lat[i] for i in served],
            "other_arrivals": [lat[i] for i in done if i not in served],
        },
        "burst_makespan_s": makespans,
        "launches": launches,
        "engine": {k: engine[k] for k in ("_table_for", "_insert_keys", "_batch_insert")},
        "backend": session.backend.stats(),
        "memory_before": before,
    }
    rec.update(rehydrations.take())
    if session._engine.faults is not None:
        rec["faults_by_site"] = faults_by_site(session._engine.faults)
    rec["memory_after"] = memory_record(session.backend)
    backend = session.backend
    session.close()
    del session, futs, stats
    gc.collect()
    torch.cuda.synchronize()
    rec["memory_after_gc"] = memory_record(backend)
    del backend
    log(f"reuse leg {label}: {rec['statuses']}, done results == refexec (rtol {rtol}, largest "
        f"{worst:.3g}); wall {wall:.2f} s, clock {rec['now_s']!r} s; {rec['counters']}; "
        f"served from cache {len(served)}; launches {launches}; "
        f"_table_for {engine['_table_for']['seconds']:.4f} s, _insert_keys "
        f"{engine['_insert_keys']['seconds']:.4f} s, _batch_insert "
        f"{engine['_batch_insert']['seconds']:.4f} s; memory after {rec['memory_after']}, "
        f"after gc {rec['memory_after_gc']}")
    return rec, results


def reuse_phase(db, report):
    """Phase 4b: the repeat trace at SF 1 on the card in four legs, each
    with ``retention="epoch"`` and ``memory_budget=0``, so that every
    retirement evicts: ``reuse-live`` (no cache: eviction destroys),
    ``reuse-cache`` (a cache that holds every artifact), the same with the
    opt-in kernels, and ``chaos`` (the cache and ``fault_plan()``). Checks:
    every completed result equals the reference executor (rtol 1e-9; 1e-5
    with the opt-in kernels) and the cache legs' results the live leg's;
    both cache legs spill, hit and rehydrate, some arrival is served from
    the cache and the memory tier evicts nothing; each leg with a cache
    probes rehydrated states and launches B1 and B2, and one of them B4;
    B6 launches at least once per rehydrated hash state that was probed;
    the chaos leg injects faults and retries, and every query that did not
    complete ends in a terminal status."""
    from repro_torch.api.backends import TorchBackend
    from repro_torch.relational import queries, refexec

    qs, pool, picks = repeat_trace(db, SEED)
    log(f"repeat trace: pool {[t for t, _ in pool]}, picks {picks}")
    t0 = time.perf_counter()
    by_pool = [refexec.execute(db, queries.make_query(db, *inst).plan) for inst in pool]
    expected = [by_pool[k] for k in picks]
    out = {"reference_executor_s": time.perf_counter() - t0, "picks": picks,
           "pool": [t for t, _ in pool], "burst_gap_s": BURST_GAP_S,
           "fault_rates": FAULT_RATES, "fault_retry_limit": FAULT_RETRY_LIMIT,
           "reuse_cache_budget": REUSE_CACHE_BUDGET, "legs": {}}
    cache = dict(EVICT_ALL, reuse_cache_budget=REUSE_CACHE_BUDGET)
    legs = (
        ("reuse-live", dict(EVICT_ALL), 1e-9),
        ("reuse-cache", cache, 1e-9),
        ("reuse-cache-optin", dict(cache, backend=TorchBackend(device="cuda", **OPTIN)), 1e-5),
        ("chaos", dict(cache, faults=fault_plan()), 1e-9),
    )
    timer = Recorder(replay=False)
    rehydrations = Rehydrations()
    results = {}
    try:
        for label, cfg, rtol in legs:
            out["legs"][label], results[label] = reuse_leg(
                db, qs, expected, label, cfg, rtol, timer, rehydrations)
    finally:
        rehydrations.restore()
        timer.restore()
    report["reuse"] = out
    live = results["reuse-live"]
    cache_legs = ("reuse-cache", "reuse-cache-optin", "chaos")
    for label in cache_legs:
        rec = out["legs"][label]
        missing = [k for k in REUSE_KERNELS if rec["launches"].get(k, 0) == 0]
        if missing:
            raise AssertionError(f"{label}: kernels never launched: {missing}")
        if rec["rehydrated_states_probed"] == 0:
            raise AssertionError(f"{label}: no rehydrated hash state was probed")
        if label == "chaos":
            continue
        check_results(f"{label} vs reuse-live", results[label], live,
                      1e-5 if label.endswith("optin") else 1e-9)
        for k in ("cache_spills", "cache_hits", "rehydrate_bytes"):
            if rec["counters"][k] <= 0:
                raise AssertionError(f"{label}: {k} is {rec['counters'][k]}")
        if rec["served_from_cache"] == 0:
            raise AssertionError(f"{label}: no arrival was served from the cache")
        if rec["counters"]["cache_evictions"] > 0:
            raise AssertionError(f"{label}: the memory tier evicted "
                                 f"{rec['counters']['cache_evictions']} artifacts")
    missing = [k for k in REUSE_SOME_LEG
               if not any(out["legs"][label]["launches"].get(k, 0) for label in cache_legs)]
    if missing:
        raise AssertionError(f"no cache leg launched {missing}")
    optin = out["legs"]["reuse-cache-optin"]
    if optin["launches"].get("hash_build_insert", 0) < max(1, optin["rehydrated_states_probed"]):
        raise AssertionError(
            f"reuse-cache-optin: B6 launched {optin['launches'].get('hash_build_insert', 0)} "
            f"times for {optin['rehydrated_states_probed']} rehydrated states probed")
    chaos = out["legs"]["chaos"]["counters"]
    if chaos["faults_injected"] <= 0 or chaos["fault_retries"] <= 0:
        raise AssertionError(f"chaos: faults {chaos['faults_injected']}, "
                             f"retries {chaos['fault_retries']}")
    log(f"reuse phase: cache legs == live leg, cache hit, B1/B2 launched in each, B4 in "
        f"{[k for k in cache_legs if out['legs'][k]['launches'].get('hash_probe_lens')]}; B6 "
        f"{optin['launches'].get('hash_build_insert', 0)} launches for "
        f"{optin['rehydrated_states_probed']} rehydrated states probed; chaos "
        f"{out['legs']['chaos']['statuses']}, faults by site {out['legs']['chaos']['faults_by_site']}")


# ---------------------------------------------------------------------------
# the batch-planning path
# ---------------------------------------------------------------------------

#: the queued-burst trace of the reference's batch sweep
#: (``benchmarks/batch_sweep.py`` ``make_burst_trace``): bursts of
#: same-instant q3s on one segment each (``b % 5``), dates ascending in
#: steps of 2 days up to 1996-06-30, so the narrowest member comes first,
#: bursts ``BATCH_GAP_S`` virtual s apart; 6 bursts of 4 at SF 1
BATCH_BURSTS = 6
BATCH_SIZE = 4
BATCH_GAP_S = 0.002
BATCH_GROUPS = 5
#: per template of a burst trace: the parameter that takes the burst's
#: group, the last date of a burst and the step between its members' dates
#: (days). q5's windows have one width, so its members are shifted windows
#: that see different rows of one shared orders state
BURST_SHAPES = {"q3": ("segment", "1996-06-30", 2), "q5": ("region", "1994-06-30", 60)}
#: the q5 burst trace: 2 bursts of 4, whose cohorts' probes reach the lens
#: probes
BATCH_Q5_BURSTS = 2
#: the two legs of the sweep (``batch_sweep._run_leg``): graft mode, the
#: default morsels, one worker, one partition; the planned leg's window is
#: 0, so each burst (one arrival instant) is one cohort
BATCH_LEG = dict(mode="graft", workers=1, partitions=1)
BATCH_LEGS = (("greedy", dict(BATCH_LEG, batch_planning=False)),
              ("planned", dict(BATCH_LEG, batch_planning=True, batch_window=0.0)))
#: per burst trace: the kernels each leg must launch, and the kernels of
#: which each leg must launch one. At SF 1 every probe of the q3 trace
#: runs inside the chain, in both legs, so B2-B4 launch 0 times there
#: (measured on the H100); the q5 trace's multi-member probes leave the
#: chain and take a lens probe
BATCH_TRACES = (
    ("q3", BATCH_BURSTS, ("fused_chain",), ()),
    ("q5", BATCH_Q5_BURSTS, ("fused_chain",),
     ("hash_probe_lens64", "hash_probe_lens_multi64")),
)
#: the engine's batch-planning counters
BATCH_COUNTERS = ("batch_cohorts", "batch_planned_queries", "batch_coverage_gain_rows")
#: the serving phase: ``benchmarks/serve_fold.py``'s workload (48 requests
#: over 4 prompts of a 1,024-token prefix, a 64-token suffix each, 32
#: decode steps, Poisson arrivals at 0.05 s, seed 0), in three legs
SERVE_LEGS = (("isolated", dict(fold=False)), ("fold", dict(fold=True)),
              ("batch-fold", dict(fold=True, batch_fold=True)))


def burst_trace(db, n_bursts, size, gap_s=BATCH_GAP_S, template="q3"):
    """A burst trace's queries, dates ascending within each burst."""
    from repro_torch.relational import queries
    from repro_torch.relational.table import days

    group, end, step = BURST_SHAPES[template]
    last = days(end)
    return [
        queries.make_query(
            db, template,
            {group: float(b % BATCH_GROUPS), "date": float(last - step * (size - 1 - i))},
            arrival=(b + 1) * gap_s,
        )
        for b in range(n_bursts)
        for i in range(size)
    ]


def fingerprint(session, results):
    """Byte-level identity of one run (``batch_sweep._fingerprint``): every
    result column in canonical row order, every engine counter, the clock."""
    import hashlib

    h = hashlib.sha256()
    for res in results:
        keys = sorted(res)
        order = np.lexsort([np.asarray(res[k]) for k in keys])
        for k in keys:
            h.update(k.encode())
            h.update(np.ascontiguousarray(np.asarray(res[k])[order]).tobytes())
    for k in sorted(session.counters):
        h.update(f"{k}={session.counters[k]!r};".encode())
    h.update(f"now={session.now!r}".encode())
    return h.hexdigest()


def batch_leg(db, qs, expected, label, cfg, timer, planner, required, one_of):
    """One leg of the batch phase: launch counts reset before it and read
    after it, every result equal to the reference executor (rtol 1e-9),
    every kernel of ``required`` and one of ``one_of`` launched. Returns the
    record and the results."""
    import torch

    from repro_torch.kernels import _build

    timer.engine_times()
    planner[0], planner[1] = 0, 0.0
    _build.reset_launch_counts()
    session, futs, wall = run_session(db, qs, **cfg)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    engine = timer.engine_times()
    results = outcomes(futs)
    worst = check_results(label, results, expected)
    if session._engine.cohort_ctx is not None:
        raise AssertionError(f"{label}: the cohort context outlived its cohort")
    c = session.counters
    rec = {
        "wall_s": wall,
        "now_s": session.now,
        "max_rel_err": worst,
        "rows_counters": {k: c.get(k, 0.0) for k in sorted(
            {k for k in c if k.endswith("_rows")} | {"represented_rows"})},
        "batch_counters": {k: c[k] for k in BATCH_COUNTERS},
        "fallbacks": {k: c[k] for k in sorted(c) if k.startswith("fallback_")},
        "launches": {k: launches.get(k, 0) for k in LAUNCH_PATH},
        "engine": engine,
        "growth_steps": engine["_insert_keys"]["calls"],
        "plan_cohort": {"calls": planner[0], "seconds": planner[1]},
        "cohorts": [{"t": e["t"], "order": list(e["plan"].order),
                     "gain_rows": e["plan"].gain_rows} for e in session.cohort_log()],
        "cohort_records": sum("cohort" in (f.stats()["admission"] or {}) for f in futs),
        "backend": session.backend.stats(),
    }
    log(f"batch leg {label}: results == refexec (rtol 1e-9, largest {worst:.3g}); wall "
        f"{wall:.3f} s, clock {session.now!r} s; {rec['batch_counters']}; rows "
        f"{rec['rows_counters']}; launches {rec['launches']}; fallbacks {rec['fallbacks']}; "
        f"_insert_keys {engine['_insert_keys']['seconds']:.4f} s over {rec['growth_steps']} "
        f"growth steps, _batch_insert {engine['_batch_insert']['seconds']:.4f} s; plan_cohort "
        f"{planner[0]} calls, {planner[1]:.4f} s")
    session.close()
    missing = [k for k in required if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing}")
    if one_of and not any(launches.get(k, 0) for k in one_of):
        raise AssertionError(f"{label}: none of {list(one_of)} launched")
    return rec, results


def batch_trace_legs(db, template, n_bursts, required, one_of, timer, planner):
    """One burst trace at SF 1 on the card in the two legs; the checks of
    ``batch_phase``. Returns the trace's record."""
    from repro_torch.relational import refexec

    qs = burst_trace(db, n_bursts, BATCH_SIZE, template=template)
    t0 = time.perf_counter()
    expected = [refexec.execute(db, q.plan) for q in qs]
    out = {"reference_executor_s": time.perf_counter() - t0, "template": template,
           "bursts": n_bursts, "burst_size": BATCH_SIZE, "gap_s": BATCH_GAP_S, "legs": {}}
    log(f"burst trace: {n_bursts} bursts of {BATCH_SIZE} {template}s; reference executor "
        f"{out['reference_executor_s']:.1f} s")
    prefix = "batch-" if template == "q3" else f"batch-{template}-"
    results = {}
    for kind, cfg in BATCH_LEGS:
        label = prefix + kind
        out["legs"][label], results[kind] = batch_leg(
            db, qs, expected, label, cfg, timer, planner, required, one_of)
    check_results(f"{prefix}planned vs {prefix}greedy", results["planned"], results["greedy"])
    planned = out["legs"][prefix + "planned"]
    want = {"batch_cohorts": n_bursts, "batch_planned_queries": len(qs)}
    got = {k: planned["batch_counters"][k] for k in want}
    if got != want:
        raise AssertionError(f"{prefix}planned: {got}, expected {want}")
    if planned["batch_counters"]["batch_coverage_gain_rows"] <= 0:
        raise AssertionError(f"{prefix}planned: no coverage gained")
    if planned["cohort_records"] != len(qs):
        raise AssertionError(f"{prefix}planned: {planned['cohort_records']} of {len(qs)} "
                             f"queries carry a cohort record")
    greedy = out["legs"][prefix + "greedy"]
    out["planned_over_greedy"] = {
        "virtual": planned["now_s"] / greedy["now_s"],
        "wall": planned["wall_s"] / greedy["wall_s"],
    }
    log(f"batch {template}: planned == greedy == refexec; planned / greedy virtual "
        f"{out['planned_over_greedy']['virtual']!r}, wall {out['planned_over_greedy']['wall']!r}")
    return out


def batch_phase(db, report):
    """Phase 4c: each burst trace at SF 1 on the card in two legs,
    greedy (one arrival at a time) and planned (each burst planned as one
    cohort). Checks: every result of both legs equals the reference
    executor (rtol 1e-9) and the planned leg's the greedy leg's; the
    planned leg forms one cohort a burst, plans every query, gains
    coverage, and every query's stats carry its cohort record; each leg
    launches its trace's kernels (``BATCH_TRACES``). ``plan_cohort``'s host
    seconds are timed around it, as the backend's calls are."""
    from repro_torch.core import batchplan

    timer = Recorder(replay=False)
    planner = [0, 0.0]
    orig = batchplan.plan_cohort
    batchplan.plan_cohort = Recorder._timed(orig, planner)
    try:
        report["batch"] = {
            template: batch_trace_legs(db, template, n_bursts, required, one_of, timer, planner)
            for template, n_bursts, required, one_of in BATCH_TRACES}
    finally:
        batchplan.plan_cohort = orig
        timer.restore()


def batch_twins(tdb, report):
    """The burst trace at the twins' scale: with batch planning, the card
    and the CPU give identical runs (``twin``); a trace of bursts of one,
    with batch planning on, is fingerprint-identical on the card to the
    same trace with it off (every cohort has one member)."""
    rec = twin(tdb, burst_trace(tdb, BATCH_BURSTS, BATCH_SIZE),
               **dict(BATCH_LEGS[1][1]))
    if rec["cohorts"] != BATCH_BURSTS or rec["batch_planned_queries"] != BATCH_BURSTS * BATCH_SIZE:
        raise AssertionError(f"twin batch_planned: {rec['cohorts']} cohorts, "
                             f"{rec['batch_planned_queries']} planned queries")
    report["twin"]["batch_planned"] = rec
    singles = burst_trace(tdb, BATCH_BURSTS, 1)
    prints = {}
    for on in (False, True):
        session, futs, _ = run_session(tdb, singles, **dict(BATCH_LEG, batch_planning=on))
        prints[on] = fingerprint(session, [f.result() for f in futs])
        session.close()
    if prints[True] != prints[False]:
        raise AssertionError("singleton trace: batch planning on differs from off")
    report["twin"]["batch_singleton_fingerprint"] = prints[True]


def serve_workload(request, n=48, n_prompts=4, prefix=1024, suffix=64, seed=0):
    """``benchmarks/serve_fold.py``'s ``_workload``."""
    rng = np.random.default_rng(seed)
    prompts = [tuple(rng.integers(0, 32000, prefix).tolist()) for _ in range(n_prompts)]
    reqs, t = [], 0.0
    for i in range(n):
        t += float(rng.exponential(0.05))
        p = prompts[int(rng.integers(0, n_prompts))]
        reqs.append(request(i, p + tuple(rng.integers(0, 32000, suffix).tolist()), 32,
                            arrival=t))
    return reqs


def serving_phase(report):
    """The KV-prefix serving plane (``graftdb_torch.connect_serving``) on the
    serve-fold workload in three legs. It runs a token-cost simulator on the
    host and touches no device. Checks: every request's represented,
    residual and ordinary tokens add up to its prompt, and both folded legs
    prefill fewer tokens than the isolated one."""
    import graftdb_torch
    from repro_torch.serve.folding import Request

    out = {"device": "none (host only: the serving plane's token-cost simulator)", "legs": {}}
    for label, cfg in SERVE_LEGS:
        session = graftdb_torch.connect_serving(**cfg)
        futs = session.submit_all(serve_workload(Request))
        t0 = time.perf_counter()
        summary = session.run()
        wall = time.perf_counter() - t0
        for f in futs:
            r = f.result()
            if r["represented_tokens"] + r["residual_tokens"] + r["ordinary_tokens"] \
                    != len(f.request.prompt):
                raise AssertionError(f"serving {label}: r{f.rid}'s extents do not add up")
        out["legs"][label] = {"prefill_tokens": summary["prefill_tokens"],
                              "mean_latency_s": summary["mean_latency"],
                              "elapsed_s": summary["elapsed"], "wall_s": wall}
        log(f"serving {label}: prefill {summary['prefill_tokens']}, mean virtual latency "
            f"{summary['mean_latency']!r} s, wall {wall:.4f} s")
    computed = {k: v["prefill_tokens"]["computed"] for k, v in out["legs"].items()}
    if not computed["fold"] < computed["isolated"] or \
            not computed["batch-fold"] < computed["isolated"]:
        raise AssertionError(f"serving: folded legs do not prefill fewer tokens: {computed}")
    report["serving"] = out


# ---------------------------------------------------------------------------
# the mesh plane
# ---------------------------------------------------------------------------

#: phase 4d: the data-axis sizes of the device plane, the shards of the
#: ``mesh-4`` leg and the join and aggregate, the rows of the mesh-4
#: session's exchange validation, of the chain parity and of the db-plane
#: record, the deliberate overflow (keys, capacity), and the aggregate's
#: tolerance against a float64 host sum
MESH_SHARDS = (2, 4, 8)
MESH_LEG_SHARDS = 4
MESH_SAMPLE_ROWS = 2**21
MESH_CHAIN_ROWS = 65_536
MESH_PLANE_ROWS = 1 << 23
MESH_OVERFLOW = (256, 4)
MESH_AGG_RTOL = 1e-4
#: results of the ``mesh-4`` leg against the mesh-less ``partitions=4``
#: leg: device affinity runs the partition units in another order, so a
#: float64 sum may differ in its last bit (the reference's own mesh=2
#: session does, by 1 ulp, at SF 0.01; ``tests/test_torch_mesh.py``)
MESH_ORACLE_RTOL = 1e-12
#: B1, B2 and B4: the kernels the ``mesh-smoke`` leg must launch
MESH_KERNELS = ("fused_chain", "hash_probe_lens64", "hash_probe_lens")


def snapshot(session, futs):
    """What two runs of one trace share when they are the same run:
    results, per-query stats (query ids aside), counters, clock."""
    return {"results": outcomes(futs),
            "stats": [{k: v for k, v in f.stats().items() if k != "qid"} for f in futs],
            "counters": dict(session.counters), "now": session.now}


def mesh_leg(db, qs, label, cfg, report, watch=None):
    """One session of phase 4d on the card: launch counts reset before it
    and read after it; and the sharded chain calls counted (the wrapper of
    ``fused_chain._launch_sharded``, which the backend reaches only
    through ``chain_launch(mesh=...)``). ``watch`` goes to
    :func:`run_session`."""
    import torch

    from repro_torch.kernels import _build, fused_chain

    sharded = [0, 0.0]
    orig = fused_chain._launch_sharded
    fused_chain._launch_sharded = Recorder._timed(orig, sharded)
    _build.reset_launch_counts()
    try:
        session, futs, wall = run_session(db, qs, watch=watch, **cfg)
        torch.cuda.synchronize()
    finally:
        fused_chain._launch_sharded = orig
    launches = _build.launch_counts()
    rec = {"wall_s": wall, "now_s": session.now, "launches": launches,
           "sharded_chain_calls": sharded[0], "backend": session.backend.stats()}
    if session.mesh is not None:
        stats = session.mesh_stats()
        stats["states"] = len(stats["states"])
        rec["mesh_stats"] = stats
        rec["mesh_data_shards"] = session.stats()["mesh_data_shards"]
    report["launches"][label] = launches
    log(f"mesh leg {label}: wall {wall:.3f} s, clock {session.now!r} s, launches {launches}, "
        f"sharded chain calls {sharded[0]}, mesh {rec.get('mesh_stats')}")
    return session, futs, rec


def mesh_exchange(okeys, d, out):
    """Exchange routing of the orders' keys on a d-shard mesh of the card
    against ``key_partition``: every shard receives exactly its keys, and
    the exchange's event mean (its device time comes last,
    ``trace_mesh``) and the bytes its buffers would move per device,
    modelled from their shapes (on one card nothing crosses a link)."""
    import torch

    from repro_torch.core.hashindex import key_partition
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.relational import distributed as dist

    mesh = make_data_mesh(d)
    dest = key_partition(okeys, d)
    vals = okeys.astype(np.float32)[:, None]
    t0 = time.perf_counter()
    rec = dist.exchange_by_key(mesh, okeys, vals, dest=dest)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cap = rec["capacity"]
    got_k = rec["keys"].cpu().numpy().reshape(d, d * cap)
    got_ok = rec["valid"].cpu().numpy().reshape(d, d * cap)
    got_v = rec["values"].cpu().numpy().reshape(d, d * cap)
    for p in range(d):
        if not np.array_equal(np.sort(got_k[p][got_ok[p]]), np.sort(okeys[dest == p])):
            raise AssertionError(f"exchange d={d}: shard {p} did not receive its keys")
        if not np.array_equal(got_v[p][got_ok[p]], got_k[p][got_ok[p]].astype(np.float32)):
            raise AssertionError(f"exchange d={d}: shard {p}'s values left their keys")
    staged = [t.cuda() for t in dist.pad_partition(okeys, vals, d, dest=dest)]
    fn = dist.make_partitioned_exchange(mesh, 1, cap)
    ms = time_ms(lambda: fn(*staged), 5)
    moved = dist.exchange_bytes(d, cap, 1)
    keys_n, over_n = MESH_OVERFLOW
    few = np.arange(1, keys_n + 1, dtype=np.int64)
    grown = dist.exchange_by_key(mesh, few, few.astype(np.float32), capacity=over_n)
    ok = grown["valid"].cpu().numpy()
    if not np.array_equal(np.sort(grown["keys"].cpu().numpy()[ok]), few) \
            or grown["bucket_overflow_rows"] <= 0 or grown["attempts"] <= 1:
        raise AssertionError(f"overflow d={d}: not recovered on grow: "
                             f"{ {k: grown[k] for k in ('capacity', 'attempts', 'bucket_overflow_rows')} }")
    try:
        dist.exchange_by_key(mesh, few, few.astype(np.float32), capacity=over_n, on_overflow="raise")
    except dist.BucketOverflowError:
        pass
    else:
        raise AssertionError(f"overflow d={d}: on_overflow='raise' did not raise")
    out[d] = {"label": f"exchange d={d}", "keys": len(okeys), "capacity": cap,
              "attempts": rec["attempts"], "bucket_overflow_rows": rec["bucket_overflow_rows"],
              "wall_s": wall, "event_ms": ms, "modelled_bytes_per_device": moved,
              "overflow_grow": {k: grown[k] for k in ("capacity", "attempts",
                                                      "bucket_overflow_rows")}}
    MESH_TRACES.append((out[d], lambda: fn(*staged)))
    log(f"exchange d={d}: {len(okeys)} order keys routed as key_partition, capacity {cap}, "
        f"{ms:.4f} ms by event mean, {moved} bytes a device by the shapes; overflow of "
        f"{keys_n} keys at capacity {over_n}: grown to {grown['capacity']} in {grown['attempts']} attempts, "
        f"raise raises")
    return mesh


def mesh_join_and_aggregate(db, mesh, out):
    """At d = 4: lineitem's order keys (width 3) joined to orders (width
    2), every lineitem row hits and the joined values equal a host gather;
    TPC-H Q1's groups (returnflag x linestatus) summed over width 4 within
    ``MESH_AGG_RTOL`` of a float64 host sum. Event means of both (their
    device times come last, ``trace_mesh``)."""
    import torch

    from repro_torch.relational import distributed as dist

    d = int(mesh.shape["data"])
    li, od = db["lineitem"].columns, db["orders"].columns
    okeys = od["o_orderkey"].astype(np.int64)
    ovals = np.stack([od["o_totalprice"], od["o_orderdate"]], -1).astype(np.float32)
    lkeys = li["l_orderkey"].astype(np.int64)
    lvals = np.stack([li["l_quantity"], li["l_extendedprice"], li["l_discount"]],
                     -1).astype(np.float32)
    cap = 2 * -(-len(lkeys) // (d * d))
    join = dist.make_partitioned_join(mesh, 2, 3, capacity=cap)
    staged = [t.cuda() for t in (*dist.pad_partition(okeys, ovals, d)[:2],
                                 *dist.pad_partition(lkeys, lvals, d)[:2])]
    res, hit, keys, overflow = join(*staged)
    torch.cuda.synchronize()
    hit, keys, res = hit.cpu().numpy(), keys.cpu().numpy(), res.cpu().numpy()
    if int(overflow) != 0 or int(hit.sum()) != len(lkeys):
        raise AssertionError(f"join: {int(hit.sum())} of {len(lkeys)} lineitem rows hit, "
                             f"overflow {int(overflow)}")
    order = np.argsort(okeys)
    gather = ovals[order[np.searchsorted(okeys[order], keys[hit])]]
    if not np.array_equal(res[hit, 3:], gather):
        raise AssertionError("join: joined orders values differ from the host gather")
    got_rows = np.column_stack([keys[hit].astype(np.float64), res[hit, :3]])
    want_rows = np.column_stack([lkeys.astype(np.float64), lvals])
    got_rows = got_rows[np.lexsort(got_rows.T[::-1])]
    want_rows = want_rows[np.lexsort(want_rows.T[::-1])]
    if not np.array_equal(got_rows, want_rows):
        raise AssertionError("join: the joined lineitem rows differ from lineitem's")
    join_ms = time_ms(lambda: join(*staged), 3)
    moved = dist.exchange_bytes(d, cap, 2) + dist.exchange_bytes(d, cap, 3)
    join_in = staged
    del res

    gids = (li["l_returnflag"] * 2 + li["l_linestatus"]).astype(np.int64)
    avals = np.stack([li["l_quantity"], li["l_extendedprice"], li["l_discount"], li["l_tax"]],
                     -1).astype(np.float32)
    n_groups = 6
    agg = dist.make_partitioned_aggregate(mesh, n_groups, 4)
    staged = [t.cuda() for t in dist.pad_groups(gids, avals, d)]
    sums = agg(*staged).cpu().numpy()
    want = np.stack([np.bincount(gids, weights=avals[:, w].astype(np.float64),
                                 minlength=n_groups) for w in range(4)], -1)
    nz = want != 0
    rel = float(np.max(np.abs(sums[nz] - want[nz]) / np.abs(want[nz])))
    if rel > MESH_AGG_RTOL or np.any(sums[~nz] != 0):
        raise AssertionError(f"aggregate: relative error {rel} above {MESH_AGG_RTOL}")
    agg_ms = time_ms(lambda: agg(*staged), 3)
    out["join"] = {"label": f"join d={d}", "probe_rows": len(lkeys), "build_rows": len(okeys),
                   "capacity": cap, "hits": int(hit.sum()), "event_ms": join_ms,
                   "modelled_bytes_per_device": moved}
    out["aggregate"] = {"label": f"aggregate d={d}", "rows": len(gids), "groups": n_groups,
                        "groups_present": int(nz.any(-1).sum()),
                        "max_rel_err_vs_float64": rel, "event_ms": agg_ms}
    MESH_TRACES.append((out["join"], lambda: join(*join_in)))
    MESH_TRACES.append((out["aggregate"], lambda: agg(*staged)))
    log(f"join d={d}: {len(lkeys)} lineitem rows x {len(okeys)} orders, every row hits, values "
        f"== host gather, overflow 0; {join_ms:.3f} ms by event mean, {moved} bytes a device "
        f"by the shapes. aggregate Q1 groups: max rel err {rel:.3g} vs float64 (limit "
        f"{MESH_AGG_RTOL}); {agg_ms:.3f} ms by event mean")


def mesh_phase(db, qs, expected, base, report):
    """Phase 4d: the mesh plane at SF 1 on the card. Legs ``mesh-smoke``
    (phase 4's workload, graft mode, ``mesh="smoke"``), ``oracle-4``
    (mesh-less, ``partitions=workers=4``) and ``mesh-4`` (``mesh=4``, four
    shards on the card); then the device plane at d in ``MESH_SHARDS``,
    and the join, the aggregate and the db-plane record at d = 4."""
    import torch

    from repro_torch.launch.db_plane import _chain_parity, db_plane_record, validate_db_plane_record

    out = report["mesh"] = {"legs": {}, "exchange": {}, "chain_parity": {}}
    smoke, futs, rec = mesh_leg(db, qs, "mesh-smoke", dict(mode="graft", mesh="smoke"), report)
    got = snapshot(smoke, futs)
    same_results("mesh-smoke vs graft", got["results"], base["results"])
    for k in ("stats", "counters", "now"):
        if got[k] != base[k]:
            raise AssertionError(f"mesh-smoke: {k} differ from the mesh-less graft leg")
    if rec["mesh_data_shards"] != 1 or rec["mesh_stats"]["mesh_exchange_rows"] != 0:
        raise AssertionError(f"mesh-smoke: {rec['mesh_data_shards']} shards, "
                             f"{rec['mesh_stats']['mesh_exchange_rows']} exchange rows")
    if smoke.backend.mesh is not smoke.mesh:
        raise AssertionError("mesh-smoke: the backend's chain is not on the session mesh")
    missing = [k for k in MESH_KERNELS if rec["launches"].get(k, 0) == 0]
    if missing:
        raise AssertionError(f"mesh-smoke: kernels never launched: {missing}")
    if rec["sharded_chain_calls"] != rec["launches"]["fused_chain"]:
        raise AssertionError(f"mesh-smoke: {rec['launches']['fused_chain']} B1 launches, "
                             f"{rec['sharded_chain_calls']} shard-local calls")
    out["legs"]["mesh-smoke"] = rec
    smoke.close()
    del smoke, futs, got

    n = MESH_LEG_SHARDS
    oracle, ofuts, orec = mesh_leg(db, qs, f"oracle-{n}", dict(mode="graft", partitions=n,
                                                             workers=n), report)
    live = {"keys": 0, "checks": 0, "watch_s": 0.0}

    def validate_live(session):
        """At each completion that leaves more live-state keys than the
        last check saw, ``validate_mesh_plane`` over them."""
        t0 = time.perf_counter()
        keys = live_state_keys(session)
        if keys > live["keys"]:
            t1 = time.perf_counter()
            check = session.validate_mesh_plane(sample_rows=MESH_SAMPLE_ROWS)
            torch.cuda.synchronize()
            check["wall_s"] = time.perf_counter() - t1
            live.update(keys=keys, check=check, checks=live["checks"] + 1)
        live["watch_s"] += time.perf_counter() - t0

    meshed, mfuts, mrec = mesh_leg(db, qs, f"mesh-{n}", dict(mode="graft", mesh=n), report,
                                   watch=validate_live)
    mrec["wall_s"] -= live["watch_s"]  # the leg's own time, without the checks
    res_o, res_m = outcomes(ofuts), outcomes(mfuts)
    worst = check_results(f"mesh-{n} vs refexec", res_m, expected)
    diff = check_results(f"mesh-{n} vs oracle-{n}", res_m, res_o, rtol=MESH_ORACLE_RTOL)
    columns = [(i, k) for i, r in enumerate(res_o) for k in r]
    unequal = [f"q{i}/{k}" for i, k in columns if not np.array_equal(res_m[i][k], res_o[i][k])]
    st = mrec["mesh_stats"]
    if meshed.now < oracle.now:
        raise AssertionError(f"mesh-{n}: clock {meshed.now!r} below the oracle's {oracle.now!r}")
    if st["mesh_exchange_rows"] <= 0 or len(st["rows_by_device"]) != n \
            or min(st["rows_by_device"]) <= 0:
        raise AssertionError(f"mesh-{n}: exchange rows {st['mesh_exchange_rows']}, rows by "
                             f"device {st['rows_by_device']}")
    if mrec["launches"].get("fused_chain", 0) == 0:
        raise AssertionError(f"mesh-{n}: B1 never launched")
    mrec.update(max_rel_err=worst, max_rel_diff_vs_oracle=diff,
                columns_bit_identical_to_oracle=len(columns) - len(unequal),
                columns=len(columns), columns_differing=unequal)
    check = live.get("check")
    if check is None:
        raise AssertionError(f"mesh-{n}: no completion left a live state to validate over")
    if not check["routing_matches_state_shards"] or check["rows_lost"] != 0 \
            or check["rows"] != min(live["keys"], MESH_SAMPLE_ROWS):
        raise AssertionError(f"mesh-{n}: validate_mesh_plane over {live['keys']} live-state "
                             f"keys: {check}")
    check.update(key_source="live states", live_state_keys=live["keys"], checks=live["checks"],
                 watch_s=live["watch_s"])
    mrec["validate_mesh_plane"] = check
    out["legs"][f"oracle-{n}"], out["legs"][f"mesh-{n}"] = orec, mrec
    log(f"mesh-{n}: results == refexec (rtol 1e-9, largest {worst:.3g}), == oracle-{n} within "
        f"{MESH_ORACLE_RTOL} ({len(columns) - len(unequal)} of {len(columns)} columns bit for bit, "
        f"largest {diff:.3g}); clock {meshed.now!r} >= {oracle.now!r}; validate_mesh_plane "
        f"{check}")
    meshed.close()
    oracle.close()
    del meshed, oracle, mfuts, ofuts

    okeys = db["orders"].columns["o_orderkey"].astype(np.int64)
    for d in MESH_SHARDS:
        mesh = mesh_exchange(okeys, d, out["exchange"])
        block = _chain_parity(mesh, rows=MESH_CHAIN_ROWS)
        if not block["parity"] or block["matched_rows"] <= 0 or block["shard_launches"] != d:
            raise AssertionError(f"chain parity d={d}: {block}")
        out["chain_parity"][d] = block
        log(f"chain parity d={d}: bit-identical, {block['shard_launches']} B1 launches, "
            f"{block['matched_rows']} rows matched")
        if d == n:
            mesh_join_and_aggregate(db, mesh, out)
            t0 = time.perf_counter()
            plane = validate_db_plane_record(db_plane_record(
                mesh, rows=MESH_PLANE_ROWS, chain_rows=MESH_CHAIN_ROWS))
            plane["wall_s"] = time.perf_counter() - t0
            out["db_plane"] = plane
            log(f"db-plane record d={d}: valid; {plane['hlo_stats']}")


def live_state_keys(session):
    """How many keys ``validate_mesh_plane`` samples from: those of the
    live states whose keycodes fit the exchange's key width."""
    from repro_torch.relational.distributed import KEY_LIMIT

    return sum(len(st.keycode.data) for states in session._engine.state_index.values()
               for st in states
               if len(st.keycode.data) and int(np.abs(st.keycode.data).max()) <= KEY_LIMIT)


def mesh_probe(session):
    """What a mesh twin compares beyond :func:`twin`'s run: ``mesh_stats()``
    (the shards' device names aside, which must name the session's
    device) and a ``validate_mesh_plane`` record."""
    stats = session.mesh_stats()
    devices = stats.pop("devices")
    kind = session.backend.device.type
    if len(devices) != MESH_LEG_SHARDS or not all(x.startswith(kind) for x in devices):
        raise AssertionError(f"twin mesh: devices {devices} on {kind}")
    return {"mesh_stats": stats, "validate_mesh_plane": session.validate_mesh_plane()}


def mesh_twin(tdb, tqs, report):
    """``mesh=4`` at the twins' scale: :func:`twin` with
    :func:`mesh_probe`, and the exchange of the orders' keys gives the
    same bits on the card and on the CPU."""
    import torch

    from repro_torch.core.hashindex import key_partition
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.relational import distributed as dist

    n = MESH_LEG_SHARDS
    rec = twin(tdb, tqs, probe=mesh_probe, mode="graft", mesh=n)
    okeys = tdb["orders"].columns["o_orderkey"].astype(np.int64)
    ex = [dist.exchange_by_key(make_data_mesh(n, dev), okeys, okeys.astype(np.float32),
                               dest=key_partition(okeys, n), capacity=4)
          for dev in ("cuda", "cpu")]
    torch.cuda.synchronize()
    for k in ("keys", "values", "valid"):
        if not torch.equal(ex[0][k].cpu(), ex[1][k]):
            raise AssertionError(f"twin mesh: exchange {k} differ across devices")
    if any(ex[0][k] != ex[1][k] for k in ("capacity", "attempts", "bucket_overflow_rows")):
        raise AssertionError("twin mesh: exchange accounting differs across devices")
    stats = rec["probe"]["mesh_stats"]
    report["twin"]["mesh"] = {"now_s": rec["now_s"], "mesh_exchange_rows": stats["mesh_exchange_rows"],
                              "rows_by_device": stats["rows_by_device"],
                              "exchange_attempts": ex[0]["attempts"]}
    log(f"twin mesh={n} SF {TWIN_SCALE}: cuda == cpu (results, counters, admission logs, "
        f"backend stats, clock, mesh_stats, validate_mesh_plane); the exchange's bits equal "
        f"across devices")


# ---------------------------------------------------------------------------
# the closed loop
# ---------------------------------------------------------------------------

#: phase 4e: the reference's closed-loop example (``examples/
#: concurrent_workload.py``) at SF 1 on phase 4's database: 16 clients with
#: one query outstanding each, ``client_sequences(db, 16, CLOSED_PER,
#: seed=3)``; each client's 10 queries are cut to 2 for the phase's time on
#: the card (the cut never goes to 1: a single burst is no closed loop)
CLOSED_CLIENTS = 16
CLOSED_PER = 2
CLOSED_SEED = 3
#: (label, mode, workers, partitions, wall clock): the example's grid on
#: the work clock, then isolated and graft on the card's wall clock, which
#: the config allows only for one worker. The grid's ``qpipe_osp`` leg is
#: left out for the script's time: the work clock is the same on every
#: device, and the CPU tests hold that leg against the reference
CLOSED_LEGS = (
    ("isolated", "isolated", 1, 1, False),
    ("graft", "graft", 1, 1, False),
    ("graft-4w8p", "graft", 4, 8, False),
    ("wall-isolated", "isolated", 1, 1, True),
    ("wall-graft", "graft", 1, 1, True),
)
#: threads that run the reference executor over the phase's instances
#: (its NumPy work releases the interpreter lock for much of the time)
CLOSED_REFEXEC_THREADS = 4
#: the engine's calls whose host seconds each leg records (as phase 4 does)
CLOSED_CALLS = ("probe_chain", "probe_visible", "probe", "probe_visible_multi", "_table_for")
#: phase 5's closed-loop twin at ``TWIN_SCALE``: the grid points run on
#: the card and on the CPU
CLOSED_TWIN_LEGS = (("graft", 1, 1), ("graft", 4, 8))


def instance_key(template, params):
    return template, tuple(sorted(params.items()))


def closed_leg(db, seqs, label, mode, workers, partitions, wall, timer):
    """One closed-loop leg on the card: launch counts and engine timers
    reset before it and read after it. Returns its record and its results
    by ``(client, position)``."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch import workload

    timer.engine_times()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    r = workload.run_closed_loop(db, mode, seqs, wall=wall, workers=workers,
                                 partitions=partitions, keep_results=True)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _build.launch_counts()
    engine = timer.engine_times()
    c = r["counters"]
    rec = {
        "mode": mode, "workers": workers, "partitions": partitions,
        "clock": "wall" if wall else "work",
        "completed": r["completed"],
        "elapsed_s": r["elapsed_s"],
        "throughput_qph": r["throughput_qph"],
        "median_latency_s": r["median_latency_s"],
        "p95_latency_s": r["p95_latency_s"],
        "latencies": r["latencies"],
        "wall_s": wall_s,
        "launches": {k: launches.get(k, 0) for k in MAIN_KERNELS},
        "fallbacks": {k: int(v) for k, v in sorted(c.items()) if k.startswith("fallback_probes_")},
        "engine": {k: engine[k] for k in CLOSED_CALLS},
    }
    log(f"closed leg {label}: {rec['completed']} done; {rec['clock']} clock {r['elapsed_s']!r} s, "
        f"{r['throughput_qph']!r} q/h, median {r['median_latency_s']!r} s, p95 "
        f"{r['p95_latency_s']!r} s; wall {wall_s:.3f} s; launches {rec['launches']}; fallbacks "
        f"{rec['fallbacks']}; host s " + ", ".join(
            f"{k} {v['seconds']:.4f} ({v['calls']})" for k, v in rec["engine"].items()))
    return rec, r["results"]


def closed_loop_phase(db, report):
    """Phase 4e: the closed loop at SF 1 on the card, in the legs of
    ``CLOSED_LEGS``. Checks: every leg completes every query; every result
    equals the reference executor (rtol 1e-9, each distinct instance
    executed once) and the first leg's result for the same client and
    position (rtol 1e-9: modes add float64 sums in other orders); B1
    launches in each graft leg. The ratios of graft's throughput and P95
    latency to isolated's on each clock are recorded, not checked."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch import workload
    from repro_torch.relational import queries, refexec

    t0 = time.perf_counter()
    seqs = workload.client_sequences(db, CLOSED_CLIENTS, CLOSED_PER, seed=CLOSED_SEED)
    n = CLOSED_CLIENTS * CLOSED_PER
    instances = {instance_key(t, p): (t, p) for seq in seqs for t, p in seq}
    plans = [queries.make_query(db, t, p).plan for t, p in instances.values()]
    with ThreadPoolExecutor(CLOSED_REFEXEC_THREADS) as pool:
        expected = dict(zip(instances, pool.map(lambda plan: refexec.execute(db, plan), plans)))
    out = report["closed_loop"] = {
        "clients": CLOSED_CLIENTS, "per_client": CLOSED_PER, "seed": CLOSED_SEED,
        "instances": len(expected), "reference_executor_s": time.perf_counter() - t0, "legs": {}}
    log(f"closed loop: {CLOSED_CLIENTS} clients x {CLOSED_PER} queries, "
        f"{[t for seq in seqs for t, _ in seq]}; {len(expected)} distinct instances, reference "
        f"executor {out['reference_executor_s']:.1f} s")
    timer = Recorder(replay=False)
    first = None
    try:
        for label, mode, workers, partitions, wall in CLOSED_LEGS:
            rec, results = closed_leg(db, seqs, label, mode, workers, partitions, wall, timer)
            out["legs"][label] = rec
            if rec["completed"] != n or sorted(results) != sorted(
                    (c, i) for c in range(CLOSED_CLIENTS) for i in range(CLOSED_PER)):
                raise AssertionError(f"closed {label}: {rec['completed']} of {n} completed")
            slots = sorted(results)
            got = [results[s][2] for s in slots]
            rec["max_rel_err"] = check_results(
                f"closed {label}", got,
                [expected[instance_key(*results[s][:2])] for s in slots])
            if first is None:
                first = got
            else:
                check_results(f"closed {label} vs {CLOSED_LEGS[0][0]}", got, first)
            if mode == "graft" and not rec["launches"]["fused_chain"]:
                raise AssertionError(f"closed {label}: B1 did not launch: {rec['launches']}")
    finally:
        timer.restore()
    legs = out["legs"]
    out["graft_over_isolated"] = {
        clock: {"throughput": legs[g]["throughput_qph"] / legs[i]["throughput_qph"],
                "p95_latency": legs[g]["p95_latency_s"] / legs[i]["p95_latency_s"]}
        for clock, g, i in (("work", "graft", "isolated"), ("wall", "wall-graft", "wall-isolated"))}
    out["seconds"] = time.perf_counter() - t0
    log(f"closed loop: every result == refexec and the {CLOSED_LEGS[0][0]} leg's (rtol 1e-9); "
        f"graft / isolated {out['graft_over_isolated']}; phase {out['seconds']:.1f} s")


def closed_twin(tdb, report):
    """Phase 5's closed-loop twin: ``client_sequences(tdb, 16, 2, seed=3)``
    at each grid point of ``CLOSED_TWIN_LEGS`` on the card and on the CPU
    must give identical runs: completions, the list of latencies, counters,
    clock, and each result (by client and position) bit for bit."""
    from repro_torch.launch import workload

    seqs = workload.client_sequences(tdb, CLOSED_CLIENTS, CLOSED_PER, seed=CLOSED_SEED)
    out = report["twin"]["closed_loop"] = {}
    for mode, workers, partitions in CLOSED_TWIN_LEGS:
        label = mode if workers == 1 else f"{mode}-{workers}w{partitions}p"
        gpu, cpu = (workload.run_closed_loop(tdb, mode, seqs, workers=workers,
                                             partitions=partitions, device=dev, keep_results=True)
                    for dev in ("cuda", "cpu"))
        for k in ("completed", "elapsed_s", "latencies", "counters"):
            if gpu[k] != cpu[k]:
                raise AssertionError(f"twin closed {label}: {k} differ: {gpu[k]} != {cpu[k]}")
        if sorted(gpu["results"]) != sorted(cpu["results"]):
            raise AssertionError(f"twin closed {label}: completed slots differ")
        slots = sorted(gpu["results"])
        same_results(f"twin closed {label}", [gpu["results"][s][2] for s in slots],
                     [cpu["results"][s][2] for s in slots])
        out[label] = {"completed": gpu["completed"], "elapsed_s": gpu["elapsed_s"],
                      "chain_launches": int(gpu["counters"]["kernel_chain_launches"])}
    log(f"twin closed loop SF {TWIN_SCALE}: cuda == cpu (completions, latencies, counters, "
        f"clock, results) {out}")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def q5_pair(db):
    """Two concurrent q5 queries folded in graft mode: q5's column-equality
    post-filter declines the fused chain, so their shared pipeline takes
    the staged loop, whose multi-member probes run
    ``hash_probe_lens_multi64``."""
    from repro_torch.relational import queries

    return [
        queries.make_query(db, "q5", {"region": 1.0, "date": d}, arrival=0.0)
        for d in (730.0, 800.0)
    ]


def run_legs(db, legs, required, label_launches, report, kept=None):
    """Run sessions on the card, reset the launch counts before them and
    read them after; every result within its tolerance of the reference
    executor and every ``required`` kernel launched. ``kept`` gets each
    leg's ``snapshot``, for later phases to compare with."""
    from repro_torch.kernels import _build

    _build.reset_launch_counts()
    for label, cfg, lqs, want, rtol in legs:
        session, futs, wall = run_session(db, lqs, **cfg)
        results = outcomes(futs)
        if kept is not None:
            kept[label] = snapshot(session, futs)
        worst = check_results(label, results, want, rtol)
        summ = leg_summary(session, wall)
        summ["max_rel_err"] = worst
        report["legs"][label] = summ
        log(f"leg {label}: results == refexec (rtol {rtol}, largest {worst:.3g}); wall {wall:.2f} s, "
            f"clock {session.now!r} s, chain launches {summ['chain_launches']}, "
            f"fallbacks {summ['fallbacks']}")
    launches = _build.launch_counts()
    report["launches"][label_launches] = launches
    log(f"launches on the {label_launches} path: {launches}")
    missing = [k for k in required if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {label_launches} path: {missing}")
    return launches


def smoke(report):
    """Phases 2-5; returns the kernels' JSON rows. Sessions of the main
    path use the default config, which is on the card; the opt-in leg
    hands the engine a ``TorchBackend`` on the card with both flags."""
    import torch

    from repro_torch.api.backends import TorchBackend
    from repro_torch.kernels import _build
    from repro_torch.relational import refexec, tpch

    # 2. build
    secs = _build.build()
    log(f"build: {secs:.1f} s")
    for stem, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {stem}: {line.strip()}")
    report["build"] = {"seconds": secs, "log": _build.BUILD_LOG}

    # 3. kernels at the SF's shapes, before the main path
    t0 = time.perf_counter()
    db = tpch.get_database(SCALE, seed=SEED)
    log(f"data: TPC-H SF {SCALE} in {time.perf_counter() - t0:.1f} s "
        f"({db.nbytes() / 1e6:.0f} MB, lineitem {db['lineitem'].nrows} rows)")
    inputs = kernel_inputs(db)
    synth = {}
    for label, (kname, kin) in inputs.items():
        rec = compare(kname, kin, label=label, trace=label in TRACED_SF or label.endswith(FLOOR))
        synth[label] = rec
        lib = "" if rec["library_ms"] is None else f", index_add_ {rec['library_ms']:.4f} ms"
        ok = f" (ok {rec['ok']})" if "ok" in rec else ""
        host = (f"; launch on its buffers {rec['entry_ms']:.4f} ms, enqueue "
                f"{rec['enqueue_ms']:.4f} ms" if "entry_ms" in rec else "")
        if "enqueue_ms" in rec and "entry_ms" not in rec:
            host = f"; enqueue {rec['enqueue_ms']:.5f} ms"
        log(f"kernel {label}: equal to plain{ok}; {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f} ms, "
            f"bound {rec['bound_ms']:.6f} ms by {rec['bound_by']}{lib}){host}")
    a, b = (kernel_pair("seg_aggregate")[0](*inputs["seg_aggregate_g4096"][1]) for _ in range(2))
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError("seg_aggregate: two calls on the same inputs differ")
    log("kernel seg_aggregate: two calls give the same bits")
    report["kernels_sf_shapes"] = synth
    report["launch_path_sf_shapes"] = {
        label: {k: rec[k] for k in ("ms", "enqueue_ms", "bound_ms")}
        for label, rec in synth.items()
        if inputs[label][0] in LAUNCH_PATH or label in TRACED_SF or label.endswith(FLOOR)}
    del inputs

    # 4. the main path at the full scale: the default config, then opt-in
    qs = workload(db, N_QUERIES, SEED)
    pair = q5_pair(db)
    log(f"workload: {[q.template for q in qs]}")
    t0 = time.perf_counter()
    expected = [refexec.execute(db, q.plan) for q in qs]
    expected_pair = [refexec.execute(db, q.plan) for q in pair]
    report["reference_executor_s"] = time.perf_counter() - t0
    log(f"reference executor: {report['reference_executor_s']:.1f} s")
    legs = (
        ("graft", dict(mode="graft"), qs, expected, 1e-9),
        ("isolated", dict(mode="isolated"), qs, expected, 1e-9),
        ("graft_per_member", dict(mode="graft", member_major=False), qs, expected, 1e-9),
        ("graft_q5_pair", dict(mode="graft"), pair, expected_pair, 1e-9),
    )
    optin_leg = (
        ("graft_opt_in", dict(mode="graft", backend=TorchBackend(device="cuda", **OPTIN)),
         qs, expected, 1e-5),
    )
    recorder = Recorder()
    report["legs"], report["launches"] = {}, {}
    kept = {}
    try:
        default_launches = run_legs(db, legs, MAIN_KERNELS, "default", report, kept)
        engine = recorder.engine_times()
        optin_launches = run_legs(db, optin_leg, OPTIN_KERNELS, "opt-in", report)
    finally:
        recorder.restore()
    legs_wall = sum(report["legs"][label]["wall_s"] for label, *_ in legs)
    report["launch_path"] = {"engine": engine, "default_legs_wall_s": legs_wall,
                             "replay": {}, "earlier_replay_ms": EARLIER_REPLAY_MS}
    for name, rec in engine.items():
        log(f"engine {name} over the default legs: {rec['calls']} calls, {rec['seconds']:.4f} s "
            f"on the host ({rec['ms_per_call']} ms a call); legs' wall {legs_wall:.4f} s")
    upload = engine["_insert_keys"]["seconds"] - engine["_batch_insert"]["seconds"]
    report["launch_path"]["table_upload_s"] = upload
    log(f"probe table growth over the default legs: host insert "
        f"{engine['_batch_insert']['seconds']:.4f} s, the rest (the upload) {upload:.4f} s")

    rows = []
    for kname, (src, replaces) in KERNELS.items():
        if kname in OPS_KERNELS:  # phase 6
            continue
        if kname in recorder.calls:
            size, kin = recorder.calls[kname]
            where = f"main-path replay {kname} (size {size})"
            rec = compare(kname, kin, label=where, trace=kname in LAUNCH_PATH)
            if kname in LAUNCH_PATH:
                report["launch_path"]["replay"][kname] = {
                    k: rec[k] for k in ("ms", "enqueue_ms", "bound_ms")}
                log(f"{where}: event mean {rec['ms']:.5f} ms, enqueue {rec['enqueue_ms']:.5f} ms "
                    f"(before the redesign {EARLIER_REPLAY_MS[kname]} ms)")
        else:  # on no engine path: its phase-3 numbers
            size, rec = None, synth[kname]
            where = f"kernel {kname} (phase 3)"
        host = (f"; launch on its buffers {rec['entry_ms']:.4f} ms, enqueue "
                f"{rec['enqueue_ms']:.4f} ms" if "entry_ms" in rec else "")
        log(f"{where}: equal to plain; {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f} ms, "
            f"bound {rec['bound_ms']:.6f} ms by {rec['bound_by']}){host}")
        runs = optin_launches if kname in OPTIN_KERNELS else default_launches
        rows.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": int(runs.get(kname, 0)), "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"], "size": size,
        })
    report["kernels"] = rows
    del recorder

    # 4b. the reuse-and-fault path at the full scale
    reuse_phase(db, report)

    # 4c. the batch-planning path at the full scale, and the serving plane
    batch_phase(db, report)
    serving_phase(report)

    # 4d. the mesh plane at the full scale
    mesh_phase(db, qs, expected, kept["graft"], report)
    del kept

    # 4e. the closed loop at the full scale
    closed_loop_phase(db, report)
    del db

    # 5. twins: card and CPU give identical runs
    t0 = time.perf_counter()
    tdb = tpch.get_database(TWIN_SCALE, seed=SEED)
    tqs = workload(tdb, N_QUERIES, SEED)
    report["twin"] = {
        "graft": twin(tdb, tqs, mode="graft"),
        "graft_per_member": twin(tdb, tqs, mode="graft", member_major=False),
        "graft_opt_in": twin(tdb, tqs, optin=True, mode="graft"),
    }
    rqs = repeat_trace(tdb, SEED)[0]
    reuse_twin = dict(EVICT_ALL, **TWIN_CACHE)
    report["twin"]["reuse_faults"] = twin(tdb, rqs, faults=fault_plan(), **reuse_twin)
    report["twin"]["reuse_faults_opt_in"] = twin(tdb, rqs, optin=True, faults=fault_plan(),
                                                 **reuse_twin)
    for label in ("reuse_faults", "reuse_faults_opt_in"):
        rec = report["twin"][label]
        for k in ("cache_hits", "cache_disk_high_water_bytes", "faults_injected"):
            if rec[k] <= 0:
                raise AssertionError(f"twin {label}: {k} is {rec[k]}")
    batch_twins(tdb, report)
    mesh_twin(tdb, tqs, report)
    closed_twin(tdb, report)
    log(f"twins SF {TWIN_SCALE}: cuda == cpu (results, counters, admission logs, cohort "
        f"plans, backend stats, clock; the mesh twin's mesh_stats and exchange too; the "
        f"closed loop's latencies); "
        f"singleton bursts: planning on == off "
        f"in {time.perf_counter() - t0:.1f} s")
    return rows


def within(label, got, want, rtol, atol=0.0, row_atol=0.0):
    """``got`` finite, of ``want``'s shape and type, and |got - want| <=
    atol + rtol |want| + row_atol rms(want's row) everywhere (a row is the
    last axis). Returns the largest absolute difference and the largest
    share of its limit that any element takes."""
    import torch

    g, w = got.float(), want.float()
    if g.shape != w.shape or got.dtype != want.dtype:
        raise AssertionError(f"{label}: {got.dtype} {tuple(g.shape)} != {want.dtype} "
                             f"{tuple(w.shape)}")
    if not torch.isfinite(g).all():
        raise AssertionError(f"{label}: non-finite output")
    diff = (g - w).abs()
    limit = atol + rtol * w.abs() + row_atol * w.square().mean(-1, keepdim=True).sqrt()
    if bool((diff > limit).any()):
        raise AssertionError(f"{label}: off by {float(diff.max())} "
                             f"(rtol {rtol}, atol {atol}, row_atol {row_atol})")
    share = torch.where(diff > 0, diff / limit, 0.0)
    return float(diff.max()), float(share.max())


def attention_inputs(rng, shape, dtype):
    import torch

    dev = torch.device("cuda")
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev).to(getattr(torch, dtype))
            for _ in range(3)]


def recurrence_inputs(rng, shape, lo=0.7, scale=0.2):
    import torch

    dev = torch.device("cuda")
    a = rng.uniform(lo, 0.999, size=shape).astype(np.float32)
    b = (rng.normal(size=shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


def sdpa(q, k, v, window):
    """The library's attention on the same inputs, as a call: SDPA on
    ``[1, BH, S, dh]`` views (it fuses only 4-D inputs), causal, with the
    window as a boolean mask."""
    import torch
    import torch.nn.functional as F

    q4, k4, v4 = q[None], k[None], v[None]
    if window is None:
        return lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    pos = torch.arange(q.shape[1], device=q.device)
    keep = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
    return lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=keep)


def attention_record(q, k, v, window, got):
    """``got`` (the kernel's output) against the plain version and the
    full-softmax oracle; times of the kernel, the plain version and SDPA."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    tol = ATTENTION_TOL[str(q.dtype).split(".")[1]]
    rec = {"shape": list(q.shape), "dtype": str(q.dtype), "window": window, "tol": tol}
    rec["max_abs_err"], rec["limit_share"] = within(
        "flash_attention vs plain", got, fa.flash_attention_plain(q, k, v, window), **tol)
    rec["max_abs_err_oracle"], rec["limit_share_oracle"] = within(
        "flash_attention vs ref", got, ref.flash_attention_ref(q, k, v, window=window), **tol)
    rec["ms"] = time_ms(lambda: fa.flash_attention(q, k, v, window=window), 10)
    rec["plain_ms"] = time_ms(lambda: fa.flash_attention_plain(q, k, v, window), 3)
    rec["library_ms"] = time_ms(sdpa(q, k, v, window), 10)
    rec["bound_ms"], rec["bound_by"] = attention_bound(q, window)
    rec["tile_flops"] = attention_tile_flops(q, window)
    rec["tflops"] = rec["tile_flops"] / rec["ms"] / 1e9
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    return rec


def recurrence_record(a, b, got):
    """``got`` (the kernel's output) equal to the plain version and within
    1e-4 of the step-by-step oracle; times of the kernel and the plain
    version (no single PyTorch call computes the recurrence)."""
    from repro_torch.kernels import linrec as lr
    from repro_torch.kernels import ref

    rec = {"shape": list(a.shape), "library_ms": None}
    rec["max_abs_err"] = max_abs_err("linrec", (got,), (lr.linrec_plain(a, b),))
    if rec["max_abs_err"] != 0:
        raise AssertionError(f"linrec: kernel differs from its plain version ({rec['max_abs_err']})")
    rec["max_abs_err_oracle"], rec["limit_share_oracle"] = within(
        "linrec vs ref", got, ref.linrec_ref(a, b), **LINREC_TOL)
    rec["ms"] = time_ms(lambda: lr.linrec(a, b), 20)
    rec["plain_ms"] = time_ms(lambda: lr.linrec_plain(a, b), 3)
    rec["bound_ms"], rec["bound_by"] = linrec_bound(a)
    return rec


def ptxas_report(stem):
    """The ptxas register and spill lines of each kernel of one source's
    library, by entry function."""
    from repro_torch.kernels import _build

    instances, name = {}, None
    for line in _build.BUILD_LOG.get(stem, "").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            instances.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return instances


def kernels_per_call(fn, iters=5):
    """CUDA kernels (memsets and copies left out) that one call of ``fn``
    launches, by name, from a ``torch.profiler`` trace of ``iters`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("Mem"):
            names[e.name] = names.get(e.name, 0) + 1
    return {name: n / iters for name, n in names.items()}


def linrec_build_record(shape, call):
    """The recurrence's ptxas register and spill lines, its launch (blocks
    of the grid, threads of a block and the blocks an SM holds at once,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the kernels one
    call launches (memsets aside), by a profiler trace: it must be one. The
    trace slows later launches on the host, so this comes after every event
    mean of the phase."""
    from repro_torch.kernels import linrec as lr

    rec = {"ptxas": ptxas_report("linrec"), "launch": lr.launch_info(shape),
           "kernels_per_call": kernels_per_call(call)}
    if not rec["ptxas"]:
        raise AssertionError("linrec: no ptxas report of its kernel")
    for inst, lines in rec["ptxas"].items():
        log(f"  ptxas linrec {inst}: {' / '.join(lines)}")
    log(f"  linrec launch at {list(shape)}: {rec['launch']}; kernels per call "
        f"{rec['kernels_per_call']}")
    if sum(rec["kernels_per_call"].values()) != 1:
        raise AssertionError(f"linrec: a call launches {rec['kernels_per_call']}, not one kernel")
    return rec


def attention_build_record():
    """The ptxas register and spill lines of each attention kernel instance,
    and the tensor-core instructions and TMA loads in the library's SASS
    (``cuobjdump``): ``HGMMA`` is wgmma, ``HMMA`` mma.sync. The bf16 kernel
    must hold ``HGMMA``; each float32 instance (``fa_tf32x3_kernel``) must
    hold TF32 ``HMMA`` in its own function and spill nothing."""
    from repro_torch.kernels import _build

    instances = ptxas_report("flash_attention")
    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(_build._lib_path("flash_attention"))],
                          capture_output=True, text=True, check=True).stdout
    functions, fname = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fname = ln.split("Function :", 1)[1].strip()
            functions[fname] = []
        elif fname:
            functions[fname].append(ln)
    sass_lines = sass.splitlines()
    counts = {op: sum(f" {op}" in ln for ln in sass_lines) for op in ("HGMMA", "HMMA", "UTMALDG")}
    if not any("fa_tc_kernel" in inst for inst in instances):
        raise AssertionError("flash_attention: no ptxas report of the tensor-core kernel")
    for inst, report in instances.items():
        log(f"  ptxas flash_attention {inst}: {' / '.join(report)}")
    if counts["HGMMA"] == 0:
        raise AssertionError("flash_attention: no wgmma (HGMMA) in the library's SASS")
    f32 = {fn: sum(" HMMA" in ln and "TF32" in ln for ln in lines)
           for fn, lines in functions.items() if "fa_tf32x3_kernel" in fn}
    if len(f32) != 3 or not all(f32.values()):
        raise AssertionError(f"flash_attention: float32 instances without TF32 HMMA: {f32}")
    f32_ptxas = {inst: rep for inst, rep in instances.items() if "fa_tf32x3_kernel" in inst}
    spilled = [inst for inst, rep in f32_ptxas.items()
               if not any("0 bytes spill stores, 0 bytes spill loads" in ln for ln in rep)]
    if len(f32_ptxas) != 3 or spilled:
        raise AssertionError(f"flash_attention: float32 instances spill or lack a report: {spilled}")
    variant = "wgmma + TMA" if counts["UTMALDG"] else "wgmma"
    log(f"  flash_attention SASS: {counts}: bf16 on {variant}; float32 TF32 HMMA per instance "
        f"{f32}, no spills")
    return {"ptxas": instances, "sass": counts, "bf16_variant": variant, "f32_tf32_hmma": f32}


def kernel_ops(report):
    """Phase 6; returns the rows of ``flash_attention`` and ``linrec``."""
    import torch

    from repro_torch.kernels import _build, ops

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' float32 matmuls
    rng = np.random.default_rng(SEED)
    calls = [(label, attention_inputs(rng, shape, dtype), window)
             for label, shape, dtype, window in ATTENTION_CALLS]
    a, b = recurrence_inputs(rng, LINREC_SHAPE)

    _build.reset_launch_counts()
    outs = [ops.attention(*qkv, window=window, device="cuda") for _, qkv, window in calls]
    h = ops.linear_recurrence(a, b, device="cuda")
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    report["launches"]["kernel-ops"] = launches
    log(f"launches on the kernel-ops path: {launches}")
    missing = [k for k in OPS_KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the kernel-ops path: {missing}")

    recs = {}
    for (label, (q, k, v), window), got in zip(calls, outs):
        rec = recs[label] = attention_record(q, k, v, window, got)
        log(f"kernel-ops attention {label} {rec['shape']} window {window}: within {rec['tol']} "
            f"of plain ({rec['max_abs_err']:.3g}, {rec['limit_share']:.3g} of the limit) and "
            f"oracle ({rec['max_abs_err_oracle']:.3g}, {rec['limit_share_oracle']:.3g}); "
            f"{rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f} ms, SDPA {rec['library_ms']:.4f} ms, "
            f"bound {rec['bound_ms']:.6f} ms by {rec['bound_by']}); {rec['tflops']:.1f} TFLOP/s over "
            f"whole tiles, {rec['bound_share']:.3f} of the bound")
    del calls, outs
    rec = recs["recurrentgemma-9b RG-LRU"] = recurrence_record(a, b, h)
    log(f"kernel-ops linear_recurrence {rec['shape']}: equal to plain, within 1e-4 of the oracle "
        f"({rec['max_abs_err_oracle']:.3g}); {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f} ms, "
        f"bound {rec['bound_ms']:.6f} ms by {rec['bound_by']})")
    linrec_call = (lambda: ops.linear_recurrence(a, b, device="cuda"))
    LAUNCH_TRACES.append((f"linrec {list(LINREC_SHAPE)}", linrec_call))
    del h

    # the kernels microbench's shapes (benchmarks/run.py): q = k = v, causal
    bench = {}
    q = attention_inputs(rng, (4, 512, 64), "float32")[:1] * 3
    bench["flash_attention[4,512,64]"] = attention_record(*q, None, ops.attention(*q, device="cuda"))
    ma, mb = recurrence_inputs(rng, (2, 1024, 128), lo=0.9, scale=1.0)
    bench["linrec[2,1024,128]"] = recurrence_record(ma, mb, ops.linear_recurrence(ma, mb, device="cuda"))
    for label, rec in bench.items():
        log(f"microbench {label}: {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f} ms, "
            f"bound {rec['bound_ms']:.6f} ms)")
    report["kernel_ops"] = {"calls": recs, "microbench": bench,
                            "flash_attention_build": attention_build_record(),
                            "linrec_build": linrec_build_record(LINREC_SHAPE, linrec_call)}

    rows = []
    for kname, label in (("flash_attention", "recurrentgemma-9b bf16"),
                         ("linrec", "recurrentgemma-9b RG-LRU")):
        rec = recs[label]
        src, replaces = KERNELS[kname]
        rows.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": int(launches.get(kname, 0)), "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"], "size": rec["shape"],
        })
    return rows


class StepTimer:
    """Wraps ``repro_torch.models.model.decode_step`` (which the serve
    driver calls through the module) with a pair of CUDA events a call, to
    time each step on the card without a synchronize of its own."""

    def __init__(self):
        from repro_torch.models import model

        self.mod, self.orig, self.events = model, model.decode_step, []

    def __enter__(self):
        import torch

        def timed(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = self.orig(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            return out

        self.mod.decode_step = timed
        return self

    def __exit__(self, *exc):
        self.mod.decode_step = self.orig

    def ms(self):
        import torch

        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def rel_err(got, want):
    """max |got - want| over max |want|, both on the host as float32."""
    import torch

    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"shape {tuple(g.shape)} against {tuple(w.shape)}, or not finite")
    return float((g - w).abs().max() / w.abs().max())


def lm_check(out, label, err, held=True, limit=LM_TOL, unit="of max |ref|"):
    """Logs ``err`` (by default a share of the largest |reference| value);
    where it is held and not below ``limit``, records the failure in
    ``out`` for the phase to raise at its end, after every number is
    recorded."""
    bad = held and not err < limit
    log(f"  {label}: {err:.3g} {unit}" + (f" (limit {limit:.3g})" if held else " (recorded)")
        + (" FAILED" if bad else ""))
    if bad:
        out.setdefault("failed", []).append(f"{label}: {err}")
    return err


def lm_serve(out):
    """Phase 6b, 1-2: the served model through ``serve_fold`` on the card,
    then its decode-through-cache, full-forward and prefill logits on one
    prompt. Leaves in ``LM_TRACES`` for the last phase what builds the
    model's decode step on a cache: the model is drawn again there from
    ``SEED``, so that its 11.2 GB are free for phase 6c."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=LM_DEVICE).manual_seed(SEED), device=LM_DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, LM_PREFIX)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, LM_SUFFIX)])
               for _ in range(LM_REQUESTS)]
    with StepTimer() as timer:
        res = serve.serve_fold(cfg, params, shared, prompts, LM_DECODE, device=LM_DEVICE)
    step_ms = timer.ms()
    peak = torch.cuda.max_memory_allocated()
    iso, fold = res["isolated"], res["folded"]
    if len(step_ms) != iso["decode_steps"] + fold["decode_steps"]:
        raise AssertionError(f"lm: {len(step_ms)} timed steps, legs report "
                             f"{iso['decode_steps']} + {fold['decode_steps']}")
    legs = {}
    for label, leg, ms in (("isolated", iso, step_ms[: iso["decode_steps"]]),
                           ("folded", fold, step_ms[iso["decode_steps"]:])):
        legs[label] = {
            "wall_s": leg["seconds"], "prefill_tokens": leg["prefill_tokens"],
            "decode_steps": leg["decode_steps"], "step_ms_median": float(np.median(ms)),
            "step_ms_p90": float(np.percentile(ms, 90)),
            "steps_per_s": leg["decode_steps"] / leg["seconds"],
            "output_tokens_per_s": LM_REQUESTS * LM_DECODE / leg["seconds"],
            "outputs": leg["outputs"],
        }
        log(f"lm serve {label}: {leg['prefill_tokens']} prefill tokens, {leg['decode_steps']} "
            f"decode steps in {leg['seconds']:.3f} s; step median "
            f"{legs[label]['step_ms_median']:.3f} ms (CUDA events), "
            f"{legs[label]['steps_per_s']:.1f} steps/s")
    out["serve"] = {"arch": LM_ARCH, "params": n_params, "param_bytes": 4 * n_params,
                    "init_s": init_s, "identical": res["identical"], "legs": legs,
                    "max_memory_allocated": peak, "card": card_smi()}
    log(f"lm serve {LM_ARCH} ({n_params} params, float32): outputs identical "
        f"{res['identical']}; peak {peak / 1e9:.3f} GB allocated")
    if not res["identical"]:
        raise AssertionError("lm: isolated and folded outputs differ")
    want = (LM_REQUESTS * (LM_PREFIX + LM_SUFFIX), LM_PREFIX + LM_REQUESTS * LM_SUFFIX)
    if (iso["prefill_tokens"], fold["prefill_tokens"]) != want:
        raise AssertionError(f"lm: prefill tokens {iso['prefill_tokens']} / "
                             f"{fold['prefill_tokens']}, expected {want}")

    # 2. decode through the cache, the full forward and prefill, one prompt,
    # over the served model's first k layers for each k of LM_DEPTHS
    n = LM_PREFIX + LM_SUFFIX
    tokens = torch.from_numpy(prompts[0]).to(LM_DEVICE)[None]
    out["consistency"] = {"prompt_tokens": n, "held_depths": [k for k in LM_DEPTHS
                                                              if k <= LM_HELD_DEPTH]}
    for k in sorted({k for k in LM_DEPTHS if k < cfg.n_layers} | {cfg.n_layers}):
        sub_cfg, sub = depth_cut(cfg, params, k)
        dec, fwd, pre_logits, pre_cache, cache = three_paths(sub_cfg, sub, tokens)
        held = k <= LM_HELD_DEPTH
        out["consistency"][f"depth_{k}"] = {
            "decode_vs_forward": lm_check(out, f"depth {k}: decode vs forward logits",
                                          rel_err(dec, fwd), held),
            "prefill_vs_forward": lm_check(out, f"depth {k}: prefill vs forward last logits",
                                           rel_err(pre_logits[0], fwd[-1]), held),
            "prefill_kv_vs_decode_cache": lm_check(out, f"depth {k}: prefill K/V vs decode cache",
                                                   max(rel_err(pre_cache[0]["attn0"][kv],
                                                               cache[0]["attn0"][kv][:, :, :n])
                                                       for kv in ("k", "v")), held),
        }
    # where the parting comes from: the full depth again, with the attention
    # weights scaled by their contracted width (recorded)
    dec, fwd, *_ = three_paths(cfg, attention_rescaled(cfg, params), tokens)
    out["consistency"]["attention_rescaled_full_depth"] = lm_check(
        out, f"depth {cfg.n_layers}, attention weights scaled by their contracted width: decode "
        f"vs forward logits", rel_err(dec, fwd), held=False)
    del dec, fwd

    def setup():  # the served model drawn again from SEED, its cache over the prompt
        params = M.init_params(cfg, torch.Generator(device=LM_DEVICE).manual_seed(SEED),
                               device=LM_DEVICE)
        cache = M.init_cache(cfg, 1, 256, dtype=torch.float32, device=LM_DEVICE)
        with torch.inference_mode():
            for t in range(n):
                M.decode_step(cfg, params, cache, tokens[:, t : t + 1], t)

        def step():  # the full model's next step, on its cache
            with torch.inference_mode():
                M.decode_step(cfg, params, cache, tokens[:, :1], n)

        return step

    LM_TRACES.append((out["serve"], setup))


def three_paths(cfg, params, tokens):
    """Decode through a cache, the full forward and prefill of one prompt
    ``tokens`` [1, n]: (decode logits [n, V], forward logits [n, V],
    prefill's last logits, prefill's caches, the decode cache)."""
    import torch

    from repro_torch.models import model as M

    n = tokens.shape[1]
    with torch.inference_mode():
        W = M.lm_head_weight(cfg, params)
        fwd = torch.einsum("sd,dv->sv", M.forward_train(cfg, params, {"tokens": tokens})[0], W)
        pre_logits, pre_cache = M.prefill(cfg, params, {"tokens": tokens})
        cache = M.init_cache(cfg, 1, 256, dtype=torch.float32, device=LM_DEVICE)
        dec = torch.cat([M.decode_step(cfg, params, cache, tokens[:, t : t + 1], t)[0][0]
                         for t in range(n)])
    return dec, fwd, pre_logits, pre_cache, cache


def attention_rescaled(cfg, params):
    """``params`` with each attention weight drawn anew at the scale of its
    contracted width (1/sqrt(d_model) for wq, wk, wv; 1/sqrt(heads *
    d_head) for wo) in place of the reference init's (1/sqrt(heads),
    1/sqrt(kv heads), 1/sqrt(d_head)): the same values rescaled."""
    import math

    D, H, KV, dh = cfg.d_model, cfg.n_heads_padded, cfg.n_kv_heads, cfg.d_head
    scale = {"wq": math.sqrt(H / D), "wk": math.sqrt(KV / D), "wv": math.sqrt(KV / D),
             "wo": math.sqrt(1 / H)}
    (group,) = params["groups"]
    blk = group["attn0"]
    return dict(params, groups=[{"attn0": dict(blk, **{w: blk[w] * a for w, a in scale.items()})}])


def depth_cut(cfg, params, k):
    """The config and parameters (views) of a one-group model's first ``k``
    layers."""
    import dataclasses

    (group,) = params["groups"]
    sub = dict(params, groups=[{name: {leaf: t[:k] for leaf, t in blk.items()}
                                for name, blk in group.items()}])
    return dataclasses.replace(cfg, n_layers=k), sub


def leaves(tree):
    """The tensors of a tree of dicts and lists."""
    import torch

    if torch.is_tensor(tree):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [t for v in vals for t in leaves(v)]


def spread_constants(tree, gen, name=""):
    """``tree`` with its constant-initialised leaves (norm weights and
    biases, the RWKV decay base, token-shift mixes, the conv bias) drawn
    at random from ``gen``, as the CPU parity tests draw them: at their
    initial values the RWKV head norm's zero weight zeroes the whole
    time-mix, and every norm is the same."""
    import torch

    if isinstance(tree, dict):
        return {k: spread_constants(v, gen, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [spread_constants(v, gen) for v in tree]

    def normal(scale, mean=0.0):
        return mean + scale * torch.randn(tree.shape, generator=gen, device=tree.device)

    if name == "ln_w":
        return normal(0.1, 1.0)
    if name.startswith(("ln", "final_norm", "enc_final_norm", "conv_b")):
        return normal(0.1)
    if name == "w_dec0":
        return normal(0.5)
    if name.startswith("mu"):
        return torch.rand(tree.shape, generator=gen, device=tree.device)
    return tree


def lm_cut(out, arch, updates, cut, decode, limit):
    """Phase 6b, 3: one family at its published widths with its depth cut:
    card against the CPU, and decode as ``decode`` says (LM_CUTS)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import layers, moe
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), **updates)
    gen = torch.Generator(device=LM_DEVICE).manual_seed(SEED)
    gpu = spread_constants(M.init_params(cfg, gen, device=LM_DEVICE), gen)
    cpu = M.tree_map(lambda t: t.cpu(), gpu, torch.is_tensor)
    rng = np.random.default_rng(SEED)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (1, LM_CUT_TOKENS)))}
    if cfg.frontend == "vision_stub":
        batch["prefix_embeds"] = torch.from_numpy(
            (rng.normal(size=(1, cfg.n_prefix_embeds, cfg.d_model)) * 0.1).astype(np.float32))
    if cfg.n_encoder_layers:
        batch["src_embeds"] = torch.from_numpy(
            (rng.normal(size=(1, LM_CUT_TOKENS // 4, cfg.d_model)) * 0.1).astype(np.float32))
    rec = {"cut": cut, "params": sum(t.numel() for t in leaves(gpu)), "tokens": LM_CUT_TOKENS}
    log(f"lm {arch}: {cut}, {rec['params']} params")

    def run(params, dev):
        b = {k: v.to(dev) for k, v in batch.items()}
        with torch.inference_mode():
            hidden = M.forward_train(cfg, params, b)
            W = M.lm_head_weight(cfg, params)
            res = {"hidden": hidden, "logits": torch.einsum("sd,dv->sv", hidden[0, -LM_LAST:], W)}
            if cfg.moe is not None:
                p = M._unstack(params["groups"][0], 1)[0]["attn0"]
                x = M.embed_tokens(cfg, params, b["tokens"])
                h = x + layers.attention(p, layers.rms_norm(p["ln1"], x), cfg,
                                         window=cfg.attn_window)
                res["experts"] = moe.route(p, layers.rms_norm(p["ln2"], h), cfg)[1].cpu()
            if decode == "forward" and dev == LM_DEVICE or decode == "cpu":
                res["all_logits"] = torch.einsum("sd,dv->sv", hidden[0], W)
                cache = M.init_cache(cfg, 1, LM_CUT_TOKENS, dtype=torch.float32, device=dev)
                if cfg.n_encoder_layers:
                    memory = M.encode(cfg, params, b["src_embeds"])
                    for gp, gc in zip(params["groups"], cache):
                        for ck, w in (("ck", "cwk"), ("cv", "cwv")):
                            gc["attn0"][ck].copy_(torch.einsum("bsd,ndgk->nbsgk", memory,
                                                               gp["attn0"][w]))
                res["decode"] = torch.cat([
                    M.decode_step(cfg, params, cache, b["tokens"][:, t : t + 1], t)[0][0]
                    for t in range(LM_CUT_TOKENS)])
        return res

    t1 = time.perf_counter()
    g = run(gpu, LM_DEVICE)
    torch.cuda.synchronize()
    rec["card_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    c = run(cpu, "cpu")
    rec["cpu_s"] = time.perf_counter() - t1
    if decode:
        rec["decode_vs_forward"] = lm_check(out, f"{arch} decode vs forward logits on the card",
                                            rel_err(g["decode"], g["all_logits"]),
                                            held=decode == "forward")
    if decode == "cpu":
        rec["decode_card_vs_cpu"] = lm_check(out, f"{arch} decode logits, card vs CPU",
                                             rel_err(g["decode"], c["decode"]))
    if limit == "rounding":  # below the bf16 rounding's own effect, this run's
        limit = rec["decode_vs_forward"]
    rec["limit_card_vs_cpu"] = limit
    rec["hidden_card_vs_cpu"] = lm_check(out, f"{arch} hidden, card vs CPU",
                                         rel_err(g["hidden"], c["hidden"]), limit=limit)
    rec["logits_card_vs_cpu"] = lm_check(out, f"{arch} last {LM_LAST} logits, card vs CPU",
                                         rel_err(g["logits"], c["logits"]), limit=limit)
    if "experts" in g:
        rec["experts_equal"] = bool(torch.equal(g["experts"], c["experts"]))
        log(f"  {arch} MoE layer's experts equal on both devices: {rec['experts_equal']}")
        if not rec["experts_equal"]:
            out.setdefault("failed", []).append(f"{arch}: the MoE layer chose other experts")
    del gpu, cpu, g, c
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def lm_phase(report):
    """Phase 6b: the LM serving path on the card. Launch counts are reset
    before it and read after it: no kernel of the port may launch."""
    import torch

    from repro_torch.kernels import _build

    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("lm: float32 products must not run in TF32")
    t0 = time.perf_counter()
    out = report["lm"] = {}
    _build.reset_launch_counts()
    lm_serve(out)
    out["cuts"] = {arch: lm_cut(out, arch, *rest) for arch, *rest in LM_CUTS}
    launches = _build.launch_counts()
    report["launches"]["lm"] = launches
    out["seconds"] = time.perf_counter() - t0
    log(f"launches on the LM serving path: {launches}; phase {out['seconds']:.1f} s")
    if any(launches.values()):
        raise AssertionError(f"lm: kernels launched on the LM serving path: {launches}")
    if out.get("failed"):
        raise AssertionError(f"lm: {out['failed']}")


def trace_lm(report, iters=5):
    """Last phase: the served model's decode step (one token at the
    consistency check's next position) from a profiler trace: its CUDA
    kernels a step and their device time, beside the step's CUDA-event
    median; the ratio is the card's busy share in a step."""
    import torch

    for rec, setup in LM_TRACES:
        call = setup()
        call()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        rec["step_device_ms"] = sum(e.time_range.elapsed_us() for e in kernels) / iters / 1e3
        rec["step_kernels"] = len(kernels) / iters
        for leg in rec["legs"].values():
            leg["busy_share"] = rec["step_device_ms"] / leg["step_ms_median"]
        log(f"lm decode step: {rec['step_kernels']:.0f} kernels, {rec['step_device_ms']:.4f} ms "
            f"on the device; busy share "
            f"{ {k: round(v['busy_share'], 4) for k, v in rec['legs'].items()} }")
        del call
        torch.cuda.empty_cache()


class TrainTimer:
    """Wraps the train driver's ``make_train_step`` (``repro_torch.launch.
    train`` calls it through its module) so that each step it returns is
    bracketed by a pair of CUDA events, without a synchronize of its own,
    and keeps its metrics (tensors on the card, read after the run). With
    ``count_first``, the first step (outside the timed ones) runs under the
    dry run's op counter, kept as ``counter``."""

    def __init__(self, count_first=False):
        from repro_torch.launch import train

        self.mod, self.orig, self.events, self.metrics = train, train.make_train_step, [], []
        self.count_first, self.counter = count_first, None

    def __enter__(self):
        import torch

        def make(*args, **kwargs):
            step = self.orig(*args, **kwargs)

            def timed(params, opt, batch):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                if self.count_first and not self.events:
                    from repro_torch.launch.hlo_analysis import OpCounter

                    with OpCounter(record_ops=True) as self.counter:
                        out = step(params, opt, batch)
                else:
                    out = step(params, opt, batch)
                end.record()
                self.events.append((start, end))
                self.metrics.append(out[2])
                return out

            return timed

        self.mod.make_train_step = make
        return self

    def __exit__(self, *exc):
        self.mod.make_train_step = self.orig

    def ms(self):
        import torch

        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]

    def values(self, key):
        return [float(m[key]) for m in self.metrics]


def train_full(out):
    """Phase 6c, 1: stablelm-3b trained at full width and depth through
    the driver's entry point. Leaves in ``TRAIN_TRACES`` what builds one
    step of the same run for the last phase."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import roofline
    from repro_torch.launch import train as T

    args = ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(TRAIN_STEPS)]
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with TrainTimer(count_first=True) as timer:
        params, opt = T.main(args)
    wall = time.perf_counter() - t0
    step_ms = timer.ms()
    losses, gnorms = timer.values("loss"), timer.values("grad_norm")
    peak = torch.cuda.max_memory_allocated()
    state_allocated = torch.cuda.memory_allocated() - base
    n_params = sum(t.numel() for t in leaves(params))
    del params, opt
    torch.cuda.empty_cache()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    median = float(np.median(step_ms[TRAIN_TIMED]))
    n_active = cfg.param_counts()["active"]
    model_flops = 6.0 * n_active * tokens
    rec = out["full"] = {
        "arch": TRAIN_ARCH, "args": args, "params": n_params, "param_counts_active": n_active,
        "optimizer": cfg.optimizer, "remat": cfg.remat, "tokens_per_step": tokens,
        "losses": losses, "grad_norms": gnorms, "step_ms": step_ms,
        "step_ms_median": median, "tokens_per_s": tokens / (median / 1e3),
        "model_flops": model_flops,
        "model_flops_share_fp32": model_flops / (median / 1e3) / roofline.H100_FP32_FLOPS,
        "model_flops_share_fp32x3": model_flops / (median / 1e3) / roofline.H100_FP32X3_FLOPS,
        "max_memory_allocated": peak, "allocated_before": base, "wall_s": wall,
        "state_allocated": state_allocated, "card": card_smi(),
        # the first step's op count, for phase 6d
        "count_flops": timer.counter.stats.flops, "count_bytes": timer.counter.stats.mem_bytes,
        "count_ops": dict(timer.counter.ops),
    }
    log(f"lm train {TRAIN_ARCH} ({n_params} params, {cfg.optimizer}, remat {cfg.remat}), "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step: losses {losses}, grad norms {gnorms}; "
        f"step ms {step_ms}; median of steps 2-{TRAIN_STEPS} {median:.3f} ms, "
        f"{rec['tokens_per_s']:.1f} tokens/s, model-FLOPs share of the FP32 peak "
        f"{rec['model_flops_share_fp32']:.4f} and of three TF32 products' "
        f"{rec['model_flops_share_fp32x3']:.4f}; peak {peak / 1e9:.3f} GB allocated "
        f"({base / 1e9:.3f} GB before); {wall:.1f} s")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses + gnorms)):
        raise AssertionError(f"lm train: losses {losses}, grad norms {gnorms}")

    def setup():  # the run drawn again from its seed: its state after one step
        from repro_torch.models import model as M
        from repro_torch.train.data import batch_at
        from repro_torch.train.optim import init_opt_state

        params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        opt = init_opt_state(params, cfg.optimizer)
        step = T.make_train_step(cfg, lr=1e-3)
        batch = batch_at(0, seed=1, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                         vocab=cfg.vocab, structured=True)
        step(params, opt, batch)
        return lambda: step(params, opt, batch)

    TRAIN_TRACES.append((rec, setup))


def _tree_err(got, want):
    """max |got - want| over the tree's largest |want|, both on the host."""
    got, want = leaves(got), leaves(want)
    scale = max(float(w.float().abs().max()) for w in want)
    return max(float((g.float().cpu() - w.float()).abs().max()) for g, w in zip(got, want)) / scale


def train_twin(out, arch, n_microbatches=1, wide=None):
    """Phase 6c, 2: one train step of ``arch``'s smoke config (or, with
    ``wide`` = (config updates, batch, seq, rescaled, held), its published
    widths with those updates, the attention weights rescaled by
    ``attention_rescaled`` if ``rescaled``, its measures held to their
    limits if ``held``) on the card and on the CPU, from the same
    parameters (drawn on the CPU from ``SEED``, constant leaves spread)
    and the same batch."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import model as M
    from repro_torch.train.data import batch_at
    from repro_torch.train.optim import init_opt_state
    from repro_torch.train.train_step import make_train_step

    if wide is None:
        cfg, B, S, held = smoke_config(arch), 4, 32, True
    else:
        updates, B, S, rescaled, held = wide
        cfg = dataclasses.replace(get_config(arch), **updates)
    gen = torch.Generator().manual_seed(SEED)
    params = spread_constants(M.init_params(cfg, gen, device="cpu"), gen)
    if wide is not None and rescaled:
        params = attention_rescaled(cfg, params)
    batch = batch_at(0, seed=1, global_batch=B, seq_len=S, vocab=cfg.vocab, structured=True)
    rng = np.random.default_rng(SEED)
    if cfg.frontend == "vision_stub":
        batch["prefix_embeds"] = (rng.normal(size=(B, cfg.n_prefix_embeds, cfg.d_model)) * 0.1
                                  ).astype(np.float32)
    if cfg.n_encoder_layers:
        batch["src_embeds"] = (rng.normal(size=(B, 8, cfg.d_model)) * 0.1).astype(np.float32)
    res = {}
    for dev in ("cuda", "cpu"):
        p = M.tree_map(lambda t: t.to(dev, copy=True), params, torch.is_tensor)
        opt = init_opt_state(p, cfg.optimizer)
        step = make_train_step(cfg, n_microbatches=n_microbatches, lr=TRAIN_LR, device=dev)
        p, opt, metrics = step(p, opt, batch)
        res[dev] = (p, opt, {k: float(v) for k, v in metrics.items()})
    (gp, go, gm), (cp, co, cm) = res["cuda"], res["cpu"]
    rwkv = arch == "rwkv6-7b"
    tol = TRAIN_RWKV_TOL if rwkv else TRAIN_TOL
    label = f"{arch} x{n_microbatches}" + (
        "" if wide is None else f" at width {cfg.d_model}, {cfg.n_layers} layers"
        + (", attention rescaled" if rescaled else ""))
    rec = {"optimizer": cfg.optimizer, "d_model": cfg.d_model, "n_layers": cfg.n_layers,
           "tokens": [B, S], "held": held, "card": gm, "cpu": cm}
    for k in ("loss", "grad_norm"):
        rec[f"{k}_rel_err"] = abs(gm[k] - cm[k]) / abs(cm[k])
        lm_check(out, f"train {label}: {k} card vs CPU", rec[f"{k}_rel_err"], held,
                 limit=tol[k], unit="of the CPU's")
    diffs = [(g.cpu() - c).abs() for g, c in zip(leaves(gp), leaves(cp))]
    rec["param_max_abs_err"] = max(float(d.max()) for d in diffs)
    rec["param_share_beyond_1e-5"] = sum(int((d > 1e-5).sum()) for d in diffs) / sum(
        d.numel() for d in diffs)
    lm_check(out, f"train {label}: parameters card vs CPU", rec["param_max_abs_err"], held,
             limit=TRAIN_PARAM_TOL, unit="largest |difference|")
    lm_check(out, f"train {label}: parameters beyond 1e-5", rec["param_share_beyond_1e-5"],
             held, limit=TRAIN_RWKV_STRAY if rwkv else TRAIN_STRAY, unit="of them")
    moment_tol = (TRAIN_RWKV_MOMENT_TOL if rwkv else TRAIN_BF16_MOMENT_TOL
                  if cfg.optimizer == "adamw_bf16" else TRAIN_MOMENT_TOL)
    for k in ("m", "v"):
        rec[f"{k}_err"] = lm_check(out, f"train {label}: {k} card vs CPU", _tree_err(go[k], co[k]),
                                   held, limit=moment_tol, unit="of the tree's max |CPU|")
    return rec


def train_resume(out):
    """Phase 6c, 3: the driver at the smoke config, 6 steps with
    checkpoints every 3, then resumed to 9, against 9 steps without a
    break; deterministic algorithms on (the embedding's backward adds with
    atomics otherwise), so the two runs must agree bit for bit."""
    import shutil

    import torch

    from repro_torch.launch import train as T
    from repro_torch.train import checkpoint as CKPT

    ckpt = OUT_DIR / "train_resume"
    shutil.rmtree(ckpt, ignore_errors=True)
    # warn_only: cuBLAS promises determinism only under
    # CUBLAS_WORKSPACE_CONFIG, which must be set for the whole process and
    # slows the enqueue of every small product (phase 6b's decode steps ran
    # at 63-68 ms with it, 33-51 without); on one stream its products
    # repeat anyway, and the bit comparisons below are the check
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with TrainTimer() as first:
            p6, o6 = T.main(TRAIN_RESUME + ["--steps", "6", "--ckpt-dir", str(ckpt)])
        restored_p, restored_o, manifest = CKPT.restore(ckpt, target_params=p6, target_opt=o6)
        same_restore = all(torch.equal(a, b) for a, b in zip(leaves((restored_p, restored_o)),
                                                             leaves((p6, o6))))
        with TrainTimer() as resumed:
            p9, o9 = T.main(TRAIN_RESUME + ["--steps", "9", "--ckpt-dir", str(ckpt)])
        with TrainTimer() as straight:
            q9, r9 = T.main(TRAIN_RESUME + ["--steps", "9"])
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt, ignore_errors=True)
    broken = first.values("loss") + resumed.values("loss")
    whole = straight.values("loss")
    rec = out["resume"] = {
        "args": TRAIN_RESUME, "restored_step": manifest["step"], "restore_equal": same_restore,
        "losses_resumed": broken, "losses_straight": whole,
        "losses_equal": broken == whole,
        "state_equal": all(torch.equal(a, b) for a, b in zip(leaves((p9, o9)),
                                                             leaves((q9, r9)))),
    }
    log(f"lm train resume: restored step {manifest['step']} equal to the saved state "
        f"{same_restore}; losses 6 + 3 {broken}, 9 straight {whole}; equal "
        f"{rec['losses_equal']}, final state equal {rec['state_equal']}")
    if not (same_restore and rec["losses_equal"] and rec["state_equal"]
            and manifest["step"] == 6 and len(whole) == 9):
        out.setdefault("failed", []).append(f"resume: {rec}")


def train_phase(report):
    """Phase 6c: the LM training path on the card. Launch counts are reset
    before it and read after it: no kernel of the port may launch."""
    import torch

    from repro_torch.configs import ARCH_IDS
    from repro_torch.kernels import _build

    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("lm train: float32 products must not run in TF32")
    t0 = time.perf_counter()
    out = report["train"] = {}
    _build.reset_launch_counts()
    train_full(out)
    out["twins"] = {arch: train_twin(out, arch) for arch in ARCH_IDS}
    out["twins"][f"{TRAIN_MICROBATCH_ARCH} x2"] = train_twin(out, TRAIN_MICROBATCH_ARCH, 2)
    for label, *wide in TRAIN_WIDE:
        out["twins"][f"{TRAIN_ARCH} {label}"] = train_twin(out, TRAIN_ARCH, wide=wide)
    train_resume(out)
    launches = _build.launch_counts()
    report["launches"]["train"] = launches
    out["seconds"] = time.perf_counter() - t0
    log(f"launches on the LM training path: {launches}; phase {out['seconds']:.1f} s")
    if any(launches.values()):
        raise AssertionError(f"lm train: kernels launched on the LM training path: {launches}")
    if out.get("failed"):
        raise AssertionError(f"lm train: {out['failed']}")


def trace_train(report):
    """Last phase: one step of the full-width training run from a profiler
    trace: its CUDA kernels and their device time, beside the run's
    CUDA-event median; the ratio is the card's busy share in a step."""
    import torch

    for rec, setup in TRAIN_TRACES:
        call = setup()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        rec["step_device_ms"] = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        rec["step_kernels"] = len(kernels)
        rec["busy_share"] = rec["step_device_ms"] / rec["step_ms_median"]
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        rec["top_kernels_ms"] = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])
        log(f"lm train step: {rec['step_kernels']} kernels, {rec['step_device_ms']:.3f} ms on "
            f"the device; busy share {rec['busy_share']:.4f}; largest: "
            f"{ {k[:60]: round(v, 2) for k, v in list(rec['top_kernels_ms'].items())[:5]} }")
        del call
        torch.cuda.empty_cache()


#: phase 6d, the dry run: the cells counted on ``meta`` on both production
#: meshes (the CPU tests and sweep count the others): a dense cell and the
#: two whose collective model holds the recurrent blocks' activation
#: traffic (the RWKV6 time mix's chunk scan, the Griffin block's RG-LRU);
#: and the step held against the card: phase 6c's own (stablelm-3b,
#: float32, ``adamw``, remat, 1 x 4,096 tokens). The step's parameters and
#: optimizer state must take within DRYRUN_ALLOC_TOL of the bytes the
#: sharding specs give a one-shard mesh
DRYRUN_CELLS = (("stablelm-3b", "train_4k"), ("rwkv6-7b", "prefill_32k"),
                ("recurrentgemma-9b", "train_4k"))
DRYRUN_STEP_SHAPE = {"kind": "train", "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH}
DRYRUN_ALLOC_TOL = 0.01


def dryrun_cells(out):
    """Phase 6d (a): ``dryrun.run_cell`` for ``DRYRUN_CELLS`` on both
    production meshes, each (arch, shape) counted once: every record
    ``ok``, the recurrent cells' collectives with the all-to-alls of their
    chunk scans."""
    from repro_torch.launch import dryrun

    counts, recs = {}, []
    out["cells"] = recs
    for arch, shape in DRYRUN_CELLS:
        for multi in (False, True):
            rec = dryrun.run_cell(arch, shape, multi, counts)
            recs.append(rec)
            log(f"dry run {arch}/{shape}/{rec['mesh']}: {rec['status']} in {rec['total_s']} s "
                f"(count {rec.get('compile_s')} s); hlo_stats {rec.get('hlo_stats')}; "
                f"analytic bytes/device {rec.get('analytic_bytes_per_device')}")
            if rec["status"] != "ok":
                raise AssertionError(f"dry run {arch}/{shape}/{rec['mesh']}: {rec.get('error')}")
            coll = rec["hlo_stats"]["coll_bytes_per_device"]
            if arch != "stablelm-3b" and "all-to-all" not in coll:
                raise AssertionError(f"dry run {arch}/{shape}/{rec['mesh']}: no all-to-all")


def dryrun_step(out, train):
    """Phase 6d (b): the op count of phase 6c's step on ``meta`` against
    the same count over the first step of 6c's run on the card (FLOPs and
    bytes exactly), the specs' bytes on a one-shard mesh against the
    memory that run's parameters and optimizer state took, and the run's
    median step against the bound of the count on the H100's peaks."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.hlo_analysis import OpCounter
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import model as M
    from repro_torch.train.optim import abstract_opt_state
    from repro_torch.train.train_step import make_train_step

    full = train.get("full")
    if not full or "count_flops" not in full:
        raise AssertionError("dry run: phase 6c left no counted step")
    cfg = get_config(TRAIN_ARCH)
    rec = out["step"] = {"arch": TRAIN_ARCH, "shape": DRYRUN_STEP_SHAPE, "card": card_smi()}
    mp = M.abstract_params(cfg, torch.float32)
    mo = abstract_opt_state(mp, cfg.optimizer)
    mb = M.input_specs(cfg, DRYRUN_STEP_SHAPE)
    t0 = time.perf_counter()
    with OpCounter(record_ops=True) as meta:
        make_train_step(cfg, lr=TRAIN_LR, device="meta")(mp, mo, mb)
    rec["meta_count_s"] = time.perf_counter() - t0
    mesh = make_smoke_mesh("cuda")
    ps = SH.param_specs(cfg, mesh, mp)
    analytic = (dryrun.tree_bytes_per_device(mp, ps, mesh)
                + dryrun.tree_bytes_per_device(mo, SH.opt_specs(cfg, mesh, mo, ps), mesh))
    allocated = full["state_allocated"]
    flops, nbytes = meta.stats.flops, meta.stats.mem_bytes
    bound_s = max(flops / roofline.H100_FP32_FLOPS, nbytes / roofline.H100_HBM_BW)
    median = full["step_ms_median"]
    card_ops = full["count_ops"]
    ops_apart = {k: (meta.ops.get(k), card_ops.get(k)) for k in set(meta.ops) | set(card_ops)
                 if meta.ops.get(k) != card_ops.get(k)}
    rec.update({
        "meta_flops": flops, "meta_bytes": nbytes, "card_flops": full["count_flops"],
        "card_bytes": full["count_bytes"], "ops_dispatched": sum(card_ops.values()),
        "ops_apart": {k: list(v) for k, v in ops_apart.items()},
        "analytic_bytes": analytic, "allocated_bytes": allocated,
        "batch_bytes": dryrun.tree_bytes_per_device(mb, SH.batch_specs(mesh, mb), mesh),
        "allocated_rel_err": abs(analytic - allocated) / allocated,
        "step_ms_median": median, "bound_ms": bound_s * 1e3,
        "bound_by": "operations" if flops / roofline.H100_FP32_FLOPS >= nbytes / roofline.H100_HBM_BW
        else "bytes",
        "bound_share": bound_s * 1e3 / median,
    })
    log(f"dry-run step {TRAIN_ARCH} {TRAIN_BATCH} x {TRAIN_SEQ}: meta count {flops} FLOPs, "
        f"{nbytes} bytes ({rec['meta_count_s']:.1f} s); 6c's first step on the card "
        f"{full['count_flops']} FLOPs, {full['count_bytes']} bytes over {rec['ops_dispatched']} "
        f"ops; ops apart {ops_apart}; specs' bytes {analytic:.0f} against {allocated} allocated "
        f"after 6c's run ({rec['allocated_rel_err']:.2e}); 6c's median step {median:.3f} ms, "
        f"bound {rec['bound_ms']:.3f} ms by {rec['bound_by']} (share {rec['bound_share']:.4f})")
    if (full["count_flops"], full["count_bytes"]) != (flops, nbytes):
        raise AssertionError(f"dry run: the card's count differs from meta's; ops apart "
                             f"{ops_apart}")
    if rec["allocated_rel_err"] > DRYRUN_ALLOC_TOL:
        raise AssertionError(f"dry run: specs' bytes {analytic} against {allocated} allocated")
    if median < rec["bound_ms"]:
        raise AssertionError(f"dry run: a step of {median:.3f} ms beats its bound of "
                             f"{rec['bound_ms']:.3f} ms: the count is wrong")


def dryrun_db_plane(out):
    """Phase 6d (c): the dry run's ``--db-plane`` at 16 x 16: the data
    plane on a 16-shard ``DataMesh`` of the card at the reference's 64 M
    rows, its record written by the CLI and validated."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.db_plane import validate_db_plane_record

    t0 = time.perf_counter()
    dryrun.main(["--db-plane"])
    rec = next(r for r in dryrun.load_results()
               if r["arch"] == "graftdb-dataplane" and r["mesh"] == "16x16")
    out["db_plane"] = validate_db_plane_record(rec)
    out["db_plane"]["wall_s"] = time.perf_counter() - t0
    log(f"dry-run db plane 16x16: valid, {rec['data_shards']} shards, {rec['rows']} rows; "
        f"{rec['hlo_stats']}; {out['db_plane']['wall_s']:.1f} s")


def dryrun_phase(report):
    """Phase 6d: the dry-run tooling. Launch counts are reset before it
    and read after it: only the db plane's shard-local chains launch a
    kernel (B1)."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    out = report["dryrun"] = {}
    _build.reset_launch_counts()
    dryrun_cells(out)
    dryrun_step(out, report.get("train", {}))
    dryrun_db_plane(out)
    launches = _build.launch_counts()
    report["launches"]["dryrun"] = launches
    out["seconds"] = time.perf_counter() - t0
    log(f"launches in the dry-run phase: {launches}; phase {out['seconds']:.1f} s")
    if not launches.get("fused_chain"):
        raise AssertionError(f"dry run: the db plane's chains launched no B1: {launches}")


def example_main(name):
    """The ``main`` of ``examples/<name>.py``."""
    import runpy

    return runpy.run_path(str(ROOT / "examples" / f"{name}.py"))["main"]


def examples_phase(report):
    """Phase 8: the three example twins on the card, each with the launch
    counts reset before it and read after it. The quickstart's Q_B must
    match the port's reference executor and B1 must launch; the serving
    twin (a host simulator) must print its lines and launch nothing; the
    closed-loop twin must print its grid's four lines and launch B1."""
    import contextlib
    import io

    from repro_torch.kernels import _build

    out = report["examples"] = {}
    for name in ("quickstart_torch", "serve_folding_torch", "concurrent_workload_torch"):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            example_main(name)([])
        launches = _build.launch_counts()
        lines = text.getvalue().splitlines()
        out[name] = {"lines": lines, "launches": launches, "wall_s": time.perf_counter() - t0}
        report["launches"][name] = launches
        log(f"example {name}: {out[name]['wall_s']:.1f} s; launches of B1-B4 "
            f"{ {k: launches.get(k, 0) for k in MAIN_KERNELS} }; "
            + " | ".join(line for line in lines[:8] if line))
    qs, sf, cw = (out[k] for k in ("quickstart_torch", "serve_folding_torch",
                                   "concurrent_workload_torch"))
    if "Q_B result matches reference executor: True" not in qs["lines"]:
        raise AssertionError(f"quickstart: {qs['lines']}")
    if not qs["launches"].get("fused_chain"):
        raise AssertionError(f"quickstart: B1 did not launch: {qs['launches']}")
    if any(sf["launches"].values()) or not any(x.startswith("folding :") for x in sf["lines"]):
        raise AssertionError(f"serving twin: {sf}")
    grid = [line.split(" throughput")[0].strip() for line in cw["lines"]]
    if grid != ["isolated", "qpipe_osp", "graft", "graft 4w×8p"]:
        raise AssertionError(f"closed-loop twin: {cw['lines']}")
    if not cw["launches"].get("fused_chain"):
        raise AssertionError(f"closed-loop twin: B1 did not launch: {cw['launches']}")


def card_smi():
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible; this smoke run needs one", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC} does not hold the port; run from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import graftdb_torch  # noqa: F401  (the facade must import)

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = card_smi()
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    report = {"device": {"name": name, "nvidia_smi": smi}}

    rows = smoke(report)
    rows += kernel_ops(report)
    lm_phase(report)
    train_phase(report)
    dryrun_phase(report)
    examples_phase(report)
    trace_launch_path(report)
    trace_mesh(report)
    trace_seg_passes(report)
    trace_train(report)
    trace_lm(report)

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
